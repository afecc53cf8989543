"""Parameter-tree checkpoints: an npz payload and a json tree description,
in the reference's format.

``save_pytree(path, tree)`` writes ``path + ".npz"`` with one array
``leaf_i`` per leaf and ``path + ".tree.json"`` with the tree's structure
and leaf count (plus ``meta``). Leaves go in the reference's flatten order
(dict keys sorted, sequences in order, None holds no leaf), so the
reference's ``load_pytree`` reads the port's file into its own template of
the same structure, and ``load_pytree`` here reads the reference's. A peer
list is saved in the reference's stacked layout by passing
``peer_params_to_numpy(peers)``.

Both files are written atomically, payload first: each goes to a
temporary, is flushed and fsynced, and is ``os.replace``d into place, so an
interrupted save leaves the previous complete checkpoint, and the tree
file never describes a payload that is not on disk yet.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Optional

import numpy as np
import torch

PyTree = Any


def _is_seq(x) -> bool:
    return isinstance(x, (list, tuple))


def _flatten(tree: PyTree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if _is_seq(tree):
        return [x for v in tree for x in _flatten(v)]
    if tree is None:
        return []
    return [tree]


def _describe(tree: PyTree) -> str:
    """The tree's structure, spelled as ``str`` of a jax treedef."""
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree))
        return "{" + inner + "}"
    if _is_seq(tree):
        inner = ", ".join(_describe(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "None" if tree is None else "*"


def _unflatten(like: PyTree, leaves) -> PyTree:
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if _is_seq(t):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        if t is None:
            return None
        return next(it)
    return build(like)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:       # numpy has no bf16: exact upcast
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_pytree(path: str, tree: PyTree, meta: Optional[dict] = None) -> None:
    """Write ``path + ".npz"`` (payload) then ``path + ".tree.json"``
    (structure, leaf count, ``meta``), each atomically. Leaves may be
    tensors (on any device) or numpy arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = _flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    _write_atomic(path + ".npz", lambda f: np.savez(f, **arrays))
    doc = {"treedef": f"PyTreeDef({_describe(tree)})", "n_leaves": len(leaves)}
    if meta:
        doc["meta"] = meta
    _write_atomic(path + ".tree.json",
                  lambda f: f.write(json.dumps(doc).encode()))


def read_meta(path: str) -> Optional[dict]:
    """The ``meta`` dict saved beside a tree (None if absent)."""
    try:
        with open(path + ".tree.json") as f:
            return json.load(f).get("meta")
    except (OSError, json.JSONDecodeError):
        return None


def load_pytree(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like``: each leaf takes its template
    leaf's dtype (and device, for tensors). A payload that is unreadable
    or has another leaf count than the template raises ``ValueError``."""
    like_leaves = _flatten(like)
    try:
        with np.load(path + ".npz") as data:
            if len(data.files) != len(like_leaves):
                raise ValueError(f"has {len(data.files)} leaves, the "
                                 f"template {len(like_leaves)}")
            raw = [np.asarray(data[f"leaf_{i}"])
                   for i in range(len(like_leaves))]
    except Exception as e:
        raise ValueError(f"corrupt or mismatched checkpoint payload "
                         f"{path + '.npz'!r}: {type(e).__name__}: {e}") from e
    out = []
    for x, ref in zip(raw, like_leaves):
        if tuple(x.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf shape {x.shape} != template "
                             f"{tuple(ref.shape)}")
        if isinstance(ref, torch.Tensor):
            out.append(torch.from_numpy(np.array(x)).to(device=ref.device,
                                                         dtype=ref.dtype))
        else:
            out.append(x.astype(ref.dtype))
    return _unflatten(like, out)
