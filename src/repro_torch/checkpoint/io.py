"""Parameter-tree checkpoints: an npz payload and a json tree description,
in the reference's format.

``save_pytree(path, tree)`` writes ``path + ".npz"`` with one array
``leaf_i`` per leaf and ``path + ".tree.json"`` with the tree's structure
and leaf count (plus ``meta``). Leaves go in the reference's flatten order
(dict keys sorted, sequences in order, None holds no leaf), so the
reference's ``load_pytree`` reads the port's file into its own template of
the same structure, and ``load_pytree`` here reads the reference's. A peer
list is saved in the reference's stacked layout by passing
``peer_params_to_numpy(peers)``. A train state (``TrainState`` /
``OptState`` named tuples, with Python ints for the steps) saves as it is:
its ints become 0-d int64 arrays and load back as ints.

The async runtime's snapshots (``save_snapshot`` and the rest) keep one
``peer{pid}`` slot a peer under a directory, in the same layout: a train
state's params are its leading leaves, so ``load_snapshot_params`` (and the
reference's) restore them against a params-only template.

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


def _read_leaves(path: str, like_leaves, exact: bool = True) -> list:
    """The payload's leading ``len(like_leaves)`` leaves, each converted to
    its template leaf's type, dtype (and device, for tensors). ``exact``
    also requires the payload to hold no more leaves than the template. An
    unreadable payload, or one with other counts or shapes, raises
    ``ValueError``."""
    n = len(like_leaves)
    try:
        with np.load(path + ".npz") as data:
            if len(data.files) < n or (exact and len(data.files) != n):
                raise ValueError(f"has {len(data.files)} leaves, the "
                                 f"template {n}")
            raw = [np.asarray(data[f"leaf_{i}"]) for i in range(n)]
    except Exception as e:
        raise ValueError(f"corrupt or mismatched checkpoint payload "
                         f"{path + '.npz'!r}: {type(e).__name__}: {e}") from e
    out = []
    for x, ref in zip(raw, like_leaves):
        shape = () if isinstance(ref, (int, float)) else tuple(ref.shape)
        if tuple(x.shape) != shape:
            raise ValueError(f"checkpoint leaf shape {x.shape} != template "
                             f"{shape}")
        if isinstance(ref, torch.Tensor):
            out.append(torch.from_numpy(np.array(x)).to(device=ref.device,
                                                         dtype=ref.dtype))
        elif isinstance(ref, (int, float)):
            out.append(type(ref)(x.item()))
        else:
            out.append(x.astype(ref.dtype))
    return out


def load_pytree(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like``: each leaf takes its template
    leaf's dtype (and device, for tensors; Python ints stay ints). A payload
    that is unreadable or has another leaf count than the template raises
    ``ValueError``."""
    return _unflatten(like, _read_leaves(path, _flatten(like)))


# ----------------------------------------------------------------------------
# the async runtime's per-peer snapshots
# ----------------------------------------------------------------------------

def snapshot_path(directory: str, peer: int) -> str:
    """Keep-latest snapshot slot of one async-runtime peer."""
    return os.path.join(directory, f"peer{peer}")


def save_snapshot(directory: str, peer: int, state: PyTree,
                  meta: Optional[dict] = None) -> None:
    """Overwrite the peer's latest snapshot (its recovery point). ``meta``
    (e.g. ``{"step": n}``) lets a reader order snapshots without loading
    the payload."""
    save_pytree(snapshot_path(directory, peer), state, meta)


def snapshot_meta(directory: str, peer: int) -> Optional[dict]:
    return read_meta(snapshot_path(directory, peer))


def has_snapshot(directory: str, peer: int) -> bool:
    return os.path.exists(snapshot_path(directory, peer) + ".npz")


def load_snapshot_params(directory: str, peer: int,
                         params_like: PyTree) -> PyTree:
    """Only the params of a saved peer state: its leading leaves, restored
    against a params-only template."""
    path = snapshot_path(directory, peer)
    return _unflatten(params_like,
                      _read_leaves(path, _flatten(params_like), exact=False))


def load_snapshot(directory: str, peer: int, like: PyTree) -> PyTree:
    return load_pytree(snapshot_path(directory, peer), like)
