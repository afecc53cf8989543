"""Bridge between the reference's parameter tree and the port's.

The reference stacks per-layer parameters on a leading axis
(``LM.init`` vmaps the layer init; ``EncDecLM`` its ``enc_layers`` and
``dec_layers``), and the port keeps them stacked the same way; the conv
nets' trees are flat per block (HWIO weights, GroupNorm scale and bias) and
the MLP's ``w{i}`` / ``b{i}`` in both. The MoE and hybrid families keep
the reference's trees too: expert stacks ``(L, E, d, f)`` beside the
``router`` ``(L, d, E)``, arctic's dense ``residual`` FFN, the Mamba leaves
(``in_proj``, ``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``,
``A_log``, ``D``, ``out_proj``) and jamba's per-sub-layer keys ``sub0`` ..
``sub7`` of one layer step; so does rwkv6: its time mix (``w_r``, ``w_k``,
``w_v``, ``w_g``, ``w_o``, ``decay_base``, ``decay_lora_a`` / ``_b``,
``bonus`` (L, H, hd), ``mix_base`` (L, 5, d), ``mix_lora_a`` (L, d, 5, r),
``mix_lora_b`` (L, 5, r, d), ``ln_x_scale`` / ``_bias``), its channel mix
(``w_k``, ``w_v``, ``w_r``, ``mix_k``, ``mix_r``) and the top-level
``embed_norm``, stacked on the layer axis. The two trees have the same keys, shapes and
layouts, leaf for leaf, so the bridge is a leaf-wise conversion between
numpy arrays and tensors.

Training keeps fp32 master weights. The reference trains n codistilling
peers as ONE tree with a leading peer axis; the port keeps a list of n
trees, so ``peer_params_from_jax`` splits that axis and
``peer_params_to_numpy`` stacks it back. ``opt_state_from_jax`` carries an
``OptState`` (step, m, v) across, so both sides can start from one
optimizer state.

Serving holds weights in the activation dtype on the card. The reference
keeps fp32 parameters and casts each weight to ``x.dtype`` inside every
einsum (``attention.py:46-52``, ``ffn.py:35-39``, ``common.py:133,145``), so
casting once at load (``serving_params``) gives the same numbers without
re-reading the fp32 tree every decode step. The leaves the reference reads
in fp32 are the exception and keep their dtype: norm scales (``rms_norm``),
the MoE ``router`` (``moe.py:108-109``), Mamba's ``dt_bias``, ``A_log``
and ``D`` (``mamba.py:49-66, 131``) and RWKV's ``decay_base``, ``bonus``,
``ln_x_scale`` and ``ln_x_bias`` (``rwkv.py:190, 213, 218-219``).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device

PyTree = Any


def _map(tree: PyTree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def params_from_jax(tree: PyTree, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> PyTree:
    """Reference tree of numpy(-convertible) leaves -> port tree of tensors
    on ``device`` (stacked layers kept stacked). ``dtype`` None keeps each
    leaf's dtype (bf16 leaves arrive through an exact fp32 upcast)."""
    dev = resolve_device(device)

    def leaf(_path, a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))    # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return _map(tree, leaf)


def params_to_numpy(params: PyTree) -> PyTree:
    """Port tree -> tree of numpy arrays with the reference's layout (bf16
    leaves are returned as their exact fp32 values)."""
    def leaf(_path, t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _map(params, leaf)


# leaves the reference reads in fp32 whatever the activation dtype
_FP32_READ = ("router", "dt_bias", "A_log", "D", "decay_base", "bonus",
              "ln_x_scale", "ln_x_bias")


def serving_params(params: PyTree, dtype: torch.dtype) -> PyTree:
    """Cast every weight, embedding and bias to ``dtype`` once; norm scales
    and the other leaves read in fp32 keep their dtype (see the module
    docstring)."""
    def leaf(path, t):
        is_norm = path[-1] == "scale" and "norm" in path[-2]
        return t if is_norm or path[-1] in _FP32_READ else t.to(dtype)

    return _map(params, leaf)


def _get(tree: PyTree, path):
    for k in path:
        tree = tree[k]
    return tree


def peer_params_from_jax(stacked_tree: PyTree, n: int, device="cuda",
                         dtype: Optional[torch.dtype] = None) -> list:
    """A reference tree with a leading peer axis of size n -> a list of n
    port trees (peer i is slice i of every leaf)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    host = _map(stacked_tree, lambda _p, a: np.asarray(a))
    for path, a in _flat_items(host):
        if a.shape[:1] != (n,):
            raise ValueError(f"leaf {'/'.join(path)} has shape {a.shape}: "
                             f"no leading peer axis of size {n}")
    return [params_from_jax(_map(host, lambda _p, a, i=i: a[i]), device, dtype)
            for i in range(n)]


def peer_params_to_numpy(peers: list) -> PyTree:
    """The inverse of ``peer_params_from_jax``: n port trees -> one tree of
    numpy arrays with a leading peer axis."""
    trees = [params_to_numpy(p) for p in peers]
    return _map(trees[0], lambda path, _a: np.stack([_get(t, path)
                                                     for t in trees]))


def _flat_items(tree: PyTree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, path + (k,))
    else:
        yield path, tree


def opt_state_from_jax(opt, n: int = 0, device="cuda"):
    """A reference ``OptState(step, m, v)`` -> the port's. ``n`` > 0 splits
    stacked moments into per-peer lists (codistillation states); 0 keeps
    one tree (a single model)."""
    from repro_torch.optim import OptState

    def conv(tree):
        if tree is None:
            return None
        return (peer_params_from_jax(tree, n, device) if n
                else params_from_jax(tree, device))

    return OptState(int(np.asarray(opt.step)), conv(opt.m), conv(opt.v))
