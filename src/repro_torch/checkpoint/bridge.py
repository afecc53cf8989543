"""Bridge between the reference's parameter tree and the port's.

The reference stacks per-layer parameters on a leading axis
(``LM.init`` vmaps the layer init), and the port keeps them stacked the same
way: the two trees have the same keys, shapes and layouts, leaf for leaf, so
the bridge is a leaf-wise conversion between numpy arrays and tensors.

Serving holds weights in the activation dtype on the card. The reference
keeps fp32 parameters and casts each weight to ``x.dtype`` inside every
einsum (``attention.py:46-52``, ``ffn.py:35-39``, ``common.py:133,145``), so
casting once at load (``serving_params``) gives the same numbers without
re-reading the fp32 tree every decode step. Norm scales are the exception:
the reference reads them in fp32 (``rms_norm``), so they stay fp32.
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


def serving_params(params: PyTree, dtype: torch.dtype) -> PyTree:
    """Cast every weight, embedding and bias to ``dtype`` once; norm scales
    keep their dtype (see the module docstring)."""
    def leaf(path, t):
        is_norm = path[-1] == "scale" and "norm" in path[-2]
        return t if is_norm else t.to(dtype)

    return _map(params, leaf)
