"""SGD-momentum and AdamW over parameter trees, updated in place.

Weight decay is decoupled and passed per step, which is how the paper's
codistillation-aware decay schedule enters the update. An optional
``trainable`` mask (the same tree, 0/1 leaves) freezes parameters.

The reference's updates are pure functions returning new trees. The port
updates the parameter and moment tensors IN PLACE under ``torch.no_grad()``
(a full-size AdamW state is 3x the weights; copying it each step would
double that) and returns the same tree objects with a new ``OptState``.
The math is the reference's: fp32 inside, cast back to the parameter's
(and the moment buffer's) dtype; AdamW's bias corrections use t = step + 1.
The update is elementwise, so a large leaf (an expert stack of 1.6 G
values) is updated in flat slices of ``_SLICE`` values: its fp32
temporaries stay bounded, and the numbers are those of one pass.

A DTensor leaf (a peer's state on its pod's mesh, or one model's on the
whole (pod, data, model) mesh, ``launch/sharding.py``) is updated on its
local shard: its gradient is first redistributed to the parameter's
placements (a ``Partial`` sum over "data" becomes a reduce-scatter or an
all-reduce), and the parameter, the gradient and the moments then share
placements, so the elementwise arithmetic on their local tensors is the
update of the whole. A sum over "pod" (the all-reduce baseline's rows
span the pods) is reduced last, after every other mesh dim has placed the
gradient, so the cross-pod all-reduce carries the parameter's own shard:
``pod_sync`` meters it, the baseline's counterpart of the pod group's
wire meter (``launch/mesh.py`` ``PodGroup``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class OptState(NamedTuple):
    step: int
    m: PyTree              # momentum / first moment
    v: Optional[PyTree]    # second moment (adamw only)


def _zeros(params: PyTree, dtype) -> PyTree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype,
                                               requires_grad=False), params)


# values of a leaf updated at once (bounds the fp32 temporaries of one leaf)
_SLICE = 1 << 26


def _leaf_triples(params, grads, state_trees, trainable):
    """(param, grad, *state, mask) tuples over matching trees, each leaf cut
    into matching flat slices of ``_SLICE`` values (a small leaf is one
    slice). A leaf that is not contiguous, or whose mask has another shape,
    goes whole."""
    for *ts, mask in _whole_leaves(params, grads, state_trees, trainable):
        ts, mask = _local_shards(ts, mask)
        if not all(x.is_contiguous() for x in ts) \
                or (torch.is_tensor(mask) and mask.shape != ts[0].shape):
            yield (*ts, mask)
            continue
        flat = [x.view(-1) for x in ts]
        if torch.is_tensor(mask):
            mask = mask.reshape(-1)
        for i in range(0, flat[0].numel(), _SLICE):
            yield (*(x[i:i + _SLICE] for x in flat),
                   mask[i:i + _SLICE] if torch.is_tensor(mask) else mask)


@dataclass
class PodSync:
    """The meter of the cross-pod gradient reduction: ``bytes`` counts the
    operand bytes a device sends into each reduction over "pod" (its local
    shard of the gradient, as ``launch/cost.py`` ``CollectiveOp.
    operand_bytes`` counts an all-reduce), ``reductions`` the leaves so
    reduced; with ``timed`` set, ``seconds`` the host seconds of those
    reductions from a synchronised device to the reduced gradient on it."""
    bytes: int = 0
    reductions: int = 0
    seconds: float = 0.0
    timed: bool = False

    def reset(self) -> None:
        self.bytes, self.reductions, self.seconds = 0, 0, 0.0

    def reduce(self, g, placements):
        """``g`` redistributed to ``placements``: the reduction over
        "pod", metered."""
        local = g.to_local()
        if self.timed and local.device.type == "cuda":
            torch.cuda.synchronize(local.device)
        t0 = time.perf_counter()
        out = g.redistribute(g.device_mesh, placements)
        if self.timed:
            if local.device.type == "cuda":
                torch.cuda.synchronize(local.device)
            self.seconds += time.perf_counter() - t0
        self.bytes += local.numel() * local.element_size()
        self.reductions += 1
        return out


pod_sync = PodSync()


def placed_grad(g, p):
    """The DTensor gradient ``g`` on the DTensor parameter ``p``'s
    placements: first on every mesh dim but "pod", then, where ``g`` is a
    sum over the pods (``Partial`` on a "pod" dim of more than one
    device), reduced over "pod" through ``pod_sync``."""
    mesh = p.device_mesh
    want = tuple(p.placements)
    names = mesh.mesh_dim_names or ()
    if "pod" in names:
        i = names.index("pod")
        if mesh.size(i) > 1 and g.placements[i].is_partial():
            inner = want[:i] + (g.placements[i],) + want[i + 1:]
            if tuple(g.placements) != inner:
                g = g.redistribute(mesh, inner)
            return pod_sync.reduce(g, want)
    return g.redistribute(mesh, want)


def _local_shards(ts, mask):
    """(param, grad, *state) as the local tensors of the parameter's
    placements where the parameter is a DTensor (the gradient placed on
    them first, ``placed_grad``), else as given; a DTensor mask
    likewise."""
    p = ts[0]
    if type(p) is torch.Tensor:
        return ts, mask
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return ts, mask
    g = ts[1]
    if tuple(g.placements) != tuple(p.placements):
        g = placed_grad(g, p)
    ts = [p.to_local(), g.to_local(), *(x.to_local() for x in ts[2:])]
    if isinstance(mask, DTensor):
        mask = mask.redistribute(p.device_mesh, p.placements).to_local()
    return ts, mask


def _whole_leaves(params, grads, state_trees, trainable):
    """Flat (param, grad, *state, mask) tuples over matching trees."""
    if (trainable is not None and isinstance(params, list)
            and not isinstance(trainable, list)):
        # one mask for every peer of a peer list, as the reference's mask
        # broadcasts over its stacked peer axis
        trainable = [trainable] * len(params)
    cols = [tree_leaves(params), tree_leaves(grads)]
    cols += [tree_leaves(t) for t in state_trees]
    cols.append(tree_leaves(trainable) if trainable is not None
                else [None] * len(cols[0]))
    n = len(cols[0])
    if any(len(c) != n for c in cols):
        raise ValueError("parameter, gradient and optimizer trees differ")
    return zip(*cols)


def _write(p: torch.Tensor, new32: torch.Tensor, mask) -> None:
    if mask is not None:
        if not torch.is_tensor(mask):
            if mask <= 0:            # a frozen leaf of a 0/1 number mask
                return
        else:
            new32 = torch.where(mask > 0, new32, p.float())
    p.copy_(new32)


# ----------------------------------------------------------------------------
# SGD + momentum (the paper's vision optimizer)
# ----------------------------------------------------------------------------

def sgdm_init(params: PyTree, dtype=torch.float32) -> OptState:
    return OptState(0, _zeros(params, dtype), None)


@torch.no_grad()
def sgdm_update(params: PyTree, grads: PyTree, state: OptState, lr,
                weight_decay=0.0, momentum: float = 0.9,
                trainable: Optional[PyTree] = None) -> Tuple[PyTree, OptState]:
    """A state without a buffer (``OptState(step, None, None)``) runs plain
    SGD, momentum 0, and keeps no per-parameter state: the reference's
    momentum-0 buffer only ever holds the last gradient, which a model
    that fills the card with its weights and gradients has no room for.
    It exists for one run, ``chip_smoke.py``'s families phase: grok-1 at
    full width (1 layer), 2 peers trained on one 80 GB card."""
    lr, wd = float(lr), float(weight_decay)
    if state.m is None and momentum:
        raise ValueError(f"momentum {momentum} needs a momentum buffer")
    bufs = () if state.m is None else (state.m,)
    for p, g, *m, mask in _leaf_triples(params, grads, bufs, trainable):
        p32 = p.float()
        g32 = g.float() + wd * p32
        m_new = momentum * m[0].float() + g32 if m else g32
        _write(p, p32 - lr * m_new, mask)
        if m:
            m[0].copy_(m_new)
    return params, OptState(state.step + 1, state.m, None)


# ----------------------------------------------------------------------------
# AdamW (the paper's NMT optimizer)
# ----------------------------------------------------------------------------

def adamw_init(params: PyTree, dtype=torch.float32) -> OptState:
    return OptState(0, _zeros(params, dtype), _zeros(params, dtype))


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, state: OptState, lr,
                 weight_decay=0.0, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8,
                 trainable: Optional[PyTree] = None) -> Tuple[PyTree, OptState]:
    lr, wd = float(lr), float(weight_decay)
    t = float(state.step) + 1.0
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for p, g, m, v, mask in _leaf_triples(params, grads, (state.m, state.v),
                                          trainable):
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32 * g32
        p32 = p.float()
        upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * p32
        _write(p, p32 - lr * upd, mask)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, OptState(state.step + 1, state.m, state.v)


# ----------------------------------------------------------------------------
# factory
# ----------------------------------------------------------------------------

_OPT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_optimizer(kind: str, **kw) -> Tuple[Callable, Callable]:
    """(init_fn(params), update_fn(params, grads, state, lr, wd,
    trainable=None)). ``dtype`` sets the moment-buffer dtype (fp32 default)."""
    dtype = kw.get("dtype", torch.float32)
    if isinstance(dtype, str):
        dtype = _OPT_DTYPES[dtype]
    if kind == "sgdm":
        momentum = kw.get("momentum", 0.9)
        return (lambda p: sgdm_init(p, dtype),
                lambda p, g, s, lr, wd, trainable=None: sgdm_update(
                    p, g, s, lr, wd, momentum, trainable))
    if kind == "adamw":
        b1, b2 = kw.get("b1", 0.9), kw.get("b2", 0.95)
        return (lambda p: adamw_init(p, dtype),
                lambda p, g, s, lr, wd, trainable=None: adamw_update(
                    p, g, s, lr, wd, b1, b2, trainable=trainable))
    raise ValueError(kind)
