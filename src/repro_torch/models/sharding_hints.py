"""Activation placements behind the reference's sharding hints.

The reference steers XLA's partitioner with ``with_sharding_constraint`` at
a few named places of its model code (``hint(x, kind)``) while a launcher's
``activation_sharding`` context is active. ``hint_spec(kind, shape,
batch_axes, tp_axis, tp_size)`` returns the spec ``hint`` applies to an
activation of that shape, or None where it leaves it alone. The cost model
(``launch/cost.py``) reads it for the bytes of the activations a device
holds (``btd_carry``, ``scores``, ``btv``) and for the split of the
attention core (``scores``) and of the loss rows (``btv``) over tp; its
collectives come from the weights' placements.

``hint(x, kind)`` is called where the reference calls it (the logits, the
attention scores, the residual stream, the top-k wire). Inside the context
it redistributes a DTensor ``x`` (a peer's activation on its pod's
("data", "model") mesh, or one model's on the whole mesh) to
``current_hint_spec``'s placements, each entry cut to the axes its dim
divides over; on a plain tensor, or outside the context, it returns
``x``. The scores are computed
on each rank's own heads (``models/attention.py``), so there the spec
places the attention core's inputs instead. A port's wire is one peer's,
without the reference's stacked model axis: its spec is the stacked
wire's with the "pod" entry dropped.

Kinds: ``btd`` (batch, seq, d_model), ``btd_carry`` (the residual stream
between layers: d_model over tp when divisible), ``btv`` (batch, seq,
vocab over tp), ``wire`` (the stacked codist exchange payload: its model
axis over "pod"), ``scores`` (attention scores (B, H, S, T): heads over tp
when divisible, else the query axis, else untouched: 56 heads on tp 16
fall back to the query axis).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager, nullcontext
from typing import Optional, Sequence, Tuple

from repro_torch.launch.sharding import P, PartitionSpec

_state = threading.local()


@contextmanager
def activation_sharding(batch_axes: Optional[Tuple[str, ...]],
                        tp_axis: Optional[str], tp_size: int = 0):
    """The placements ``current_hint_spec`` reads inside the block (the
    reference's context of the same name, which its launchers set before
    tracing)."""
    _state.ctx = (batch_axes, tp_axis, tp_size)
    try:
        yield
    finally:
        _state.ctx = None


def remat_context():
    """A ``context_fn`` for ``torch.utils.checkpoint``: the layer recomputed
    in the backward sees the context the forward ran in, this module's
    placements and, on a mesh, DTensor's implicit replication (``on_mesh``
    in ``train/engine.py`` enters both). A CUDA backward runs on the
    autograd engine's device thread, where a thread-local context is not
    set: there the hints would place nothing, and the recomputed layer's
    tensors would not be the ones its forward saved. Each is restored on
    exit, so a recomputation on the forward's own thread leaves it as it
    was."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return nullcontext(), nullcontext()
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    implicit = dispatcher._allow_implicit_replication

    @contextmanager
    def recompute():
        before = getattr(_state, "ctx", None), \
            dispatcher._allow_implicit_replication
        _state.ctx = ctx
        dispatcher._allow_implicit_replication = implicit
        try:
            yield
        finally:
            _state.ctx = before[0]
            dispatcher._allow_implicit_replication = before[1]
    return nullcontext(), recompute()


def hint_spec(kind: str, shape: Sequence[int],
              batch_axes: Optional[Tuple[str, ...]], tp_axis: Optional[str],
              tp_size: int = 0) -> Optional[PartitionSpec]:
    """The spec the reference's ``hint(x, kind)`` applies to an ``x`` of
    ``shape`` under ``activation_sharding(batch_axes, tp_axis, tp_size)``,
    or None where it returns ``x`` untouched (an unknown kind, the scores
    with neither heads nor queries divisible, a wire of rank < 2). A spec
    shorter than the shape is padded with None on the left (stacked codist
    models: the leading axis is placed by the params and the batch)."""
    ndim = len(shape)
    tp_size = tp_size or 1
    b = batch_axes if batch_axes else None
    if kind == "btd":
        spec = [b, None, None]
    elif kind == "btd_carry":
        d = shape[-1]
        spec = [b, None, tp_axis if (d % tp_size == 0 and d >= tp_size)
                else None]
    elif kind == "btv":
        spec = [b, None, tp_axis]
    elif kind == "wire":
        spec = ["pod", b, *([None] * (ndim - 2))]
        return P(*spec) if len(spec) == ndim else None
    elif kind == "scores":
        h, s = shape[-3], shape[-2]
        if h % tp_size == 0 and h >= tp_size:
            spec = [b, tp_axis, None, None]
        elif s % tp_size == 0 and s >= tp_size:
            spec = [b, None, tp_axis, None]
        else:
            return None
    else:
        return None
    if len(spec) != ndim:
        spec = [None] * (ndim - len(spec)) + spec
    return P(*spec)


def current_hint_spec(kind: str, shape: Sequence[int]
                      ) -> Optional[PartitionSpec]:
    """``hint_spec`` under the active context (None outside one, where the
    reference's ``hint`` is a no-op)."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or (ctx[0] is None and ctx[1] is None):
        return None
    return hint_spec(kind, shape, *ctx)


def hint(x, kind: str):
    """``x`` redistributed to the placements of ``current_hint_spec(kind,
    x.shape)`` on its own mesh where ``x`` is a DTensor and the spec is not
    None; else ``x`` itself (the reference's ``hint`` outside a context is
    a no-op, and a plain tensor has no placement to steer)."""
    if getattr(_state, "ctx", None) is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if kind == "wire":
        spec = current_hint_spec(kind, (1, *x.shape))
        spec = None if spec is None else P(*spec[1:])
    else:
        spec = current_hint_spec(kind, x.shape)
    if spec is None:
        return x
    from repro_torch.launch.sharding import placements
    mesh = x.device_mesh
    want = placements(dividing_spec(spec, x.shape, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def dividing_spec(spec, shape, mesh) -> PartitionSpec:
    """``spec`` with each entry cut to the mesh axes its dim divides over:
    a tuple of axes loses its outer ones until the dim divides (a batch
    whose rows do not split over ("pod", "data") goes over "data", as
    ``launch/sharding.py`` ``batch_shardings`` places it), and an entry
    whose dim divides over none of them is None. The reference's
    constraint pads an uneven dim; DTensor's uneven shards do not survive
    the step's views."""
    from repro_torch.launch.sharding import axes_of
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    out = []
    for dim, entry in enumerate(spec):
        axes = list(axes_of(entry))
        while axes and shape[dim] % math.prod(int(sizes[a]) for a in axes):
            axes.pop(0)
        out.append(tuple(axes))
    return P(*out)
