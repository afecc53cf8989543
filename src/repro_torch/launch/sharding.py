"""Sharding rules: param-name-driven partition specs with a divisibility
fallback (the reference's ``launch/sharding.py``, rule for rule).

Strategy (Megatron + FSDP):
  * TP  ("model" axis): attention heads, the FFN hidden dim, the vocab;
  * FSDP ("data" axis): the d_model dim of every large matrix;
  * the scan-over-layers leading axis: never sharded;
  * codistillation: the stacked model axis -> "pod".

A rule that does not divide evenly falls back to replication for that dim
(e.g. 8 KV heads over a 16-way model axis), which is always correct.

A spec is a ``PartitionSpec``: a tuple with one entry per dim, each an axis
name, a tuple of names or None (``()`` replicates a scalar); it equals the
plain tuple of its entries. The rules read a tree's leaves by their path
strings, which are the reference's ``_path_str`` leaf for leaf: the port's
trees keep the reference's keys (``checkpoint/bridge.py``), and a state's
NamedTuple fields join the path by name (``params/…``, ``opt/m/…``,
``opt/v/…``). The leaves are anything with a ``shape`` (``torch.device
("meta")`` stand-ins from ``launch/specs.py``).

The rules are executed on a ``torch.distributed`` ``DeviceMesh``
(``launch/mesh.py``'s ``device_mesh``): ``placements`` turns a spec into
one DTensor placement per mesh dim, and ``distribute_state`` /
``distribute_batch`` place a peer's state and batch on its pod's
("data", "model") sub-mesh, or one model's (the all-reduce baseline's) on
the whole (pod, data, model) mesh. The reference's stacked peer axis is
not a dim of a port's tree (a list of peers, or one peer a pod): its spec
entry ("pod" or None) says which pod holds the peer and is never a
placement.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch

PyTree = Any


class PartitionSpec(tuple):
    """One entry per dim: an axis name, a tuple of names, or None; a tuple
    of one name is that name, an empty one None (as ``jax``'s)."""

    def __new__(cls, *parts):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in parts))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# name -> spec template applied to the LAST len(template) dims of the leaf.
# Symbols: 'fsdp' -> data axis, 'tp' -> model axis, None -> replicated.
# Entries may be (pattern, template) or (pattern, template, slide);
# slide=False disables the greedy divisibility fallback (attention head
# dims: sharding head_dim when the head count is indivisible makes the
# partitioner re-gather whole tensors; replication + sequence-parallel
# scores is cheaper).
_RULES = [
    # embeddings / head
    (r"embed/tokens$", ("tp", "fsdp")),            # (V, d)
    (r"embed/head$", ("fsdp", "tp")),              # (d, V)
    # attention
    (r"(self_attn|cross_attn|attn|mix)/wq$", ("fsdp", "tp", None), False),
    (r"(self_attn|cross_attn|attn|mix)/wk$", ("fsdp", "tp", None), False),
    (r"(self_attn|cross_attn|attn|mix)/wv$", ("fsdp", "tp", None), False),
    (r"(self_attn|cross_attn|attn|mix)/wo$", ("tp", "fsdp")),
    (r"/b[qkv]$", ("tp", None), False),
    # dense ffn (also arctic's residual branch)
    (r"(ffn|residual)/w_gate$", ("fsdp", "tp")),
    (r"(ffn|residual)/w_up$", ("fsdp", "tp")),
    (r"(ffn|residual)/w_down$", ("tp", "fsdp")),
    # moe
    (r"ffn/router$", ("fsdp", None)),              # (d, E)
    (r"ffn/w_gate$", (None, "fsdp", "tp")),        # (E, d, f), after dense
    (r"ffn/w_up$", (None, "fsdp", "tp")),
    (r"ffn/w_down$", (None, "tp", "fsdp")),
    # mamba
    (r"mix/in_proj$", ("fsdp", "tp")),
    (r"mix/conv_w$", (None, "tp")),
    (r"mix/conv_b$", ("tp",)),
    (r"mix/x_proj$", ("tp", None)),
    (r"mix/dt_proj$", (None, "tp")),
    (r"mix/dt_bias$", ("tp",)),
    (r"mix/A_log$", ("tp", None)),
    (r"mix/D$", ("tp",)),
    (r"mix/out_proj$", ("tp", "fsdp")),
    # rwkv time-mix / channel-mix
    (r"mix/w_[rkvg]$", ("fsdp", "tp")),
    (r"mix/w_o$", ("tp", "fsdp")),
    (r"mix/decay_lora_a$", ("fsdp", None)),
    (r"mix/decay_lora_b$", (None, "tp")),
    (r"mix/decay_base$", ("tp",)),
    (r"mix/bonus$", ("tp", None)),
    (r"mix/ln_x_(scale|bias)$", ("tp",)),
    (r"ffn/w_k$", ("fsdp", "tp")),
    (r"ffn/w_v$", ("tp", "fsdp")),
    (r"ffn/w_r$", ("fsdp", "tp")),
    # conv nets: replicate (pure DP: they are small)
]

_SCAN_SUBTREES = ("layers", "enc_layers", "dec_layers")


# ----------------------------------------------------------------------------
# trees with paths
# ----------------------------------------------------------------------------

def _is_leaf(x) -> bool:
    return isinstance(x, PartitionSpec) or torch.is_tensor(x) \
        or not isinstance(x, (dict, list, tuple))


def tree_map_with_path(fn: Callable, tree: PyTree, path: Tuple[str, ...] = ()
                       ) -> PyTree:
    """``fn(path, leaf)`` over a tree of dicts (keys), NamedTuples (field
    names) and lists / tuples (indices), rebuilt with the same structure;
    None is an empty subtree, a ``PartitionSpec`` a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               path + (f,))
                            for f in tree._fields))
    if _is_leaf(tree):
        return fn(path, tree)
    return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                      for i, v in enumerate(tree))


def tree_flatten_with_path(tree: PyTree):
    """[(path string, leaf)] in the tree's order."""
    out = []
    tree_map_with_path(lambda p, x: out.append((path_str(p), x)), tree)
    return out


def path_str(path) -> str:
    return "/".join(path)


# ----------------------------------------------------------------------------
# the rules
# ----------------------------------------------------------------------------

def param_spec(path_s: str, shape: Tuple[int, ...], mesh,
               stacked: bool = False, scanned: bool = False,
               fsdp_axis: Optional[str] = "data",
               tp_axis: Optional[str] = "model",
               moe_expert_axis: Optional[str] = None,
               two_d_ffn: bool = False) -> PartitionSpec:
    """The spec of one parameter leaf.

    moe_expert_axis: shard the EXPERT axis of stacked MoE weights over this
    mesh axis (expert parallelism: token routing becomes an all-to-all)
    instead of FSDP-sharding inside each expert.
    two_d_ffn: the decode-serving scheme: FFN / lm-head / embedding weights
    get 2D weight-stationary sharding over ("data", "model") (no per-step
    re-gather) while attention keeps FSDP + TP."""
    sizes = mesh.shape
    symbols = {"fsdp": fsdp_axis, "tp": tp_axis, "exp": moe_expert_axis}
    if two_d_ffn and re.search(
            r"(embed/tokens|embed/head|ffn/w_(gate|up|down|k|v|r))$", path_s):
        symbols = {"fsdp": None, "tp": ("data", "model"),
                   "exp": moe_expert_axis}

    template: Tuple = ()
    slide = True
    is_expert = (re.search(r"ffn/w_(gate|up|down)$", path_s)
                 and len(shape) >= 3 + int(stacked) + int(scanned))
    if moe_expert_axis and is_expert:
        # (…, E, d, f) / (…, E, f, d): expert axis + tp on the wide dim
        template = (("exp", None, "tp") if path_s.endswith(("w_gate", "w_up"))
                    else ("exp", "tp", None))
        slide = False
    else:
        for rule in _RULES:
            if re.search(rule[0], path_s):
                template = rule[1]
                slide = rule[2] if len(rule) > 2 else True
                break

    ndim = len(shape)
    spec: list = [None] * ndim
    lead = 0
    if stacked:
        if "pod" in sizes and shape[0] == sizes["pod"]:
            spec[0] = "pod"
        lead += 1
    if scanned:
        lead += 1  # the scan axis is never sharded

    def axis_ways(axis) -> int:
        if isinstance(axis, tuple):
            if not all(a in sizes for a in axis):
                return 0
            n = 1
            for a in axis:
                n *= sizes[a]
            return n
        return sizes.get(axis, 0)

    # the template on the trailing dims, with the greedy fallback: if the
    # intended dim is not divisible (28 heads over a 16-way model axis),
    # slide right to the next free divisible dim (head_dim 128)
    t = list(template)[-max(0, ndim - lead):] if template else []
    off = ndim - len(t)
    for i, sym in enumerate(t):
        if sym is None:
            continue
        axis = symbols.get(sym)
        ways = axis_ways(axis) if axis else 0
        if not ways:
            continue
        hi = ndim if slide else min(off + i + 1, ndim)
        for dim in range(max(off + i, lead), hi):
            if spec[dim] is None and shape[dim] % ways == 0 \
                    and shape[dim] >= ways:
                spec[dim] = axis
                break
    return P(*spec)


def _scanned(ps: str) -> bool:
    return any(f"{s}/" in ps for s in _SCAN_SUBTREES)


def params_shardings(params_shapes: PyTree, mesh, stacked: bool = False,
                     fsdp_axis: Optional[str] = "data",
                     tp_axis: Optional[str] = "model") -> PyTree:
    """The spec tree of a (possibly stacked) parameter tree."""
    def one(path, leaf):
        ps = path_str(path)
        return param_spec(ps, tuple(leaf.shape), mesh, stacked, _scanned(ps),
                          fsdp_axis, tp_axis)
    return tree_map_with_path(one, params_shapes)


def optstate_shardings(opt_shapes: PyTree, param_shardings: PyTree,
                       mesh) -> PyTree:
    """Optimizer moments mirror the param specs; scalars replicate."""
    flat_p = dict(tree_flatten_with_path(param_shardings))

    def one(path, leaf):
        ps = path_str(path)
        # OptState fields are ('step', 'm', 'v'); strip the field prefix
        for field in ("m/", "v/"):
            if ps.startswith(field) and ps[len(field):] in flat_p:
                return flat_p[ps[len(field):]]
        m = re.match(r"^\d+/(m|v)/(.*)$", ps)
        if m and m.group(2) in flat_p:
            return flat_p[m.group(2)]
        return replicated(mesh)

    return tree_map_with_path(one, opt_shapes)


def batch_shardings(batch_shapes: PyTree, mesh, stacked: bool = False,
                    microbatched: bool = False,
                    shard_seq_when_b1: bool = False) -> PyTree:
    """Batch arrays: the batch dim shards over (pod +) data, pod only when
    not stacked (the baseline's data parallelism spans pods; codist batches
    stack over pod). The microbatch axis is never sharded. With
    ``shard_seq_when_b1`` and an indivisible batch the sequence axis shards
    instead."""
    sizes = mesh.shape
    has_pod = "pod" in sizes

    def one(_path, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        i = 0
        if stacked:
            if has_pod and shape[0] == sizes["pod"]:
                spec[0] = "pod"
            i = 1
        if microbatched:
            i += 1
        if len(shape) > i:
            batch_axes = []
            b = shape[i]
            if not stacked and has_pod \
                    and b % (sizes["pod"] * sizes["data"]) == 0:
                batch_axes = ["pod", "data"]
            elif b % sizes["data"] == 0:
                batch_axes = ["data"]
            if batch_axes:
                spec[i] = (tuple(batch_axes) if len(batch_axes) > 1
                           else batch_axes[0])
            elif shard_seq_when_b1 and len(shape) > i + 1 and \
                    shape[i + 1] % sizes["data"] == 0:
                spec[i + 1] = "data"
        return P(*spec)

    return tree_map_with_path(one, batch_shapes)


def cache_shardings(cache_shapes: PyTree, mesh, batch: int,
                    prefer_time: bool = False) -> PyTree:
    """KV caches and recurrent states, (L, B, T, kv, hd)-style leaves: B
    shards over "data" when divisible; for B == 1, or with ``prefer_time``,
    the time axis shards over "data" (context parallelism) and head-like
    axes take "model" when divisible."""
    sizes = mesh.shape

    def one(_path, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        used = set()
        # axis 0 is the layer axis: never sharded; axis 1 is the batch
        if not prefer_time and len(shape) >= 2 \
                and shape[1] % sizes["data"] == 0 and shape[1] > 1:
            spec[1] = "data"
            used.add("data")
        # remaining axes: time over "data" (if free), heads over "model"
        for dim in range(2, len(shape)):
            if "data" not in used and shape[dim] % sizes["data"] == 0 \
                    and shape[dim] >= sizes["data"] and dim == 2:
                spec[dim] = "data"
                used.add("data")
            elif "model" not in used and shape[dim] % sizes["model"] == 0 \
                    and shape[dim] >= sizes["model"]:
                spec[dim] = "model"
                used.add("model")
        return P(*spec)

    return tree_map_with_path(one, cache_shapes)


def replicated(mesh) -> PartitionSpec:
    return P()


def state_shardings(state_shapes: PyTree, mesh, stacked: bool = False,
                    fsdp_axis: Optional[str] = "data",
                    tp_axis: Optional[str] = "model",
                    moe_expert_axis: Optional[str] = None,
                    two_d_ffn: bool = False) -> PyTree:
    """Specs of a whole train / codist state tree (or a bare parameter
    tree). Optimizer moments and stale replicas mirror the param rules
    because their paths end with the same leaf names; scalars replicate."""
    def one(path, leaf):
        if len(getattr(leaf, "shape", ())) == 0:
            return replicated(mesh)
        ps = path_str(path)
        return param_spec(ps, tuple(leaf.shape), mesh, stacked, _scanned(ps),
                          fsdp_axis, tp_axis, moe_expert_axis, two_d_ffn)

    return tree_map_with_path(one, state_shapes)


# ----------------------------------------------------------------------------
# what a spec leaves on one device
# ----------------------------------------------------------------------------

def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in dim order."""
    return tuple(a for e in spec for a in axes_of(e))


def local_shape(shape: Tuple[int, ...], spec, mesh) -> Tuple[int, ...]:
    """The per-device shard of a ``shape`` placed by ``spec`` (a spec
    shorter than the shape leaves the trailing dims whole)."""
    sizes = mesh.shape
    out = list(shape)
    for dim, entry in enumerate(spec):
        ways = 1
        for a in axes_of(entry):
            ways *= sizes[a]
        if out[dim] % ways:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {entry} ({ways} ways)")
        out[dim] //= ways
    return tuple(out)


# ----------------------------------------------------------------------------
# specs executed: DTensor placements on a DeviceMesh
# ----------------------------------------------------------------------------

def placements(spec, device_mesh) -> tuple:
    """One DTensor placement per dim of ``device_mesh`` for ``spec``:
    ``Shard(d)`` on each mesh dim that entry d names (a tuple entry such as
    ("pod", "data") shards d over each of its dims, in mesh order, as jax
    splits a dim over a tuple of axes, major first), else ``Replicate()``.
    A mesh dim of size 1 splits nothing and is ``Replicate()`` too (the same
    layout; it spares DTensor's planner a trivial shard). A spec that names
    an axis the mesh does not have raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = device_mesh.mesh_dim_names
    named = {a: d for d, e in enumerate(spec) for a in axes_of(e)}
    missing = sorted(set(named) - set(names))
    if missing:
        raise ValueError(f"spec {spec!r} names axes {missing} that the mesh "
                         f"{names} does not have")
    return tuple(Shard(named[a]) if a in named and device_mesh.size(i) > 1
                 else Replicate() for i, a in enumerate(names))


def _stacked_meta(tree: PyTree, n: int) -> PyTree:
    """A tree of ``meta`` stand-ins with a leading axis of n (the
    reference's stacked peer layout); scalars stay scalars."""
    def one(_path, x):
        if not torch.is_tensor(x) or x.dim() == 0:
            return torch.empty((), device="meta")
        return torch.empty((n, *x.shape), dtype=x.dtype, device="meta")
    return tree_map_with_path(one, tree)


def _distribute(x: torch.Tensor, spec, device_mesh) -> torch.Tensor:
    """``x`` (the same full value on every rank of ``device_mesh``) as a
    DTensor placed by ``spec``: each rank keeps its own shard, in storage
    of its own (``x`` is left as it was, and may be freed), and nothing is
    sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    out = distribute_tensor(x.detach(), device_mesh,
                            placements(spec, device_mesh), src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        out = DTensor.from_local(local.clone(), device_mesh, out.placements,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out.requires_grad_(x.requires_grad)


def _state_specs(state, mesh, n: Optional[int],
                 moe_expert_axis: Optional[str] = None):
    """(one peer?, the specs of ``{"params", "opt": {"m", "v"}}``). With n
    None the state is one model's (``AllReduce``), placed by
    ``state_shardings(..., stacked=False)``. Else the specs are those of the
    reference's stacked state of n peers on ``mesh``: ``state.params`` is
    one peer's tree (a pod that holds one peer: the pod axis must have n
    devices, and ``param_spec`` puts the peer axis on it) or the list of n
    peers (one pod: ``param_spec`` leaves the peer axis unplaced)."""
    opt = state.opt
    if n is None:
        tree = {"params": state.params,
                "opt": {f: getattr(opt, f) for f in ("m", "v")}}
        return True, state_shardings(tree, mesh,
                                     moe_expert_axis=moe_expert_axis)
    one_peer = not isinstance(state.params, list)
    on_pods = mesh.shape.get("pod") == n
    if one_peer != on_pods:
        raise ValueError(
            f"{'one peer' if one_peer else 'a list of peers'} on a mesh "
            f"{mesh.shape} for {n} models: one peer a pod needs a pod axis "
            "of n, a peer list a pod axis of another size or none")
    take = (lambda t: t) if one_peer else (lambda t: t[0])
    stacked = {"params": _stacked_meta(take(state.params), n),
               "opt": {f: (_stacked_meta(take(getattr(opt, f)), n)
                           if getattr(opt, f) is not None else None)
                       for f in ("m", "v")}}
    return one_peer, state_shardings(stacked, mesh, stacked=True,
                                     moe_expert_axis=moe_expert_axis)


def distribute_state(state, mesh, device_mesh, n: Optional[int] = None,
                     moe_expert_axis: Optional[str] = None):
    """A state's parameter and optimizer leaves as DTensors on
    ``device_mesh``.

    With n None the state is one model's (``AllReduce``'s ``TrainState``)
    on the whole (pod, data, model) mesh, placed by ``state_shardings(...,
    stacked=False)``: FSDP over "data", TP over "model", replicated over
    "pod". With n it is a codist state on a pod's ("data", "model")
    sub-mesh, placed by ``state_shardings`` of the reference's stacked
    state of n peers on ``mesh``: one peer's tree (a ``TrainState`` of a
    pod that holds one peer) or the list of the n peers (a ``CodistState``
    on one pod); the peer axis's entry only says where the peer lives and
    is dropped. ``moe_expert_axis`` places the expert stacks' E dim over
    that axis (``param_spec``: expert parallelism), as the reference's dry
    run passes it to ``state_shardings``. The step and any other field
    pass through; ``requires_grad`` is kept."""
    one_peer, specs = _state_specs(state, mesh, n, moe_expert_axis)
    lead = 0 if n is None else 1

    def place(tree, spec_tree):
        flat = dict(tree_flatten_with_path(spec_tree))

        def one(path, x):
            return _distribute(x, P(*flat[path_str(path)][lead:]),
                               device_mesh)
        if one_peer:
            return tree_map_with_path(one, tree)
        return [tree_map_with_path(one, t) for t in tree]

    opt = state.opt._replace(**{
        f: place(getattr(state.opt, f), specs["opt"][f])
        for f in ("m", "v") if getattr(state.opt, f) is not None})
    return state._replace(params=place(state.params, specs["params"]),
                          opt=opt)


def distribute_batch(batch: Dict[str, torch.Tensor], mesh, device_mesh,
                     peer: Optional[int] = None, stacked: bool = True,
                     microbatched: bool = False) -> Dict[str, torch.Tensor]:
    """A batch as DTensors on ``device_mesh``, placed by ``batch_shardings``
    on ``mesh`` (every leaf: tokens, labels, mask, a VLM's patches, an
    enc-dec LM's frames or source tokens, a classifier's images or
    features and its one label a row).

    ``stacked`` (codist): every leaf is ``(n, [k,] B, ...)`` and its batch
    dim goes over "data" where it divides. With ``peer`` (a pod that holds
    one peer) the leaves are that peer's rows ``([k,] B, ...)``; without,
    the stacked leaves stay whole on the one pod (the peer axis
    replicated). Not ``stacked`` (one model, ``AllReduce``): every leaf is
    ``([k,] B, ...)`` and its batch dim goes over ("pod", "data"), pod
    outer, where it divides. ``microbatched``: the leaves carry the
    microbatch axis k in front of the batch dim (never placed), so that
    each microbatch's rows are split as a whole batch's are."""
    if not stacked:
        specs = batch_shardings({k: v.to("meta") for k, v in batch.items()},
                                mesh, microbatched=microbatched)
        return {k: _distribute(v, specs[k], device_mesh)
                for k, v in batch.items()}
    specs = batch_shardings({k: _stacked_meta(v[0], v.shape[0])
                             for k, v in batch.items()}, mesh,
                            stacked=True, microbatched=microbatched)
    if peer is None:
        return {k: _distribute(v, P(None, *specs[k][1:]), device_mesh)
                for k, v in batch.items()}
    return {k: _distribute(v[peer], P(*specs[k][1:]), device_mesh)
            for k, v in batch.items()}
