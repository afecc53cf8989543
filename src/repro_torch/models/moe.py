"""Top-k Mixture-of-Experts with GShard/Switch-style capacity per group.

The reference turns routing into dense one-hot dispatch and combine
tensors of shape (G, s, E, C) and runs every expert on its C capacity rows
(``models/moe.py:110-128``), zeros included. The port computes the same
function with index dispatch: for each expert that received a kept
(token, choice) pair, gather those token rows, run the expert with
``torch.matmul`` and scatter-add its outputs times their combine weights.
No product of a zero row is formed, so a decode step (cf = 0: C = s = 1 per
slot) runs only the experts its tokens chose, not all E of them.

What the dense form fixes and the port keeps:
* one routing group per batch row, capacity ``_capacity`` per expert and
  group; ``capacity_factor <= 0`` means no drops (serving), training uses
  the GShard 1.25;
* router logits in fp32; top-k over the softmax with ties to the lowest
  expert index (a stable sort, as ``jax.lax.top_k``); top-2 gates
  renormalized by ``max(sum, 1e-9)``;
* GShard priority: a pair's position in its expert is the exclusive cumsum
  over the choice-major flattening (every token's first choice in token
  order, then every second choice); pairs at or past the capacity drop;
* the combine weights are cast to the activation dtype before the product
  (bf16 rounds the gates first); the products of a token sum in fp32 and
  round once, as the einsum over (E, C) does;
* the Switch load-balance loss per group, averaged over groups and scaled
  by ``load_balance_weight``; ``frac_routed`` counts every top-k choice,
  dropped ones included.

Arctic's dense residual FFN is added after the combine.

On a mesh (a DTensor x) each rank routes its own batch rows through
``local_map`` (``_moe_placed``), which is exact since a routing group is a
row. With the expert stacks' E dim split over a mesh axis
(``moe_expert_axis``: expert parallelism) the rows reach their experts as
the reference's partitioner sends them: the (E, G, C, d) capacity buffers
through an all-to-all over that axis and back (``_moe_experts``, metered by
``launch/mesh.py``'s ``expert_exchange``), sizes fixed by the shapes, no
host sync.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import activation, stacked_dense
from repro_torch.models.ffn import ffn_forward, init_stacked_ffn


def init_stacked_moe(cfg: ModelConfig, n: int, generator: torch.Generator,
                     dtype: torch.dtype, device,
                     router_dtype: torch.dtype) -> Dict:
    """The MoE FFN of n layers, the reference's ``init_moe`` tree stacked:
    ``router`` (n, d, E), expert stacks ``w_gate`` / ``w_up`` (n, E, d, f)
    (``w_gate`` only for gated acts) and ``w_down`` (n, E, f, d) scaled by
    1 / sqrt(num_layers), and arctic's ``residual`` FFN. The router, which
    the forward reads in fp32, is stored in ``router_dtype``."""
    m = cfg.moe
    d, dff, e = cfg.d_model, cfg.d_ff, m.num_experts
    down = 1.0 / max(1, cfg.num_layers) ** 0.5

    def experts(in_dim, out_dim, scale=1.0):
        return stacked_dense(n, (e, in_dim, out_dim), in_dim, generator,
                             dtype, device, scale, batch_dims=1)

    p: Dict = {"router": stacked_dense(n, (d, e), d, generator, router_dtype,
                                       device)}
    if cfg.act in ("silu", "geglu"):
        p["w_gate"] = experts(d, dff)
    p["w_up"] = experts(d, dff)
    p["w_down"] = experts(dff, d, down)
    if m.dense_residual:
        p["residual"] = init_stacked_ffn(cfg, n, generator, dtype, device)
    return p


def _capacity(m: MoEConfig, tokens: int, capacity_factor: float = 1.25) -> int:
    """Capacity per expert per group; ``capacity_factor <= 0`` => no drops
    (the group size), which serving uses so that incremental decode equals
    prefill."""
    if capacity_factor <= 0:
        return tokens
    c = math.ceil(m.top_k * tokens / m.num_experts * capacity_factor)
    return max(min(4, tokens), min(tokens, c))


def _route(m: MoEConfig, logits: torch.Tensor, capacity: int):
    """logits (G, T, E) fp32 -> (gate_idx (G,T,k), gate_vals (G,T,k) fp32,
    pos (G,T,k) each pair's position in its expert, keep (G,T,k) bool, aux
    (G,) the load-balance loss of each group)."""
    g, t, e = logits.shape
    k = m.top_k
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    if k > 1:   # Mixtral-style renormalization over the chosen experts
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(gate_idx, e)          # (G,T,k,E)
    # GShard priority: all tokens' first choices, then the second choices
    flat = onehot.transpose(1, 2).reshape(g, k * t, e)
    pos_flat = torch.cumsum(flat, dim=1) - flat                 # exclusive
    pos = (pos_flat * flat).sum(-1).reshape(g, k, t).transpose(1, 2)
    keep = pos < capacity
    frac_routed = onehot.float().mean(dim=(1, 2)) * k           # (G, E)
    mean_prob = probs.mean(dim=1)                               # (G, E)
    aux = e * (frac_routed * mean_prob).sum(-1)
    return gate_idx, gate_vals, pos, keep, aux


def router_decisions(m: MoEConfig, logits: torch.Tensor, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) fp32 -> (dispatch (T, E, C), combine (T, E, C) fp32,
    aux): the reference's dense decisions, built from the index routing
    that ``moe_forward`` uses."""
    idx, vals, pos, keep, aux = _route(m, logits[None], capacity)
    t, e = logits.shape
    dispatch = torch.zeros((t, m.num_experts, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    tok = torch.arange(t, device=logits.device)[:, None].expand(t, m.top_k)
    kp = keep[0]
    dispatch[tok[kp], idx[0][kp], pos[0][kp]] = 1.0
    combine[tok[kp], idx[0][kp], pos[0][kp]] = vals[0][kp]
    return dispatch, combine, aux[0]


def _expert(w: Dict, e: int, x: torch.Tensor, act) -> torch.Tensor:
    """Expert ``e`` on its rows ``x``; ``w`` maps each matrix name to the
    list of the experts' matrices."""
    if "w_gate" in w:
        h = act(x @ w["w_gate"][e].to(x.dtype))
        h = h * (x @ w["w_up"][e].to(x.dtype))
    else:
        h = act(x @ w["w_up"][e].to(x.dtype))
    return h @ w["w_down"][e].to(x.dtype)


def _dispatch(w: Dict, x: torch.Tensor, cfg: ModelConfig, idx, vals, keep
              ) -> torch.Tensor:
    """The kept (token, choice) pairs of x (G, s, d) through their experts
    by index (``w``: the router and the expert stacks) -> y (G, s, d) in
    x's dtype."""
    m = cfg.moe
    b, s, d = x.shape
    # the kept pairs, grouped by expert (stable: token-major within one)
    tok = torch.arange(b * s, device=x.device)[:, None].expand(b * s, m.top_k)
    kp = keep.reshape(-1, m.top_k)
    rows = tok[kp]
    experts = idx.reshape(-1, m.top_k)[kp]
    weights = vals.reshape(-1, m.top_k)[kp].to(x.dtype)
    order = torch.argsort(experts, stable=True)
    rows, experts, weights = rows[order], experts[order], weights[order]
    counts = torch.bincount(experts, minlength=m.num_experts).tolist()
    act = activation(cfg.act if cfg.act != "relu" else "gelu")
    # one unbind per expert stack: its backward stacks the experts'
    # gradients once, where indexing each expert would write a zero
    # gradient of the whole stack per expert
    w = {k: w[k].unbind(0) for k in ("w_gate", "w_up", "w_down") if k in w}
    xf = x.reshape(b * s, d)
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        r = rows[start:start + n]
        ye = _expert(w, e, xf[r], act)
        y = y.index_add(0, r, ye.float() * weights[start:start + n, None].float())
        start += n
    return y.to(x.dtype).reshape(b, s, d)


def _moe_rows(w: Dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float, group=None):
    """The routed experts on the rows x (G, s, d), a routing group a row
    -> (y (G, s, d) in x's dtype, aux (G,) each group's load-balance
    loss). With ``group`` (the expert axis's process group) ``w`` holds
    this rank's block of the experts and the rows go through
    ``_moe_experts``; else every expert is here and runs on its kept rows
    (``_dispatch``)."""
    m = cfg.moe
    logits = x.float() @ w["router"].float()                     # (G, s, E)
    cap = _capacity(m, x.shape[1], capacity_factor)
    idx, vals, pos, keep, aux = _route(m, logits, cap)
    if group is None:
        return _dispatch(w, x, cfg, idx, vals, keep), aux
    return _moe_experts(w, x, cfg, idx, vals, pos, keep, cap, group), aux


def _moe_experts(w: Dict, x: torch.Tensor, cfg: ModelConfig, idx, vals,
                 pos, keep, cap: int, group) -> torch.Tensor:
    """Expert parallelism over ``group`` (``ways`` ranks, each holding a
    contiguous block of E / ways experts, as ``Shard`` places the E dim):
    the kept pairs of x (G, s, d) written by index into capacity buffers
    (E, G, C, d), zeros elsewhere (the reference's layout, no one-hot
    product and no host sync), one all-to-all sending each block of E /
    ways experts to its rank, every local expert on its ways x G x C rows
    (one batched product over the local experts), the reverse
    all-to-all, then y[g, t] = sum_k w_k * out[e_k, g, pos_k] in fp32,
    rounded once, as ``_dispatch`` combines. The buffers' sizes come from
    the shapes alone, so the exchange's bytes do not depend on the
    routing."""
    from repro_torch.launch.mesh import all_to_all
    m = cfg.moe
    g, s, d = x.shape
    e, k = m.num_experts, m.top_k
    ways = group.size()
    n_slot = e * g * cap
    grp = torch.arange(g, device=x.device)[:, None, None]
    # each pair's slot in the (E, G, C) buffer; a dropped one the zero row
    slot = torch.where(keep, (idx * g + grp) * cap + pos, n_slot)
    tok = (grp * s + torch.arange(s, device=x.device)[None, :, None]
           ).expand(g, s, k)
    src = torch.full((n_slot + 1,), g * s, dtype=torch.long, device=x.device)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    xz = torch.cat([x.reshape(g * s, d), x.new_zeros((1, d))])
    buf = xz[src[:n_slot]].view(ways, e // ways, g * cap, d)
    # (ways sources, E / ways, G C, d) -> each local expert's rows from
    # every source, (E / ways, ways G C, d): a batched product whose weight
    # is not broadcast (a broadcast weight would be copied per source)
    xin = all_to_all(buf, group).transpose(0, 1).reshape(
        e // ways, ways * g * cap, d)
    act = activation(cfg.act if cfg.act != "relu" else "gelu")
    if "w_gate" in w:
        h = act(xin @ w["w_gate"].to(x.dtype))
        h = h * (xin @ w["w_up"].to(x.dtype))
    else:
        h = act(xin @ w["w_up"].to(x.dtype))
    ye = (h @ w["w_down"].to(x.dtype)).view(e // ways, ways, g * cap, d)
    out = all_to_all(ye.transpose(0, 1), group)            # (E, G C, d)
    oz = torch.cat([out.reshape(n_slot, d), out.new_zeros((1, d))])
    y = (oz[slot].float() * vals.to(x.dtype)[..., None].float()).sum(2)
    return y.to(x.dtype)


def moe_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, the scaled aux loss). Each
    batch row is a routing group with its own capacity. A DTensor x (a
    model on its mesh) routes each rank's own rows (``_moe_placed``)."""
    m = cfg.moe
    if type(x) is not torch.Tensor and hasattr(x, "device_mesh"):
        from torch.distributed.tensor import Replicate
        y, aux = _moe_placed({k: v for k, v in p.items() if k != "residual"},
                             x, cfg, capacity_factor)
        # every group's loss on every rank, then their mean there (a mean
        # over the split rows would be a Partial(avg), which torch 2.11
        # does not add to the Partial(sum) losses)
        aux = aux.redistribute(aux.device_mesh,
                               (Replicate(),) * aux.device_mesh.ndim)
    else:
        y, aux = _moe_rows(p, x, cfg, capacity_factor)
    if "residual" in p:  # Arctic dense-MoE hybrid
        y = y + ffn_forward(p["residual"], x, cfg)
    return y, aux.mean() * m.load_balance_weight


def _expert_axis(w) -> "int | None":
    """The mesh dim that splits the E dim (dim 0) of the expert stack
    ``w`` over more than one device (expert parallelism), or None."""
    from torch.distributed.tensor import Shard
    mesh = w.device_mesh
    return next((i for i, pl in enumerate(w.placements)
                 if pl == Shard(0) and mesh.size(i) > 1), None)


def _moe_placed(p: Dict, x, cfg: ModelConfig, capacity_factor: float):
    """``_moe_rows`` on each rank's own rows of the DTensor x through
    ``local_map`` -> (y, aux (B,) placed as x's rows). A routing group is
    a batch row, so local rows route exactly as the whole batch does. The
    router is whole; each expert matrix keeps the hidden dim f over
    "model" where every one of them splits it there (the output then a
    ``Partial`` sum over "model", as ``ffn._ffn_placed``'s), and is
    gathered over its other dims but the expert axis (``_expert_axis``),
    which stays split: the rows then reach their experts through
    ``_moe_experts``'s all-to-all over that axis, whose ranks must split
    the rows. An expert's gradient is whole on the rank that holds it (a
    sum only over the other dims that split the rows: "pod" for the
    all-reduce baseline). With f split, the combine weights' gradient is
    a partial sum over "model" too, and the router's and the rows' with
    it: the aux loss feeds its gradient back on "model" coordinate 0
    only, so that the sum over "model" counts it once."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models.common import whole_weight
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate()
                 for pl in x.placements)
    if tuple(x.placements) != rows:
        x = x.redistribute(mesh, rows)
    experts = [n for n in ("w_gate", "w_up", "w_down") if n in p]
    f_dim = {n: 1 if n == "w_down" else 2 for n in experts}
    ep = _expert_axis(p[experts[0]])
    if ep is not None and rows[ep] != Shard(0):
        raise ValueError(f"experts over mesh dim {names[ep]!r}, which does "
                         f"not split the rows {rows}")
    tp = names.index("model") if "model" in names else None
    split = tp is not None and mesh.size(tp) > 1 and all(
        p[n].placements[tp] == Shard(f_dim[n]) for n in experts)
    w_in = [tuple(Shard(0) if i == ep else Shard(f_dim[n])
                  if split and i == tp else Replicate()
                  for i in range(mesh.ndim)) for n in experts]
    w_grad = [tuple(Partial() if r == Shard(0) and i != ep else w
                    for i, (r, w) in enumerate(zip(rows, pl)))
              for pl in w_in]
    part = tuple(Partial() if split and i == tp else r
                 for i, r in enumerate(rows))
    r_grad = tuple(Partial() if r == Shard(0) or (split and i == tp)
                   else Replicate() for i, r in enumerate(rows))
    first = not split or mesh.get_local_rank(tp) == 0
    group = None if ep is None else mesh.get_group(ep)

    def fn(xl, router, *ws):
        w = dict(zip(experts, ws), router=router)
        y, aux = _moe_rows(w, xl, cfg, capacity_factor, group)
        return y, (aux if first else aux.detach())
    return local_map(fn, out_placements=(part, rows),
                     in_placements=(rows, (Replicate(),) * mesh.ndim, *w_in),
                     in_grad_placements=(part, r_grad, *w_grad),
                     device_mesh=mesh)(
        x, whole_weight(p["router"]),
        *(whole_weight(p[n], pl) for n, pl in zip(experts, w_in)))
