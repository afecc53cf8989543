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


def moe_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, the scaled aux loss). Each
    batch row is a routing group with its own capacity."""
    m = cfg.moe
    b, s, d = x.shape
    logits = x.float() @ p["router"].float()                     # (B, S, E)
    cap = _capacity(m, s, capacity_factor)
    idx, vals, _pos, keep, aux = _route(m, logits, cap)
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
    w = {k: p[k].unbind(0) for k in ("w_gate", "w_up", "w_down") if k in p}
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
    y = y.to(x.dtype).reshape(b, s, d)
    if "residual" in p:  # Arctic dense-MoE hybrid
        y = y + ffn_forward(p["residual"], x, cfg)
    return y, aux.mean() * m.load_balance_weight
