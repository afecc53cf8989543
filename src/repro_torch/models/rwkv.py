"""RWKV6 "Finch" block: data-dependent decay linear attention (attention-free).

Time-mix runs the RWKV6 recurrence per head (hd = rwkv.head_dim):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with the data-dependent per-channel decay w_t = exp(-exp(w0 + lora_w(x)))
and a learned bonus u. Training and prefill take the chunked form
(``rwkv_wkv_chunked``, chunks of 64): within a chunk the pairwise decay
factors exp(L_{t-1} - L_j) <= 1 come from cumulative log-decays (they never
overflow), and the state S is carried from chunk to chunk. A length that is
not a multiple of the chunk (a decode step, most fleet prefills) takes the
sequential scan, ``rwkv_wkv_sequential``, as the reference's does: the two
forms agree only to fp32 rounding, so the port takes the reference's branch
at every length.

Precision is the reference's: the decay sums in fp32, r, k, v, the bonus,
the WKV state and the per-head group norm run in fp32 and the output is cast
back to the activation dtype; log-decays are floored at 1e-38 and the
pairwise log-decays clipped to [-60, 0]. Every other weight is cast to the
activation dtype inside its op.

Channel-mix is the RWKV squared-relu FFN with token shift. Parameters are
stacked on a leading layer axis, the reference's scanned tree leaf for leaf.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RWKVConfig
from repro_torch.models.common import (stacked_const, stacked_dense,
                                       stacked_draw)

CHUNK = 64


def _dims(cfg: ModelConfig) -> Tuple[int, int, RWKVConfig]:
    r = cfg.rwkv or RWKVConfig()
    return cfg.d_model // r.head_dim, r.head_dim, r


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------

def _normal(scale: float):
    return lambda t, g: t.normal_(0.0, 1.0, generator=g).mul_(scale)


def _uniform(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    return t.uniform_(0.0, 1.0, generator=g)


def init_time_mix(cfg: ModelConfig, n: int, generator: torch.Generator,
                  dtype: torch.dtype, device,
                  fp32_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's ``init_time_mix`` tree of n layers, stacked: fan-in
    ``w_r``, ``w_k``, ``w_v``, ``w_g`` and ``w_o`` (scaled by
    1 / sqrt(num_layers)), ``decay_base`` linspace(-6, -0.5), the decay
    and token-shift loras, ``bonus`` N(0, 0.1), ``mix_base`` U(0, 1) and the
    group norm's scale 1 and bias 0. The leaves the forward reads in fp32
    (``decay_base``, ``bonus``, ``ln_x_scale``, ``ln_x_bias``) are stored in
    ``fp32_dtype``, the others in ``dtype``."""
    d = cfg.d_model
    h, hd, r = _dims(cfg)

    def dense(shape, in_dim, scale=1.0):
        return stacked_dense(n, shape, in_dim, generator, dtype, device, scale)

    return {
        "w_r": dense((d, d), d),
        "w_k": dense((d, d), d),
        "w_v": dense((d, d), d),
        "w_g": dense((d, d), d),
        "w_o": dense((d, d), d, 1.0 / max(1, cfg.num_layers) ** 0.5),
        "decay_base": torch.linspace(-6.0, -0.5, d, dtype=torch.float32,
                                     device=device).to(fp32_dtype)
                      .expand(n, d).clone(),
        "decay_lora_a": dense((d, r.decay_lora), d),
        "decay_lora_b": dense((r.decay_lora, d), r.decay_lora, 0.1),
        "bonus": stacked_draw(n, (h, hd), _normal(0.1), generator,
                              fp32_dtype, device),
        "mix_base": stacked_draw(n, (5, d), _uniform, generator, dtype,
                                 device),
        "mix_lora_a": dense((d, 5, r.mix_lora), d),
        "mix_lora_b": stacked_draw(n, (5, r.mix_lora, d), _normal(0.01),
                                   generator, dtype, device),
        "ln_x_scale": stacked_const(n, (d,), 1.0, fp32_dtype, device),
        "ln_x_bias": stacked_const(n, (d,), 0.0, fp32_dtype, device),
    }


def init_channel_mix(cfg: ModelConfig, n: int, generator: torch.Generator,
                     dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The reference's ``init_channel_mix`` tree of n layers, stacked:
    fan-in ``w_k``, ``w_v`` (scaled by 1 / sqrt(num_layers)) and ``w_r``,
    and the token-shift mixes ``mix_k``, ``mix_r`` U(0, 1)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_k": stacked_dense(n, (d, f), d, generator, dtype, device),
        "w_v": stacked_dense(n, (f, d), f, generator, dtype, device,
                             1.0 / max(1, cfg.num_layers) ** 0.5),
        "w_r": stacked_dense(n, (d, d), d, generator, dtype, device),
        "mix_k": stacked_draw(n, (d,), _uniform, generator, dtype, device),
        "mix_r": stacked_draw(n, (d,), _uniform, generator, dtype, device),
    }


# ----------------------------------------------------------------------------
# token shift
# ----------------------------------------------------------------------------

def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """x_{t-1}; the first position takes ``prev`` (the decode carry) or 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _tm_streams(p: Dict, x: torch.Tensor, x_prev: torch.Tensor):
    """The RWKV6 data-dependent token shift -> the 5 mixed streams (r, k, v,
    w, g). ``mu_x`` is the mean of the 5 bases in the activation dtype,
    summed in fp32 as ``jnp.mean`` does."""
    xx = x_prev - x
    base = p["mix_base"].to(x.dtype)                           # (5, d)
    mu_x = (base.float().sum(0) / base.shape[0]).to(x.dtype)
    xxx = x + xx * mu_x
    lora_in = torch.tanh(torch.einsum("bld,dsr->blsr", xxx,
                                      p["mix_lora_a"].to(x.dtype)))
    deltas = torch.einsum("blsr,srd->blsd", lora_in,
                          p["mix_lora_b"].to(x.dtype))          # (B,L,5,d)
    streams = x[:, :, None] + xx[:, :, None] * (base[None, None] + deltas)
    return streams.unbind(2)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head layer norm on (B, L, H, hd) (biased variance), flattened
    back to (B, L, d)."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, unbiased=False, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + eps)
    return yn.flatten(2) * scale + bias


# ----------------------------------------------------------------------------
# the wkv recurrence: the sequential scan and the chunked form
# ----------------------------------------------------------------------------

def rwkv_wkv_sequential(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        s0: Optional[torch.Tensor] = None):
    """The exact recurrence, one step a position. r/k/v/w: (B, L, H, hd)
    fp32; u: (H, hd). Returns (y (B, L, H, hd), s_final (B, H, hd, hd))."""
    b, length, h, hd = r.shape
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0)
    uu = u[None, :, :, None]
    ys = []
    for t in range(length):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]         # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv_wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, chunk: int = CHUNK,
                     s0: Optional[torch.Tensor] = None):
    """The chunked parallel form; equals the sequential scan to fp32
    rounding, and IS the sequential scan when L is not a multiple of
    ``chunk`` (the reference's branch)."""
    b, length, h, hd = r.shape
    if length % chunk != 0:
        return rwkv_wkv_sequential(r, k, v, w, u, s0)
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    ys = []
    for c0 in range(0, length, chunk):
        rt, kt, vt, wt = (t[:, c0:c0 + chunk] for t in (r, k, v, w))
        logw = torch.log(torch.clamp(wt, min=1e-38))
        li = torch.cumsum(logw, dim=1)            # inclusive L_t
        le = li - logw                            # exclusive L_{t-1}
        # inter-chunk: y_t += (r_t * exp(L_{t-1}))^T S
        y_inter = torch.einsum("bchk,bhkv->bchv", rt * torch.exp(le), s)
        # intra-chunk: pairwise decay exp(L_{t-1} - L_j), j < t (never > 1)
        decay = torch.exp(torch.clamp(le[:, :, None] - li[:, None, :],
                                      -60.0, 0.0))          # (B,t,j,H,hd)
        att = (rt[:, :, None] * kt[:, None] * decay).sum(-1)  # (B,t,j,H)
        att = att * tri[None, :, :, None]
        y_intra = torch.einsum("btjh,bjhv->bthv", att, vt)
        # the diagonal bonus term
        bonus = (rt * u[None, None] * kt).sum(-1)           # (B,C,H)
        ys.append(y_inter + y_intra + bonus[..., None] * vt)
        # S' = diag(exp(L_C)) S + sum_j diag(exp(L_C - L_j)) k_j v_j^T
        lc = li[:, -1:]                                     # (B,1,H,hd)
        s = torch.exp(lc[:, 0])[..., None] * s + torch.einsum(
            "bjhk,bjhv->bhkv",
            kt * torch.exp(torch.clamp(lc - li, -60.0, 0.0)), vt)
    return torch.cat(ys, dim=1), s


def _wkv_placed(r, k, v, w, u, s0=None):
    """``rwkv_wkv_chunked`` on each rank's own batch rows and heads of the
    DTensors r, k, v, w (B, L, H, hd) through ``local_map``: the rows split
    as r's batch dim is, the heads over "model" where they divide over it
    (the bonus u (H, hd) and the state (B, H, hd, hd) split with them),
    every other dim whole. The recurrence mixes nothing across rows or
    heads, so each rank's fp32 scan is the whole one's on its part, and
    no product flattens a split head dim (which the DTensor of some torch
    versions refuses)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models.common import whole_weight
    mesh = r.device_mesh
    names = mesh.mesh_dim_names
    h = r.shape[2]
    rows = [pl == Shard(0) for pl in r.placements]
    heads = [not rows[i] and name == "model" and mesh.size(i) > 1
             and h % mesh.size(i) == 0 for i, name in enumerate(names)]

    def pl(head_dim, row=Shard(0)):
        return tuple(row if rows[i] else Shard(head_dim) if heads[i]
                     else Replicate() for i in range(mesh.ndim))
    x_pl, u_pl, s_pl = pl(2), pl(0, Replicate()), pl(1)
    ins = [x if tuple(x.placements) == x_pl else x.redistribute(mesh, x_pl)
           for x in (r, k, v, w)] + [whole_weight(u, u_pl)]
    in_pl = [x_pl] * 4 + [u_pl]
    grad_pl = [x_pl] * 4 + [pl(0, Partial())]
    if s0 is not None:
        ins.append(s0 if tuple(s0.placements) == s_pl
                   else s0.redistribute(mesh, s_pl))
        in_pl.append(s_pl)
        grad_pl.append(s_pl)
    return local_map(
        lambda *a: rwkv_wkv_chunked(*a[:5], s0=a[5] if len(a) > 5 else None),
        out_placements=(x_pl, s_pl), in_placements=tuple(in_pl),
        in_grad_placements=tuple(grad_pl), device_mesh=mesh)(*ins)


def _decay(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """The data-dependent decay w_t in (0, 1): exp(-exp(base + lora(xw))),
    summed in fp32."""
    lora = torch.tanh(xw @ p["decay_lora_a"].to(xw.dtype))
    lora = lora @ p["decay_lora_b"].to(xw.dtype)
    raw = p["decay_base"].float() + lora.float()
    return torch.exp(-torch.exp(raw))


def time_mix_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                     shift_prev: Optional[torch.Tensor] = None,
                     s0: Optional[torch.Tensor] = None):
    """x (B, L, d) -> (out (B, L, d), (last_x (B, 1, d), s_final (B, H,
    hd, hd) fp32)); the carries let a decode step continue the sequence."""
    h, hd, _ = _dims(cfg)
    x_prev = _shift(x, shift_prev)
    xr, xk, xv, xw, xg = _tm_streams(p, x, x_prev)

    def heads(t):
        return t.unflatten(-1, (h, hd))

    r = heads(xr @ p["w_r"].to(x.dtype))
    k = heads(xk @ p["w_k"].to(x.dtype))
    v = heads(xv @ p["w_v"].to(x.dtype))
    g = F.silu(xg @ p["w_g"].to(x.dtype))
    w = heads(_decay(p, xw))
    u = p["bonus"].float()
    wkv = _wkv_placed if hasattr(r, "device_mesh") else rwkv_wkv_chunked
    y, s_fin = wkv(r.float(), k.float(), v.float(), w, u, s0=s0)
    y = _group_norm(y, p["ln_x_scale"].float(),
                    p["ln_x_bias"].float()).to(x.dtype)
    return (y * g) @ p["w_o"].to(x.dtype), (x[:, -1:], s_fin)


def channel_mix_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                        shift_prev: Optional[torch.Tensor] = None):
    """The squared-relu FFN with token shift -> (out, last_x (B, 1, d))."""
    xx = _shift(x, shift_prev) - x
    xk = x + xx * p["mix_k"].to(x.dtype)
    xr = x + xx * p["mix_r"].to(x.dtype)
    kk = torch.square(torch.relu(xk @ p["w_k"].to(x.dtype)))
    vv = kk @ p["w_v"].to(x.dtype)
    rr = torch.sigmoid(xr @ p["w_r"].to(x.dtype))
    return rr * vv, x[:, -1:]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Zero decode state of one sub-layer: the WKV state ``s`` (B, H, hd,
    hd) in fp32 and the token-shift carries ``shift_tm``, ``shift_cm`` (B,
    1, d) in ``dtype``."""
    h, hd, _ = _dims(cfg)
    d = cfg.d_model
    return {"s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "shift_tm": torch.zeros((batch, 1, d), dtype=dtype, device=device),
            "shift_cm": torch.zeros((batch, 1, d), dtype=dtype, device=device)}
