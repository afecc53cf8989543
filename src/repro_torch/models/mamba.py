"""Mamba (selective SSM) block, used by the Jamba hybrid architecture.

Training and prefill scan over time chunk by chunk (128 steps, the
reference's chunk): within a chunk an associative scan in log2(chunk)
doubling steps (``_scan_chunk``), across chunks the last state carried
into the next. ``y`` is formed per chunk from that chunk's states, so the
(B, L, d_inner, d_state) fp32 tensor of all states the reference
materializes (512 KiB a token and a sub-layer at jamba's full width) never
exists; the function is the same. As the reference's ``mamba_scan``
asserts, a sequence longer than one chunk must be a multiple of it.

Decode carries an explicit ``{"h", "conv"}`` state: ``h`` (B, d_inner,
d_state) fp32, ``conv`` the last ``d_conv - 1`` pre-activation inputs
(B, d_conv - 1, d_inner), left-padded with zeros (a prefill emits them in
the activation dtype, ``init_mamba_state`` in the cache dtype).

Precision is the reference's: ``a_bar``, ``bx``, ``h`` and ``y`` in fp32,
``y`` cast to the activation dtype before the ``silu(z)`` gate; ``dt_bias``,
``A_log`` and ``D`` read in fp32, every other weight cast to the
activation dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models.common import stacked_const, stacked_dense

CHUNK = 128


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm or SSMConfig()
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, s.d_state, s.d_conv


def init_stacked_mamba(cfg: ModelConfig, n: int, generator: torch.Generator,
                       dtype: torch.dtype, device,
                       state_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's ``init_mamba`` tree of n layers, stacked: fan-in
    ``in_proj``, ``x_proj``, ``dt_proj`` and ``out_proj`` (scaled by
    1 / sqrt(num_layers)), ``conv_w`` N(0, 0.1), zero ``conv_b`` and
    ``dt_bias``, ``A_log = log(1..d_state)`` and ``D = 1``. The leaves the
    forward reads in fp32 (``dt_bias``, ``A_log``, ``D``) are stored in
    ``state_dtype``, the others in ``dtype``."""
    d = cfg.d_model
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    conv_w = torch.empty((n, d_conv, d_inner), dtype=dtype, device=device)
    for sl in ([] if conv_w.is_meta else conv_w):
        tmp = torch.empty(sl.shape, dtype=torch.float32, device=device)
        sl.copy_(tmp.normal_(0.0, 1.0, generator=generator).mul_(0.1))
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device)).expand(d_inner, d_state)
    return {
        "in_proj": stacked_dense(n, (d, 2 * d_inner), d, generator, dtype,
                                 device),
        "conv_w": conv_w,
        "conv_b": stacked_const(n, (d_inner,), 0.0, dtype, device),
        "x_proj": stacked_dense(n, (d_inner, dt_rank + 2 * d_state), d_inner,
                                generator, dtype, device),
        "dt_proj": stacked_dense(n, (dt_rank, d_inner), dt_rank, generator,
                                 dtype, device),
        "dt_bias": stacked_const(n, (d_inner,), 0.0, state_dtype, device),
        "A_log": a_log.to(state_dtype).expand(n, d_inner, d_state).clone(),
        "D": stacked_const(n, (d_inner,), 1.0, state_dtype, device),
        "out_proj": stacked_dense(n, (d_inner, d), d_inner, generator, dtype,
                                  device, 1.0 / max(1, cfg.num_layers) ** 0.5),
    }


def _ssm_inputs(p: Dict, xc: torch.Tensor, cfg: ModelConfig):
    """xc (..., d_inner) post-conv activations -> (dt, B, C) in fp32."""
    _, dt_rank, d_state, _ = _dims(cfg)
    proj = xc @ p["x_proj"].to(xc.dtype)
    dt_in, b, c = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = dt_in @ p["dt_proj"].to(xc.dtype)
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt.float() + p["dt_bias"].float(),
                         torch.zeros((), device=xc.device))
    return dt, b.float(), c.float()


def _discretize(p: Dict, dt: torch.Tensor, b: torch.Tensor,
                xc: torch.Tensor):
    """(a_bar, bx) of ``h_t = a_bar_t * h_{t-1} + bx_t``, shapes
    (..., d_inner, N) in fp32."""
    a = -torch.exp(p["A_log"].float())                        # (d_in, N)
    a_bar = torch.exp(dt[..., None] * a)
    bx = dt[..., None] * b[..., None, :] * xc.float()[..., None]
    return a_bar, bx


def _causal_conv(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv over (B, L, d_inner)."""
    d_conv = _dims(cfg)[3]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    w = p["conv_w"].to(x.dtype)                               # (d_conv, d_in)
    y = sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(d_conv))
    return y + p["conv_b"].to(x.dtype)


def _scan_chunk(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + bx_t`` over axis 1 from
    h = 0, in ceil(log2(L)) doubling steps (Hillis-Steele): after the step
    of offset o every position holds the composition of its last 2o
    steps."""
    n = a.shape[1]
    off = 1
    while off < n:
        bx = torch.cat([bx[:, :off], a[:, off:] * bx[:, :-off] + bx[:, off:]],
                       dim=1)
        if 2 * off < n:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return bx


def _scan_y(p: Dict, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            xc: torch.Tensor, chunk: int):
    """The chunked scan, forming ``y = <h_t, C_t>`` (B, L, d_inner) fp32 a
    chunk at a time; returns (y, the last state (B, d_inner, N))."""
    bsz, length, d_in = xc.shape
    if length > chunk and length % chunk:
        raise ValueError(f"mamba scan: sequence length {length} is not a "
                         f"multiple of the chunk {chunk} (the reference "
                         "asserts the same)")
    step = length if length <= chunk else chunk
    h = torch.zeros((bsz, d_in, b.shape[-1]), dtype=torch.float32,
                    device=xc.device)
    ys = []
    for t0 in range(0, length, step):
        sl = slice(t0, t0 + step)
        a_bar, bx = _discretize(p, dt[:, sl], b[:, sl], xc[:, sl])
        # fold the carried state into the chunk's first step
        bx = torch.cat([(bx[:, 0] + a_bar[:, 0] * h)[:, None], bx[:, 1:]],
                       dim=1)
        hs = _scan_chunk(a_bar, bx)                       # (B, l, d_in, N)
        ys.append(torch.einsum("blin,bln->bli", hs, c[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def _forward(p: Dict, x: torch.Tensor, cfg: ModelConfig, chunk: int):
    xz = x @ p["in_proj"].to(x.dtype)
    xr, z = xz.chunk(2, dim=-1)
    xc = F.silu(_causal_conv(p, xr, cfg))
    dt, b, c = _ssm_inputs(p, xc, cfg)
    y, h = _scan_y(p, dt, b, c, xc, chunk)
    y = y + xc.float() * p["D"].float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"].to(x.dtype), xr, h


def mamba_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = CHUNK) -> torch.Tensor:
    """x (B, L, d) -> (B, L, d). A DTensor x (a model on its mesh) runs on
    each rank's own rows with every weight whole
    (``common.on_local_rows``): the scan mixes nothing across rows, so
    this is exact, and no pad, concatenation or scan einsum runs on a
    DTensor. d_inner is not split over "model" (``xz.chunk`` of a split
    in_proj output would hand one rank x and the other z, and x_proj
    contracts over d_inner mid-mixer), so each "model" rank computes the
    whole mixer."""
    if type(x) is not torch.Tensor and hasattr(x, "device_mesh"):
        from repro_torch.models.common import on_local_rows
        names = list(p)

        def fn(xl, *ws):
            return _forward(dict(zip(names, ws)), xl, cfg, chunk)[0]
        return on_local_rows(fn, x, *(p[n] for n in names))
    return _forward(p, x, cfg, chunk)[0]


def mamba_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = CHUNK
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The forward and the decode state it leaves: ``h`` the last scan
    state (fp32), ``conv`` the last ``d_conv - 1`` pre-activation inputs in
    x's dtype, left-padded with zeros when the sequence is shorter."""
    d_conv = _dims(cfg)[3]
    out, xr, h = _forward(p, x, cfg, chunk)
    tail = xr[:, -(d_conv - 1):]
    pad = d_conv - 1 - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    return out, {"h": h, "conv": tail}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> Dict[str, torch.Tensor]:
    d_inner, _, d_state, d_conv = _dims(cfg)
    return {"h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                                device=device)}


def mamba_decode(p: Dict, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, d), one token -> (y (B, 1, d), the new state). The conv
    window takes the promoted dtype of the state's and x's, as the
    reference's ``concatenate`` does (an fp32 state beside bf16
    activations runs the mixer's input side in fp32), and the new ``conv``
    keeps it."""
    xz = x @ p["in_proj"].to(x.dtype)
    xr, z = xz.chunk(2, dim=-1)                                # (B, 1, d_in)
    cdt = torch.promote_types(state["conv"].dtype, x.dtype)
    window = torch.cat([state["conv"].to(cdt), xr[:, 0:1].to(cdt)], dim=1)
    w = p["conv_w"].to(x.dtype).to(cdt)
    xc = torch.einsum("bki,ki->bi", window, w) + p["conv_b"].to(x.dtype)
    xc = F.silu(xc)[:, None]                                   # (B, 1, d_in)
    dt, b, c = _ssm_inputs(p, xc, cfg)
    a_bar, bx = _discretize(p, dt, b, xc)                      # (B,1,d_in,N)
    h = a_bar[:, 0] * state["h"] + bx[:, 0]
    y = torch.einsum("bin,bn->bi", h, c[:, 0])
    y = y + xc[:, 0].float() * p["D"].float()
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"h": h, "conv": window[:, 1:]}
