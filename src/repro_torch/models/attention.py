"""GQA attention: prefill forward (cache emit) and the dense KV cache.

Query head ``h`` reads KV head ``h // G`` with ``G = H // KVh``. Keys are
cached already rotated. Prefill attention is plain ``torch.matmul`` plus an
fp32 softmax, as the reference computes it with einsums (it has no kernel
there).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.common import apply_rope

NEG_INF = -1e30


def attention_shapes(cfg) -> Dict[str, tuple]:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h, hd), bk=(kv, hd), bv=(kv, hd))
    return shapes


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk')."""
    d, n, k = w.shape
    return (x @ w.reshape(d, n * k).to(x.dtype)).unflatten(-1, (n, k))


def _project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _out_proj(p: Dict[str, torch.Tensor], o: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd) @ p["wo"].to(o.dtype)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,hd), k (B,T,KV,hd) -> scores (B,H,S,T), scaled by hd^-0.5
    after the product (dtypes promote as the reference's einsum does)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.to(dt).reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)  # b k g s d
    kt = k.to(dt).permute(0, 2, 3, 1)[:, :, None]                    # b k 1 d t
    scores = qg @ kt                                                 # b k g s t
    return scores.reshape(b, kvh * g, s, k.shape[1]) * (hd ** -0.5)


def _gqa_combine(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w (B,H,S,T), v (B,T,KV,hd) -> (B,S,H,hd)."""
    b, h, s, t = w.shape
    kvh = v.shape[2]
    g = h // kvh
    dt = torch.promote_types(w.dtype, v.dtype)
    wg = w.to(dt).reshape(b, kvh, g, s, t)
    vt = v.to(dt).permute(0, 2, 1, 3)[:, :, None]                    # b k 1 t d
    o = wg @ vt                                                      # b k g s d
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, v.shape[-1])


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    return torch.softmax(scores.float(), dim=-1)


def attention_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                      positions: Optional[torch.Tensor] = None,
                      return_cache: bool = False):
    """Causal full-sequence attention. x (B,S,d) -> (out, cache|None) with
    cache = {"k": roped keys (B,S,KV,hd), "v": values}."""
    if cfg.sliding_window > 0:
        raise NotImplementedError("sliding-window attention is not in the "
                                  "serving slice")
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scores = _gqa_scores(q, k)                                       # b h s s
    i = torch.arange(s, device=x.device)
    mask = i[None, :] <= i[:, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    w = _softmax(scores).to(x.dtype)
    out = _out_proj(p, _gqa_combine(w, v))
    return out, ({"k": k, "v": v} if return_cache else None)


def init_kv_cache(cfg, batch: int, max_len: int, dtype,
                  device) -> Dict[str, torch.Tensor]:
    """Full-length dense cache buffer (the ring-buffer variant is not in
    this slice)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_into_cache(cache: Dict[str, torch.Tensor],
                       new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy prefill keys/values into the head of a full-length cache (in
    place; returns the same dict)."""
    s = new["k"].shape[1]
    cap = cache["k"].shape[1]
    if s > cap:
        raise ValueError(f"prefill length {s} exceeds cache capacity {cap}")
    for name in ("k", "v"):
        cache[name][:, :s] = new[name].to(cache[name].dtype)
    return cache
