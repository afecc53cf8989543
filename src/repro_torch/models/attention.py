"""GQA attention: the full-sequence forward (causal, or not for an
encoder; cache emit for prefill), the dense KV cache and the one-token
decode that reads it, and the enc-dec cross attention (forward, decode over
the encoder's K/V cache).

Query head ``h`` reads KV head ``h // G`` with ``G = H // KVh``. Keys are
cached already rotated, so a ring-buffer (sliding-window) cache never needs
absolute positions at read time. Attention is plain ``torch.matmul`` plus
an fp32 softmax, as the reference computes it with einsums (it has no
kernel there). Unlike the reference's pure functions, the cache is updated
in place: ``prefill_into_cache`` and ``attention_decode`` write into the
buffers they are given (a layer's views of the stacked cache) and return
the same dict.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.common import apply_rope, on_local_rows
from repro_torch.models.sharding_hints import current_hint_spec, hint

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
    if _heads_off_tp(x, w.shape[1]):
        return on_local_rows(_proj, x, w)
    d, n, k = w.shape
    return (x @ w.reshape(d, n * k).to(x.dtype)).unflatten(-1, (n, k))


def _heads_off_tp(x, heads: int) -> bool:
    """Whether ``x`` is a DTensor on a mesh whose "model" dim the
    ``heads`` do not divide. DTensor then splits a projection's (B, S,
    heads * hd) output over "model" and cannot unflatten the heads (nor
    flatten them again for the output projection), where the reference's
    rules leave the head dims whole on every device (``param_spec``:
    ``slide=False``)."""
    mesh = getattr(x, "device_mesh", None)
    if mesh is None or type(x) is torch.Tensor:
        return False
    names = mesh.mesh_dim_names
    return "model" in names and heads % mesh.size(names.index("model")) != 0


def _project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _out_proj(p: Dict[str, torch.Tensor], o: torch.Tensor) -> torch.Tensor:
    if _heads_off_tp(o, o.shape[2]):
        return on_local_rows(_out_product, o, p["wo"])
    return _out_product(o, p["wo"])


def _out_product(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd) @ wo.to(o.dtype)


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
                      causal: bool = True, return_cache: bool = False):
    """Full-sequence attention. ``causal`` masks key j from query i unless
    j <= i, windowed when ``cfg.sliding_window`` > 0 (i - window < j <= i);
    the enc-dec encoder passes ``causal=False`` (no mask). x (B,S,d) ->
    (out, cache|None) with cache = {"k": roped keys (B,S,KV,hd), "v":
    values}."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attend = _attend_placed if hasattr(q, "device_mesh") else _attend
    o = attend(q, k, v, causal, cfg.sliding_window, x.dtype)
    return _out_proj(p, o), ({"k": k, "v": v} if return_cache else None)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, dtype) -> torch.Tensor:
    """The attention core over whole sequences: q (B,S,H,hd), k, v
    (B,S,KV,hd) -> (B,S,H,hd); the softmax weights in ``dtype``."""
    s = q.shape[1]
    scores = hint(_gqa_scores(q, k), "scores")                       # b h s s
    if causal:
        i = torch.arange(s, device=q.device)
        mask = i[None, :] <= i[:, None]
        if window > 0:
            mask = mask & (i[:, None] - i[None, :] < window)
        scores = scores.masked_fill(~mask, NEG_INF)
    w = _softmax(scores).to(dtype)
    return _gqa_combine(w, v)


def _attend_placed(q, k, v, causal: bool, window: int, dtype):
    """``_attend`` on each rank's own batch rows and heads of the DTensors
    q, k, v (a peer on its pod's mesh), through ``local_map``, placed as
    the "scores" hint places the scores: the batch over the axes it
    divides over (``sharding_hints.dividing_spec``), the heads over TP
    where the KV heads divide. (The hint's
    fallback, the queries over TP, needs each rank's causal offsets: the
    heads then stay whole on every rank, as they do without a hint.)"""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.sharding import axes_of
    from repro_torch.models.sharding_hints import dividing_spec
    mesh = q.device_mesh
    b, s, h, _ = q.shape
    kvh = k.shape[2]
    shape = (b, h, s, k.shape[1])
    spec = current_hint_spec("scores", shape)
    spec = (None, None) if spec is None else dividing_spec(spec, shape, mesh)
    pl = []
    for i, name in enumerate(mesh.mesh_dim_names):
        ways = mesh.size(i)
        if ways > 1 and name in axes_of(spec[0]):
            pl.append(Shard(0))
        elif ways > 1 and name in axes_of(spec[1]) and kvh % ways == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    pl = tuple(pl)
    q, k, v = (x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
               for x in (q, k, v))
    return local_map(lambda a, b_, c: _attend(a, b_, c, causal, window,
                                              dtype),
                     out_placements=(pl,), in_placements=(pl, pl, pl),
                     device_mesh=mesh)(q, k, v)


def _cross(p: Dict[str, torch.Tensor], x: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """Queries of x against the memory's k, v, every key: ``_attend``
    without a mask, on a mesh on each rank's own rows and heads
    (``_attend_placed``), as self-attention runs."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    attend = _attend_placed if hasattr(q, "device_mesh") else _attend
    o = attend(q, k.to(x.dtype), v.to(x.dtype), False, 0, x.dtype)
    return _out_proj(p, o)


def cross_attention_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                            memory: torch.Tensor, cfg) -> torch.Tensor:
    """Decoder-to-encoder attention: queries from x (B,S,d), keys and
    values from ``memory`` (B,T,d) in x's dtype; no RoPE, no mask."""
    kv = encoder_kv(p, memory.to(x.dtype), cfg)
    return _cross(p, x, kv["k"], kv["v"])


def cross_attention_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                           mem_cache: Dict[str, torch.Tensor],
                           cfg) -> torch.Tensor:
    """Decode-time cross attention of x (B,1,d) over the encoder's K/V
    cache, read in x's dtype, every row (no mask)."""
    return _cross(p, x, mem_cache["k"], mem_cache["v"])


def encoder_kv(p: Dict[str, torch.Tensor], memory: torch.Tensor,
               cfg) -> Dict[str, torch.Tensor]:
    """The cross-attention keys and values of ``memory`` (B,T,d), in its
    dtype, with the optional biases."""
    k, v = _proj(memory, p["wk"]), _proj(memory, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(memory.dtype)
        v = v + p["bv"].to(memory.dtype)
    return {"k": k, "v": v}


def init_kv_cache(cfg, batch: int, max_len: int, dtype,
                  device) -> Dict[str, torch.Tensor]:
    """Zero cache buffers (B, length, KV, hd): a ring buffer of
    ``min(max_len, window)`` slots when ``cfg.sliding_window`` > 0, else
    ``max_len``."""
    length = (min(max_len, cfg.sliding_window) if cfg.sliding_window > 0
              else max_len)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, length, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_into_cache(cache: Dict[str, torch.Tensor],
                       new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy prefill keys/values (B,S,KV,hd) into the cache buffers (in
    place; returns the same dict). When S reaches the capacity (a ring
    buffer shorter than the prompt), keep the trailing window rolled so
    that position p lands in slot p % cap: decode writes at pos % cap and
    must overwrite the oldest slot."""
    s = new["k"].shape[1]
    cap = cache["k"].shape[1]
    for name in ("k", "v"):
        buf = cache[name]
        if s >= cap:
            buf.copy_(torch.roll(new[name][:, s - cap:], s % cap, dims=1))
        else:
            buf[:, :s] = new[name].to(buf.dtype)
    return cache


def attention_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos, cfg):
    """One-token decode. x (B,1,d); ``pos`` the absolute position of the
    token: an int (or 0-d tensor) shared by the rows, or a (B,) int tensor
    of per-row positions (ragged batching; full-length caches only).

    Writes the token's roped K and V into ``cache`` in place — at pos % cap
    in a ring buffer (``cfg.sliding_window`` > 0), else at pos — and
    attends over the valid slots: those at or before ``pos`` in a
    full-length cache; in a ring buffer the slots whose absolute position
    (pos - age, age = (write - slot) % cap) is >= 0 and whose age is below
    min(cap, pos + 1). Returns (out (B,1,d), cache)."""
    b = x.shape[0]
    cap = cache["k"].shape[1]
    dev = x.device
    vector_pos = torch.is_tensor(pos) and pos.dim() == 1
    if vector_pos:
        if cfg.sliding_window > 0:
            raise ValueError("per-row positions require a full-length "
                             "(non-ring) cache")
        positions = pos.to(device=dev, dtype=torch.int32)[:, None]
    else:
        pos = int(pos)
        if cfg.sliding_window <= 0 and not 0 <= pos < cap:
            raise ValueError(f"position {pos} outside a cache of {cap}")
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = _project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)

    slot = torch.arange(cap, device=dev)
    if vector_pos:
        rows = torch.arange(b, device=dev)
        idx = positions[:, 0].long()
        for name, new in (("k", k_new), ("v", v_new)):
            cache[name][rows, idx] = new[:, 0].to(cache[name].dtype)
        valid = (slot[None, :] <= idx[:, None])[:, None, None, :]  # (B,1,1,cap)
    else:
        write_idx = pos % cap if cfg.sliding_window > 0 else pos
        for name, new in (("k", k_new), ("v", v_new)):
            cache[name][:, write_idx] = new[:, 0].to(cache[name].dtype)
        if cfg.sliding_window > 0:
            age = (write_idx - slot) % cap              # 0 == just written
            valid = (pos - age >= 0) & (age < min(cap, pos + 1))
        else:
            valid = slot <= pos
        valid = valid[None, None, None, :]

    scores = _gqa_scores(q, cache["k"])                              # b h 1 cap
    scores = scores.masked_fill(~valid, NEG_INF)
    w = _softmax(scores).to(x.dtype)
    return _out_proj(p, _gqa_combine(w, cache["v"])), cache
