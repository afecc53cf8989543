"""Batched decode over the paged KV pool: one step for all slots.

Mirrors the reference's layer loop, but attention sub-layers read and write
the shared block pool through the kernels of ``repro_torch.kernels``, and
every slot carries its OWN absolute position (= its current context length)
— the ragged substrate continuous batching needs.

Step order per attention sub-layer: project and rope q/k/v at each slot's
position ``lengths[s]``; ``paged_scatter_kv`` appends the new K and V rows
into the layer's two pools (in place, one launch); then attention reads the
pools, on the same stream, so
the new token's key is visible (valid keys: positions ``<= lengths[s]``).
Inactive slots go through the step too, with length 0 and an all-zero table
row (the null block); they appear in no write-map entry, never touch the
pool, and their attention output is exactly 0.

Two attention paths, pinned against each other:

* ``fused_attention=False`` — the oracle: ``paged_gather`` a dense
  ``(S, MB*BS, KVh, hd)`` context, dense fp32 masked softmax;
* ``fused_attention=True`` (the default) — the ``paged_attention_decode``
  kernel consumes the block table directly; no gathered context exists.

Quantized pools (int8 / fp8, with ``k_scale`` / ``v_scale`` in the layer's
dict) append through ``paged_scatter_quant_kv`` (quantize at scatter) and
dequantize per row inside whichever attention path runs: the decode
kernel in its tile loads, the gather path after gathering the scales too.

``build_verify_step`` is the speculative k-token verify: every slot's k
draft inputs in one forward, appended with one K+V scatter launch per draft
position per layer. Its fused path runs the decode kernel over S*k
pseudo-slots that share their slot's table, with the split plan of the
plain S-slot tick, so pseudo-slot (s, j) sums its softmax as a plain
decode at position ``lengths[s] + j`` does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.paged_attention import paged_attention_decode
from repro_torch.kernels.paged_cache import (paged_gather, paged_scatter_kv,
                                             paged_scatter_quant_kv)
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, apply_rope, embed_tokens,
                                       lm_head)
from repro_torch.models.ffn import ffn_forward
from repro_torch.models.transformer import _n_scan, _sub_kinds, layer_params


def _paged_attention_decode(p: Dict, x: torch.Tensor,
                            kv: Dict[str, torch.Tensor], table: torch.Tensor,
                            lengths: torch.Tensor, write_slot: torch.Tensor,
                            write_off: torch.Tensor, cfg,
                            fused: bool) -> torch.Tensor:
    """One-token decode for every slot against its paged context.

    x (S,1,d); kv {"k","v"[,"k_scale","v_scale"]}: (NB,BS,KVh,hd) pools of
    THIS layer (plus (NB,BS) fp32 row scales when quantized), updated in
    place; table (S,MB) int32; lengths (S,) int32; write_slot / write_off
    (NB,) int32 from ``PagedCachePool.write_maps``.
    """
    quantized = "k_scale" in kv
    bs = kv["k"].shape[1]
    positions = lengths[:, None]                       # (S,1) per-slot pos
    q, k_new, v_new = attn._project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    _scatter_rows(kv, k_new[:, 0], v_new[:, 0], write_slot, write_off)
    k_pool, v_pool = kv["k"], kv["v"]
    k_sc, v_sc = kv.get("k_scale"), kv.get("v_scale")

    if fused:
        o = paged_attention_decode(q[:, 0].contiguous(), k_pool, v_pool,
                                   table, lengths, k_sc, v_sc)  # (S, H, hd)
        return attn._out_proj(p, o[:, None].to(x.dtype))

    n_live = (lengths + bs) // bs                      # blocks incl. new token
    k = paged_gather(k_pool, table, n_live)            # (S, MB*BS, KVh, hd)
    v = paged_gather(v_pool, table, n_live)
    if quantized:
        ks = paged_gather(k_sc[..., None, None], table, n_live)  # (S,T,1,1)
        vs = paged_gather(v_sc[..., None, None], table, n_live)
        k = (k.float() * ks).to(x.dtype)
        v = (v.float() * vs).to(x.dtype)
    scores = attn._gqa_scores(q, k)                    # (S, H, 1, MB*BS)
    slot_pos = torch.arange(k.shape[1], device=x.device)
    valid = (slot_pos[None, :] <= lengths[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, attn.NEG_INF)
    w = attn._softmax(scores).to(x.dtype)
    return attn._out_proj(p, attn._gqa_combine(w, v))


def _run_layers(params, kv, tokens: torch.Tensor, cfg, attend) -> torch.Tensor:
    """Embed ``tokens`` (S, T), run every layer's attention sub-layers
    (``attend(p_mix, h, kv_l)`` gives the attention output of the normed
    input ``h`` against the layer's pools ``kv_l``) with their FFNs, and
    return the head's logits (S, T, V)."""
    kinds = _sub_kinds(cfg)
    x = embed_tokens(params["embed"], tokens, cfg.activation_dtype)
    for li in range(_n_scan(cfg)):
        lp = layer_params(params["layers"], li)
        for i in range(len(kinds)):
            name = f"sub{i}"
            p = lp[name]
            h = apply_norm(p["norm1"], x, cfg.norm_eps)
            x = x + attend(p["mix"], h, {n: t[li] for n, t in kv[name].items()})
            h2 = apply_norm(p["norm2"], x, cfg.norm_eps)
            x = x + ffn_forward(p["ffn"], h2, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    return lm_head(params["embed"], x)


def build_decode_step(model, fused_attention: Optional[bool] = None):
    """Batched decode: (params, kv, table, lengths, write_slot, write_off,
    tokens (S,1) long) -> logits (S, V). ``kv`` is ``PagedCachePool.kv``
    and is updated in place.

    ``fused_attention`` None/True (the default) runs the paged-attention
    kernel; False runs the gather + dense-softmax oracle.
    """
    cfg = model.cfg
    _n_scan(cfg)           # called for effect: validates the layout early
    fused = True if fused_attention is None else bool(fused_attention)

    def step(params, kv, table, lengths, write_slot, write_off, tokens):
        def attend(p, h, kv_l):
            return _paged_attention_decode(p, h, kv_l, table, lengths,
                                           write_slot, write_off, cfg, fused)
        return _run_layers(params, kv, tokens, cfg, attend)[:, -1]

    return step


def _scatter_rows(kv: Dict[str, torch.Tensor], k_new: torch.Tensor,
                  v_new: torch.Tensor, write_slot: torch.Tensor,
                  write_off: torch.Tensor) -> None:
    """Append one K and one V row per writer into the layer's pools (one
    launch for both, quantizing for int8 / fp8 pools)."""
    if "k_scale" in kv:
        paged_scatter_quant_kv(kv["k"], kv["k_scale"], kv["v"], kv["v_scale"],
                               k_new.contiguous(), v_new.contiguous(),
                               write_slot, write_off)
    else:
        paged_scatter_kv(kv["k"], kv["v"], k_new.to(kv["k"].dtype).contiguous(),
                         v_new.to(kv["v"].dtype).contiguous(), write_slot,
                         write_off)


def _paged_attention_verify(p: Dict, x: torch.Tensor,
                            kv: Dict[str, torch.Tensor], table: torch.Tensor,
                            lengths: torch.Tensor, write_slots: torch.Tensor,
                            write_offs: torch.Tensor, cfg,
                            fused: bool) -> torch.Tensor:
    """k-token speculative verify of every slot in one forward.

    x (S,k,d): the k draft inputs of each slot at positions
    ``lengths[s] + j``; write_slots / write_offs (k,NB) from
    ``PagedCachePool.write_maps_k`` (one K+V scatter per draft position).
    The fused path expands each slot into k pseudo-slots sharing its block
    table; the decode's inclusive ``pos <= length`` mask then gives pseudo-
    slot (s, j) positions ``0..lengths[s]+j``: the prior context and the
    drafts ``<= j``. The gather path attends a dense (S, H, k, T) causal
    softmax over the gathered context.
    """
    quantized = "k_scale" in kv
    bs = kv["k"].shape[1]
    s, kq, _ = x.shape
    positions = lengths[:, None] + torch.arange(kq, dtype=lengths.dtype,
                                                device=x.device)[None, :]
    q, k_new, v_new = attn._project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    for j in range(kq):
        _scatter_rows(kv, k_new[:, j], v_new[:, j], write_slots[j],
                      write_offs[j])
    k_sc, v_sc = kv.get("k_scale"), kv.get("v_scale")

    if fused:
        qf = q.reshape(s * kq, *q.shape[2:]).contiguous()      # (S*k, H, hd)
        table_x = table.repeat_interleave(kq, dim=0)           # (S*k, MB)
        len_x = positions.reshape(-1).contiguous()             # (S*k,)
        o = paged_attention_decode(qf, kv["k"], kv["v"], table_x, len_x,
                                   k_sc, v_sc, plan_slots=s)
        o = o.reshape(s, kq, *o.shape[1:])                     # (S,k,H,hd)
        return attn._out_proj(p, o.to(x.dtype))

    last = positions[:, -1]                            # deepest draft position
    n_live = torch.clamp((last + bs) // bs, max=table.shape[1]).to(torch.int32)
    k = paged_gather(kv["k"], table, n_live)           # (S, MB*BS, KVh, hd)
    v = paged_gather(kv["v"], table, n_live)
    if quantized:
        ks = paged_gather(k_sc[..., None, None], table, n_live)
        vs = paged_gather(v_sc[..., None, None], table, n_live)
        k = (k.float() * ks).to(x.dtype)
        v = (v.float() * vs).to(x.dtype)
    scores = attn._gqa_scores(q, k)                    # (S, H, k, MB*BS)
    slot_pos = torch.arange(k.shape[1], device=x.device)
    valid = (slot_pos[None, None, :] <= positions[:, :, None])[:, None]
    scores = scores.masked_fill(~valid, attn.NEG_INF)
    w = attn._softmax(scores).to(x.dtype)
    return attn._out_proj(p, attn._gqa_combine(w, v))


def build_verify_step(model, k: int, fused_attention: Optional[bool] = None):
    """k-token speculative verify: (params, kv, table, lengths, write_slots
    (k,NB), write_offs (k,NB), tokens (S,k) long) -> logits (S, k, V);
    ``kv`` is updated in place with the k draft rows of every active slot.

    ``logits[s, j]`` is the target's distribution for position
    ``lengths[s]+j+1`` given the prompt and draft tokens ``<= j``: its
    argmax is the token plain decode would emit there. Attention-only
    models only: recurrent sub-layer state has no rollback for a rejected
    draft, so those architectures raise here, as the reference's do.
    """
    cfg = model.cfg
    period = cfg.attn_layer_period or 1
    mixers = (["rwkv"] if cfg.family == "ssm"
              else [cfg.layer_kind(i) for i in range(period)])
    if any(m != "attn" for m in mixers):
        raise ValueError(
            "speculative verify requires attention-only models (recurrent "
            f"sublayer state has no rollback); got kinds={mixers}")
    _n_scan(cfg)           # called for effect: validates the layout early
    fused = True if fused_attention is None else bool(fused_attention)

    def step(params, kv, table, lengths, write_slots, write_offs, tokens):
        def attend(p, h, kv_l):
            return _paged_attention_verify(p, h, kv_l, table, lengths,
                                           write_slots, write_offs, cfg, fused)
        return _run_layers(params, kv, tokens, cfg, attend)    # (S, k, V)

    return step
