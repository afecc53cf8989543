"""Batched decode over the paged KV pool: one step for all slots.

Mirrors the reference's layer loop, but attention sub-layers read and write
the shared block pool through the kernels of ``repro_torch.kernels``, and
every slot carries its OWN absolute position (= its current context length)
— the ragged substrate continuous batching needs.

Step order per attention sub-layer: project and rope q/k/v at each slot's
position ``lengths[s]``; ``paged_scatter`` appends the new K/V rows into the
pools (in place); then attention reads the pools, on the same stream, so
the new token's key is visible (valid keys: positions ``<= lengths[s]``).
Inactive slots go through the step too, with length 0 and an all-zero table
row (the null block); they appear in no write-map entry, never touch the
pool, and their attention output is exactly 0.

Two attention paths, pinned against each other:

* ``fused_attention=False`` — the oracle: ``paged_gather`` a dense
  ``(S, MB*BS, KVh, hd)`` context, dense fp32 masked softmax;
* ``fused_attention=True`` (the default) — the ``paged_attention_decode``
  kernel consumes the block table directly; no gathered context exists.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.paged_attention import paged_attention_decode
from repro_torch.kernels.paged_cache import paged_gather, paged_scatter
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

    x (S,1,d); kv {"k","v"}: (NB,BS,KVh,hd) pools of THIS layer, updated in
    place; table (S,MB) int32; lengths (S,) int32; write_slot / write_off
    (NB,) int32 from ``PagedCachePool.write_maps``.
    """
    bs = kv["k"].shape[1]
    positions = lengths[:, None]                       # (S,1) per-slot pos
    q, k_new, v_new = attn._project_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    k_pool = paged_scatter(kv["k"], k_new[:, 0].to(kv["k"].dtype).contiguous(),
                           write_slot, write_off)
    v_pool = paged_scatter(kv["v"], v_new[:, 0].to(kv["v"].dtype).contiguous(),
                           write_slot, write_off)

    if fused:
        o = paged_attention_decode(q[:, 0].contiguous(), k_pool, v_pool,
                                   table, lengths)          # (S, H, hd)
        return attn._out_proj(p, o[:, None].to(x.dtype))

    n_live = (lengths + bs) // bs                      # blocks incl. new token
    k = paged_gather(k_pool, table, n_live)            # (S, MB*BS, KVh, hd)
    v = paged_gather(v_pool, table, n_live)
    scores = attn._gqa_scores(q, k)                    # (S, H, 1, MB*BS)
    slot_pos = torch.arange(k.shape[1], device=x.device)
    valid = (slot_pos[None, :] <= lengths[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, attn.NEG_INF)
    w = attn._softmax(scores).to(x.dtype)
    return attn._out_proj(p, attn._gqa_combine(w, v))


def _attn_sublayer(p: Dict, x: torch.Tensor, kv, table, lengths, write_slot,
                   write_off, cfg, fused: bool) -> torch.Tensor:
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    x = x + _paged_attention_decode(p["mix"], h, kv, table, lengths,
                                    write_slot, write_off, cfg, fused)
    h2 = apply_norm(p["norm2"], x, cfg.norm_eps)
    return x + ffn_forward(p["ffn"], h2, cfg)


def build_decode_step(model, fused_attention: Optional[bool] = None):
    """Batched decode: (params, kv, table, lengths, write_slot, write_off,
    tokens (S,1) long) -> logits (S, V). ``kv`` is ``PagedCachePool.kv``
    and is updated in place.

    ``fused_attention`` None/True (the default) runs the paged-attention
    kernel; False runs the gather + dense-softmax oracle.
    """
    cfg = model.cfg
    kinds = _sub_kinds(cfg)
    n_scan = _n_scan(cfg)
    fused = True if fused_attention is None else bool(fused_attention)

    def step(params, kv, table, lengths, write_slot, write_off, tokens):
        x = embed_tokens(params["embed"], tokens, cfg.activation_dtype)
        for li in range(n_scan):
            lp = layer_params(params["layers"], li)
            for i, _k in enumerate(kinds):
                name = f"sub{i}"
                kv_l = {k: v[li] for k, v in kv[name].items()}
                x = _attn_sublayer(lp[name], x, kv_l, table, lengths,
                                   write_slot, write_off, cfg, fused)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        return lm_head(params["embed"], x)[:, -1]

    return step
