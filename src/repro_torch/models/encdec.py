"""Encoder-decoder transformer: the paper's NMT model (transformer-big) and
the whisper-style audio layout it shares.

The encoder reads precomputed frame embeddings ``batch["frames"]`` (B,
frames, d) when ``cfg.num_audio_frames`` > 0 (the reduced configs of every
enc-dec arch are such frames models), and source TOKENS
``batch["src_tokens"]`` through the shared embedding when it is 0 (the
full transformer-big). Self-attention in both stacks uses RoPE, the
encoder's without a mask; cross-attention has neither. Per-layer
parameters are stacked on a leading axis (``enc_layers``, ``dec_layers``),
the reference's scanned tree leaf for leaf, and the forward loops over
that axis, as ``LM`` does. On a mesh (DTensors, ``launch/sharding.py``)
every attention core, the cross-attention's too, runs on each rank's own
rows and heads (``models/attention.py`` ``_attend_placed``).

API (the reference's):
    init(generator, device, weight_dtype) -> params
    encode(params, batch) -> memory (B, T, d)
    forward(params, batch, remat) -> (logits (B, S, V), aux 0)
    init_cache(batch, cap, dtype, device) -> cache
    prefill(params, batch, cap, cache_dtype) -> (last logits (B,1,V), cache)
    decode(params, cache, tokens, pos) -> (logits (B,1,V), cache)

The cache is ``{"self": {"k","v": (L,B,cap,KV,hd)}, "cross": {"k","v":
(L,B,M,KV,hd)}}``. As in the reference, ``init_cache``'s cross cache is
``num_audio_frames`` long, or ``cap`` long for a token-source model, while
``prefill`` returns the memory's own length. ``decode`` updates the self
cache in place and returns the same dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, embed_tokens, lm_head,
                                       stacked_const)
from repro_torch.models.ffn import ffn_forward, init_stacked_ffn
from repro_torch.models.sharding_hints import remat_context
from repro_torch.models.transformer import (init_embedding,
                                            init_stacked_attention,
                                            layer_params, unbind_layers)

PyTree = Any


def _dec_layer_fwd(lp: Dict, x: torch.Tensor, memory: torch.Tensor,
                   cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    a, _ = attn.attention_forward(lp["self_attn"],
                                  apply_norm(lp["norm1"], x, eps), cfg,
                                  positions)
    x = x + a
    x = x + attn.cross_attention_forward(
        lp["cross_attn"], apply_norm(lp["norm_x"], x, eps), memory, cfg)
    return x + ffn_forward(lp["ffn"], apply_norm(lp["norm2"], x, eps), cfg)


@dataclass(frozen=True)
class EncDecLM:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device="cuda",
             weight_dtype: Optional[torch.dtype] = None) -> PyTree:
        """Random parameters from ``generator`` (on ``device``), drawn as
        ``LM.init`` draws them: matrices, embeddings and biases in
        ``weight_dtype`` (default ``cfg.param_dtype``), norm scales in
        ``cfg.param_dtype``; empty stand-ins on ``device="meta"``."""
        cfg = self.cfg
        dev = resolve_device(device, meta=True)
        pdt = torch_dtype(cfg.param_dtype)
        wdt = weight_dtype or pdt
        d = cfg.d_model
        ne, nd = cfg.encoder_layers, cfg.num_layers

        def norm(n):
            return {"scale": stacked_const(n, (d,), 1.0, pdt, dev)}

        embed = init_embedding(cfg, generator, wdt, dev)
        enc = {"norm1": norm(ne),
               "attn": init_stacked_attention(cfg, ne, generator, wdt, dev),
               "norm2": norm(ne),
               "ffn": init_stacked_ffn(cfg, ne, generator, wdt, dev)}
        dec = {"norm1": norm(nd),
               "self_attn": init_stacked_attention(cfg, nd, generator, wdt,
                                                   dev),
               "norm_x": norm(nd),
               "cross_attn": init_stacked_attention(cfg, nd, generator, wdt,
                                                    dev),
               "norm2": norm(nd),
               "ffn": init_stacked_ffn(cfg, nd, generator, wdt, dev)}
        return {"embed": embed, "enc_layers": enc, "dec_layers": dec,
                "enc_norm": {"scale": torch.ones(d, dtype=pdt, device=dev)},
                "final_norm": {"scale": torch.ones(d, dtype=pdt, device=dev)}}

    # ------------------------------------------------------------------
    def encode(self, params: PyTree, batch: Dict) -> torch.Tensor:
        """The encoder's memory (B, T, d) in the activation dtype."""
        cfg = self.cfg
        dtype = cfg.activation_dtype
        if cfg.num_audio_frames > 0:
            x = batch["frames"].to(dtype)            # stub frontend output
        else:
            x = embed_tokens(params["embed"], batch["src_tokens"].long(),
                             dtype)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None]
        eps = cfg.norm_eps
        for lp in unbind_layers(params["enc_layers"], cfg.encoder_layers):
            a, _ = attn.attention_forward(lp["attn"],
                                          apply_norm(lp["norm1"], x, eps),
                                          cfg, positions, causal=False)
            x = x + a
            x = x + ffn_forward(lp["ffn"], apply_norm(lp["norm2"], x, eps),
                                cfg)
        return apply_norm(params["enc_norm"], x, eps)

    def forward(self, params: PyTree, batch: Dict,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: ``tokens`` (B, S) and ``frames`` or ``src_tokens`` ->
        (logits (B, S, V) in the activation dtype, aux 0). ``remat``
        recomputes each decoder layer in the backward, as the reference
        checkpoints its decoder scan body."""
        cfg = self.cfg
        memory = self.encode(params, batch)
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens.long(), cfg.activation_dtype)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None]
        for lp in unbind_layers(params["dec_layers"], cfg.num_layers):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    _dec_layer_fwd, lp, x, memory, cfg, positions,
                    use_reentrant=False, context_fn=remat_context)
            else:
                x = _dec_layer_fwd(lp, x, memory, cfg, positions)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return lm_head(params["embed"], x), aux

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, cap: int, dtype=torch.bfloat16,
                   device="cuda") -> PyTree:
        """Zero caches: the self cache ``cap`` long, the cross cache
        ``num_audio_frames`` long (``cap`` for a token-source model);
        empty stand-ins on ``device="meta"``."""
        cfg = self.cfg
        n = cfg.num_layers
        dev = resolve_device(device, meta=True)
        mem_len = cfg.num_audio_frames or cap
        one = attn.init_kv_cache(cfg, batch * n, cap, dtype, dev)
        shape = (n, batch, mem_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"self": {k: v.unflatten(0, (n, batch)) for k, v in one.items()},
                "cross": {k: torch.zeros(shape, dtype=dtype, device=dev)
                          for k in ("k", "v")}}

    def prefill(self, params: PyTree, batch: Dict, cap: int,
                cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, PyTree]:
        """Encode, then a teacher-forced decoder pass over
        ``batch["tokens"]`` writing both caches: (logits (B,1,V) of the last
        position, cache) with the cross cache as long as the memory."""
        cfg = self.cfg
        eps = cfg.norm_eps
        memory = self.encode(params, batch)
        tokens = batch["tokens"]
        b, s = tokens.shape
        if cfg.sliding_window <= 0 and cap < s:
            raise ValueError(f"cache capacity {cap} smaller than prefill "
                             f"length {s}")
        x = embed_tokens(params["embed"], tokens.long(), cfg.activation_dtype)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
        n = cfg.num_layers
        one = attn.init_kv_cache(cfg, b * n, cap, cache_dtype, x.device)
        self_c = {k: v.unflatten(0, (n, b)) for k, v in one.items()}
        cross_k, cross_v = [], []
        for li, lp in enumerate(unbind_layers(params["dec_layers"], n)):
            a, kv = attn.attention_forward(lp["self_attn"],
                                           apply_norm(lp["norm1"], x, eps),
                                           cfg, positions, return_cache=True)
            attn.prefill_into_cache({k: v[li] for k, v in self_c.items()}, kv)
            x = x + a
            mem_kv = attn.encoder_kv(lp["cross_attn"], memory, cfg)
            x = x + attn.cross_attention_decode(
                lp["cross_attn"], apply_norm(lp["norm_x"], x, eps), mem_kv,
                cfg)
            cross_k.append(mem_kv["k"].to(cache_dtype))
            cross_v.append(mem_kv["v"].to(cache_dtype))
            x = x + ffn_forward(lp["ffn"], apply_norm(lp["norm2"], x, eps),
                                cfg)
        x = apply_norm(params["final_norm"], x, eps)
        cache = {"self": self_c, "cross": {"k": torch.stack(cross_k),
                                           "v": torch.stack(cross_v)}}
        return lm_head(params["embed"], x[:, -1:]), cache

    def decode(self, params: PyTree, cache: PyTree, tokens: torch.Tensor,
               pos) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B, 1) at absolute position ``pos`` (an int, or a (B,)
        tensor of per-row positions) -> (logits (B, 1, V), cache)."""
        cfg = self.cfg
        eps = cfg.norm_eps
        x = embed_tokens(params["embed"], tokens.long(), cfg.activation_dtype)
        for li in range(cfg.num_layers):
            lp = layer_params(params["dec_layers"], li)
            a, _ = attn.attention_decode(
                lp["self_attn"], apply_norm(lp["norm1"], x, eps),
                {k: v[li] for k, v in cache["self"].items()}, pos, cfg)
            x = x + a
            x = x + attn.cross_attention_decode(
                lp["cross_attn"], apply_norm(lp["norm_x"], x, eps),
                {k: v[li] for k, v in cache["cross"].items()}, cfg)
            x = x + ffn_forward(lp["ffn"], apply_norm(lp["norm2"], x, eps),
                                cfg)
        x = apply_norm(params["final_norm"], x, eps)
        return lm_head(params["embed"], x), cache
