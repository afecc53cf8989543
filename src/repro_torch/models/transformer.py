"""Decoder-only LM for the dense family: attention + dense-FFN sub-layers.

Per-layer parameters are stacked on a leading ``L`` axis as in the
reference's scanned tree (``params["layers"]["sub0"][...]``); the forward is
a Python loop over that axis, reading per-layer views (no copies).

API:
    init(generator, device, weight_dtype) -> params
    prefill(params, tokens, cap, cache_dtype) -> (last-token logits, cache)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, dense_init_, embed_init_,
                                       embed_tokens, embedding_shapes, lm_head)
from repro_torch.models.ffn import ffn_forward, ffn_shapes

PyTree = Any


# ----------------------------------------------------------------------------
# sub-layer templates
# ----------------------------------------------------------------------------

def _sub_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) kind per scanned sub-layer within one layer step. The
    serving slice carries attention mixers with dense FFNs; every other
    family raises, naming the slice that ports it."""
    if cfg.family == "ssm":
        kinds = [("rwkv", "rwkv")]
    else:
        period = cfg.attn_layer_period or 1
        kinds = [(cfg.layer_kind(i), "moe" if cfg.is_moe_layer(i) else "dense")
                 for i in range(period)]
    bad = [k for k in kinds if k != ("attn", "dense")]
    if bad or cfg.is_encdec or cfg.num_patches:
        raise NotImplementedError(
            f"{cfg.name}: sub-layers {bad or kinds} (family {cfg.family!r}) "
            "are not in the serving slice, which ports attention + dense-FFN "
            "LMs; the other mixers come with ROADMAP Queue 1 item 11")
    return kinds


def _n_scan(cfg: ModelConfig) -> int:
    period = len(_sub_kinds(cfg))
    if cfg.num_layers % period:
        raise ValueError((cfg.num_layers, period))
    return cfg.num_layers // period


def layer_params(layers: PyTree, idx: int) -> PyTree:
    """The per-layer view ``layers[..][idx]`` of a stacked tree."""
    if isinstance(layers, dict):
        return {k: layer_params(v, idx) for k, v in layers.items()}
    return layers[idx]


def _sublayer_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, cache: Dict[str, torch.Tensor]):
    """Forward one attention + dense-FFN sub-layer, writing its roped K/V
    into ``cache`` (this layer's views of the stacked buffers)."""
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    h, kv = attn.attention_forward(p["mix"], h, cfg, positions,
                                   return_cache=True)
    attn.prefill_into_cache(cache, kv)
    x = x + h
    h2 = ffn_forward(p["ffn"], apply_norm(p["norm2"], x, cfg.norm_eps), cfg)
    return x + h2


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

@dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, device="cuda",
             weight_dtype: Optional[torch.dtype] = None) -> PyTree:
        """Random parameters from ``generator`` (which must live on
        ``device``): truncated-normal fan-in matrices and N(0, 0.02)
        embeddings, as the reference draws them. Matrices, embeddings and
        biases are stored in ``weight_dtype`` (default ``cfg.param_dtype``);
        norm scales stay in ``cfg.param_dtype``. Each stacked layer slice is
        drawn in fp32 and cast on store, so a bf16 full-size init never
        holds the fp32 tree."""
        cfg = self.cfg
        dev = resolve_device(device)
        pdt = torch_dtype(cfg.param_dtype)
        wdt = weight_dtype or pdt
        n = _n_scan(cfg)
        d = cfg.d_model
        down_scale = 1.0 / max(1, cfg.num_layers) ** 0.5

        def stacked(shape, in_dim, scale=1.0):
            t = torch.empty((n, *shape), dtype=wdt, device=dev)
            for i in range(n):
                dense_init_(t[i], in_dim, generator, scale)
            return t

        def const(shape, value, dtype):
            return torch.full((n, *shape), value, dtype=dtype, device=dev)

        layers: Dict = {}
        for i in range(len(_sub_kinds(cfg))):
            ash = attn.attention_shapes(cfg)
            mix = {
                "wq": stacked(ash["wq"], d), "wk": stacked(ash["wk"], d),
                "wv": stacked(ash["wv"], d),
                "wo": stacked(ash["wo"], ash["wo"][0], down_scale),
            }
            for b in ("bq", "bk", "bv"):
                if b in ash:
                    mix[b] = const(ash[b], 0.0, wdt)
            fsh = ffn_shapes(cfg)
            layers[f"sub{i}"] = {
                "norm1": {"scale": const((d,), 1.0, pdt)},
                "mix": mix,
                "norm2": {"scale": const((d,), 1.0, pdt)},
                "ffn": {"w_gate": stacked(fsh["w_gate"], d),
                        "w_up": stacked(fsh["w_up"], d),
                        "w_down": stacked(fsh["w_down"], cfg.d_ff, down_scale)},
            }
        esh = embedding_shapes(cfg)
        embed = {"tokens": embed_init_(
            torch.empty(esh["tokens"], dtype=wdt, device=dev), generator)}
        if "head" in esh:
            embed["head"] = dense_init_(
                torch.empty(esh["head"], dtype=wdt, device=dev), d, generator)
        return {"embed": embed,
                "final_norm": {"scale": torch.ones(d, dtype=pdt, device=dev)},
                "layers": layers}

    def prefill(self, params: PyTree, tokens: torch.Tensor, cap: int,
                cache_dtype=torch.float32) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B,S) -> (logits (B,1,V) of the last position, cache) with
        cache ``{"sub0": {"k","v": (L,B,cap,KV,hd)}}`` in ``cache_dtype``."""
        cfg = self.cfg
        kinds = _sub_kinds(cfg)
        n = _n_scan(cfg)
        b, s = tokens.shape
        if cap < s:
            raise ValueError(f"cache capacity {cap} smaller than prefill "
                             f"length {s}")
        dev = tokens.device
        x = embed_tokens(params["embed"], tokens, cfg.activation_dtype)
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
        cache = {}
        for i, _k in enumerate(kinds):
            one = attn.init_kv_cache(cfg, b * n, cap, cache_dtype, dev)
            cache[f"sub{i}"] = {k: v.unflatten(0, (n, b))
                                for k, v in one.items()}
        for li in range(n):
            lp = layer_params(params["layers"], li)
            for i, _k in enumerate(kinds):
                name = f"sub{i}"
                x = _sublayer_prefill(lp[name], x, cfg, positions,
                                      {k: v[li] for k, v in cache[name].items()})
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        return lm_head(params["embed"], x[:, -1:]), cache
