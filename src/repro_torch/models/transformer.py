"""Decoder-only LM for the dense family: attention + dense-FFN sub-layers.

Per-layer parameters are stacked on a leading ``L`` axis as in the
reference's scanned tree (``params["layers"]["sub0"][...]``); the forward is
a Python loop over that axis, reading per-layer views (no copies).

API:
    init(generator, device, weight_dtype) -> params
    forward(params, batch, remat) -> (logits, aux)       (training)
    prefill(params, tokens, cap, cache_dtype) -> (last-token logits, cache)
    init_cache(batch, cap, dtype, device) -> cache
    decode(params, cache, tokens, pos) -> (logits, cache)   (one token)

Weights may be fp32 masters: every op casts its weight to the activation
dtype inside (as the reference does), so the gradient flows back through
the cast to the fp32 leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

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


def unbind_layers(layers: PyTree, n: int) -> List[PyTree]:
    """All n per-layer views of a stacked tree, from ONE ``unbind`` per
    leaf. Its backward stacks the n layers' gradients once; taking each
    layer with ``layer_params`` instead makes autograd write a full-size
    zero gradient per layer and leaf and sum n of them."""
    if isinstance(layers, dict):
        subs = {k: unbind_layers(v, n) for k, v in layers.items()}
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return list(layers.unbind(0))


def _sublayer_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor,
                      cache: Optional[Dict[str, torch.Tensor]] = None):
    """Forward one attention + dense-FFN sub-layer over the full sequence,
    writing its roped K/V into ``cache`` (this layer's views of the stacked
    buffers) when one is given; the training forward passes none."""
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    h, kv = attn.attention_forward(p["mix"], h, cfg, positions,
                                   return_cache=cache is not None)
    if cache is not None:
        attn.prefill_into_cache(cache, kv)
    x = x + h
    h2 = ffn_forward(p["ffn"], apply_norm(p["norm2"], x, cfg.norm_eps), cfg)
    return x + h2


def _sublayer_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                     cache: Dict[str, torch.Tensor], pos) -> torch.Tensor:
    """One token through one attention + dense-FFN sub-layer, writing its
    K/V into ``cache`` (this layer's views of the stacked buffers)."""
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    h, _ = attn.attention_decode(p["mix"], h, cache, pos, cfg)
    x = x + h
    h2 = ffn_forward(p["ffn"], apply_norm(p["norm2"], x, cfg.norm_eps), cfg)
    return x + h2


def _layer_fwd(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    for i in range(len(_sub_kinds(cfg))):
        x = _sublayer_prefill(lp[f"sub{i}"], x, cfg, positions)
    return x


# ----------------------------------------------------------------------------
# stacked (leading L axis) parameter inits, shared with the enc-dec model
# ----------------------------------------------------------------------------

def stacked_dense(n: int, shape, in_dim: int, generator: torch.Generator,
                  dtype: torch.dtype, device, scale: float = 1.0) -> torch.Tensor:
    """n fan-in inits of ``shape`` stacked on a leading axis; each slice is
    drawn in fp32 and cast on store, so a bf16 init never holds an fp32
    copy of the whole stack."""
    t = torch.empty((n, *shape), dtype=dtype, device=device)
    for i in range(n):
        dense_init_(t[i], in_dim, generator, scale)
    return t


def stacked_const(n: int, shape, value: float, dtype: torch.dtype,
                  device) -> torch.Tensor:
    return torch.full((n, *shape), value, dtype=dtype, device=device)


def init_embedding(cfg: ModelConfig, generator: torch.Generator,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The token table (N(0, 0.02)) and, untied, the fan-in head."""
    esh = embedding_shapes(cfg)
    embed = {"tokens": embed_init_(
        torch.empty(esh["tokens"], dtype=dtype, device=device), generator)}
    if "head" in esh:
        embed["head"] = dense_init_(
            torch.empty(esh["head"], dtype=dtype, device=device), cfg.d_model,
            generator)
    return embed


def init_stacked_attention(cfg: ModelConfig, n: int,
                           generator: torch.Generator, dtype: torch.dtype,
                           device) -> Dict[str, torch.Tensor]:
    """wq, wk, wv, wo (and the zero QKV biases) of n layers; ``wo`` scaled
    by 1 / sqrt(num_layers), as the reference's."""
    ash = attn.attention_shapes(cfg)
    d = cfg.d_model
    down_scale = 1.0 / max(1, cfg.num_layers) ** 0.5
    p = {name: stacked_dense(n, ash[name], d, generator, dtype, device)
         for name in ("wq", "wk", "wv")}
    p["wo"] = stacked_dense(n, ash["wo"], ash["wo"][0], generator, dtype,
                            device, down_scale)
    for b in ("bq", "bk", "bv"):
        if b in ash:
            p[b] = stacked_const(n, ash[b], 0.0, dtype, device)
    return p


def init_stacked_ffn(cfg: ModelConfig, n: int, generator: torch.Generator,
                     dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The FFN's matrices of n layers (gated: w_gate, w_up, w_down; plain:
    w_up, w_down); ``w_down`` scaled by 1 / sqrt(num_layers)."""
    down_scale = 1.0 / max(1, cfg.num_layers) ** 0.5
    return {name: stacked_dense(n, shape, shape[0], generator, dtype, device,
                                down_scale if name == "w_down" else 1.0)
            for name, shape in ffn_shapes(cfg).items()}


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
        layers: Dict = {}
        for i in range(len(_sub_kinds(cfg))):
            layers[f"sub{i}"] = {
                "norm1": {"scale": stacked_const(n, (d,), 1.0, pdt, dev)},
                "mix": init_stacked_attention(cfg, n, generator, wdt, dev),
                "norm2": {"scale": stacked_const(n, (d,), 1.0, pdt, dev)},
                "ffn": init_stacked_ffn(cfg, n, generator, wdt, dev),
            }
        return {"embed": init_embedding(cfg, generator, wdt, dev),
                "final_norm": {"scale": torch.ones(d, dtype=pdt, device=dev)},
                "layers": layers}

    def forward(self, params: PyTree, batch: Dict,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch["tokens"] (B,S) -> (logits (B,S,V) in the activation dtype,
        aux). ``aux`` is the load-balancing loss of MoE layers: 0 for the
        dense family. ``remat`` recomputes each layer in the backward
        (``torch.utils.checkpoint``), the reference's ``jax.checkpoint``
        around its scan body."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens.long(), cfg.activation_dtype)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None]
        for lp in unbind_layers(params["layers"], _n_scan(cfg)):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    _layer_fwd, lp, x, cfg, positions, use_reentrant=False)
            else:
                x = _layer_fwd(lp, x, cfg, positions)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return lm_head(params["embed"], x), aux

    def init_cache(self, batch: int, cap: int, dtype=torch.bfloat16,
                   device="cuda") -> PyTree:
        """Zero caches ``{"sub0": {"k","v": (L,B,cap,KV,hd)}}``, the layout
        ``prefill`` emits; ``cap`` becomes ``min(cap, window)`` (a ring
        buffer) when ``cfg.sliding_window`` > 0."""
        cfg = self.cfg
        n = _n_scan(cfg)
        dev = resolve_device(device)
        cache = {}
        for i in range(len(_sub_kinds(cfg))):
            one = attn.init_kv_cache(cfg, batch * n, cap, dtype, dev)
            cache[f"sub{i}"] = {k: v.unflatten(0, (n, batch))
                                for k, v in one.items()}
        return cache

    def prefill(self, params: PyTree, tokens: torch.Tensor, cap: int,
                cache_dtype=torch.float32) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B,S) -> (logits (B,1,V) of the last position, cache) with
        cache ``{"sub0": {"k","v": (L,B,cap,KV,hd)}}`` in ``cache_dtype``.
        ``cap`` may be below S only with a sliding window: the ring buffer
        then keeps the trailing window."""
        cfg = self.cfg
        kinds = _sub_kinds(cfg)
        n = _n_scan(cfg)
        b, s = tokens.shape
        if cfg.sliding_window <= 0 and cap < s:
            raise ValueError(f"cache capacity {cap} smaller than prefill "
                             f"length {s}")
        dev = tokens.device
        x = embed_tokens(params["embed"], tokens, cfg.activation_dtype)
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
        cache = self.init_cache(b, cap, cache_dtype, dev)
        for li in range(n):
            lp = layer_params(params["layers"], li)
            for i, _k in enumerate(kinds):
                name = f"sub{i}"
                x = _sublayer_prefill(lp[name], x, cfg, positions,
                                      {k: v[li] for k, v in cache[name].items()})
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        return lm_head(params["embed"], x[:, -1:]), cache

    def decode(self, params: PyTree, cache: PyTree, tokens: torch.Tensor,
               pos) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B,1) -> (logits (B,1,V), cache). ``pos``: the tokens'
        absolute position, an int shared by the rows or a (B,) int tensor
        of per-row positions (ragged decode; see ``attention_decode``).
        The cache is updated in place and returned."""
        cfg = self.cfg
        kinds = _sub_kinds(cfg)
        x = embed_tokens(params["embed"], tokens.long(), cfg.activation_dtype)
        for li in range(_n_scan(cfg)):
            lp = layer_params(params["layers"], li)
            for i, _k in enumerate(kinds):
                name = f"sub{i}"
                x = _sublayer_decode(lp[name], x, cfg,
                                     {k: v[li] for k, v in cache[name].items()},
                                     pos)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        return lm_head(params["embed"], x), cache
