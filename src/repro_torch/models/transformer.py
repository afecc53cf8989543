"""Decoder-only LM: the dense, MoE, hybrid (attention + Mamba) and
attention-free (RWKV6) families.

Per-layer parameters are stacked on a leading ``L`` axis as in the
reference's scanned tree (``params["layers"]["sub0"][...]``); the forward is
a Python loop over that axis, reading per-layer views (no copies). A
hybrid (jamba) model steps over blocks of ``attn_layer_period``
sub-layers ``sub0 .. sub{p-1}``, so the stacked tree stays homogeneous:
attention at ``i = p - 1``, Mamba elsewhere, and an MoE FFN wherever
``cfg.is_moe_layer(i)``. An ``ssm``-family model (rwkv6) has one
sub-layer a step, the RWKV time mix and channel mix, and an ``embed_norm``
after the embedding. A VLM config (``num_patches``) reads a batch's
``patches`` (B, P, d_model), precomputed patch embeddings of the stub
frontend, as a prefix before the token embeddings; the logits cover only
the text tokens. Encoder-decoder configs are ``EncDecLM``'s.

API:
    init(generator, device, weight_dtype) -> params
    forward(params, batch, remat) -> (logits, aux)       (training)
    prefill(params, tokens or batch, cap, cache_dtype)
        -> (last-token logits, cache)
    init_cache(batch, cap, dtype, device) -> cache
    decode(params, cache, tokens, pos) -> (logits, cache)   (one token)

``aux`` is the MoE load-balance loss summed over the sub-layers of a step
and over the steps, as the reference's scan sums it; training routes with
the GShard capacity factor 1.25, prefill and decode with 0 (no drops).
A cache holds per sub-layer attention K/V ``{"k", "v"}``, a Mamba state
``{"h", "conv"}`` or an RWKV state ``{"s", "shift_tm", "shift_cm"}``, each
stacked on the leading ``L`` axis.

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
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv as rk
from repro_torch.models.common import (apply_norm, dense_init_, embed_init_,
                                       embed_tokens, embedding_shapes, lm_head,
                                       stacked_const, stacked_dense)
from repro_torch.models.ffn import ffn_forward, init_stacked_ffn
from repro_torch.models.moe import init_stacked_moe, moe_forward
from repro_torch.models.sharding_hints import hint, remat_context

PyTree = Any

# ----------------------------------------------------------------------------
# sub-layer templates
# ----------------------------------------------------------------------------

def _sub_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) kind per sub-layer within one layer step: mixers
    ``attn`` and ``ssm`` (Mamba) with FFNs ``dense`` and ``moe``, or the
    ``ssm`` family's one ``("rwkv", "rwkv")``. An encoder-decoder config
    raises: it builds ``EncDecLM``."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} (family {cfg.family!r}) is an "
                         "encoder-decoder config: build_model gives EncDecLM")
    if cfg.family == "ssm":
        return [("rwkv", "rwkv")]
    period = cfg.attn_layer_period or 1
    return [(cfg.layer_kind(i), "moe" if cfg.is_moe_layer(i) else "dense")
            for i in range(period)]


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


def ffn_block(p: Dict, h: torch.Tensor, cfg: ModelConfig, kind: str,
              capacity_factor: float = 1.25):
    """The sub-layer's dense or MoE FFN on the normed input -> (out, aux);
    a dense FFN's aux is None."""
    if kind == "moe":
        return moe_forward(p, h, cfg, capacity_factor)
    return ffn_forward(p, h, cfg), None


def _sublayer_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      mixer: str, ffn: str, positions: torch.Tensor,
                      cache: Optional[Dict[str, torch.Tensor]] = None):
    """One sub-layer over the full sequence -> (x, aux or None). With a
    ``cache`` (this layer's views of the stacked buffers) attention writes
    its roped K/V there and Mamba its decode state, and the MoE FFN routes
    with no drops (the reference's prefill), and RWKV writes its WKV state
    and both token-shift carries (cast to the cache's dtype); the training
    forward passes none and routes at the capacity factor 1.25."""
    h = apply_norm(p["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        h, kv = attn.attention_forward(p["mix"], h, cfg, positions,
                                       return_cache=cache is not None)
        if cache is not None:
            attn.prefill_into_cache(cache, kv)
    elif mixer == "rwkv":
        h, (last, s) = rk.time_mix_forward(p["mix"], h, cfg)
        if cache is not None:
            cache["s"].copy_(s)
            cache["shift_tm"].copy_(last)
    elif cache is not None:
        h, state = mb.mamba_prefill(p["mix"], h, cfg)
        for k, v in state.items():
            cache[k].copy_(v)
    else:
        h = mb.mamba_forward(p["mix"], h, cfg)
    x = x + h
    h2 = apply_norm(p["norm2"], x, cfg.norm_eps)
    if ffn == "rwkv":
        h2, last = rk.channel_mix_forward(p["ffn"], h2, cfg)
        if cache is not None:
            cache["shift_cm"].copy_(last)
        return x + h2, None
    h2, aux = ffn_block(p["ffn"], h2, cfg, ffn,
                        0.0 if cache is not None else 1.25)
    return x + h2, aux


def mixer_decode(p: Dict, h: torch.Tensor, cfg: ModelConfig, mixer: str,
                 cache: Dict[str, torch.Tensor], pos) -> torch.Tensor:
    """One token through a sub-layer's mixer (normed input ``h``),
    updating ``cache`` (this layer's views of the stacked buffers) in
    place: attention writes its K/V row, Mamba its new state, RWKV its WKV
    state and time-mix shift (read in the activation dtype, stored in the
    cache's); the recurrent mixers do not read the position."""
    if mixer == "attn":
        return attn.attention_decode(p, h, cache, pos, cfg)[0]
    if mixer == "rwkv":
        out, (last, s) = rk.time_mix_forward(
            p, h, cfg, shift_prev=cache["shift_tm"].to(h.dtype),
            s0=cache["s"])
        cache["s"].copy_(s)
        cache["shift_tm"].copy_(last)
        return out
    out, state = mb.mamba_decode(p, h, cache, cfg)
    for k, v in state.items():
        cache[k].copy_(v)
    return out


def ffn_decode(p: Dict, h: torch.Tensor, cfg: ModelConfig, ffn: str,
               cache: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """One token through a sub-layer's FFN (normed input ``h``): the MoE
    FFN routes with no drops; the rwkv channel mix continues from, and
    updates, ``cache["shift_cm"]``."""
    if ffn == "rwkv":
        out, last = rk.channel_mix_forward(
            p, h, cfg, shift_prev=cache["shift_cm"].to(h.dtype))
        cache["shift_cm"].copy_(last)
        return out
    return ffn_block(p, h, cfg, ffn, 0.0)[0]


def _sublayer_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, mixer: str,
                     ffn: str, cache: Dict[str, torch.Tensor],
                     pos) -> torch.Tensor:
    """One token through one sub-layer."""
    x = x + mixer_decode(p["mix"], apply_norm(p["norm1"], x, cfg.norm_eps),
                         cfg, mixer, cache, pos)
    return x + ffn_decode(p["ffn"], apply_norm(p["norm2"], x, cfg.norm_eps),
                          cfg, ffn, cache)


def _layer_fwd(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor):
    """One layer step (every sub-layer) -> (x, the step's aux, fp32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (m, f) in enumerate(_sub_kinds(cfg)):
        x, a = _sublayer_prefill(lp[f"sub{i}"], x, cfg, m, f, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def promote_states(cache: PyTree, cfg: ModelConfig) -> None:
    """Give every Mamba ``conv`` buffer of ``cache`` the promoted dtype of
    its own and the activation dtype, as the reference's decode leaves it
    (``mamba_decode`` concatenates the state with the new input)."""
    for sub in cache.values():
        if "conv" in sub:
            cdt = torch.promote_types(sub["conv"].dtype, cfg.activation_dtype)
            if sub["conv"].dtype != cdt:
                sub["conv"] = sub["conv"].to(cdt)


def init_states(cfg: ModelConfig, n: int, batch: int, dtype,
                device) -> PyTree:
    """Zero recurrent states of the non-attention sub-layers (leaves ``(n,
    batch, ...)``): Mamba ``{"sub{i}": {"h", "conv"}}`` with ``conv`` in
    ``dtype``, RWKV ``{"s", "shift_tm", "shift_cm"}`` with the shifts in
    ``dtype``; ``h`` and ``s`` are fp32."""
    out = {}
    for i, (m, _f) in enumerate(_sub_kinds(cfg)):
        if m != "attn":
            init = rk.init_rwkv_state if m == "rwkv" else mb.init_mamba_state
            one = init(cfg, n * batch, dtype, device)
            out[f"sub{i}"] = {k: v.unflatten(0, (n, batch))
                              for k, v in one.items()}
    return out


def embed(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig,
          patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings in the activation dtype, after the ``patches``
    prefix (B, P, d_model) cast to that dtype where one is given, through
    the ``embed_norm`` an ``ssm``-family tree carries."""
    x = embed_tokens(params["embed"], tokens.long(), cfg.activation_dtype)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    if "embed_norm" in params:
        x = apply_norm(params["embed_norm"], x, cfg.norm_eps)
    return hint(x, "btd")


# ----------------------------------------------------------------------------
# stacked (leading L axis) parameter inits, shared with the enc-dec model
# ----------------------------------------------------------------------------

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
        norm scales and the leaves the reference reads in fp32 (the MoE
        router, Mamba's ``dt_bias``, ``A_log`` and ``D``, RWKV's
        ``decay_base``, ``bonus``, ``ln_x_scale`` and ``ln_x_bias``) stay in
        ``cfg.param_dtype``. Each stacked slice (an expert's matrix for an
        expert stack) is drawn in fp32 and cast on store, so a bf16
        full-size init never holds the fp32 tree. On ``device="meta"``
        (``generator`` may be None) every leaf is an empty stand-in of its
        shape and dtype: nothing is drawn or allocated."""
        cfg = self.cfg
        dev = resolve_device(device, meta=True)
        pdt = torch_dtype(cfg.param_dtype)
        wdt = weight_dtype or pdt
        n = _n_scan(cfg)
        d = cfg.d_model
        layers: Dict = {}
        for i, (m, f) in enumerate(_sub_kinds(cfg)):
            if m == "attn":
                mix = init_stacked_attention(cfg, n, generator, wdt, dev)
            elif m == "rwkv":
                mix = rk.init_time_mix(cfg, n, generator, wdt, dev, pdt)
            else:
                mix = mb.init_stacked_mamba(cfg, n, generator, wdt, dev, pdt)
            if f == "moe":
                ffn = init_stacked_moe(cfg, n, generator, wdt, dev, pdt)
            elif f == "rwkv":
                ffn = rk.init_channel_mix(cfg, n, generator, wdt, dev)
            else:
                ffn = init_stacked_ffn(cfg, n, generator, wdt, dev)
            layers[f"sub{i}"] = {
                "norm1": {"scale": stacked_const(n, (d,), 1.0, pdt, dev)},
                "mix": mix,
                "norm2": {"scale": stacked_const(n, (d,), 1.0, pdt, dev)},
                "ffn": ffn,
            }
        params = {"embed": init_embedding(cfg, generator, wdt, dev),
                  "final_norm": {"scale": torch.ones(d, dtype=pdt,
                                                     device=dev)},
                  "layers": layers}
        if cfg.family == "ssm":
            params["embed_norm"] = {"scale": torch.ones(d, dtype=pdt,
                                                        device=dev)}
        return params

    def _patches(self, batch: Dict) -> Optional[torch.Tensor]:
        """The batch's patch prefix, read only by a VLM config (any other
        ignores a ``patches`` input, as the reference's)."""
        return batch.get("patches") if self.cfg.num_patches else None

    def forward(self, params: PyTree, batch: Dict,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch["tokens"] (B,S) and, for a VLM config, batch["patches"]
        (B,P,d) -> (logits (B,S,V) over the text tokens in the activation
        dtype, aux). ``aux`` is the MoE load-balance loss summed over
        sub-layers and layers (0 without MoE sub-layers). ``remat``
        recomputes each layer in the backward (``torch.utils.checkpoint``,
        under the forward's hint context: ``remat_context``), the
        reference's ``jax.checkpoint`` around its scan body."""
        cfg = self.cfg
        patches = self._patches(batch)
        x = embed(params, batch["tokens"], cfg, patches)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None]
        auxs = []
        for lp in unbind_layers(params["layers"], _n_scan(cfg)):
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    _layer_fwd, lp, x, cfg, positions, use_reentrant=False,
                    context_fn=remat_context)
            else:
                x, a = _layer_fwd(lp, x, cfg, positions)
            x = hint(x, "btd")
            auxs.append(a)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        if patches is not None:
            x = x[:, patches.shape[1]:]
        return lm_head(params["embed"], x), torch.stack(auxs).sum()

    def init_cache(self, batch: int, cap: int, dtype=torch.bfloat16,
                   device="cuda") -> PyTree:
        """Zero caches in the layout ``prefill`` emits: attention
        sub-layers ``{"k","v": (L,B,cap,KV,hd)}`` (``cap`` becomes
        ``min(cap, window)``, a ring buffer, when ``cfg.sliding_window`` >
        0), Mamba sub-layers ``{"h": (L,B,d_inner,N) fp32, "conv":
        (L,B,d_conv-1,d_inner)}`` in ``dtype``, RWKV sub-layers ``{"s":
        (L,B,H,hd,hd) fp32, "shift_tm", "shift_cm": (L,B,1,d)}`` in
        ``dtype``. ``device="meta"`` gives empty stand-ins."""
        cfg = self.cfg
        n = _n_scan(cfg)
        dev = resolve_device(device, meta=True)
        cache = init_states(cfg, n, batch, dtype, dev)
        for i, (m, _f) in enumerate(_sub_kinds(cfg)):
            if m == "attn":
                one = attn.init_kv_cache(cfg, batch * n, cap, dtype, dev)
                cache[f"sub{i}"] = {k: v.unflatten(0, (n, batch))
                                    for k, v in one.items()}
        return {f"sub{i}": cache[f"sub{i}"]
                for i in range(len(_sub_kinds(cfg)))}

    def prefill(self, params: PyTree, tokens, cap: int,
                cache_dtype=torch.float32) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B,S), or a batch dict with ``tokens`` and, for a VLM
        config, ``patches`` (B,P,d) -> (logits (B,1,V) of the last text
        position, cache): attention K/V in ``cache_dtype``, Mamba states as
        the prefill leaves them (``h`` fp32, ``conv`` in the activation
        dtype, as the reference emits them), RWKV's ``s`` in fp32 and its
        shifts in ``cache_dtype``. The cache holds the patch prefix in its
        first P positions; ``cap`` may be below P + S only with a sliding
        window: the ring buffer then keeps the trailing window."""
        cfg = self.cfg
        kinds = _sub_kinds(cfg)
        n = _n_scan(cfg)
        batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
        x = embed(params, batch["tokens"], cfg, self._patches(batch))
        b, s = x.shape[:2]
        if cfg.sliding_window <= 0 and cap < s:
            raise ValueError(f"cache capacity {cap} smaller than prefill "
                             f"length {s}")
        dev = x.device
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
        cache = self.init_cache(b, cap, cache_dtype, dev)
        for sub in cache.values():
            if "conv" in sub:
                sub["conv"] = sub["conv"].to(cfg.activation_dtype)
        for li in range(n):
            lp = layer_params(params["layers"], li)
            for i, (m, f) in enumerate(kinds):
                name = f"sub{i}"
                x, _ = _sublayer_prefill(
                    lp[name], x, cfg, m, f, positions,
                    {k: v[li] for k, v in cache[name].items()})
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        return lm_head(params["embed"], x[:, -1:]), cache

    def decode(self, params: PyTree, cache: PyTree, tokens: torch.Tensor,
               pos) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B,1) -> (logits (B,1,V), cache). ``pos``: the tokens'
        absolute position, an int shared by the rows or a (B,) int tensor
        of per-row positions (ragged decode; see ``attention_decode``;
        recurrent sub-layers do not read it). The cache is updated in place
        and returned (a Mamba ``conv`` buffer first takes the dtype the
        reference's decode leaves it in: ``promote_states``)."""
        cfg = self.cfg
        kinds = _sub_kinds(cfg)
        promote_states(cache, cfg)
        x = embed(params, tokens, cfg)
        for li in range(_n_scan(cfg)):
            lp = layer_params(params["layers"], li)
            for i, (m, f) in enumerate(kinds):
                name = f"sub{i}"
                x = _sublayer_decode(lp[name], x, cfg, m, f,
                                     {k: v[li] for k, v in cache[name].items()},
                                     pos)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps)
        return lm_head(params["embed"], x), cache
