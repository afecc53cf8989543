"""Model config dataclass and the reduced-variant rule.

The fields, ``padded_vocab``, ``resolved_head_dim`` and ``reduced()`` are
those of the reference's ``configs/base.py``; ``activation_dtype`` is a
``torch.dtype`` here. Family-specific sub-configs (moe / ssm / rwkv) stay
opaque: this slice serves the dense attention archs only.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype name {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio | conv
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"  # silu => SwiGLU
    sliding_window: int = 0
    attn_layer_period: int = 0
    moe: Optional[Any] = None
    ssm: Optional[Any] = None
    rwkv: Optional[Any] = None
    encoder_layers: int = 0
    num_audio_frames: int = 1500
    num_patches: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 256
    max_position: int = 1 << 20
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_layer_period > 0:
            p = self.attn_layer_period
            return "attn" if (i % p) == (p - 1) else "ssm"
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.layer_period) == (self.moe.layer_period - 1)


def reduced(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (the reference's rule)."""
    kw: dict[str, Any] = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        max_position=65536,
        dtype="float32",
    )
    hd = 32
    heads = max(2, min(4, cfg.num_heads))
    kv = heads if cfg.num_kv_heads >= cfg.num_heads else max(1, heads // 2)
    kw.update(num_heads=heads, num_kv_heads=kv, head_dim=hd)
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, num_experts=min(4, cfg.moe.num_experts))
    if cfg.attn_layer_period:
        kw["attn_layer_period"] = 2
        kw["num_layers"] = 2
    if cfg.rwkv is not None:
        kw["rwkv"] = replace(cfg.rwkv, head_dim=32, decay_lora=16, mix_lora=8)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["num_audio_frames"] = 64
    if cfg.num_patches:
        kw["num_patches"] = 16
    if cfg.sliding_window:
        kw["sliding_window"] = min(cfg.sliding_window, 64)
    kw.update(overrides)
    return replace(cfg, **kw)
