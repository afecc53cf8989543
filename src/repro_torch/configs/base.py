"""Model, codistillation and training configs, and the reduced-variant rule.

The fields, ``padded_vocab``, ``resolved_head_dim`` and ``reduced()`` are
those of the reference's ``configs/base.py``; ``activation_dtype`` is a
``torch.dtype`` here. ``MoEConfig``, ``SSMConfig`` and ``RWKVConfig`` are
the reference's (grok-1, arctic, jamba and rwkv6 run in the port). The
conv nets' config
is ``models.conv.ConvConfig``, as in the reference. ``CodistConfig`` and
``TrainConfig`` are the reference's field for field, with its defaults;
``param_count``, ``attention_free``, ``InputShape`` and ``INPUT_SHAPES``
are its arithmetic and its four dry-run shapes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

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
class MoEConfig:
    num_experts: int
    top_k: int = 2
    # period (in layers) at which FFN blocks are MoE; 1 => every layer
    layer_period: int = 1
    # Arctic-style dense FFN residual running in parallel with the experts
    dense_residual: bool = False
    # weight of the auxiliary load-balance loss (Switch-style)
    load_balance_weight: float = 0.01
    # router jitter for training (the reference's LM never passes the key
    # that turns it on)
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM parameters (used by hybrid archs)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) parameters."""
    head_dim: int = 64
    # low-rank sizes for the data-dependent decay / token-shift mixers
    decay_lora: int = 64
    mix_lora: int = 32


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
    act: str = "silu"  # silu => SwiGLU, geglu => gated tanh-GeLU
    # attention variant: 0 => full causal; >0 => sliding window of that size
    sliding_window: int = 0
    # hybrid (jamba): one attention layer every `attn_layer_period` layers
    # (the rest Mamba); 0 => all layers are attention
    attn_layer_period: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
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

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

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

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), used by the comm
        model and the roofline; the reference's arithmetic, its cross-
        attention bookkeeping included (one more attention per encoder
        layer)."""
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        n = v * d                                   # token embedding
        if not self.tie_embeddings:
            n += v * d                              # lm head

        def attn_params() -> int:
            p = (d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                 + (self.num_heads * hd) * d)
            if self.qkv_bias:
                p += (self.num_heads + 2 * self.num_kv_heads) * hd
            return p

        def dense_ffn(dff: int) -> int:
            mult = 3 if self.act in ("silu", "geglu") else 2
            return mult * d * dff

        def moe_ffn() -> int:
            m = self.moe
            p = m.num_experts * dense_ffn(self.d_ff) + d * m.num_experts
            if m.dense_residual:
                p += dense_ffn(self.d_ff)
            return p

        def ssm_params() -> int:
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            dt_rank = s.dt_rank or -(-d // 16)
            return (d * 2 * d_in                     # in_proj
                    + d_in * s.d_conv                # depthwise conv
                    + d_in * (dt_rank + 2 * s.d_state)   # x_proj
                    + dt_rank * d_in + d_in          # dt_proj
                    + d_in * s.d_state + d_in        # A_log, D
                    + d_in * d)                      # out_proj

        def rwkv_params() -> int:
            r = self.rwkv or RWKVConfig()
            return (4 * d * d + d * d                # r, k, v, o + gate
                    + r.decay_lora * d * 2 + d       # decay lora + base
                    + 5 * (d * r.mix_lora + r.mix_lora * d)  # shift mixers
                    + 2 * d * self.d_ff              # channel mix (k, v)
                    + d * d)                         # channel mix receptance

        for i in range(self.num_layers):
            if self.family == "ssm":
                n += rwkv_params() if self.rwkv is not None else ssm_params()
            elif self.layer_kind(i) == "ssm":
                n += ssm_params()
            else:
                n += attn_params()
            if self.family != "ssm" or self.rwkv is None:
                n += moe_ffn() if self.is_moe_layer(i) else dense_ffn(self.d_ff)
            n += 2 * d                               # norms
        for _ in range(self.encoder_layers):
            n += attn_params() + dense_ffn(self.d_ff) + 2 * d
            n += attn_params()   # decoder cross-attention (bookkeeping)
        return n


@dataclass(frozen=True)
class CodistConfig:
    """Algorithm 1 + Section 3 implementation options."""
    n_models: int = 2
    # 'predictions' (coordinated sampling, logits exchange) or 'checkpoints'
    mode: str = "predictions"
    # communicate every T steps; off-steps drop the distillation term
    # (predictions) or reuse the stale replica (checkpoints)
    period: int = 1
    # distillation loss D: 'mse' (paper's experiments), 'kl', or 'ce'
    distill_loss: str = "mse"
    # penalty coefficient schedule: alpha^k = alpha0 * growth^(epoch k)
    alpha0: float = 1.0
    alpha_growth: float = 1.0  # paper: 1.0 vision, 1.1/epoch NMT
    steps_per_epoch: int = 1
    # warm-up steps before the distillation term switches on
    burn_in_steps: int = 0
    # ---- beyond-paper exchange compression ----
    # 'none' | 'topk' | 'bf16' | 'subsample'
    compression: str = "none"
    topk: int = 64
    subsample: int = 0  # tokens per sequence used for the distill term
    # beyond-paper: use previous step's peer logits (removes the sync point)
    pipelined: bool = False


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    lr_schedule: str = "cosine"  # 'step' | 'cosine' | 'constant'
    warmup_steps: int = 100
    total_steps: int = 1000
    step_milestones: Tuple[float, ...] = (0.5, 0.75, 0.9)  # fractions of total
    step_decay: float = 0.1
    weight_decay: float = 1e-4
    # paper: decay WD at LR milestones (5e-4 -> 1e-5 -> 0)
    weight_decay_schedule: Tuple[float, ...] = ()
    label_smoothing: float = 0.0
    label_smoothing_decay: bool = False
    optimizer: str = "sgdm"  # 'sgdm' | 'adamw' (the CLI defaults to adamw)
    momentum: float = 0.9
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    grad_clip: float = 0.0
    seed: int = 0
    microbatch: int = 0  # 0 => no gradient accumulation
    remat: bool = False
    opt_dtype: str = "float32"    # optimizer moment buffers
    accum_dtype: str = "float32"  # microbatch gradient accumulators
    # Every training-step loss (task CE + distill D) through the fused loss
    # kernels of repro_torch.kernels.ops. None => auto: on for CUDA, off on
    # the CPU, where forcing True runs the kernels' plain versions.
    fused_losses: Optional[bool] = None


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
