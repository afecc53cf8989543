"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536. One attention layer per
8 layers (the rest Mamba); MoE FFN every 2nd layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    act="silu",
    attn_layer_period=8,
    moe=MoEConfig(num_experts=16, top_k=2, layer_period=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="Jamba v0.1 [arXiv:2403.19887]",
)


def reduced():
    return _reduced(CONFIG)
