"""qwen2-7b [dense] — GQA, QKV bias [arXiv:2407.10671].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    act="silu",
    rope_theta=1e6,
    source="Qwen2-7B [arXiv:2407.10671]",
)


def reduced():
    return _reduced(CONFIG)
