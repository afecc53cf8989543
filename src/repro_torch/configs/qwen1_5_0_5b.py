"""qwen1.5-0.5b [dense] — QKV bias, MHA [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    act="silu",
    tie_embeddings=True,
    source="Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]",
)


def reduced():
    return _reduced(CONFIG)
