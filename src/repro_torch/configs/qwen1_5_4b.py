"""qwen1.5-4b [dense] — QKV bias, MHA [hf:Qwen/Qwen1.5-0.5B family card].

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    act="silu",
    source="Qwen1.5-4B [hf:Qwen/Qwen1.5-4B]",
)


def reduced():
    return _reduced(CONFIG)
