"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    qkv_bias=False,
    act="silu",
    source="DeepSeek LLM 67B [arXiv:2401.02954]",
)


def reduced():
    return _reduced(CONFIG)
