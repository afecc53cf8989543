"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536. 32 heads of dim 64 in the WKV time-mix.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,   # wkv heads = d_model / rwkv.head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    act="relu",  # rwkv channel-mix uses squared relu
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    source="RWKV-6 Finch 1.6B [arXiv:2404.05892]",
)


def reduced():
    return _reduced(CONFIG)
