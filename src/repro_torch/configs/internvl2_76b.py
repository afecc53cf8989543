"""internvl2-76b [vlm] — InternViT + (Llama3-70B-style) language backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The vision frontend
(InternViT-6B + MLP projector) is a STUB, as in the reference: the LM reads
precomputed patch embeddings ``batch["patches"]`` (B, num_patches, d_model)
as a prefix before the token embeddings.
"""
from repro_torch.configs.base import ModelConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    qkv_bias=False,
    act="silu",
    rope_theta=5e5,
    num_patches=256,
    source="InternVL2-Llama3-76B [arXiv:2404.16821]",
)


def reduced():
    return _reduced(CONFIG)
