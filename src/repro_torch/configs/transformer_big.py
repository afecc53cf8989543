"""transformer-big [paper's own NMT workload] — Vaswani et al. "big" [arXiv:1706.03762],
setup of Ott et al. [arXiv:1806.00187] on WMT'16 En-De, as used in Section 4.2.

6 enc + 6 dec blocks, d_model=1024 16H d_ff=4096 vocab=32768 (joint BPE).
"""
from repro_torch.configs.base import ModelConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="transformer-big",
    family="audio",  # reuses the enc-dec substrate; frontend is token embedding
    num_layers=6,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=32768,
    act="gelu",
    encoder_layers=6,
    num_audio_frames=0,  # 0 => encoder consumes source TOKENS, not stub frames
    source="Transformer big on WMT'16 En-De [arXiv:1706.03762, arXiv:1806.00187]",
)


def reduced():
    return _reduced(CONFIG)
