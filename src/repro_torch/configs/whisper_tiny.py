"""whisper-tiny [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

4L (enc) + 4L (dec), d_model=384 6H (kv=6) d_ff=1536 vocab=51865 (padded to 51968).
The mel-spectrogram + conv feature extractor is a STUB, as in the reference:
the encoder reads precomputed frame embeddings ``batch["frames"]`` (B, 1500,
384), which ``EncDecLM`` serves through ``Engine.generate``.
"""
from repro_torch.configs.base import ModelConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    encoder_layers=4,
    num_audio_frames=1500,
    source="Whisper tiny [arXiv:2212.04356]",
)


def reduced():
    return _reduced(CONFIG)
