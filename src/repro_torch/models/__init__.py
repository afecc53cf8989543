"""Model registry: the dense decoder LM of the port."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import LM, _sub_kinds


def build_model(cfg: ModelConfig) -> LM:
    _sub_kinds(cfg)          # raises for families outside the port
    return LM(cfg)
