"""Model registry: build a model object from a config, as the reference's
``build_model`` dispatches. An ``MLP`` is built directly by its callers."""
from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.models.conv import ConvConfig, ConvNet
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM, _sub_kinds


def build_model(cfg: Union[ModelConfig, ConvConfig]):
    """A ``ConvConfig`` gives ``ConvNet``, an enc-dec config ``EncDecLM``,
    any other ``LM`` (families outside the port raise)."""
    if isinstance(cfg, ConvConfig):
        return ConvNet(cfg)
    if cfg.is_encdec:
        return EncDecLM(cfg)
    _sub_kinds(cfg)
    return LM(cfg)
