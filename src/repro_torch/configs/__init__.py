"""Architecture config registry.

Knows every arch id of the reference's registry, so ``--arch`` spells the
same names: the dense attention LMs, the MoE and hybrid families (grok-1,
arctic, jamba), the attention-free rwkv6, the VLM internvl2 (a patch
prefix), the audio whisper-tiny (enc-dec over frames) and the paper's own
models (resnet50, wrn28x10 and transformer-big).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (INPUT_SHAPES,  # noqa: F401
                                      CodistConfig, InputShape, ModelConfig,
                                      MoEConfig, RWKVConfig, SSMConfig,
                                      TrainConfig, reduced)

_PORTED = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    # the paper's own workloads
    "transformer-big": "repro_torch.configs.transformer_big",
    "resnet50": "repro_torch.configs.resnet50",
    "wrn28x10": "repro_torch.configs.wrn28_10",
}


# the ten assigned architectures (the dry run's coverage), in the
# reference's order
ASSIGNED_ARCHS: List[str] = [
    "deepseek-67b", "qwen2-7b", "internvl2-76b", "qwen1.5-0.5b", "arctic-480b",
    "jamba-v0.1-52b", "grok-1-314b", "qwen1.5-4b", "whisper-tiny", "rwkv6-1.6b",
]


def list_archs() -> List[str]:
    return list(_PORTED)


def _module(arch: str):
    if arch in _PORTED:
        return importlib.import_module(_PORTED[arch])
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(list_archs())}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_reduced(arch: str):
    return _module(arch).reduced()
