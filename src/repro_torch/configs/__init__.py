"""Architecture config registry.

Knows every arch id of the reference's registry, so ``--arch`` spells the
same names. The dense attention LMs, the MoE and hybrid families (grok-1,
arctic, jamba), the attention-free rwkv6 and the paper's own models
(resnet50, wrn28x10 and transformer-big) resolve; the VLM and audio archs
raise ``NotImplementedError`` naming the item that ports them.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (CodistConfig, ModelConfig,  # noqa: F401
                                      TrainConfig, reduced)

_PORTED = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    # the paper's own workloads
    "transformer-big": "repro_torch.configs.transformer_big",
    "resnet50": "repro_torch.configs.resnet50",
    "wrn28x10": "repro_torch.configs.wrn28_10",
}

# reference arch ids whose families (vlm / audio) the port has not reached
_LATER = ("internvl2-76b", "whisper-tiny")


def list_archs() -> List[str]:
    return list(_PORTED) + list(_LATER)


def _module(arch: str):
    if arch in _PORTED:
        return importlib.import_module(_PORTED[arch])
    if arch in _LATER:
        raise NotImplementedError(
            f"arch {arch!r} is not in the port yet: it carries "
            f"{sorted(_PORTED)}; the other families (vlm, audio) "
            "come with ROADMAP Queue 1 item 11 (11d-ii-b)")
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(list_archs())}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_reduced(arch: str):
    return _module(arch).reduced()
