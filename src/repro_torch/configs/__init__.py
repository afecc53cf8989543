"""Architecture config registry.

Knows every arch id of the reference's registry, so ``--arch`` spells the
same names; only the dense attention archs of the serving slice resolve.
The others raise ``NotImplementedError`` naming the slice that ports them.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401

_PORTED = {
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
}

# reference arch ids whose families (moe / hybrid / ssm / vlm / audio / conv,
# and dense archs not yet carried over) the port has not reached
_LATER = ("deepseek-67b", "internvl2-76b", "arctic-480b", "jamba-v0.1-52b",
          "grok-1-314b", "qwen1.5-4b", "whisper-tiny", "rwkv6-1.6b",
          "transformer-big", "resnet50", "wrn28x10")


def list_archs() -> List[str]:
    return list(_PORTED) + list(_LATER)


def _module(arch: str):
    if arch in _PORTED:
        return importlib.import_module(_PORTED[arch])
    if arch in _LATER:
        raise NotImplementedError(
            f"arch {arch!r} is not in the port yet: the serving slice carries "
            f"the dense archs {sorted(_PORTED)}; the other families come "
            "with ROADMAP Queue 1 item 11 (\"the rest\"), after the training "
            "slice")
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(list_archs())}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
