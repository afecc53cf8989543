"""Small MLP classifier — the controlled model of the Section-5.1 multi-view
experiments (each codistilling model sees one VIEW of the features).

The tree is the reference's: ``w{i}`` (in, out) and ``b{i}`` (out,) per
layer, fp32; relu between layers, fp32 logits. On a mesh (features placed
by rows, the weights replicated by the rules) the products run through
DTensor's own dispatch, each rank on its own rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models.common import dense_init_

PyTree = Any


@dataclass(frozen=True)
class MLPConfig:
    name: str = "mlp"
    in_dim: int = 128
    hidden: Tuple[int, ...] = (256, 256)
    num_classes: int = 10
    kind: str = "mlp"  # marks the non-LM path for the train steps

    @property
    def family(self) -> str:
        return "mlp"


@dataclass(frozen=True)
class MLP:
    cfg: MLPConfig

    def init(self, generator: torch.Generator, device="cuda") -> PyTree:
        """Truncated-normal fan-in weights and zero biases, fp32 (empty
        stand-ins on ``device="meta"``)."""
        dev = resolve_device(device, meta=True)
        dims = (self.cfg.in_dim, *self.cfg.hidden, self.cfg.num_classes)
        params: Dict[str, torch.Tensor] = {}
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            params[f"w{i}"] = dense_init_(torch.empty((a, b), device=dev), a,
                                          generator)
        for i, b in enumerate(dims[1:]):
            params[f"b{i}"] = torch.zeros(b, device=dev)
        return params

    def forward(self, params: PyTree,
                batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch["features"] (B, in_dim) -> (logits (B, classes), aux 0)."""
        x = batch["features"].float()
        n = len(self.cfg.hidden) + 1
        for i in range(n):
            x = x @ params[f"w{i}"] + params[f"b{i}"]
            if i < n - 1:
                x = torch.relu(x)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
