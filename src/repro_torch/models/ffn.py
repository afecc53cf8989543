"""Dense feed-forward block: SwiGLU (gate, up, down)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import activation


def ffn_shapes(cfg) -> Dict[str, tuple]:
    d, dff = cfg.d_model, cfg.d_ff
    if cfg.act not in ("silu", "geglu"):
        raise NotImplementedError(
            f"act {cfg.act!r}: the serving slice ports the gated FFN only")
    return {"w_gate": (d, dff), "w_up": (d, dff), "w_down": (dff, d)}


def ffn_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    act = activation(cfg.act)
    h = act(x @ p["w_gate"].to(x.dtype))
    h = h * (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)
