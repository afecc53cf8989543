"""Dense feed-forward blocks: SwiGLU / GeGLU (gate, up, down) and the plain
two-matrix MLP (up, down)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import activation, stacked_dense


def ffn_shapes(cfg) -> Dict[str, tuple]:
    d, dff = cfg.d_model, cfg.d_ff
    if cfg.act in ("silu", "geglu"):
        return {"w_gate": (d, dff), "w_up": (d, dff), "w_down": (dff, d)}
    return {"w_up": (d, dff), "w_down": (dff, d)}


def init_stacked_ffn(cfg, n: int, generator: torch.Generator,
                     dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The FFN's matrices of n layers (gated: w_gate, w_up, w_down; plain:
    w_up, w_down); ``w_down`` scaled by 1 / sqrt(num_layers)."""
    down_scale = 1.0 / max(1, cfg.num_layers) ** 0.5
    return {name: stacked_dense(n, shape, shape[0], generator, dtype, device,
                                down_scale if name == "w_down" else 1.0)
            for name, shape in ffn_shapes(cfg).items()}


def ffn_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    # the reference maps act "relu" to gelu here
    act = activation(cfg.act if cfg.act != "relu" else "gelu")
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(x.dtype))
        h = h * (x @ p["w_up"].to(x.dtype))
    else:
        h = act(x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)
