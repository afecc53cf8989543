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
    if type(x) is not torch.Tensor and hasattr(x, "device_mesh"):
        return _ffn_placed(p, x, cfg)
    return _ffn(p, x, cfg)


def _ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    # the reference maps act "relu" to gelu here
    act = activation(cfg.act if cfg.act != "relu" else "gelu")
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(x.dtype))
        h = h * (x @ p["w_up"].to(x.dtype))
    else:
        h = act(x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def _ffn_placed(p: Dict[str, torch.Tensor], x, cfg):
    """``_ffn`` on each rank's own rows of the DTensor ``x`` through
    ``local_map``, in the Megatron layout the reference's rules give: the
    rows split as ``x``'s batch dim is, d whole, the hidden dim over
    "model" where every matrix of the block splits it there (w_gate, w_up
    by column, w_down by row; each gathered over its other mesh dims by
    ``common.whole_weight``), the output then a ``Partial`` sum over
    "model"; else every matrix whole. DTensor's own choice of layouts for
    these products searches strided shards of the rows, which took minutes
    a step once a rank holds one row."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models.common import whole_weight
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate()
                 for pl in x.placements)
    tp = names.index("model") if "model" in names else None
    f_dim = {n: 0 if n == "w_down" else 1 for n in p}
    split = tp is not None and mesh.size(tp) > 1 and all(
        w.placements[tp] == Shard(f_dim[n]) for n, w in p.items())

    names_w = list(p)
    w_in = [tuple(Shard(f_dim[n]) if split and i == tp else Replicate()
                  for i in range(mesh.ndim)) for n in names_w]
    w_grad = [tuple(Partial() if r == Shard(0) else w
                    for r, w in zip(rows, pl)) for pl in w_in]
    out = tuple(Partial() if split and i == tp else r
                for i, r in enumerate(rows))
    if tuple(x.placements) != rows:
        x = x.redistribute(mesh, rows)

    def fn(xl, *ws):
        return _ffn(dict(zip(names_w, ws)), xl, cfg)
    return local_map(fn, out_placements=(out,),
                     in_placements=(rows, *w_in),
                     in_grad_placements=(out, *w_grad), device_mesh=mesh)(
        x, *(whole_weight(p[n], pl) for n, pl in zip(names_w, w_in)))
