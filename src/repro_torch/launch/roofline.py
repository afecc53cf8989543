"""Roofline of one step on H100s, from the cost model's per-device counts.

Hardware constants (NVIDIA H100 SXM at its 700 W limit, the data sheet's
dense rates):
    bf16 tensor cores     989 TFLOP/s
    fp32 (no tensor core)  67 TFLOP/s
    HBM3                 3.35 TB/s
    NVLink                450 GB/s each way, all to all within a node of 8
    network                50 GB/s a GPU between nodes: one 400 Gb/s NDR
                           InfiniBand port a GPU, as a DGX H100 has

Terms (seconds a step; the counts are per device):

    compute    = FLOPs / peak (bf16, or fp32 for an fp32 model)
    memory     = bytes / HBM rate
    collective = intra-node collective bytes / NVLink
                 + inter-node collective bytes / network

with node = device id // 8. MODEL_FLOPS = 6·N_active·D for a train step
(2·N·D for prefill, 2·N·B for decode) over the GLOBAL tokens of a step;
MODEL_FLOPS / (FLOPs · chips) is the share of the counted work that is
"useful" (it shows remat, replicated fallbacks and attention).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.configs.base import InputShape, ModelConfig

PEAK_FLOPS = 989e12          # bf16 a GPU
PEAK_FLOPS_FP32 = 67e12      # fp32 a GPU, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s a GPU
NVLINK_BW = 450e9            # bytes/s each way, within a node
NET_BW = 50e9                # bytes/s a GPU between nodes (400 Gb/s NDR)
GPUS_PER_NODE = 8


def node_of(device_id: int) -> int:
    return device_id // GPUS_PER_NODE


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device counts of the cost model (the reference's "hlo_" names)
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    cross_pod_bytes: float
    # terms in seconds
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    # usefulness
    model_flops: float
    useful_ratio: float
    note: str = ""

    def to_dict(self) -> Dict:
        return asdict(self)


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched a token: MoE layers count top_k of num_experts.

    An expert has as many matrices as ``param_count`` gives it: three for
    the gated FFNs (silu and geglu). The reference's ``active_params``
    gives a geglu expert two, so for grok-1 it leaves a third of each
    inactive expert in and its model FLOPs exceed the step's own count."""
    total = cfg.param_count()
    if cfg.moe is None:
        return total
    m = cfg.moe
    mult = 3 if cfg.act in ("silu", "geglu") else 2
    per_expert = mult * cfg.d_model * cfg.d_ff
    n_moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    return total - n_moe_layers * (m.num_experts - m.top_k) * per_expert


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6·N_active·D with D the global tokens a step."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len  # forward only
    return 2.0 * n * shape.global_batch                       # one token


def build_report(arch: str, shape: InputShape, mesh_name: str, chips: int,
                 flops: float, bytes_: float, intra_node_bytes: float,
                 inter_node_bytes: float, cross_pod_bytes: float,
                 cfg: Optional[ModelConfig], note: str = "",
                 peak_flops: float = PEAK_FLOPS) -> RooflineReport:
    compute_s = flops / peak_flops
    memory_s = bytes_ / HBM_BW
    collective_s = intra_node_bytes / NVLINK_BW + inter_node_bytes / NET_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape) if cfg is not None else 0.0
    total = flops * chips
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=bytes_,
        collective_bytes=intra_node_bytes + inter_node_bytes,
        cross_pod_bytes=cross_pod_bytes, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, bottleneck=bottleneck,
        model_flops=mf, useful_ratio=(mf / total) if total > 0 else 0.0,
        note=note)


def format_table(reports) -> str:
    cols = ["arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
            "bottleneck", "useful_ratio"]
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for r in reports:
        d = r.to_dict() if hasattr(r, "to_dict") else r
        row = [f"{d[c]:.3e}" if isinstance(d[c], float) else str(d[c])
               for c in cols]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)
