"""PyTorch/CUDA port of the codistillation system, slice 1: fleet serving.

A second package beside the JAX reference (``repro``), which it never
imports. This slice carries the serving path — ``launch/serve.py`` fleet
mode, ``FleetRouter`` -> ``FleetEngine`` -> ``PagedCachePool`` ->
``build_decode_step`` — for the dense attention LMs, with the three paged-KV
kernels of that path written by hand in CUDA C++ for Hopper (``csrc/``).

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
asking for CUDA without a card raises (nothing falls back to the CPU). On a
CPU tensor a kernel wrapper runs its plain PyTorch version, which is what
the CPU tests hold against the JAX reference.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
