"""KV-cache dtype policy of the serving engines.

The dense ``Engine`` (batched ``generate``) is not in the serving slice;
its dtype policy is, because the fleet resolves ``--cache-dtype`` through it.
"""
from __future__ import annotations

from typing import Optional

import torch


def default_cache_dtype(device="cuda") -> torch.dtype:
    """bf16 KV caches on the card (halves the dominant serving tensor);
    fp32 on the CPU, where the tests want reference numerics — the
    reference's TPU / interpret split."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


_NAMES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
          "fp32": torch.float32, "float32": torch.float32,
          "fp16": torch.float16, "float16": torch.float16}
_QUANTIZED = ("int8", "fp8", "float8_e4m3fn")


def resolve_cache_dtype(name: Optional[str], device="cuda") -> torch.dtype:
    """CLI spelling -> dtype; None/'auto' defers to ``default_cache_dtype``.
    The quantized pool dtypes (int8, fp8) raise ``NotImplementedError``:
    their scatter-quant kernel and dequantizing decode come in the next
    slice."""
    if name is None or name == "auto":
        return default_cache_dtype(device)
    if name in _QUANTIZED:
        raise NotImplementedError(
            f"cache dtype {name!r}: quantized KV pools (paged_scatter_quant "
            "and the dequantizing decode kernel) come in the next serving "
            "slice (ROADMAP Queue 2, rows 1q and 4)")
    if name not in _NAMES:
        raise ValueError(f"unknown cache dtype {name!r}; valid names: auto, "
                         f"{', '.join([*_NAMES, *_QUANTIZED])}")
    return _NAMES[name]
