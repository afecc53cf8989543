"""Hand-written CUDA kernels of the serving slice (sources in ``csrc/``),
each with its plain PyTorch version beside it."""
from repro_torch.kernels._build import (launch_counts,  # noqa: F401
                                        reset_launch_counts)
from repro_torch.kernels.paged_attention import (  # noqa: F401
    NEG, paged_attention_decode, paged_attention_decode_plain)
from repro_torch.kernels.paged_cache import (  # noqa: F401
    is_quantized_dtype, paged_gather, paged_gather_plain, paged_scatter,
    paged_scatter_plain)
