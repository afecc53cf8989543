"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version beside it: the paged-KV kernels of the serving
slices (bf16 and quantized pools), the fused loss kernels of the training
slices (CE, CE + distillation, distillation alone) and the standalone
forward CE and flash attention."""
from repro_torch.kernels._build import (launch_counts,  # noqa: F401
                                        reset_launch_counts)
from repro_torch.kernels.combined_loss import (  # noqa: F401
    fused_ce_distill_grad, fused_ce_distill_grad_plain,
    fused_ce_distill_parts, fused_ce_distill_parts_plain)
from repro_torch.kernels.distill_loss import (  # noqa: F401
    fused_distill_kl_grad, fused_distill_kl_grad_plain, fused_distill_kl_parts,
    fused_distill_kl_parts_plain, fused_distill_loss, fused_distill_loss_plain,
    fused_distill_mse_grad, fused_distill_mse_grad_plain)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_plain)
from repro_torch.kernels.fused_ce import (  # noqa: F401
    fused_cross_entropy, fused_cross_entropy_grad,
    fused_cross_entropy_grad_plain, fused_cross_entropy_parts,
    fused_cross_entropy_parts_plain, fused_cross_entropy_plain)
from repro_torch.kernels.paged_attention import (  # noqa: F401
    NEG, paged_attention_decode, paged_attention_decode_plain)
from repro_torch.kernels.paged_cache import (  # noqa: F401
    QMAX, is_quantized_dtype, paged_gather, paged_gather_plain, paged_scatter,
    paged_scatter_kv, paged_scatter_kv_plain, paged_scatter_plain,
    paged_scatter_quant, paged_scatter_quant_kv, paged_scatter_quant_kv_plain,
    paged_scatter_quant_plain, quantize_rows, quantized_dtype_names)
