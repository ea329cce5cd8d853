from repro_torch.kernels.flash_prefill.ops import (
    flash_prefill, flash_prefill_plain, paged_prefill_attention,
    paged_prefill_attention_plain,
)

__all__ = ["flash_prefill", "flash_prefill_plain", "paged_prefill_attention",
           "paged_prefill_attention_plain"]
