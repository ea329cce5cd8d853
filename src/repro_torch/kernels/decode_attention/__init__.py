from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_plain, decode_splits, dense_splits,
    paged_decode_attention, paged_decode_attention_plain,
)

__all__ = ["decode_attention", "decode_attention_plain", "decode_splits",
           "dense_splits", "paged_decode_attention",
           "paged_decode_attention_plain"]
