from repro_torch.kernels.ssd_scan.ops import (
    ssd_chunk, ssd_chunk_plain, ssd_chunk_train,
)

__all__ = ["ssd_chunk", "ssd_chunk_plain", "ssd_chunk_train"]
