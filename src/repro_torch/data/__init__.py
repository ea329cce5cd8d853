from repro_torch.data.synthetic import SyntheticLM, synthetic_batches
from repro_torch.data.packing import pack_documents

__all__ = ["SyntheticLM", "synthetic_batches", "pack_documents"]
