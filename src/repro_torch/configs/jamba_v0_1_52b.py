"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=65536.
Jamba block structure (period 8): attention at offset 4, MoE at every other
layer (offset 1). Jamba-v0.1 uses Mamba-1 blocks (d_state=16); we implement
the SSM block with the Mamba2/SSD formulation (d_state=16 kept) — noted as a
hardware adaptation in DESIGN.md. [arXiv:2403.19887]
"""
from repro_torch.config.base import (
    AttentionKind, LayerKind, ModelConfig, MoEConfig, SSMConfig, register_arch,
)

_PATTERN = (
    LayerKind.SSM, LayerKind.SSM_MOE, LayerKind.SSM, LayerKind.SSM_MOE,
    LayerKind.DENSE, LayerKind.SSM_MOE, LayerKind.SSM, LayerKind.SSM_MOE,
)


@register_arch("jamba-v0.1-52b")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="jamba-v0.1-52b[reduced]", family="hybrid",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
            d_ff=512, vocab_size=512,
            attention=AttentionKind.GQA,
            layer_pattern=(LayerKind.SSM_MOE, LayerKind.DENSE),
            moe=MoEConfig(num_experts=4, top_k=2, d_expert=512, capacity_factor=8.0),
            ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk_size=32),
            max_seq_len=1024,
            source="arXiv:2403.19887",
        )
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        attention=AttentionKind.GQA,
        layer_pattern=_PATTERN,
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk_size=256),
        max_seq_len=524288,
        source="arXiv:2403.19887",
    )
