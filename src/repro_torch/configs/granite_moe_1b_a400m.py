"""granite-moe-1b-a400m [moe] — fine-grained MoE, 32 experts top-8.

24L, d_model=1024, 16 heads (GQA kv=8), d_expert=512, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.config.base import (
    AttentionKind, LayerKind, ModelConfig, MoEConfig, register_arch,
)


@register_arch("granite-moe-1b-a400m")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="granite-moe-1b-a400m[reduced]", family="moe",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
            d_ff=128, vocab_size=512,
            attention=AttentionKind.GQA,
            layer_pattern=(LayerKind.MOE,),
            moe=MoEConfig(num_experts=4, top_k=2, d_expert=128, capacity_factor=8.0),
            tie_embeddings=True, max_seq_len=512,
            source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        )
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        d_ff=512, vocab_size=49155,
        attention=AttentionKind.GQA,
        layer_pattern=(LayerKind.MOE,),
        moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
        tie_embeddings=True, max_seq_len=32768,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
