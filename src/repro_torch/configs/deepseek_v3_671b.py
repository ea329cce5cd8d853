"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 + MTP.

61L, d_model=7168, 128 heads (MLA), vocab=129280. First 3 layers dense
(d_ff=18432); remaining 58 layers MoE with 256 routed experts (d_expert=2048,
sigmoid scoring, top-8, routed_scaling=2.5) + 1 shared expert. MLA:
q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128. MTP depth 1.
This is the model the SBS paper serves in production. [arXiv:2412.19437]
"""
from repro_torch.config.base import (
    AttentionKind, LayerKind, MLAConfig, ModelConfig, MoEConfig, register_arch,
)


@register_arch("deepseek-v3-671b")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="deepseek-v3-671b[reduced]", family="moe",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
            d_ff=512, vocab_size=512,
            attention=AttentionKind.MLA,
            mla=MLAConfig(q_lora_rank=128, kv_lora_rank=64,
                          qk_nope_head_dim=32, qk_rope_head_dim=16,
                          v_head_dim=32),
            layer_pattern=(LayerKind.MOE,), dense_prefix=1,
            moe=MoEConfig(num_experts=4, top_k=2, d_expert=128,
                          num_shared=1, d_shared=128,
                          score_fn="sigmoid", routed_scaling=2.5, capacity_factor=8.0),
            mtp_depth=1, max_seq_len=1024,
            source="arXiv:2412.19437",
        )
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
        d_ff=18432, vocab_size=129280,
        attention=AttentionKind.MLA,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        layer_pattern=(LayerKind.MOE,), dense_prefix=3,
        moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                      num_shared=1, d_shared=2048,
                      score_fn="sigmoid", routed_scaling=2.5),
        mtp_depth=1, max_seq_len=32768,
        source="arXiv:2412.19437",
    )
