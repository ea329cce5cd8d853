"""minicpm3-4b [dense] — MLA (multi-head latent attention).

62L, d_model=2560, 40 heads, d_ff=6400, vocab=73448. MLA dims follow the
model card: q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32,
v_head=64. Decode KV cache stores only the compressed latent + rope key.
[hf:openbmb/MiniCPM3-4B]
"""
from repro_torch.config.base import (
    AttentionKind, LayerKind, MLAConfig, ModelConfig, register_arch,
)


@register_arch("minicpm3-4b")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="minicpm3-4b[reduced]", family="dense",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
            d_ff=512, vocab_size=512,
            attention=AttentionKind.MLA,
            mla=MLAConfig(q_lora_rank=128, kv_lora_rank=64,
                          qk_nope_head_dim=32, qk_rope_head_dim=16,
                          v_head_dim=32),
            layer_pattern=(LayerKind.DENSE,),
            tie_embeddings=True, max_seq_len=512,
            source="hf:openbmb/MiniCPM3-4B",
        )
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=6400, vocab_size=73448,
        attention=AttentionKind.MLA,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
        layer_pattern=(LayerKind.DENSE,),
        tie_embeddings=True, max_seq_len=32768,
        source="hf:openbmb/MiniCPM3-4B",
    )
