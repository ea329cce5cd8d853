"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B-style LM backbone.

24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151655. The ViT
vision encoder + MLP projector is STUBbed: ``input_specs`` feeds
(B, 256, d_model) patch embeddings prepended to the text sequence.
[arXiv:2404.16821]
"""
from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig, register_arch


@register_arch("internvl2-1b")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="internvl2-1b[reduced]", family="vlm",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
            d_ff=512, vocab_size=512,
            attention=AttentionKind.GQA,
            layer_pattern=(LayerKind.DENSE,),
            num_patch_tokens=16, max_seq_len=512,
            rope_theta=1_000_000.0,
            source="arXiv:2404.16821",
        )
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=4864, vocab_size=151655,
        attention=AttentionKind.GQA,
        layer_pattern=(LayerKind.DENSE,),
        num_patch_tokens=256, max_seq_len=32768,
        rope_theta=1_000_000.0,
        source="arXiv:2404.16821",
    )
