"""deepseek-7b [dense] — plain llama-architecture dense model.

30L, d_model=4096, 32 heads (MHA: kv=32), d_ff=11008, vocab=102400.
[arXiv:2401.02954]
"""
from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig, register_arch


@register_arch("deepseek-7b")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="deepseek-7b[reduced]", family="dense",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
            d_ff=512, vocab_size=512,
            attention=AttentionKind.GQA,
            layer_pattern=(LayerKind.DENSE,),
            max_seq_len=512,
            source="arXiv:2401.02954",
        )
    return ModelConfig(
        name="deepseek-7b", family="dense",
        num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=11008, vocab_size=102400,
        attention=AttentionKind.GQA,
        layer_pattern=(LayerKind.DENSE,),
        max_seq_len=32768,
        source="arXiv:2401.02954",
    )
