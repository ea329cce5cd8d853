"""minicpm-2b [dense] — llama-like, trained with the WSD schedule.

40L, d_model=2304, 36 heads (MHA: kv=36), d_ff=5760, vocab=122753.
The WSD (warmup-stable-decay) schedule is implemented in repro.train.schedule.
[arXiv:2404.06395]
"""
from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig, register_arch


@register_arch("minicpm-2b")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="minicpm-2b[reduced]", family="dense",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
            d_ff=512, vocab_size=512,
            attention=AttentionKind.GQA,
            layer_pattern=(LayerKind.DENSE,),
            tie_embeddings=True, max_seq_len=512,
            source="arXiv:2404.06395",
        )
    return ModelConfig(
        name="minicpm-2b", family="dense",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        attention=AttentionKind.GQA,
        layer_pattern=(LayerKind.DENSE,),
        tie_embeddings=True, max_seq_len=32768,
        source="arXiv:2404.06395",
    )
