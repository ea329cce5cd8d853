"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L, d_model=3840, 32 heads (GQA kv=8), d_ff=10240, vocab=32000.
SWA window 4096 bounds the decode KV cache (ring buffer) => long_500k runs.
[arXiv:2401.16818]
"""
from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig, register_arch


@register_arch("h2o-danube-3-4b")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="h2o-danube-3-4b[reduced]", family="dense",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
            d_ff=512, vocab_size=512,
            attention=AttentionKind.SWA, sliding_window=64,
            layer_pattern=(LayerKind.DENSE,),
            max_seq_len=512,
            source="arXiv:2401.16818",
        )
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
        d_ff=10240, vocab_size=32000,
        attention=AttentionKind.SWA, sliding_window=4096,
        layer_pattern=(LayerKind.DENSE,),
        max_seq_len=524288,
        source="arXiv:2401.16818",
    )
