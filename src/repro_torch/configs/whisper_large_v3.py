"""whisper-large-v3 [audio] — encoder-decoder transformer backbone.

32L decoder + 32L encoder, d_model=1280, 20 heads (MHA: kv=20), d_ff=5120,
vocab=51866. The mel-spectrogram + conv feature extractor is STUBbed:
``input_specs`` feeds (B, 1500, d_model) frame embeddings directly to the
encoder (the one allowed stub). [arXiv:2212.04356]
"""
from repro_torch.config.base import AttentionKind, LayerKind, ModelConfig, register_arch


@register_arch("whisper-large-v3")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="whisper-large-v3[reduced]", family="audio",
            num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
            d_ff=512, vocab_size=512,
            attention=AttentionKind.GQA,
            layer_pattern=(LayerKind.DENSE,),
            is_encoder_decoder=True, num_encoder_layers=2,
            encoder_seq_len=64, max_seq_len=256,
            source="arXiv:2212.04356",
        )
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        attention=AttentionKind.GQA,
        layer_pattern=(LayerKind.DENSE,),
        is_encoder_decoder=True, num_encoder_layers=32,
        encoder_seq_len=1500, max_seq_len=32768,
        source="arXiv:2212.04356",
    )
