"""mamba2-370m [ssm] — attention-free, SSD (state-space duality).

48L, d_model=1024, no attention, no MLP (the Mamba block IS the layer),
vocab=50280, ssm_state=128. Decode state is O(1) per request => long_500k
runs. [arXiv:2405.21060]
"""
from repro_torch.config.base import (
    AttentionKind, LayerKind, ModelConfig, SSMConfig, register_arch,
)


@register_arch("mamba2-370m")
def make(reduced: bool = False) -> ModelConfig:
    if reduced:
        return ModelConfig(
            name="mamba2-370m[reduced]", family="ssm",
            num_layers=2, d_model=256, num_heads=0, num_kv_heads=0,
            d_ff=0, vocab_size=512,
            attention=AttentionKind.NONE,
            layer_pattern=(LayerKind.SSM,),
            ssm=SSMConfig(d_state=32, head_dim=32, expand=2, chunk_size=32),
            tie_embeddings=True, max_seq_len=1024,
            source="arXiv:2405.21060",
        )
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        attention=AttentionKind.NONE,
        layer_pattern=(LayerKind.SSM,),
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
        tie_embeddings=True, max_seq_len=1048576,
        source="arXiv:2405.21060",
    )
