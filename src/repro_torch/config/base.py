"""Config system: model/parallel/serving/train configs + architecture registry.

Every assigned architecture registers a ``ModelConfig`` factory under its id;
``get_arch(name)`` returns the full config, ``get_arch(name, reduced=True)``
returns the ≤2-layer smoke variant of the same family.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Dict, List, Optional, Tuple


class AttentionKind(str, enum.Enum):
    GQA = "gqa"            # grouped-query (covers MHA when kv==heads)
    MLA = "mla"            # multi-head latent attention (DeepSeek)
    SWA = "swa"            # sliding-window GQA
    NONE = "none"          # attention-free layer (SSM)


class LayerKind(str, enum.Enum):
    DENSE = "dense"        # attention + dense MLP
    MOE = "moe"            # attention + MoE MLP
    SSM = "ssm"            # Mamba2 SSD block (+ dense or MoE MLP optional)
    SSM_MOE = "ssm_moe"    # Mamba2 block with MoE MLP (jamba)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0              # per-expert FFN hidden dim
    num_shared: int = 0            # shared (always-on) experts
    d_shared: int = 0              # shared-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    routed_scaling: float = 1.0    # deepseek-v3 routed_scaling_factor
    score_fn: str = "softmax"      # "softmax" | "sigmoid" (deepseek-v3)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1              # B/C projection groups (mamba2)
    chunk_size: int = 256
    # n_heads = d_model * expand // head_dim (derived)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 0           # 0 => no q compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    attention: AttentionKind = AttentionKind.GQA
    # layer_pattern: maps layer index -> LayerKind. Encoded as a repeating
    # pattern tuple applied cyclically, plus an optional dense prefix
    # (deepseek-v3 uses 3 dense layers then MoE).
    layer_pattern: Tuple[LayerKind, ...] = (LayerKind.DENSE,)
    dense_prefix: int = 0
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    mla: MLAConfig = MLAConfig()
    sliding_window: int = 0        # SWA window (tokens); 0 => full attention
    rope_theta: float = 10000.0
    max_seq_len: int = 32768
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # encoder-decoder (whisper): encoder layers use self-attn only; decoder
    # layers add cross-attention to encoder output.
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0       # fixed frontend length (whisper frames)
    # VLM: prefix of patch embeddings injected before text tokens.
    num_patch_tokens: int = 0
    # Multi-token prediction (deepseek-v3): extra MTP depth.
    mtp_depth: int = 0
    # activation dtype for large-scale lowering
    dtype: str = "bfloat16"
    source: str = ""               # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def layer_kind(self, i: int) -> LayerKind:
        if i < self.dense_prefix:
            return LayerKind.DENSE
        j = i - self.dense_prefix
        return self.layer_pattern[j % len(self.layer_pattern)]

    def layer_kinds(self) -> List[LayerKind]:
        return [self.layer_kind(i) for i in range(self.num_layers)]

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state is bounded (SSM/hybrid/SWA) => long_500k ok."""
        kinds = set(self.layer_kinds())
        has_full_attn = any(
            k in (LayerKind.DENSE, LayerKind.MOE) for k in kinds
        ) and self.attention in (AttentionKind.GQA, AttentionKind.MLA)
        if self.attention == AttentionKind.SWA and self.sliding_window > 0:
            return True
        if not has_full_attn:
            return True  # pure SSM
        # hybrid: attention layers exist but are a small fraction; decode KV
        # grows linearly yet stays feasible — the task assigns jamba to run.
        n_attn = sum(
            1 for i in range(self.num_layers)
            if self.layer_kind(i) in (LayerKind.DENSE, LayerKind.MOE)
            and self.attention != AttentionKind.NONE
        )
        return self.family == "hybrid" and n_attn * 4 <= self.num_layers

    # ---- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----
    def param_counts(self) -> Dict[str, float]:
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        nh, nkv = self.num_heads, self.num_kv_heads
        embed = v * d * (1 if self.tie_embeddings else 2)
        total = embed
        active = embed
        enc_layers = self.num_encoder_layers if self.is_encoder_decoder else 0
        for i in range(self.num_layers + enc_layers):
            is_enc = i >= self.num_layers
            kind = LayerKind.DENSE if is_enc else self.layer_kind(i)
            # attention params
            if kind in (LayerKind.DENSE, LayerKind.MOE):
                if self.attention == AttentionKind.MLA and not is_enc:
                    m = self.mla
                    qin = m.q_lora_rank or d
                    attn = 0.0
                    if m.q_lora_rank:
                        attn += d * m.q_lora_rank
                    attn += qin * nh * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    attn += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    attn += m.kv_lora_rank * nh * (m.qk_nope_head_dim + m.v_head_dim)
                    attn += nh * m.v_head_dim * d
                else:
                    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                if is_enc or (self.is_encoder_decoder and not is_enc):
                    pass
                if self.is_encoder_decoder and not is_enc:
                    attn *= 2  # + cross attention
            elif kind in (LayerKind.SSM, LayerKind.SSM_MOE):
                di = d * self.ssm.expand
                nheads = di // self.ssm.head_dim
                attn = (
                    d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state + nheads)
                    + (di + 2 * self.ssm.n_groups * self.ssm.d_state) * self.ssm.d_conv
                    + di * d
                )
            else:
                attn = 0.0
            # mlp params
            if kind in (LayerKind.MOE, LayerKind.SSM_MOE) and self.moe.num_experts:
                mc = self.moe
                per_exp = 3 * d * mc.d_expert
                mlp_total = mc.num_experts * per_exp + d * mc.num_experts
                mlp_total += mc.num_shared * 3 * d * mc.d_shared
                mlp_active = mc.top_k * per_exp + d * mc.num_experts
                mlp_active += mc.num_shared * 3 * d * mc.d_shared
            elif kind in (LayerKind.DENSE,):
                mlp_total = mlp_active = 3 * d * self.d_ff
            elif kind == LayerKind.SSM and self.d_ff:
                mlp_total = mlp_active = 3 * d * self.d_ff
            else:
                mlp_total = mlp_active = 0.0
            total += attn + mlp_total
            active += attn + mlp_active
        return {"total": float(total), "active": float(active)}


# ---------------------------------------------------------------------------
# Parallel / serving / train configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the device mesh.

    Axes: optional "pod" (slowest), "data" (batch / sequence / FSDP),
    "model" (TP heads / ff, EP experts).
    """
    data_axes: Tuple[str, ...] = ("data",)     # batch sharding axes
    model_axis: str = "model"
    expert_axes: Tuple[str, ...] = ("model",)  # expert-dim sharding (EP)
    fsdp_params: bool = False                  # shard params over data too
    fsdp_axes: Tuple[str, ...] = ("data",)
    shard_seq_for_decode: bool = True          # long-context: KV seq on data
    remat: str = "block"                       # none | block | full
    zero1: bool = True                         # shard optimizer state on data


# default paged batch rows per padded-equivalent slot: the ONE source of
# the 2× rule — ServingConfig.resolved_decode_slots (scheduler admission)
# and EngineSpec.paged_slots (engine batch rows) both derive from it, so
# the scheduler can never hand out more slots than the engine allocates
PAGED_SLOTS_FACTOR = 2


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """SBS scheduler + cluster parameters (paper §4 / §5)."""
    # cluster topology (paper: 3P1D, prefill TP4/DP8, decode DP32)
    num_prefill_instances: int = 3
    num_decode_instances: int = 1
    prefill_dp_per_instance: int = 8
    decode_dp_per_instance: int = 32
    chunk_size: int = 3072                  # C_chunk (paper: 3K/5K/16K)
    # Algorithm 1
    window_size: int = 32                   # W_size sliding window
    l_net: float = 0.002                    # network latency (s)
    t_default: float = 0.25                 # T_default initial forward time
    # Algorithm 2
    n_limit: int = 8                        # max waiting cycles before throttle
    cache_aware: bool = False
    # Algorithm 3
    iqr_k: float = 1.5
    # sync protocol
    watchdog_multiplier: float = 5.0
    # decode capacity
    max_batch_per_dp: int = 64
    kv_budget_tokens: int = 200_000         # per-DP KV token budget
    # paged KV cache (0 = padded max_len slots).  With paging on, decode
    # admission is gated by free KV *blocks* (block_size tokens each)
    # instead of free slots, so a DP holds more concurrent requests at
    # the same memory budget; max_batch_per_dp keeps its meaning as the
    # padded-equivalent memory budget (slots × max_len tokens).
    block_size: int = 0
    decode_slots_per_dp: int = 0            # 0 => auto (see resolved_decode_slots)
    # SLO-aware overload control.  `preemption` arms page-level decode
    # preemption: when a waiter cannot be admitted (real plane: free
    # blocks short; sim plane: KV budget exceeded), lower-priority
    # residents are swapped out (KV parked with generation state) and
    # re-admitted through the normal join path when pressure drops.
    # `flow_control` arms the runtime's arrival gate: while the decode
    # pool is saturated, arrivals are throttled (re-queued with
    # exponential backoff) and eventually rejected, least-urgent
    # priority class first.  `slo_default` is the E2E deadline used for
    # goodput when a request carries no per-class slo_e2e.
    preemption: bool = False
    flow_control: bool = False
    flow_backoff: float = 0.05
    slo_default: float = 20.0
    # Unified mixed-batch plane (Sarathi-style piggybacking).  With
    # `mixed_batch` on, the deployment runs ONE pool of unified engines:
    # prompts are admitted directly to the decode plane and their
    # chunked-prefill work rides the leftover per-step token budget
    # (`mixed_chunk − decode_rows`) of the SAME forward pass the decode
    # rows run in, so decode never stalls behind a prefill pass.
    # `prefill_starve_limit` bounds lockout: after that many consecutive
    # steps where pending prefill got zero budget, the next step grants
    # a chunk regardless of decode load.  `mixed_piggyback=False` is the
    # ablation leg (disjoint steps on the same engine: a step runs
    # EITHER the pending prefill chunk OR the decode rows) used by the
    # real-plane A/B.
    mixed_batch: bool = False
    mixed_chunk: int = 0                    # per-DP step token budget (0 => chunk_size)
    prefill_starve_limit: int = 4
    mixed_piggyback: bool = True
    # Length-bucketed batch formation (BucketServe) inside the SBS
    # buffering window: queued prompts are grouped by padded-length
    # class (`ceil(input_len / bucket_size)`) and a dispatch draws from
    # whole buckets — starved buckets (held back `bucket_max_wait`
    # dispatch cycles) first, then densest — so co-batched prompts pad
    # to a common boundary instead of the batch max.  0 disables.
    bucket_size: int = 0
    bucket_max_wait: int = 4

    def __post_init__(self):
        if self.decode_slots_per_dp and not self.block_size:
            # paged-only knob: on the padded plane slots ARE the memory
            # (max_batch_per_dp × max_len), so a divergent slot count
            # would let the scheduler admit more than engines allocate
            raise ValueError(
                "decode_slots_per_dp requires block_size > 0 (padded "
                "slots are fixed by max_batch_per_dp)")
        if self.mixed_chunk and not self.mixed_batch:
            raise ValueError(
                "mixed_chunk is only meaningful with mixed_batch=True")

    @property
    def resolved_mixed_chunk(self) -> int:
        """Per-DP token budget of one unified step: decode rows cost one
        token each, the remainder is the prefill piggyback allowance."""
        return self.mixed_chunk or self.chunk_size

    @property
    def resolved_decode_slots(self) -> int:
        """Batch rows per decode DP.  Padded: one row per max_len slot
        (max_batch_per_dp).  Paged: default PAGED_SLOTS_FACTOR× — rows
        are cheap (the KV memory lives in the shared block pool), the
        real gate is the free-block count."""
        if self.decode_slots_per_dp:
            return self.decode_slots_per_dp
        if self.block_size:
            return self.max_batch_per_dp * PAGED_SLOTS_FACTOR
        return self.max_batch_per_dp


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "wsd"                  # wsd | cosine | constant
    warmup_steps: int = 100
    stable_frac: float = 0.8               # WSD stable fraction
    total_steps: int = 1000
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                              # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[bool], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[bool], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str, reduced: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populate registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](reduced)


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
