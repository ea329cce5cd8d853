"""Roofline-derived engine cost model (hardware adaptation, DESIGN.md §3).

The paper measures wall-clock on H800s; this container has no accelerator,
so the discrete-event simulator prices every forward pass with the same
three-term roofline used in §Roofline of EXPERIMENTS.md, instantiated for
the TPU v5e target:

    peak 197 TFLOP/s bf16 / chip,  819 GB/s HBM / chip,  ~50 GB/s/link ICI.

Prefill pass time  = max(FLOPs/(chips·peak·eff), bytes/(chips·bw)) + t_sync
Decode step time   = max(compute, weights+KV bytes / bw) + t_sync

The DP+EP synchronization barrier (§3.3) appears as max() over per-DP times
at the instance level — stragglers stall the whole instance.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.config.base import ModelConfig

PEAK_FLOPS = 197e12          # bf16 per chip
HBM_BW = 819e9               # bytes/s per chip
ICI_BW = 50e9                # bytes/s per link


@dataclasses.dataclass
class CostModel:
    cfg: ModelConfig
    chips_per_prefill_dp: int = 4     # paper: prefill TP=4 per DP unit
    chips_per_decode_dp: int = 1      # paper: decode TP=1
    decode_ep_size: int = 32          # expert weights sharded over EP group
    mfu: float = 0.55                 # achievable fraction of peak (prefill)
    mbu: float = 0.75                 # achievable fraction of HBM bw (decode)
    t_sync: float = 0.004             # per-pass sync/all-to-all overhead (s)
    avg_ctx: int = 2048               # mean context for attention flops
    a2a_bytes_per_token: Optional[int] = None  # MoE dispatch+combine bytes
    kv_bytes_per_token: Optional[int] = None
    param_bytes: Optional[float] = None
    active_param_bytes: Optional[float] = None

    def __post_init__(self):
        pc = self.cfg.param_counts()
        if self.param_bytes is None:
            self.param_bytes = pc["total"] * 2.0           # bf16
        if self.active_param_bytes is None:
            self.active_param_bytes = pc["active"] * 2.0
        if self.kv_bytes_per_token is None:
            self.kv_bytes_per_token = self._kv_bytes_per_token()
        if self.a2a_bytes_per_token is None:
            self.a2a_bytes_per_token = self._a2a_bytes_per_token()
        self._active_params = pc["active"]

    def with_measured_sync(self, t_sync: float) -> "CostModel":
        """Replace the hardcoded per-pass sync constant with a MEASURED
        per-step collective time (sharded-step wall time minus the
        equivalent single-device step — see `examples/serve_e2e.py
        --sharded-bench` and the `micro/ep_a2a_*` probes in
        `benchmarks/microbench.py`), so simulator sweeps price the DP
        barrier at what the mesh actually charges."""
        return dataclasses.replace(self, t_sync=max(float(t_sync), 0.0))

    def _kv_bytes_per_token(self) -> int:
        from repro_torch.config.base import AttentionKind, LayerKind
        total = 0
        for i in range(self.cfg.num_layers):
            kind = self.cfg.layer_kind(i)
            if kind.name in ("DENSE", "MOE"):
                if self.cfg.attention == AttentionKind.MLA:
                    total += (self.cfg.mla.kv_lora_rank
                              + self.cfg.mla.qk_rope_head_dim) * 2
                else:
                    total += (2 * self.cfg.num_kv_heads
                              * self.cfg.resolved_head_dim) * 2
            # SSM layers: constant state, not per-token — excluded
        return total

    def _a2a_bytes_per_token(self) -> int:
        """All-to-all dispatch+combine activation bytes per token per step —
        the reason batch-size imbalance hurts (§4.3.1 'communication
        inefficiencies')."""
        if not self.cfg.moe.num_experts:
            return 0
        n_moe = sum(1 for i in range(self.cfg.num_layers)
                    if self.cfg.layer_kind(i).name in ("MOE", "SSM_MOE"))
        k = self.cfg.moe.top_k
        return n_moe * 2 * k * self.cfg.d_model * 2   # dispatch + combine, bf16

    # ------------------------------------------------------------------
    def prefill_flops(self, tokens: int, ctx: Optional[int] = None) -> float:
        """FLOPs to prefill `tokens` prompt tokens at mean context `ctx`.
        Also the unit in which prefix-cache savings are priced: a cached
        prefix of T tokens skips exactly prefill_flops(T)."""
        if tokens <= 0:
            return 0.0
        ctx = ctx or self.avg_ctx
        flops = 2.0 * self._active_params * tokens
        # attention ~ 2·2·L·d_head·H·ctx per token (rough quadratic term)
        flops += 4.0 * self.cfg.num_layers * self.cfg.d_model * ctx * tokens
        return flops

    def prefill_dp_time(self, tokens: int, ctx: Optional[int] = None) -> float:
        """One DP unit processing `tokens` prompt tokens."""
        if tokens <= 0:
            return 0.0
        flops = self.prefill_flops(tokens, ctx)
        chips = self.chips_per_prefill_dp
        t_comp = flops / (chips * PEAK_FLOPS * self.mfu)
        t_mem = (self.active_param_bytes / 8.0) / (chips * HBM_BW * self.mbu)
        return max(t_comp, t_mem)

    min_fill: float = 0.5             # §3.2 "batch-insensitive latency":
                                      # partial passes cost at least this
                                      # fraction of a full-chunk pass

    def prefill_pass_time(self, dp_tokens: Sequence[int],
                          chunk: Optional[int] = None) -> float:
        """Instance-level pass: sync barrier => max over DP units + overhead.

        Paper §3.2 'Batch-Insensitive Latency': within capacity limits a
        pass's execution time is dominated by the longest sequence and
        synchronization overhead rather than the token count — modeled as a
        floor of `min_fill`·chunk tokens on the pass cost."""
        if not dp_tokens or max(dp_tokens) <= 0:
            return self.t_sync
        load = max(dp_tokens)
        if chunk is not None:
            load = max(load, int(chunk * self.min_fill))
        return self.prefill_dp_time(load) + self.t_sync

    # ------------------------------------------------------------------
    def decode_dp_time(self, batch: int, kv_tokens: int) -> float:
        """One decode iteration on one DP unit (memory-bound).

        `kv_tokens` is the KV footprint actually swept from HBM each
        step.  Callers pass `DecodeDPState.kv_occupancy`: exact resident
        tokens on a padded deployment, reserved-block tokens (internal
        fragmentation included) on a paged one — so the sim plane prices
        the same block-granular reads the real paged engine performs."""
        if batch <= 0:
            return 0.0
        chips = self.chips_per_decode_dp
        flops = 2.0 * self._active_params * batch / self.decode_ep_size
        t_comp = flops / (chips * PEAK_FLOPS * self.mfu)
        # per-chip traffic: weights are sharded over the EP group (each rank
        # reads its expert shard once per iteration); the DP unit's own KV
        # cache is read in full every step — the K_i term of Algorithm 3.
        bytes_moved = (self.active_param_bytes / self.decode_ep_size
                       + self.kv_bytes_per_token * kv_tokens)
        t_mem = bytes_moved / (chips * HBM_BW * self.mbu)
        # all-to-all over ICI scales with the DP unit's batch: the B_i term
        t_comm = batch * self.a2a_bytes_per_token / ICI_BW
        return max(t_comp, t_mem) + t_comm

    def decode_step_time(self, batches: Sequence[int],
                         kvs: Sequence[int]) -> float:
        """Instance-level decode step (sync barrier across DP units)."""
        if not batches:
            return self.t_sync
        return max(self.decode_dp_time(b, k)
                   for b, k in zip(batches, kvs)) + self.t_sync

    # ------------------------------------------------------------------
    def mixed_dp_time(self, batch: int, kv_tokens: int,
                      prefill_tokens: int) -> float:
        """One UNIFIED mixed-batch iteration on one DP unit: `batch`
        decode rows plus `prefill_tokens` piggybacked chunked-prefill
        tokens in the same forward pass.

        This is where the Sarathi win lives in the roofline: the decode
        step is memory-bound on the WEIGHT sweep, so riding prefill
        compute on the same pass reuses that sweep — t_mem gains only
        the prefill tokens' KV writes, while a disjoint prefill pass
        would pay the whole weight read again.  Compute and all-to-all
        scale with the extra tokens as usual."""
        if batch <= 0 and prefill_tokens <= 0:
            return 0.0
        chips = self.chips_per_decode_dp
        flops = (2.0 * self._active_params * max(batch, 0)
                 / self.decode_ep_size)
        flops += self.prefill_flops(prefill_tokens) / self.decode_ep_size
        t_comp = flops / (chips * PEAK_FLOPS * self.mfu)
        bytes_moved = (self.active_param_bytes / self.decode_ep_size
                       + self.kv_bytes_per_token * kv_tokens
                       + self.kv_bytes_per_token * max(prefill_tokens, 0))
        t_mem = bytes_moved / (chips * HBM_BW * self.mbu)
        t_comm = ((max(batch, 0) + max(prefill_tokens, 0))
                  * self.a2a_bytes_per_token / ICI_BW)
        return max(t_comp, t_mem) + t_comm

    def mixed_step_time(self, batches: Sequence[int], kvs: Sequence[int],
                        prefill_tokens: Sequence[int]) -> float:
        """Instance-level unified step (sync barrier across DP units)."""
        if not batches:
            return self.t_sync
        return max(self.mixed_dp_time(b, k, p)
                   for b, k, p in zip(batches, kvs, prefill_tokens)
                   ) + self.t_sync

    def padding_flops_wasted(self, lens: Sequence[int],
                             pad_to: Optional[int] = None) -> float:
        """FLOPs spent on PADDING when the prompt lengths `lens` are
        formed into one batch padded to a common length (`pad_to`,
        default the batch max) — the BucketServe waste metric.  Bucketed
        formation shrinks this by co-batching near-equal lengths."""
        if not lens:
            return 0.0
        target = pad_to if pad_to is not None else max(lens)
        wasted = sum(max(target - ln, 0) for ln in lens)
        return self.prefill_flops(wasted)
