"""Global State & Feedback System (paper Figure 5, plane 2).

Maintains the Global State Matrix ⟨C_avail, B_i, K_i⟩ from EndForward
feedback and drives the adaptive interval (Algorithm 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.interval import AdaptiveIntervalController
from repro_torch.core.types import DecodeDPState, DPState, EndForward


class GlobalState:
    def __init__(
        self,
        num_prefill_instances: int,
        prefill_dp_per_instance: int,
        num_decode_instances: int,
        decode_dp_per_instance: int,
        chunk_size: int,
        interval: Optional[AdaptiveIntervalController] = None,
        max_batch_per_dp: int = 10_000,
        kv_budget_tokens: int = 10 ** 12,
        block_size: int = 0,
    ):
        self.chunk_size = chunk_size
        self.prefill_dps: List[DPState] = []
        for i in range(num_prefill_instances):
            for j in range(prefill_dp_per_instance):
                self.prefill_dps.append(DPState(
                    dp_id=i * prefill_dp_per_instance + j,
                    instance_id=i, c_chunk=chunk_size))
        self.decode_dps: List[DecodeDPState] = []
        for i in range(num_decode_instances):
            for j in range(decode_dp_per_instance):
                self.decode_dps.append(DecodeDPState(
                    dp_id=i * decode_dp_per_instance + j,
                    instance_id=i,
                    max_batch=max_batch_per_dp,
                    kv_budget=kv_budget_tokens,
                    block_size=block_size))
        self.interval = interval or AdaptiveIntervalController(
            n_active=num_prefill_instances)
        self.num_prefill_instances = num_prefill_instances
        self.num_decode_instances = num_decode_instances

    def prefill_dps_of(self, inst: int) -> List[DPState]:
        return [d for d in self.prefill_dps if d.instance_id == inst]

    def decode_dps_of(self, inst: int) -> List[DecodeDPState]:
        return [d for d in self.decode_dps if d.instance_id == inst]

    def on_end_forward(self, ev: EndForward) -> None:
        """Feedback-plane update: capacity release + interval adaptation."""
        for d in self.prefill_dps:
            if d.instance_id == ev.instance_id and d.dp_id == ev.dp_id:
                d.on_end_forward(ev.processed_tokens, ev.remaining_tokens)
        self.interval.on_end_forward(ev.exec_time)

    def snapshot(self) -> Dict:
        return {
            "c_avail": [d.c_avail for d in self.prefill_dps],
            "decode_B": [d.batch for d in self.decode_dps],
            "decode_K": [d.kv_tokens for d in self.decode_dps],
            "i_opt": self.interval.interval,
            "t_fwd": self.interval.t_fwd,
        }
