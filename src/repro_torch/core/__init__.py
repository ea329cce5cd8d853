"""The paper's primary contribution: Staggered Batch Scheduling.

interval.py       — Algorithm 1 (throughput-adaptive interval control)
prefill_alloc.py  — Algorithm 2 (PBAA water-filling bin packing)
decode_alloc.py   — Algorithm 3 (IQR-aware lexicographical decode scheduling)
sync.py           — §4.1.2 multi-tier state-synchronization protocol
scheduler.py      — SBS main loop + immediate-dispatch baselines
state.py          — global state matrix ⟨C_avail, B_i, K_i⟩
prefix_cache.py   — radix-tree index for cache-aware PBAA
flow_control.py   — overload protection
"""

from repro_torch.core.interval import AdaptiveIntervalController
from repro_torch.core.prefill_alloc import greedy_dispatch, pbaa, chunk_utilization
from repro_torch.core.decode_alloc import (
    iqr_safe_set, lex_compare, schedule_decode_batch,
    schedule_decode_immediate,
)
from repro_torch.core.scheduler import (
    StaggeredBatchScheduler, ImmediatePrefillScheduler, DecodeScheduler,
)
from repro_torch.core.state import GlobalState
from repro_torch.core.sync import SyncProtocol, Readiness
from repro_torch.core.types import (
    DecodeDPState, DPState, DispatchCommand, EndForward, Request,
    RequestPhase,
)
from repro_torch.core.prefix_cache import PrefixCacheIndex, RadixTree
from repro_torch.core.flow_control import FlowAction, FlowController

__all__ = [
    "AdaptiveIntervalController", "greedy_dispatch", "pbaa",
    "chunk_utilization", "iqr_safe_set", "lex_compare",
    "schedule_decode_batch", "schedule_decode_immediate",
    "StaggeredBatchScheduler", "ImmediatePrefillScheduler", "DecodeScheduler",
    "GlobalState", "SyncProtocol", "Readiness", "DecodeDPState", "DPState",
    "DispatchCommand", "EndForward", "Request", "RequestPhase",
    "PrefixCacheIndex", "RadixTree", "FlowAction", "FlowController",
]
