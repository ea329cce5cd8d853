"""Algorithm 3 — IQR-Aware Lexicographical Decode Scheduling.

Step 1 (Mask): DP units whose KV load exceeds Q3 + k·IQR are outliers —
masked out of the decision space (fallback: all units if everything is
saturated).
Step 2 (Lexicographical select): among safe units pick
argmin ⟨B_i, K_i⟩ — batch size first (parallel efficiency), KV load as the
tie-breaker (memory pressure).
Step 3: assign and update state.

Requests are pre-sorted by total sequence length descending
("fill-the-valley": place heavy requests while the decision space is rich).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import DecodeDPState, Request

# cache-aware placement hook: affinity(req, unit) -> matched prefix tokens
# already resident on that unit (0 = no preference)
AffinityFn = Callable[[Request, DecodeDPState], int]


def _best_affinity(req: Request, units: Sequence[DecodeDPState],
                   affinity: Optional[AffinityFn]
                   ) -> Optional[DecodeDPState]:
    """Cache-aware placement: among `units`, the one holding the longest
    cached prefix of `req` — ties broken by least ⟨kv_occupancy, batch⟩
    so reuse never concentrates load on one hot unit.  None when no unit
    holds any prefix (fall through to the load-based policy)."""
    if affinity is None:
        return None
    scored = [(affinity(req, u), u) for u in units]
    best_hit = max(s for s, _ in scored)
    if best_hit <= 0:
        return None
    cands = [u for s, u in scored if s == best_hit]
    return min(cands, key=lambda u: (u.kv_occupancy, u.batch))


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy 'linear' method)."""
    if not values:
        raise ValueError("empty")
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    rank = (len(v) - 1) * q / 100.0
    lo = int(rank)
    hi = min(lo + 1, len(v) - 1)
    frac = rank - lo
    return float(v[lo] * (1 - frac) + v[hi] * frac)


def iqr_safe_set(units: Sequence[DecodeDPState], k: float = 1.5
                 ) -> List[DecodeDPState]:
    """Step 1 — outlier detection over the KV-load snapshot.  The load
    metric is `kv_occupancy`: identical to kv_tokens on padded units, and
    block-granular (reserved pages, fragmentation included) on paged
    units, so the mask sees what the device memory actually holds."""
    kv = [u.kv_occupancy for u in units]
    q1, q3 = percentile(kv, 25), percentile(kv, 75)
    th = q3 + k * (q3 - q1)
    safe = [u for u in units if u.kv_occupancy <= th]
    # hard budgets also mask (memory exhaustion risk)
    safe = [u for u in safe
            if u.batch < u.max_batch and u.kv_occupancy < u.kv_budget]
    if not safe:
        safe = list(units)      # fallback: all saturated
    return safe


def lex_compare(a: DecodeDPState, b: DecodeDPState) -> bool:
    """LexCompare(i, j): (B_i < B_j) or (B_i == B_j and K_i < K_j)."""
    return (a.batch < b.batch) or (a.batch == b.batch
                                   and a.kv_tokens < b.kv_tokens)


def schedule_decode_batch(
    requests: Sequence[Request],
    units: Sequence[DecodeDPState],
    k: float = 1.5,
) -> Dict[int, List[Request]]:
    """ScheduleBatch(R, N) — returns dp_id -> assigned requests and updates
    unit states in place."""
    out: Dict[int, List[Request]] = {}
    # Length-Based Pre-Sorting (fill-the-valley); priority classes place
    # first, so urgent work sees the richest decision space
    order = sorted(requests,
                   key=lambda r: (r.priority, -(r.input_len + r.output_len)))
    for req in order:
        safe = iqr_safe_set(units, k)
        best: Optional[DecodeDPState] = None
        for u in safe:
            if best is None or lex_compare(u, best):
                best = u
        assert best is not None
        best.admit(req.input_len + req.generated,
                   reserve_len=req.input_len + req.output_len)
        req.assigned_dp = best.dp_id
        out.setdefault(best.dp_id, []).append(req)
    return out


# ---------------------------------------------------------------------------
# Load-Aware Global Allocation (decode phase, two-level)
# ---------------------------------------------------------------------------

def schedule_decode_global(
    requests: Sequence[Request],
    units: Sequence[DecodeDPState],
    k: float = 1.5,
    exclude_instances: frozenset = frozenset(),
    affinity: Optional[AffinityFn] = None,
) -> Dict[int, List[Request]]:
    """Batched decode placement that balances per-DP KV-TOKEN load (not
    just request count) across DP units within an instance AND across
    instances.

    Level 1 picks the target instance by least mean-per-unit ⟨K, B⟩ load,
    so a hot instance sheds traffic to its peers; level 2 picks the DP
    within it by least ⟨K_i, B_i⟩ — KV load first, batch as tie-break
    (the dual of Algorithm 3's batch-first order, for memory-bound decode
    pools).  IQR masking and hard budgets apply over the global DP
    population exactly as in `iqr_safe_set`.  `exclude_instances` removes
    quarantined (watchdog-expired) instances from the decision space; if
    that empties it, the exclusion is ignored rather than dropping work.

    `affinity`, when given, is the cache-aware override (§context
    caching): a safe unit already holding a prefix of the request wins
    over the load order — joining there points at resident pages instead
    of re-copying KV, and a longer match beats a shorter one.  Load-based
    placement is the tie-break and the fallback when nothing matches.
    """
    eligible = [u for u in units if u.instance_id not in exclude_instances]
    if not eligible:
        eligible = list(units)
    all_of: Dict[int, List[DecodeDPState]] = {}
    for u in eligible:
        all_of.setdefault(u.instance_id, []).append(u)
    out: Dict[int, List[Request]] = {}
    order = sorted(requests,
                   key=lambda r: (r.priority, -(r.input_len + r.output_len)))
    for req in order:
        safe = iqr_safe_set(eligible, k)
        best = _best_affinity(req, safe, affinity)
        if best is None:
            by_inst: Dict[int, List[DecodeDPState]] = {}
            for u in safe:
                by_inst.setdefault(u.instance_id, []).append(u)
            # level-1 load is the mean over ALL the instance's units —
            # masked (saturated) units still pace its sync barrier, so
            # hiding them would make a hot instance look cold and attract
            # traffic.  Loads are kv_occupancy so paged fragmentation is
            # balanced, not hidden.
            inst = min(by_inst, key=lambda i: (
                sum(u.kv_occupancy for u in all_of[i]) / len(all_of[i]),
                sum(u.batch for u in all_of[i]) / len(all_of[i])))
            best = min(by_inst[inst],
                       key=lambda u: (u.kv_occupancy, u.batch))
        best.admit(req.input_len + req.generated,
                   reserve_len=req.input_len + req.output_len)
        req.assigned_dp = best.dp_id
        out.setdefault(best.dp_id, []).append(req)
    return out


# ---------------------------------------------------------------------------
# Page-level preemption — victim selection (SLO-aware overload control)
# ---------------------------------------------------------------------------

def kv_footprint(req: Request, block_size: int) -> int:
    """KV tokens a resident request's reservation holds: its lifetime
    (input + output) rounded up to whole blocks when paged — the same
    ceiling rule admission reserved by, so preempting the victim frees
    exactly this much headroom."""
    total = req.input_len + req.output_len
    if not block_size:
        return total
    from repro_torch.core.types import blocks_for_tokens
    return blocks_for_tokens(total, block_size) * block_size


def select_victims(
    residents: Sequence[Request],
    need_tokens: int,
    block_size: int = 0,
    max_priority: Optional[int] = None,
) -> List[Request]:
    """Pick the requests to swap out to free >= `need_tokens` of KV.

    Policy (one model for the sim and real planes): only requests of
    priority STRICTLY LOWER than `max_priority` are eligible (a waiter
    can never evict its own class or better — the strict ordering is
    what makes preemption cycle-free); among eligible residents the
    least-urgent class goes first, ties broken by least generation
    progress (cheapest swap payload, most remaining work to benefit from
    re-placement) then youngest arrival (preserve FCFS within a class).
    Victims accumulate until their reservations cover the need; returns
    [] when the eligible set cannot cover it (partial preemption would
    burn swaps without admitting the waiter)."""
    if need_tokens <= 0:
        return []
    elig = [r for r in residents
            if max_priority is None or r.priority > max_priority]
    elig.sort(key=lambda r: (-r.priority, r.generated, -r.arrival_time))
    out: List[Request] = []
    freed = 0
    for r in elig:
        out.append(r)
        freed += kv_footprint(r, block_size)
        if freed >= need_tokens:
            return out
    return []


# ---------------------------------------------------------------------------
# Immediate-dispatch decode baselines (paper's comparison point)
# ---------------------------------------------------------------------------

def schedule_decode_immediate(
    requests: Sequence[Request],
    units: Sequence[DecodeDPState],
    policy: str = "round_robin",
    rr_state: Optional[List[int]] = None,
    affinity: Optional[AffinityFn] = None,
) -> Dict[int, List[Request]]:
    """Baselines: round_robin | least_batch | least_kv. No global window —
    each request is placed in arrival order with instantaneous state only.
    `affinity` adds cache-aware placement on top: a unit holding a cached
    prefix wins outright (round-robin state does NOT advance for such a
    request — the rotation resumes where it left off)."""
    out: Dict[int, List[Request]] = {}
    for req in requests:
        u = _best_affinity(req, units, affinity)
        if u is not None:
            u.admit(req.input_len + req.generated,
                    reserve_len=req.input_len + req.output_len)
            req.assigned_dp = u.dp_id
            out.setdefault(u.dp_id, []).append(req)
            continue
        if policy == "round_robin":
            assert rr_state is not None
            u = units[rr_state[0] % len(units)]
            rr_state[0] += 1
        elif policy == "least_batch":
            u = min(units, key=lambda x: x.batch)
        elif policy == "least_kv":
            # occupancy, like every batched allocator above: the baseline
            # must not be blind to paged block reservations
            u = min(units, key=lambda x: x.kv_occupancy)
        else:
            raise ValueError(policy)
        u.admit(req.input_len + req.generated,
                reserve_len=req.input_len + req.output_len)
        req.assigned_dp = u.dp_id
        out.setdefault(u.dp_id, []).append(req)
    return out
