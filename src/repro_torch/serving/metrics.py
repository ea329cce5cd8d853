"""Serving metrics: TTFT / queuing / utilization / decode balance."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.types import Request


def percentile(xs: Sequence[float], q: float) -> float:
    if not xs:
        return float("nan")
    v = sorted(xs)
    rank = (len(v) - 1) * q / 100.0
    lo = int(rank)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (rank - lo)


def mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else float("nan")


def std(xs: Sequence[float]) -> float:
    if len(xs) < 2:
        return 0.0
    m = mean(xs)
    return math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1))


def goodput_by_class(requests: Sequence[Request],
                     default_slo: Optional[float] = None
                     ) -> Dict[str, float]:
    """SLO-attained fraction per priority class.  The denominator is the
    WHOLE offered class — rejected and unfinished requests count against
    goodput, so shedding load never looks like serving it.  A request's
    own `slo_e2e` wins over `default_slo` (see Request.slo_attained)."""
    total: Dict[str, int] = {}
    attained: Dict[str, int] = {}
    for r in requests:
        total[r.slo_class] = total.get(r.slo_class, 0) + 1
        if r.slo_attained(default_slo):
            attained[r.slo_class] = attained.get(r.slo_class, 0) + 1
    return {c: attained.get(c, 0) / n for c, n in sorted(total.items())}


@dataclasses.dataclass
class PrefillReport:
    n: int
    ttft_mean: float
    ttft_p50: float
    ttft_p99: float
    queue_mean: float            # scheduler-side queueing
    device_queue_mean: float     # HOL blocking inside the engine
    chunk_util: float
    qps_served: float
    rejected: int = 0

    def row(self) -> str:
        return (f"n={self.n} ttft={self.ttft_mean*1000:.1f}ms "
                f"p99={self.ttft_p99*1000:.1f}ms "
                f"devq={self.device_queue_mean*1000:.1f}ms "
                f"util={self.chunk_util*100:.1f}% qps={self.qps_served:.1f}")


def prefill_report(requests: Sequence[Request], duration: float,
                   chunk_util: float, rejected: int = 0) -> PrefillReport:
    done = [r for r in requests if r.first_token_time is not None]
    ttfts = [r.ttft for r in done]
    queues = [r.queueing_delay for r in done if r.queueing_delay is not None]
    devq = [r.device_queue_delay for r in done
            if r.device_queue_delay is not None]
    return PrefillReport(
        n=len(done),
        ttft_mean=mean(ttfts), ttft_p50=percentile(ttfts, 50),
        ttft_p99=percentile(ttfts, 99),
        queue_mean=mean(queues) if queues else 0.0,
        device_queue_mean=mean(devq) if devq else 0.0,
        chunk_util=chunk_util,
        qps_served=len(done) / duration if duration > 0 else float("nan"),
        rejected=rejected,
    )


@dataclasses.dataclass
class DecodeReport:
    tokens_generated: int
    duration: float
    throughput: float            # tokens / s
    kv_std_mean: float           # time-averaged std of per-DP KV loads
    kv_band: tuple               # (mean-1σ, mean+1σ) time-averaged
    kv_peak: float
    batch_std_mean: float

    def row(self) -> str:
        return (f"tok={self.tokens_generated} thr={self.throughput:.0f} tok/s "
                f"kv_std={self.kv_std_mean:.0f} band=({self.kv_band[0]:.0f},"
                f"{self.kv_band[1]:.0f}) peak={self.kv_peak:.0f}")


def decode_report(tokens_generated: int, duration: float,
                  kv_timeline: Sequence[Sequence[int]],
                  batch_timeline: Sequence[Sequence[int]]) -> DecodeReport:
    kv_stds = [std(list(map(float, snap))) for snap in kv_timeline if snap]
    kv_means = [mean(list(map(float, snap))) for snap in kv_timeline if snap]
    b_stds = [std(list(map(float, snap))) for snap in batch_timeline if snap]
    kv_peak = max((max(s) for s in kv_timeline if s), default=0)
    m, s = mean(kv_means), mean(kv_stds)
    return DecodeReport(
        tokens_generated=tokens_generated, duration=duration,
        throughput=tokens_generated / duration if duration else float("nan"),
        kv_std_mean=s, kv_band=(m - s, m + s), kv_peak=float(kv_peak),
        batch_std_mean=mean(b_stds),
    )
