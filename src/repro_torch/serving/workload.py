"""Synthetic workloads matching the paper's §5 evaluation traffic.

- short:      input lengths 0–3K tokens, mean ≈ 1K   (Fig 6a; Chunk 3K)
- long:       input lengths 3K–64K tokens, mean ≈ 6.7K (Fig 6b; Chunk 16K)
- decode:     combined in+out ≈ 2.5K tokens, avg batch 35 (Fig 7/8)
- bursty:     short lengths under a Markov-modulated Poisson process —
              on/off arrival bursts with the same long-run rate (flash
              crowds; stresses the staggered clock and flow control)
- decode_burst: decode-heavy bursty — long generations keep every DP
              populated while MMPP prompt bursts arrive on top (the
              mixed-batch ITL scenario: disjoint prefill stalls the
              resident decode rows, piggybacking does not)
- heavy_tail: long-context heavy-tail (lognormal σ=1.6, up to 128K) —
              a few huge documents amid chat traffic (stresses chunking
              and KV-load balance)
- shared_prefix: multi-tenant traffic where every request opens with its
              tenant's system prompt; tenants are Zipf-popular, so a few
              hot prompts dominate (the prefix-cache / page-sharing
              scenario — hit rate tracks Zipf mass × prefix fraction)
- overload_spike: mixed SLO classes under a hard flash crowd (5× peak):
              interactive chat, standard traffic and batch jobs share the
              pool, so overload control has real choices to make (the
              preemption / flow-control / goodput scenario)
- diurnal:    the same class mix under a slow sinusoidal rate swell —
              a compressed day: the pool saturates near the crest and
              recovers in the trough (tests that throttled work admits
              again and preempted work completes)

Arrivals are Poisson (the M in the paper's M/D/S analysis); bursty
workloads modulate the rate between a high and a low state; diurnal
workloads thin a peak-rate Poisson stream against a sinusoid.

Priority classes: `class_mix` assigns each request an SLO class
(core.types.SLO_CLASSES — name, priority, e2e deadline) with the given
probabilities.  An empty mix leaves every request in the default class,
which keeps the legacy scenarios byte-identical.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Dict, Iterator, List, Optional

from repro_torch.core.types import Request, SLO_CLASSES


@dataclasses.dataclass
class WorkloadSpec:
    name: str
    min_len: int
    max_len: int
    mean_len: float
    out_mean: int = 200
    sigma: float = 0.8            # lognormal shape (tail heaviness)
    # arrival-process modulation (1.0 => plain Poisson)
    burst_factor: float = 1.0     # peak rate = burst_factor × mean rate
    burst_duty: float = 0.3       # fraction of each cycle at peak rate
    burst_period: float = 2.0     # seconds per on/off cycle
    # multi-tenant system prompts (n_tenants > 0 => every request starts
    # with its tenant's prompt; tenant popularity is Zipf(tenant_zipf))
    n_tenants: int = 0
    tenant_zipf: float = 1.2
    tenant_prefix_len: int = 384
    # SLO class mix: class name -> probability (empty = all default class)
    class_mix: Dict[str, float] = dataclasses.field(default_factory=dict)
    # sinusoidal rate modulation (diurnal): peak rate = qps, trough rate =
    # qps * diurnal_floor, one full cycle per diurnal_period seconds
    diurnal_period: float = 0.0
    diurnal_floor: float = 0.1


SHORT = WorkloadSpec("short", 16, 3000, 1000.0)
LONG = WorkloadSpec("long", 3000, 64000, 6700.0)
DECODE = WorkloadSpec("decode", 512, 4096, 2000.0, out_mean=500)
BURSTY = WorkloadSpec("bursty", 16, 3000, 1000.0,
                      burst_factor=3.0, burst_duty=0.25, burst_period=2.0)
HEAVY_TAIL = WorkloadSpec("heavy_tail", 64, 131072, 2500.0, sigma=1.6)
SHARED_PREFIX = WorkloadSpec("shared_prefix", 256, 3000, 1000.0,
                             n_tenants=24, tenant_zipf=1.2,
                             tenant_prefix_len=384)
# decode-heavy bursty traffic: long generations keep every decode DP
# populated while MMPP prompt bursts arrive on top — each burst's prefill
# must run WHILE decodes are resident, which is exactly where a disjoint
# prefill/decode loop stalls the resident rows (the ITL-p99 bubble the
# unified mixed-batch plane removes)
DECODE_BURST = WorkloadSpec("decode_burst", 512, 8000, 2500.0,
                            out_mean=600,
                            burst_factor=4.0, burst_duty=0.2,
                            burst_period=3.0)
_CLASS_MIX = {"interactive": 0.35, "standard": 0.45, "batch": 0.20}
OVERLOAD_SPIKE = WorkloadSpec("overload_spike", 16, 3000, 1000.0,
                              out_mean=300,
                              burst_factor=5.0, burst_duty=0.15,
                              burst_period=4.0, class_mix=_CLASS_MIX)
DIURNAL = WorkloadSpec("diurnal", 16, 3000, 1000.0, out_mean=300,
                       diurnal_period=20.0, diurnal_floor=0.15,
                       class_mix=_CLASS_MIX)

SPECS = {"short": SHORT, "long": LONG, "decode": DECODE,
         "bursty": BURSTY, "decode_burst": DECODE_BURST,
         "heavy_tail": HEAVY_TAIL,
         "shared_prefix": SHARED_PREFIX,
         "overload_spike": OVERLOAD_SPIKE, "diurnal": DIURNAL}


def _zipf_cdf(n: int, s: float) -> List[float]:
    w = [1.0 / (k ** s) for k in range(1, n + 1)]
    tot = sum(w)
    acc, cdf = 0.0, []
    for x in w:
        acc += x
        cdf.append(acc / tot)
    return cdf


def sample_tenant(rng: random.Random, cdf: List[float]) -> int:
    """Zipf-popular tenant id: 0 is the hottest."""
    return min(bisect.bisect_left(cdf, rng.random()), len(cdf) - 1)


def _lognormal_params(spec: WorkloadSpec) -> tuple:
    """Pick (mu, sigma) so the clipped lognormal lands near the target mean."""
    mean = spec.mean_len
    sigma = spec.sigma
    mu = math.log(mean) - 0.5 * sigma ** 2
    return mu, sigma


def sample_length(spec: WorkloadSpec, rng: random.Random) -> int:
    mu, sigma = _lognormal_params(spec)
    v = int(rng.lognormvariate(mu, sigma))
    return max(spec.min_len, min(spec.max_len, v))


def sample_output_len(spec: WorkloadSpec, rng: random.Random) -> int:
    # geometric-ish output lengths
    return max(1, int(rng.expovariate(1.0 / spec.out_mean)))


def arrival_times(spec: WorkloadSpec, qps: float, duration: float,
                  rng: random.Random) -> Iterator[float]:
    """Arrival process: plain Poisson, or a two-state Markov-modulated
    Poisson process when burst_factor > 1.  The long-run average rate is
    `qps` in both cases: the peak state runs at burst_factor×qps for
    burst_duty of each period, the quiet state absorbs the remainder.

    Diurnal specs (`diurnal_period` > 0) thin a PEAK-rate (`qps`) Poisson
    stream against a raised sinusoid instead: rate(t) swings between
    qps·diurnal_floor (trough) and qps (crest) once per period."""
    if spec.diurnal_period > 0.0:
        per, fl = spec.diurnal_period, spec.diurnal_floor
        t = 0.0
        while True:
            t += rng.expovariate(qps)
            if t >= duration:
                return
            envelope = fl + (1.0 - fl) * 0.5 * (
                1.0 - math.cos(2.0 * math.pi * t / per))
            if rng.random() < envelope:
                yield t
        return
    if spec.burst_factor <= 1.0:
        t = 0.0
        while True:
            t += rng.expovariate(qps)
            if t >= duration:
                return
            yield t
        return
    duty, period, bf = spec.burst_duty, spec.burst_period, spec.burst_factor
    if bf * duty > 1.0:
        raise ValueError(
            f"burst_factor·burst_duty = {bf * duty:.2f} > 1: the quiet "
            f"state cannot absorb the burst, so the long-run rate would "
            f"exceed qps")
    hi = bf * qps
    lo = qps * (1.0 - duty * bf) / max(1.0 - duty, 1e-9)
    t = 0.0
    while t < duration:
        cycle0 = math.floor(t / period) * period
        # the epsilon guards a float livelock: when duty*period is not
        # exactly representable (e.g. 0.15×4.0), a t clamped to the burst
        # end can still test < the boundary, making seg_end == t — and
        # then no draw ever advances the clock
        in_burst = t < cycle0 + duty * period - 1e-12
        seg_end = cycle0 + (duty * period if in_burst else period)
        rate = hi if in_burst else lo
        if rate <= 0.0:
            t = seg_end
            continue
        t += rng.expovariate(rate)
        if t < seg_end:
            if t >= duration:
                return
            yield t
        else:
            t = seg_end


def generate(
    spec: WorkloadSpec,
    qps: float,
    duration: float,
    seed: int = 0,
    with_tokens: bool = False,
    shared_prefix_prob: float = 0.0,
    vocab: int = 50000,
) -> List[Request]:
    """Arrivals over [0, duration) per the spec's process. Optionally attach
    token ids with shared prefixes (for cache-aware scheduling).

    When `spec.n_tenants` > 0 (the `shared_prefix` scenario) every
    tokenized request opens with its tenant's system prompt — tenant
    picked Zipf(spec.tenant_zipf), so a handful of hot prompts carry most
    of the traffic; `shared_prefix_prob` is ignored in that mode.  A
    sampled length shorter than the prompt truncates it (a prefix of a
    system prompt still shares pages with its siblings)."""
    rng = random.Random(seed)
    reqs: List[Request] = []
    rid = 0
    prefixes = [tuple(rng.randrange(vocab) for _ in range(256))
                for _ in range(4)]
    tenant_cdf, tenant_prompts = None, []
    if spec.n_tenants > 0:
        tenant_cdf = _zipf_cdf(spec.n_tenants, spec.tenant_zipf)
        tenant_prompts = [
            tuple(rng.randrange(vocab)
                  for _ in range(spec.tenant_prefix_len))
            for _ in range(spec.n_tenants)]
    class_names: List[str] = []
    class_cdf: List[float] = []
    if spec.class_mix:
        tot = sum(spec.class_mix.values())
        acc = 0.0
        for name, p in spec.class_mix.items():
            acc += p / tot
            class_names.append(name)
            class_cdf.append(acc)
    for t in arrival_times(spec, qps, duration, rng):
        L = sample_length(spec, rng)
        tokens = None
        if with_tokens:
            if tenant_prompts:
                pre = tenant_prompts[sample_tenant(rng, tenant_cdf)]
                body = tuple(rng.randrange(vocab)
                             for _ in range(max(L - len(pre), 0)))
                tokens = (pre + body)[:L]
            elif rng.random() < shared_prefix_prob:
                pre = prefixes[rng.randrange(len(prefixes))]
                body = tuple(rng.randrange(vocab)
                             for _ in range(max(L - len(pre), 0)))
                tokens = (pre + body)[:L]
            else:
                tokens = tuple(rng.randrange(vocab) for _ in range(L))
        kw = {}
        if class_names:
            i = min(bisect.bisect_left(class_cdf, rng.random()),
                    len(class_names) - 1)
            cls = SLO_CLASSES[class_names[i]]
            kw = dict(priority=cls.priority, slo_e2e=cls.slo_e2e,
                      slo_class=cls.name)
        reqs.append(Request(
            rid=rid, arrival_time=t, input_len=L,
            output_len=sample_output_len(spec, rng), tokens=tokens, **kw))
        rid += 1
    return reqs


def empirical_mean_len(spec: WorkloadSpec, n: int = 20000, seed: int = 1
                       ) -> float:
    rng = random.Random(seed)
    return sum(sample_length(spec, rng) for _ in range(n)) / n
