"""PyTorch port: the serving benchmark twin `examples/serve_e2e_torch.py`
against the reference `examples/serve_e2e.py`, on the CPU:

  (a) trace parity: for the reference's flag sets (its defaults and the
      `scripts/ci.sh --real-smoke` commands), both mains run against one
      recording stub for `RealSBSServer` and `EngineSpec` (no model
      runs) and must build the same deployments and engine specs and
      serve the same requests in the same order (rids, arrival times,
      lengths, tokens, priorities, SLOs), with the same flags;
  (b) token parity: one reduced paged sweep (sbs-la) through both
      `run_sweep`s on the same JAX-made weights gives identical tokens;
  (c) every mode of the twin finishes every request at `--reduced
      --device cpu` (the sharded A/B on four logical CPU shards,
      `--mesh-devices cpux4`), and writes exactly the reference's section
      keys (as in BENCH_e2e.json) plus `device`, in each overload leg the
      interactive requests' TTFT (`ttft_interactive`, the quantity the
      overload gate fails on at published width), and in the sharded
      section the mesh's devices and each leg's step p50 and EP
      exchanges, bytes and device time per step; no timing gate is
      asserted;
  (d) `--sharded-bench` raises where its default mesh (the first four
      cards) does not exist, and the card default raises where there is
      no card;
  (e) chip_smoke.py's twin phases (checked serves, structural checks)
      rehearsed on two A/Bs at the reduced size.
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.config.base import ServingConfig as JServingConfig
from repro.models import model as JM

from repro_torch.bridge import params_from_numpy
from repro_torch.serving.server import RealSBSServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's flag sets: its defaults, then scripts/ci.sh --real-smoke
FLAG_SETS = {
    "sweep_default": [],
    "sweep_ci": ["--arch", "granite-moe-1b-a400m", "--requests", "10",
                 "--max-new", "12", "--max-batch-per-dp", "1",
                 "--arrival-spacing", "0", "--schedulers", "sbs-la",
                 "--timeout", "110", "--compare-padded"],
    "prefix": ["--requests", "10", "--max-new", "4", "--timeout", "150",
               "--prefix-bench"],
    "overload": ["--timeout", "150", "--overload-bench"],
    "mixed": ["--timeout", "150", "--mixed-bench"],
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load("serve_e2e_reference", "examples/serve_e2e.py")


@pytest.fixture(scope="module")
def twin():
    return _load("serve_e2e_torch", "examples/serve_e2e_torch.py")


# ---------------------------------------------------------------------------
# (a) trace parity against a recording stub
# ---------------------------------------------------------------------------

def _req_fields(r):
    return (r.rid, r.arrival_time, r.input_len, r.output_len,
            tuple(r.tokens), r.priority, r.slo_e2e, r.slo_class, r.generated)


def _cfg_fields(cfg):
    return (cfg.name, cfg.num_layers, cfg.d_model, cfg.vocab_size)


def _recording_stubs(log):
    """Stand-ins for EngineSpec and RealSBSServer that append what they
    are given to `log` and serve every request at once."""
    specs = []

    class Spec:
        def __init__(self, cfg, params, **kw):
            kw.pop("device", None)
            specs.append(self)
            log.append(("spec", _cfg_fields(cfg), kw))

    class Engine:
        def __init__(self, paged):
            self.peak_resident = 3 if paged else 2
            self.itl = [0.01, 0.02]
            self.mixed_steps = self.forced_grants = self.prefill_tokens = 0
            self.graphs = None

    class Server:
        def __init__(self, cfg, params, serving_cfg=None, scheduler="sbs",
                     max_len=256, max_new=8, spec=None, prefix_cache=False,
                     device=None):
            log.append(("server", _cfg_fields(cfg),
                        dataclasses.asdict(serving_cfg), scheduler, max_len,
                        max_new, specs.index(spec), prefix_cache))
            self.engines = []
            self.decode_engines = [Engine(bool(serving_cfg.block_size))]
            self.state = types.SimpleNamespace(
                interval=types.SimpleNamespace(interval=0.01, t_fwd=0.01))
            self.runtime = types.SimpleNamespace(
                preempted=[None] if serving_cfg.preemption else [])
            self._served = 0

        def prefix_stats(self):
            n = self._served
            return {"prefix_hit_tokens": 10 * n, "prefix_seen_tokens": 20 * n,
                    "prefill_chunks_run": n, "decode_blocks_shared": n}

        def serve(self, requests, timeout=120.0):
            log.append(("serve", [_req_fields(r) for r in requests],
                        timeout))
            self._served += 1
            for r in requests:
                r.generated = r.output_len
                r.first_token_time = r.arrival_time + 0.01
                r.finish_time = r.arrival_time + 0.02
            return [types.SimpleNamespace(rid=r.rid, ttft=0.01, tokens=[0])
                    for r in requests]
    return Spec, Server


def _run_main(mod, argv, monkeypatch, init):
    """`mod.main()` under `argv` with the recording stubs; returns (the
    log, the parsed flags)."""
    log, parsed = [], []
    Spec, Server = _recording_stubs(log)
    inner = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        out = inner(self, args, namespace)
        parsed.append(vars(out))
        return out
    with monkeypatch.context() as m:
        m.setattr(mod, "EngineSpec", Spec)
        m.setattr(mod, "RealSBSServer", Server)
        m.setattr(mod, "init_params", init)
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        m.setattr(sys, "argv", ["serve_e2e"] + argv)
        try:
            mod.main()
        except SystemExit:
            pass
    return log, parsed[0]


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_twin_traces_equal_reference(ref, twin, monkeypatch, flags):
    argv = FLAG_SETS[flags]
    want, ref_args = _run_main(ref, argv, monkeypatch,
                               lambda cfg, key: None)
    got, twin_args = _run_main(
        twin, argv + ["--reduced", "--device", "cpu"], monkeypatch,
        lambda cfg, **kw: {"embed": torch.zeros(1)})
    assert {k: v for k, v in twin_args.items()
            if k not in ("device", "reduced", "mesh_devices")} == ref_args
    assert [e[0] for e in got] == [e[0] for e in want]
    assert got == want
    assert sum(e[0] == "serve" for e in want) >= 2


# ---------------------------------------------------------------------------
# (b) token parity of one reduced sweep on the same weights
# ---------------------------------------------------------------------------

def _recording(server_cls, out):
    class Recording(server_cls):
        def serve(self, requests, timeout=120.0):
            gens = super().serve(requests, timeout=timeout)
            out.append({g.rid: list(g.tokens) for g in gens})
            return gens
    return Recording


def test_twin_sweep_tokens_equal_reference(ref, twin, monkeypatch):
    from repro.config import get_arch
    cfg = get_arch("deepseek-7b", reduced=True)
    jparams = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tcfg = twin.get_arch("deepseek-7b", reduced=True)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    args = argparse.Namespace(requests=4, max_new=6, seed=0,
                              arrival_spacing=0.05, max_batch_per_dp=8,
                              schedulers="sbs-la", timeout=120.0,
                              device="cpu")
    fresh, scfg_for = twin.sweep_trace(tcfg, args)
    scfg = scfg_for(16)
    out = {}
    for name, mod, c, p, s, f in (
            ("ref", ref, cfg, jparams,
             JServingConfig(**dataclasses.asdict(scfg)),
             ref.make_requests(4, cfg, 6, 0, 0.05)),
            ("twin", twin, tcfg, tparams, scfg, fresh)):
        runs = []
        monkeypatch.setattr(mod, "RealSBSServer",
                            _recording(mod.RealSBSServer, runs))
        ok, peaks = mod.run_sweep("paged", c, p, s, f, args)
        assert ok and peaks["sbs-la"] >= 1
        out[name] = runs[0]
    assert sorted(out["twin"]) == [0, 1, 2, 3]
    assert out["twin"] == out["ref"]


# ---------------------------------------------------------------------------
# (c) every mode finishes on the CPU at the reduced size
# ---------------------------------------------------------------------------

MODES = {
    "real_plane": FLAG_SETS["sweep_ci"],
    "real_plane_prefix": ["--requests", "4", "--max-new", "4",
                          "--prefix-bench"],
    "real_plane_overload": FLAG_SETS["overload"],
    "real_plane_mixed": FLAG_SETS["mixed"],
    "real_plane_sharded": ["--arch", "granite-moe-1b-a400m", "--timeout",
                           "150", "--sharded-bench", "--mesh-devices",
                           "cpux4"],
}
SHARDED_LEG_EXTRA = ["ep_bytes_per_step", "ep_exchanges_per_step",
                     "ep_ms_per_step", "step_p50_ms"]


def _keys(section):
    """Top-level keys and, for each dict-valued key, its keys."""
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in section.items()}


@pytest.mark.parametrize("key", list(MODES))
def test_twin_mode_finishes_on_cpu(twin, monkeypatch, tmp_path, key):
    runs = []

    class Finishing(RealSBSServer):
        def serve(self, requests, timeout=120.0):
            gens = super().serve(requests, timeout=timeout)
            runs.append((len(gens), len(requests)))
            return gens
    monkeypatch.setattr(twin, "RealSBSServer", Finishing)
    out = tmp_path / "bench.json"
    try:
        twin.main(MODES[key] + ["--reduced", "--device", "cpu",
                                "--bench-json", str(out)])
    except SystemExit:
        pass                    # a timing gate's verdict is not held here
    assert runs and all(n == m for n, m in runs), runs
    with open(os.path.join(REPO, "BENCH_e2e.json")) as f:
        want = _keys(json.load(f)[key])
    with open(out) as f:
        got = json.load(f)[key]
    assert got["device"] == "cpu"
    want["device"] = None
    if key == "real_plane_overload":
        for leg in ("drain_only", "preempt"):
            want[leg] = sorted(want[leg] + ["ttft_interactive"])
            assert len(got[leg]["ttft_interactive"]) == 2
    if key == "real_plane_sharded":
        want["mesh_devices"] = None
        assert got["mesh_devices"] == ["cpu"] * 4
        assert got["ep_all_to_all_active"]
        for leg in ("immediate", "sbs-la"):
            want[leg] = sorted(want[leg] + SHARDED_LEG_EXTRA)
            assert got[leg]["ep_exchanges_per_step"] > 0
            assert got[leg]["ep_ms_per_step"] is None    # timed on CUDA
    assert _keys(got) == want


# ---------------------------------------------------------------------------
# (d) what the twin refuses
# ---------------------------------------------------------------------------

def test_twin_sharded_bench_raises(twin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        twin.main(["--sharded-bench", "--reduced", "--device", "cpu"])


def test_twin_needs_a_card_by_default(twin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = twin.parse_args(["--reduced"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.load_model(args)


# ---------------------------------------------------------------------------
# chip_smoke.py's twin phases, rehearsed at the reduced size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["sweep_paged_vs_padded", "overload",
                                   "mixed", "sharded"])
def test_chip_smoke_twin_phase_on_cpu(twin, phase, tmp_path):
    """The smoke's checked serves (every request finished, the pools
    drained, first-token logits against the plain forward, an MoE
    model's with the served expert sets) and its structural checks on
    one A/B, through the twin's CLI on the CPU (the sharded A/B on four
    logical CPU shards).  The paged-vs-padded
    residency depends on how the prefills and decodes interleave: it
    reads 4 against 2 when, on both DP units at once, a second request
    joins while the first still decodes (every run on the CPU and the
    H100 so far, PERF.md)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    counters = [paged_decode_attention, paged_prefill_attention,
                flash_prefill, decode_attention]
    flags, key = {p: (f, k) for p, f, k in chip_smoke.TWIN_PHASES}[phase]
    rep = chip_smoke.twin_phase(twin, phase, flags, key, counters, "cpu",
                                str(tmp_path / "bench.json"), reduced=True)
    assert rep["serves"] and all(
        e["logits_rel_err"] <= chip_smoke.LOGITS_REL_TOL
        and e["computed_prompts"] == e["requests"] for e in rep["serves"])
    assert all(e["expert_sets_replayed"]
               == (phase in ("sweep_paged_vs_padded", "sharded"))
               for e in rep["serves"])
    assert set(rep["launches"].values()) == {0}     # plain versions on CPU
    assert rep["section"]["device"] == "cpu"
    assert not os.path.exists(tmp_path / "bench.json")
