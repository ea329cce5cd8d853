"""PyTorch port: launch and tooling (`repro_torch.launch.{serve, specs,
dryrun, step_analysis}`, `make_production_mesh`, the production
sharding rules and `scripts/microbench_torch.py`) against the reference,
on the CPU:

  * the port's `param_pspecs`, `cache_pspecs`, `paged_cache_pspecs`,
    `batch_pspecs` and `opt_pspecs` equal the reference's (as strings)
    for every assigned architecture and every input shape, on the 16 ×
    16 and 2 × 16 × 16 production meshes; the reference's side comes
    from one JAX subprocess with 512 forced host devices (specs only);
  * `lower_one` runs on `meta` tensors for one architecture per family
    at full size, and its FLOPs a device equal the reference's
    `analyze_hlo` on the same reduced training step compiled for one
    CPU device, within 10%;
  * the collective formula of `launch.step_analysis`, one hand-reckoned
    case per kind;
  * `launch.serve --mode sim` prints the reference's line, and the real
    mode's `serve_real`, given the reference's weights, returns the
    reference server's tokens;
  * `scripts/microbench_torch.py --device cpu` prints every row;
  * chip_smoke.py's phase 6l (the launcher's real mode and the
    microbench twin) rehearsed.
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.bridge import _layer_slots, params_from_numpy
from repro_torch.config.base import INPUT_SHAPES, InputShape, ParallelConfig
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.configs import ASSIGNED
from repro_torch.distributed.sharding import (
    PSpec, batch_pspecs, cache_pspecs, opt_pspecs, paged_cache_pspecs,
    param_pspecs,
)
from repro_torch.launch.dryrun import _lower_inner, default_parallel, lower_one
from repro_torch.launch.mesh import EngineMesh, make_production_mesh
from repro_torch.launch.specs import batch_inputs
from repro_torch.launch.step_analysis import collective_estimate
from repro_torch.models import model as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGED = dict(slots=32, blocks=64, max_len=256, block_size=16)
FAMILIES = ["deepseek-7b", "deepseek-v3-671b", "mamba2-370m",
            "jamba-v0.1-52b", "whisper-large-v3"]
REDUCED_TRAIN = dict(seq_len=64, global_batch=2)
FLOPS_TOL = 0.10


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_JAX = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.config.base import INPUT_SHAPES, InputShape, get_arch
from repro.configs import ASSIGNED
from repro.distributed.sharding import (
    batch_pspecs, cache_pspecs, opt_pspecs, paged_cache_pspecs,
    param_pspecs)
from repro.launch.dryrun import default_parallel
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import (
    abstract_opt_state, batch_inputs, make_step_fn)
from repro.models import abstract_cache, abstract_params
from repro.models import model as JM

PAGED = json.loads(sys.argv[2])
FAMILIES = json.loads(sys.argv[3])
RT = json.loads(sys.argv[4])

def key(p):
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return "#%d" % p.idx
    return str(p)

def flat(specs, tree):
    out = []
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sl = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    for (path, s), (_p, leaf) in zip(sl, leaves):
        out.append(["/".join(key(k) for k in path), list(leaf.shape),
                    str(s)])
    return out

out = {"specs": {}, "paged": {}, "flops": {}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    mname = "multi" if mp else "single"
    for arch in ASSIGNED:
        cfg = get_arch(arch)
        params = abstract_params(cfg, jnp.bfloat16)
        by_kind = {}
        for sname, shape in INPUT_SHAPES.items():
            par = default_parallel(cfg, shape, mesh)
            kind = shape.kind == "train"
            if kind not in by_kind:
                ps = param_pspecs(cfg, mesh, par, params)
                by_kind[kind] = (flat(ps, params),
                                 str(opt_pspecs(ps)["step"]))
            rec = {"params": by_kind[kind][0], "opt_step": by_kind[kind][1]}
            ins = batch_inputs(cfg, shape, jnp.bfloat16)
            if shape.kind == "train":
                b = ins["batch"]
            elif shape.kind == "prefill":
                b = ins
            else:
                b = {"token": ins["token"]}
                rec["cache"] = flat(cache_pspecs(
                    cfg, mesh, par, ins["cache"], shape.global_batch),
                    ins["cache"])
            rec["batch"] = flat(batch_pspecs(
                mesh, par, shape.global_batch, b), b)
            out["specs"]["%s|%s|%s" % (arch, sname, mname)] = rec
        try:
            JM.paged_layout(cfg, PAGED["max_len"], PAGED["block_size"])
        except ValueError:
            continue
        cache = jax.eval_shape(lambda: JM.init_paged_cache(
            cfg, PAGED["slots"], PAGED["blocks"], PAGED["max_len"],
            PAGED["block_size"]))
        par = default_parallel(cfg, INPUT_SHAPES["decode_32k"], mesh)
        out["paged"]["%s|%s" % (arch, mname)] = flat(
            paged_cache_pspecs(cfg, mesh, par, cache), cache)
# the reduced training step's FLOPs on one CPU device
for arch in FAMILIES:
    cfg = get_arch(arch, reduced=True)
    shape = InputShape("train_r", RT["seq_len"], RT["global_batch"], "train")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1])
    par = default_parallel(cfg, shape, mesh)
    fn, _ = make_step_fn(cfg, shape, remat=par.remat)
    pa = abstract_params(cfg, jnp.bfloat16)
    b = batch_inputs(cfg, shape, jnp.bfloat16)["batch"]
    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    low = jax.jit(fn, in_shardings=dev).lower(
        pa, abstract_opt_state(pa), b)
    out["flops"][arch] = analyze_hlo(low.compile().as_text())["flops"]
json.dump(out, open(sys.argv[1], "w"))
print("JAX-SPECS-OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("launch") / "specs.json")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run(
        [sys.executable, "-c", _JAX, dst, json.dumps(PAGED),
         json.dumps(FAMILIES), json.dumps(REDUCED_TRAIN)],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0 and "JAX-SPECS-OK" in res.stdout, \
        res.stderr[-3000:]
    with open(dst) as f:
        return json.load(f)


def _leaves(tree, path=()):
    if isinstance(tree, (torch.Tensor, PSpec)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))


def _ref_param_key(cfg, path):
    """The reference's key of the port's param leaf at `path`, and
    whether the reference stacks it (a leading layer axis, never
    split)."""
    if path[0] == "layers":
        group, _i = _layer_slots(cfg)[int(path[1])]
        head = ("prefix",) if group == "prefix" else ("blocks", group)
        return "/".join(head + path[2:]), True
    if path[0] == "encoder":
        return "/".join(("encoder",) + path[2:]), True
    return "/".join(path), False


def _by_tail(entries):
    """Reference leaves keyed by their shape without the leading axis
    (the port stacks caches by kind, the reference by layer group; the
    rules read only the shape past the stacked axis)."""
    out = {}
    for path, shape, spec in entries:
        out.setdefault(tuple(shape[1:]), set()).add(spec)
    return out


def _check_cache(port_tree, port_specs, ref_entries, what):
    named = {p: s for p, _shape, s in ref_entries
             if p in ("cur", "kv_pos", "block_tab")}
    tails = _by_tail([e for e in ref_entries if e[0] not in named])
    for (path, t), (_p, spec) in zip(_leaves(port_tree),
                                     _leaves(port_specs)):
        if path[0] in named:
            assert str(spec) == named[path[0]], (what, path)
            continue
        want = tails.get(tuple(t.shape[1:]))
        assert want is not None and len(want) == 1, (what, path, t.shape)
        assert str(spec) == next(iter(want)), (what, path, spec, want)


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_production_specs_equal_reference(ref, mesh_name):
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    checked = 0
    for arch in ASSIGNED:
        cfg = t_get_arch(arch)
        params = TM.abstract_params(cfg)
        for sname, shape in INPUT_SHAPES.items():
            rec = ref["specs"][f"{arch}|{sname}|{mesh_name}"]
            par = default_parallel(cfg, shape, mesh)
            specs = param_pspecs(cfg, mesh, par, params)
            want = {p: s for p, _shape, s in rec["params"]}
            n = 0
            for path, spec in _leaves(specs):
                key, stacked = _ref_param_key(cfg, path)
                got = PSpec(None, *spec) if stacked else spec
                assert str(got) == want[key], (arch, sname, key)
                n += 1
            assert n == len(list(_leaves(params)))
            opt = opt_pspecs(specs)
            assert str(opt["step"]) == rec["opt_step"] == "PartitionSpec()"
            assert opt["mu"] is specs and opt["nu"] is specs
            ins = batch_inputs(cfg, shape)
            b = (ins["batch"] if shape.kind == "train" else ins
                 if shape.kind == "prefill" else {"token": ins["token"]})
            bwant = {p: s for p, _shape, s in rec["batch"]}
            bs = batch_pspecs(mesh, par, shape.global_batch, b)
            assert {k: str(v) for k, v in bs.items()} == bwant
            if shape.kind == "decode":
                cache = ins["cache"]
                _check_cache(cache, cache_pspecs(cfg, mesh, par, cache,
                                                 shape.global_batch),
                             rec["cache"], (arch, sname))
            checked += 1
        key = f"{arch}|{mesh_name}"
        if key in ref["paged"]:
            cache = TM.init_paged_cache(
                cfg, PAGED["slots"], PAGED["blocks"], PAGED["max_len"],
                PAGED["block_size"], dtype=torch.bfloat16, device="meta")
            par = default_parallel(cfg, INPUT_SHAPES["decode_32k"], mesh)
            _check_cache(cache, paged_cache_pspecs(cfg, mesh, par, cache),
                         ref["paged"][key], (arch, "paged"))
    assert checked == len(ASSIGNED) * len(INPUT_SHAPES)
    # the paged caches of every architecture that pages
    assert len([k for k in ref["paged"] if k.endswith(mesh_name)]) >= 8


@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_one_on_meta(ref, arch):
    """Full size on the 16 × 16 mesh (a decode step: seconds), then the
    reduced training step's FLOPs against the reference's HLO count."""
    rec = lower_one(arch, "decode_32k", False)
    assert rec["status"] == "ok", rec
    assert rec["roofline"]["chips"] == 256
    assert rec["roofline"]["card"] == "NVIDIA H100 80GB HBM3, 700 W"
    for k in ("flops_per_device", "hbm_bytes_per_device",
              "collective_bytes_per_device", "collectives"):
        assert k in rec["analysis"]
    assert rec["analysis"]["flops_per_device"] > 0
    assert isinstance(rec["fits"], bool)
    long = lower_one(arch, "long_500k", False, compile_=False)
    assert long["status"] == ("lowered" if arch in ("mamba2-370m",
                                                    "jamba-v0.1-52b")
                              else "skipped")
    cfg = t_get_arch(arch, reduced=True)
    shape = InputShape("train_r", REDUCED_TRAIN["seq_len"],
                       REDUCED_TRAIN["global_batch"], "train")
    one = EngineMesh(["meta"], (1, 1), ("data", "model"))
    rec = _lower_inner(cfg, shape, one, default_parallel(cfg, shape, one),
                       {}, True, torch.bfloat16, time.time())
    got, want = rec["analysis"]["flops_per_device"], ref["flops"][arch]
    assert abs(got - want) <= FLOPS_TOL * want, (arch, got, want)


def test_collective_formula_by_kind():
    """One hand-reckoned leaf per kind on a (2, 2) mesh, 6 tokens a
    device, d_model 16, bf16."""
    cfg = dataclasses.replace(t_get_arch("granite-moe-1b-a400m",
                                         reduced=True), d_model=16)
    mesh = EngineMesh(["meta"] * 4, (2, 2), ("data", "model"))
    tok, act = 6.0, 6 * 16 * 2
    bf = dict(dtype=torch.bfloat16, device="meta")

    def est(params, kind, par=ParallelConfig(), remat="none"):
        specs = param_pspecs(cfg, mesh, par, params)
        c = collective_estimate(cfg, mesh, par, params, specs, kind, tok,
                                remat, ("data",))
        return ({k: v for k, v in c["counts"].items() if v},
                {k: v for k, v in c["bytes_by_op"].items() if v})
    # all-reduce: a row-parallel w_o (H = 4 split on "model"), decode
    w_o = {"layers": [{"attn": {"w_o": torch.empty(4, 8, 16, **bf)}}]}
    assert est(w_o, "decode") == ({"all-reduce": 1}, {"all-reduce": act})
    # all-to-all: an MoE layer's experts over (data, model): dispatch
    # and combine of tok · top_k · capacity_factor · d_model · 2 bytes
    moe = {"layers": [{"moe": {"w_gate": torch.empty(4, 16, 8, **bf)}}]}
    ep = ParallelConfig(expert_axes=("data", "model"))
    a2a = tok * cfg.moe.top_k * cfg.moe.capacity_factor * 16 * 2
    assert est(moe, "prefill", ep) == ({"all-to-all": 2},
                                       {"all-to-all": 2 * a2a})
    # all-gather and reduce-scatter: FSDP in training with block remat:
    # a dense w_gate (64, 32), "model" on its 32 columns, "data" on its
    # 64 rows: gathered to 64·16·2 bytes twice (forward, recomputation),
    # its gradient scattered to 32·16·2 bytes; its input gradient (a
    # column-parallel product) all-reduced once
    fsdp = ParallelConfig(fsdp_params=True)
    wg = {"layers": [{"mlp": {"w_gate": torch.empty(64, 32, **bf)}}]}
    counts, nbytes = est(wg, "train", fsdp, remat="block")
    assert counts == {"all-gather": 2, "reduce-scatter": 1, "all-reduce": 1}
    assert nbytes == {"all-gather": 2 * 64 * 16 * 2,
                      "reduce-scatter": 32 * 16 * 2, "all-reduce": act}


def test_serve_sim_prints_the_reference_line(capsys, monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    argv = ["serve", "--mode", "sim", "--duration", "4", "--qps", "60"]
    for extra in ([], ["--cache-aware", "--scheduler", "immediate-lt"]):
        monkeypatch.setattr(sys, "argv", argv + extra)
        jserve.main()
        want = capsys.readouterr().out
        tserve.main(argv[1:] + extra)
        got = capsys.readouterr().out
        assert got == want and got.startswith(
            extra[-1] if extra else "sbs")


def test_serve_real_matches_reference_server():
    from repro.config import get_arch
    from repro.core.types import Request as JRequest
    from repro.models import model as JM
    from repro.serving.server import RealSBSServer as JServer
    from repro_torch.launch.serve import make_requests, serve_real
    cfg = get_arch("deepseek-7b", reduced=True)
    tcfg = t_get_arch("deepseek-7b", reduced=True)
    jp = jax.jit(JM.init_params, static_argnums=0)(cfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    reqs = make_requests(tcfg, 4, seed=0)
    gens, _srv = serve_real(tcfg, tp, reqs, "cpu")
    jreqs = [JRequest(rid=r.rid, arrival_time=r.arrival_time,
                      input_len=r.input_len, output_len=r.output_len,
                      tokens=r.tokens) for r in reqs]
    rng = random.Random(0)           # the reference launcher's traffic
    for r in jreqs:
        L = rng.randrange(16, 96)
        assert r.input_len == L and r.tokens == tuple(
            rng.randrange(cfg.vocab_size) for _ in range(L))
    want = {g.rid: g.tokens for g in JServer(
        cfg, jp, scheduler="sbs", max_len=160, max_new=8).serve(
            jreqs, timeout=300)}
    got = {g.rid: g.tokens for g in gens}
    assert set(got) == set(range(4)) and got == want


def test_microbench_twin_prints_every_row(capsys):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import microbench_torch
    finally:
        sys.path.pop(0)
    assert microbench_torch.cli(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = out[out.index("name,us_per_call,derived") + 1:]
    names = [r.split(",")[0] for r in rows]
    want = ["micro/pbaa_64x8", "micro/decode_64x32",
            "micro/radix_match_512", "micro/pool_heap_churn_64k",
            "micro/pool_sorted_churn_64k"]
    for n in (2, 4, 8):
        want += [f"micro/ep_a2a_{n}dev", f"micro/sharded_decode_step_{n}dev"]
    assert names == want
    for r in rows:
        name, us, derived = r.split(",")
        assert float(us) > 0 and derived == ""


def test_chip_smoke_launch_phase_rehearsed():
    """chip_smoke.py's phase 6l on the CPU: `launch/serve.py --mode real`
    through its `main` (every request served with 8 tokens; the plain
    versions on the CPU, so no launch is counted), then the microbench
    twin's rows."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.flash_prefill import (
        flash_prefill, paged_prefill_attention)
    from repro_torch.kernels.ssd_scan import ssd_chunk
    counters = [paged_decode_attention, paged_prefill_attention,
                flash_prefill, decode_attention, ssd_chunk]
    rep = chip_smoke.launch_phase(counters, "cpu", requests=3)
    assert sorted(rep["serve"]["tokens"]) == [0, 1, 2]
    assert all(len(t) == 8 for t in rep["serve"]["tokens"].values())
    assert set(rep["serve"]["launches"].values()) == {0}
    assert len(rep["microbench"]) == 11
