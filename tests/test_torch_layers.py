"""PyTorch port: package guards, layer ops, plain attention, init and
bridge, each held against the JAX package on the same numpy inputs.

Tolerances: fp32 on both sides, so 1e-5 absolute for O(1) values (sums
are taken in another order by XLA and by PyTorch), exact for masks and
gathers.
"""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.model import init_params as j_init_params

from repro_torch.bridge import (
    cache_from_numpy, cache_to_numpy, params_from_numpy,
)
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model import init_params as t_init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(j, t, tol=TOL):
    a = np.asarray(j, np.float32)
    b = t.detach().float().numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol


# ---------------------------------------------------------------------------
# (f) the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

def test_import_guard_server_pulls_no_jax():
    examples = [os.path.join(REPO, "examples", f) for f in (
        "serve_e2e_torch.py", "train_wsd_torch.py",
        "simulate_production_torch.py")] + [
        os.path.join(REPO, "scripts", "microbench_torch.py")]
    code = ("import importlib.util, sys, repro_torch.serving.server\n"
            "import repro_torch.bridge, repro_torch.launch.mesh\n"
            "import repro_torch.distributed.sharding\n"
            "import repro_torch.distributed.annotate\n"
            "import repro_torch.models.moe_ep\n"
            "import repro_torch.train, repro_torch.checkpoint\n"
            "import repro_torch.data, repro_torch.launch.train\n"
            "import repro_torch.serving.e2e, repro_torch.launch.serve\n"
            "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.step_analysis\n"
            f"for i, f in enumerate({examples!r}):\n"
            "    s = importlib.util.spec_from_file_location(f'ex{i}', f)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _port_sources():
    root = os.path.join(REPO, "src", "repro_torch")
    for d, _sub, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "examples", "serve_e2e_torch.py")
    yield os.path.join(REPO, "examples", "quickstart_torch.py")
    yield os.path.join(REPO, "examples", "train_wsd_torch.py")
    yield os.path.join(REPO, "examples", "simulate_production_torch.py")
    yield os.path.join(REPO, "scripts", "microbench_torch.py")


def test_port_sources_import_no_jax_or_repro():
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, n)


# ---------------------------------------------------------------------------
# (a) layer ops
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    s = rng.normal(size=(64,)).astype(np.float32)
    _close(JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6),
           TL.rms_norm(torch.tensor(x), torch.tensor(s), 1e-6))


@pytest.mark.parametrize("hd,theta", [(64, 10000.0), (128, 1e6), (32, 500.0)])
def test_rope_matches_jax(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    _close(JL.rope_freqs(hd, theta), TL.rope_freqs(hd, theta))
    # angles up to 4000 rad: fp32 sin/cos of large arguments differ in the
    # last bits between libraries
    _close(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           TL.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
           tol=2e-4)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32) * 0.2
    j = JL.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))
    t = TL.swiglu(*map(torch.tensor, (x, wg, wu, wd)))
    _close(j, t)


# ---------------------------------------------------------------------------
# plain attention (repro/models/attention.py:21-314)
# ---------------------------------------------------------------------------

def _pos_seg(rng, B, S):
    pos = rng.integers(-2, 40, size=(B, S)).astype(np.int32)
    seg = rng.integers(-1, 3, size=(B, S)).astype(np.int32)
    return pos, seg


@pytest.mark.parametrize("causal,window,segs", [
    (True, 0, False), (True, 8, False), (False, 0, True), (True, 5, True)])
def test_build_mask_matches_jax(causal, window, segs):
    rng = np.random.default_rng(2)
    qp, qs = _pos_seg(rng, 2, 9)
    kp, ks = _pos_seg(rng, 2, 13)
    jseg = (jnp.asarray(qs), jnp.asarray(ks)) if segs else (None, None)
    tseg = (torch.tensor(qs), torch.tensor(ks)) if segs else (None, None)
    j = JA.build_mask(jnp.asarray(qp), jnp.asarray(kp), *jseg, causal, window)
    t = TA.build_mask(torch.tensor(qp), torch.tensor(kp), *tseg, causal,
                      window)
    assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("H,K", [(4, 4), (8, 2)])
def test_gqa_reference_matches_jax(H, K):
    rng = np.random.default_rng(H * K)
    B, Sq, Skv, hd = 2, 6, 11, 16
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, Skv, K, hd)).astype(np.float32)
            for _ in range(2))
    qp = np.tile(np.arange(5, 5 + Sq, dtype=np.int32), (B, 1))
    kp = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    kp[1, 3:] = -1                                # row 1: mostly empty
    qp[0, 0] = -1                                 # a fully masked row
    mj = JA.build_mask(jnp.asarray(qp), jnp.asarray(kp))
    mt = TA.build_mask(torch.tensor(qp), torch.tensor(kp))
    j = JA.gqa_reference(*map(jnp.asarray, (q, k, v)), mj)
    t = TA.gqa_reference(*map(torch.tensor, (q, k, v)), mt)
    _close(j, t)
    assert float(t[0, 0].abs().max()) == 0.0     # fully masked -> 0


def _paged_inputs(rng, B=3, N=12, bs=4, nbt=5, H=4, K=2, hd=16):
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    kp, vp = (rng.normal(size=(N, bs, K, hd)).astype(np.float32)
              for _ in range(2))
    kvp = rng.integers(-1, nbt * bs, size=(N, bs)).astype(np.int32)
    tab = np.full((B, nbt), -1, np.int32)
    ids = rng.permutation(np.arange(1, N))
    tab[0, :4] = ids[:4]
    tab[1, :2] = ids[4:6]                        # row 2 stays all -1
    pos = np.array([17, 6, 9], np.int32)
    return q, kp, vp, kvp, tab, pos


def test_gather_paged_matches_jax():
    q, kp, vp, kvp, tab, pos = _paged_inputs(np.random.default_rng(3))
    j = JA.gather_paged(jnp.asarray(kp), jnp.asarray(tab))
    t = TA.gather_paged(torch.tensor(kp), torch.tensor(tab))
    assert np.array_equal(np.asarray(j), t.numpy())
    j = JA.gather_paged_pos(jnp.asarray(kvp), jnp.asarray(tab))
    t = TA.gather_paged_pos(torch.tensor(kvp), torch.tensor(tab))
    assert np.array_equal(np.asarray(j), t.numpy())
    assert (t[2] == -1).all()                    # unset -> empty


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_paged_matches_jax(window):
    q, kp, vp, kvp, tab, pos = _paged_inputs(np.random.default_rng(4))
    j = JA.decode_attention_paged(*map(jnp.asarray, (q, kp, vp, kvp, tab,
                                                     pos)), window)
    t = TA.decode_attention_paged(*map(torch.tensor, (q, kp, vp, kvp, tab,
                                                      pos)), window)
    _close(j, t)
    assert float(t[2].abs().max()) == 0.0        # all -1 table -> 0


# ---------------------------------------------------------------------------
# init + bridge
# ---------------------------------------------------------------------------

def test_init_params_shapes_and_scales_match_jax():
    _check_init_matches_jax("deepseek-7b")


def test_init_params_ssm_shapes_and_scales_match_jax():
    """Mamba2 mixers: split projections, conv weights, and the fp32
    A_log / D_skip / dt_bias, as the JAX init."""
    _check_init_matches_jax("mamba2-370m")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "minicpm3-4b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b"])
def test_init_params_moe_and_mla_shapes_and_scales_match_jax(arch):
    """MoE FFNs (fp32 router and selection bias, stacked experts, shared
    experts), MLA attention with query compression, deepseek-v3's dense
    prefix layer and jamba's SSM_MOE layer, as the JAX init (the MTP head
    is not part of the port's params)."""
    _check_init_matches_jax(arch)


def _check_init_matches_jax(arch):
    cfg = get_arch(arch, reduced=True)
    tcfg = t_get_arch(arch, reduced=True)
    jp = jax.tree.map(np.asarray, jax.jit(j_init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0)))
    tp = t_init_params(tcfg, seed=0, device="cpu")
    ref = params_from_numpy(tcfg, jp, device="cpu")
    flat_t = jax.tree_util.tree_leaves_with_path(tp)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_t) == len(flat_r)
    for path, t in flat_t:
        r = flat_r[path]
        assert t.shape == r.shape and t.dtype == r.dtype, path
        # same init scale: N(0, s^2) drawn by another generator
        st, sr = float(t.float().std()), float(r.float().std())
        assert abs(st - sr) <= 0.1 * max(sr, 1e-6) or st == sr == 0, path


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-1b"])
def test_unported_archs_raise(arch):
    """The model-level functions take the encoder-decoder and the VLM;
    the serving engines, which carry no frame or patch embeddings to the
    prefill, refuse them."""
    from repro_torch.serving.real_engine import EngineSpec
    tcfg = t_get_arch(arch, reduced=True)
    params = t_init_params(tcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        EngineSpec(tcfg, params, device="cpu")


def test_cache_bridge_roundtrip():
    from repro.models.model import init_paged_cache
    cfg = get_arch("deepseek-7b", reduced=True)
    jc = jax.tree.map(np.asarray, init_paged_cache(cfg, 3, 7, 32, 8))
    rng = np.random.default_rng(5)
    k, v = jc["blocks"]["p0"]
    jc["blocks"]["p0"] = (rng.normal(size=k.shape).astype(np.float32),
                          rng.normal(size=v.shape).astype(np.float32))
    jc["kv_pos"] = rng.integers(-1, 32, size=jc["kv_pos"].shape
                                ).astype(np.int32)
    tcfg = t_get_arch("deepseek-7b", reduced=True)
    back = cache_to_numpy(tcfg, cache_from_numpy(tcfg, jc, device="cpu"))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(back)):
        assert np.array_equal(a, b)
