"""PyTorch port: the MoE FFN (`repro_torch.models.moe`) against the JAX
package's `repro.models.moe` on the same numpy inputs and the JAX init's
weights, in fp32 on the CPU:

  * `route` for softmax scoring (reduced granite-moe-1b-a400m) and for
    sigmoid scoring with a selection bias, `routed_scaling` and a shared
    expert (reduced deepseek-v3-671b);
  * `moe_block` at capacity_factor 8.0 (nothing drops) and 1.0 (tokens
    drop): the same output, and the same (token, expert) pairs dropped,
    read off each package's own output by which subset of a token's k
    expert contributions it is made of;
  * `moe_block` equals `moe_block_dense_reference` where nothing drops,
    and `aux_loss` equals the reference's.

Tolerance: 1e-5 of the largest output element (sums taken in another
order by XLA and by PyTorch); expert ids and drops exactly.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.models import moe as JMOE
from repro.models.model import init_params as j_init_params

from repro_torch.bridge import params_from_numpy
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.models import moe as TMOE

TOL = 1e-5
ARCHS = ["granite-moe-1b-a400m", "deepseek-v3-671b"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def layers():
    """{arch: (JAX cfg, port cfg, JAX moe params of the first MoE layer
    as numpy, the port's)}; the sigmoid router gets a nonzero selection
    bias (the init's is 0) so that selection and weights differ."""
    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch, reduced=True)
        tcfg = t_get_arch(arch, reduced=True)
        jp = jax.tree.map(np.asarray, jax.jit(
            j_init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0)))
        tp = params_from_numpy(tcfg, jp, device="cpu")
        layer = next(i for i, p in enumerate(tp["layers"]) if "moe" in p)
        tm = tp["layers"][layer]["moe"]
        jm = {k: v.numpy() for k, v in tm.items()}
        if "router_bias" in jm:
            bias = np.random.default_rng(3).normal(
                size=jm["router_bias"].shape).astype(np.float32) * 0.1
            jm["router_bias"] = bias
            tm["router_bias"] = torch.tensor(bias)
        out[arch] = (cfg, tcfg, jm, tm)
    return out


def _x(T, D, seed):
    return np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(layers, arch):
    cfg, tcfg, jm, tm = layers[arch]
    x = _x(64, cfg.d_model, 1)
    jw, je, jprob = JMOE.route(jnp.asarray(x), jax.tree.map(jnp.asarray, jm),
                               cfg.moe)
    tw, te, tprob = TMOE.route(torch.tensor(x), tm, tcfg.moe)
    assert np.array_equal(np.asarray(je), te.numpy())
    assert _rel(jw, tw) <= TOL
    assert _rel(jprob, tprob) <= TOL
    assert te.dtype == torch.int64 and tw.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax(layers, arch):
    cfg, tcfg, jm, tm = layers[arch]
    x = _x(48, cfg.d_model, 2)
    _w, je, jprob = JMOE.route(jnp.asarray(x), jax.tree.map(jnp.asarray, jm),
                               cfg.moe)
    _w, te, tprob = TMOE.route(torch.tensor(x), tm, tcfg.moe)
    ja = float(JMOE.aux_loss(jprob, je, cfg.moe.num_experts))
    ta = float(TMOE.aux_loss(tprob, te, tcfg.moe.num_experts))
    assert abs(ja - ta) <= TOL * max(abs(ja), 1.0)


def _kept_pairs(out, x, params, mc, expert):
    """Which of each token's k (token, expert) pairs an MoE output keeps:
    the subset of the token's weighted expert outputs (plus the shared
    experts) it is the sum of.  `expert(x (T, D), e)` is one expert's
    SwiGLU.  Returns a (T, k) bool array."""
    w, e, _ = TMOE.route(torch.tensor(x), params, mc)
    w, e = w.numpy(), e.numpy()
    T, k = e.shape
    contrib = np.stack([np.stack([w[t, j] * expert(x[t:t + 1], e[t, j])[0]
                                  for j in range(k)]) for t in range(T)])
    base = np.zeros_like(out)
    if mc.num_shared:
        base = TMOE._shared(torch.tensor(x), params).numpy()
    subsets = [np.array(m, bool) for m in itertools.product((0, 1),
                                                            repeat=k)]
    kept = np.zeros((T, k), bool)
    for t in range(T):
        errs = [np.abs(out[t] - base[t] - contrib[t][m].sum(0)).max()
                for m in subsets]
        best = int(np.argmin(errs))
        assert errs[best] <= 1e-4 * max(np.abs(out[t]).max(), 1.0)
        kept[t] = subsets[best]
    return kept


def _expert(params):
    def f(x, e):
        x = torch.tensor(x)
        g = x @ params["w_gate"][e]
        u = x @ params["w_up"][e]
        h = torch.nn.functional.silu(g) * u
        return (h @ params["w_down"][e]).numpy()
    return f


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax_and_drops_the_same_pairs(layers, arch,
                                                        capacity_factor):
    cfg, tcfg, jm, tm = layers[arch]
    mc = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    tmc = dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor)
    x = _x(64, cfg.d_model, 4)
    jout, jaux = JMOE.moe_block(jnp.asarray(x),
                                jax.tree.map(jnp.asarray, jm), mc)
    tout, taux = TMOE.moe_block(torch.tensor(x), tm, tmc)
    assert _rel(jout, tout) <= TOL
    assert abs(float(jaux) - float(taux)) <= TOL * max(abs(float(jaux)), 1.0)
    jkept = _kept_pairs(np.asarray(jout), x, tm, tmc, _expert(tm))
    tkept = _kept_pairs(tout.numpy(), x, tm, tmc, _expert(tm))
    assert np.array_equal(jkept, tkept)
    dropped = int((~tkept).sum())
    if capacity_factor == 8.0:
        assert dropped == 0
    else:
        # C = ceil(64·k/E) = 32: some expert overflows, and only its
        # latest tokens lose their slot
        assert dropped > 0
        _w, e, _ = TMOE.route(torch.tensor(x), tm, tmc)
        C = TMOE.capacity(64, tmc)
        for ex in range(tmc.num_experts):
            rows = np.nonzero((e.numpy() == ex).any(-1))[0]
            kept_rows = [t for t in rows
                         if tkept[t][list(e[t].numpy()).index(ex)]]
            assert kept_rows == list(rows[:C])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_equals_dense_reference_without_drops(layers, arch):
    _cfg, tcfg, _jm, tm = layers[arch]
    x = torch.tensor(_x(2 * 24, tcfg.d_model, 5)).reshape(2, 24, -1)
    out, aux = TMOE.moe_block(x, tm, tcfg.moe)
    ref, ref_aux = TMOE.moe_block_dense_reference(x, tm, tcfg.moe)
    assert out.shape == x.shape
    assert _rel(ref.numpy(), out) <= TOL
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)


def test_dense_reference_matches_jax(layers):
    cfg, tcfg, jm, tm = layers["deepseek-v3-671b"]
    x = _x(32, cfg.d_model, 6)
    jout, _ = JMOE.moe_block_dense_reference(
        jnp.asarray(x), jax.tree.map(jnp.asarray, jm), cfg.moe)
    tout, _ = TMOE.moe_block_dense_reference(torch.tensor(x), tm, tcfg.moe)
    assert _rel(jout, tout) <= TOL


@pytest.mark.parametrize("T", [1, 7, 64, 256])
@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_capacity_formula_matches_reference(T, cf):
    """C from the reference's expression (`repro/models/moe.py:118`) for
    the served configs' (E, k)."""
    import math
    for arch in ("granite-moe-1b-a400m", "deepseek-v3-671b",
                 "jamba-v0.1-52b"):
        mc = dataclasses.replace(t_get_arch(arch).moe, capacity_factor=cf)
        want = max(int(math.ceil(T * mc.top_k / mc.num_experts * cf)), 1)
        assert TMOE.capacity(T, mc) == want


def test_moe_params_init_and_bridge_dtypes():
    """The router and its bias stay fp32 in a bf16 model, in the port's
    init and through the bridge, as in the JAX init."""
    from repro_torch.models.model import init_params
    tcfg = t_get_arch("deepseek-v3-671b", reduced=True)
    tp = init_params(tcfg, dtype=torch.bfloat16, device="cpu")
    m = tp["layers"][1]["moe"]
    assert m["router"].dtype == torch.float32
    assert m["router_bias"].dtype == torch.float32
    assert m["w_gate"].dtype == torch.bfloat16
    assert m["w_gate"].shape == (4, 256, 128)
    assert m["shared_down"].shape == (128, 256)
    assert "mlp" in tp["layers"][0] and "moe" not in tp["layers"][0]
    cfg = get_arch("deepseek-v3-671b", reduced=True)
    jp = jax.tree.map(np.asarray, jax.jit(
        j_init_params, static_argnums=(0, 2))(cfg, jax.random.PRNGKey(0),
                                               jnp.bfloat16))
    bp = params_from_numpy(tcfg, jp, dtype=torch.bfloat16, device="cpu")
    assert bp["layers"][1]["moe"]["router"].dtype == torch.float32
    assert bp["layers"][1]["moe"]["w_up"].dtype == torch.bfloat16
