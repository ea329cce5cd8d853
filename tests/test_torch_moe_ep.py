"""PyTorch port: the expert-parallel MoE (`repro_torch.models.moe_ep`)
and the mesh pieces under it (`launch.mesh`, `distributed.sharding`,
`distributed.annotate`), on logical CPU meshes:

  * `moe_block_ep` against the JAX package's `moe_block_ep` (run in a
    subprocess on a forced-host 8-device mesh, as
    `tests/test_distributed.py` runs it) on the same numpy inputs:
    meshes 2×2 and 2×4, expert axes ("model",) and ("data", "model"),
    softmax scoring and sigmoid scoring with a selection bias and a
    shared expert, at capacity factor 8.0 (nothing drops) and 1.0
    (each source drops pairs: the per-source drops must match);
  * `moe_block_ep_reference` (the plain version) equals `moe_block_ep`;
  * `ep_all_to_all` moves slice g of every source to rank g and counts
    its exchanges and the bytes that cross between ranks;
  * the dispatch rule of `moe_block`: the EP path only under a mesh
    context whose expert axes divide E and whose devices divide T;
    otherwise the single-program result, also with expert weights split
    over the mesh (`ExpertShards`, no copy where the devices repeat);
  * `make_engine_mesh` raises with too few CUDA devices and refuses
    tensor parallelism.

Tolerance: 1e-5 of the largest output element in fp32 (sums taken in
another order by XLA and by PyTorch).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.config.base import MoEConfig
from repro_torch.distributed import annotate
from repro_torch.distributed.sharding import ExpertShards
from repro_torch.launch.mesh import (
    EngineMesh, make_engine_mesh, make_test_mesh, parse_mesh_devices,
)
from repro_torch.models import moe as TMOE
from repro_torch.models import moe_ep as TEP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
MESHES = [(2, 2), (2, 4)]
EP_AXES = [("model",), ("data", "model")]
CFS = [8.0, 1.0]
SCORES = ["softmax", "sigmoid"]
E, K, D, F = 8, 2, 16, 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _mc(score, cf):
    if score == "sigmoid":
        return MoEConfig(num_experts=E, top_k=K, d_expert=F,
                         capacity_factor=cf, num_shared=1, d_shared=F,
                         score_fn="sigmoid", routed_scaling=2.5)
    return MoEConfig(num_experts=E, top_k=K, d_expert=F, capacity_factor=cf)


def _inputs(score):
    """x (4, 16, D) and an MoE layer's params, as numpy, from a seed."""
    rng = np.random.default_rng(11)

    def n(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    p = {"router": n(D, E, scale=D ** -0.5),
         "w_gate": n(E, D, F, scale=D ** -0.5),
         "w_up": n(E, D, F, scale=D ** -0.5),
         "w_down": n(E, F, D, scale=F ** -0.5)}
    if score == "sigmoid":
        p["router_bias"] = n(E, scale=0.1)
        p["shared_gate"] = n(D, F, scale=D ** -0.5)
        p["shared_up"] = n(D, F, scale=D ** -0.5)
        p["shared_down"] = n(F, D, scale=F ** -0.5)
    return n(4, 16, D, scale=0.5), p


def _t(p):
    return {k: torch.tensor(v) for k, v in p.items()}


_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.config.base import MoEConfig
from repro.launch.mesh import make_test_mesh
from repro.models.moe_ep import moe_block_ep

src, dst = sys.argv[1], sys.argv[2]
data = dict(np.load(src))
out = {}
for score in ("softmax", "sigmoid"):
    p = {k[len(score) + 1:]: jnp.asarray(v) for k, v in data.items()
         if k.startswith(score + "/")}
    x = jnp.asarray(data["x/" + score])
    for cf in (8.0, 1.0):
        if score == "sigmoid":
            mc = MoEConfig(num_experts=8, top_k=2, d_expert=32,
                           capacity_factor=cf, num_shared=1, d_shared=32,
                           score_fn="sigmoid", routed_scaling=2.5)
        else:
            mc = MoEConfig(num_experts=8, top_k=2, d_expert=32,
                           capacity_factor=cf)
        for dm in ((2, 2), (2, 4)):
            mesh = make_test_mesh(*dm)
            for ep in (("model",), ("data", "model")):
                o, _ = jax.jit(lambda x, p: moe_block_ep(
                    x, p, mc, mesh, ("data",), ep))(x, p)
                out[f"{score}/{cf}/{dm[0]}x{dm[1]}/{'+'.join(ep)}"] = (
                    np.asarray(o))
np.savez(dst, **out)
print("JAX-EP-OK")
"""


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """JAX's `moe_block_ep` on every case, from one subprocess."""
    d = tmp_path_factory.mktemp("moe_ep")
    arrays = {}
    for score in SCORES:
        x, p = _inputs(score)
        arrays["x/" + score] = x
        arrays.update({f"{score}/{k}": v for k, v in p.items()})
    src, dst = str(d / "in.npz"), str(d / "out.npz")
    np.savez(src, **arrays)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _JAX, src, dst],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=REPO)
    assert res.returncode == 0 and "JAX-EP-OK" in res.stdout, \
        res.stderr[-3000:]
    return dict(np.load(dst))


@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("dm", MESHES)
@pytest.mark.parametrize("ep", EP_AXES)
def test_moe_block_ep_matches_jax(jax_ep, score, cf, dm, ep):
    x, p = _inputs(score)
    mc = _mc(score, cf)
    mesh = make_test_mesh(*dm)
    out, _ = TEP.moe_block_ep(torch.tensor(x), _t(p), mc, mesh, ("data",),
                              ep)
    want = jax_ep[f"{score}/{cf}/{dm[0]}x{dm[1]}/{'+'.join(ep)}"]
    got = out.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    # at factor 1.0 the per-source capacity binds: the single-program
    # moe_block drops other pairs, so it must differ (the case tests
    # the drops, not only the routing)
    single, _ = TMOE.moe_block(torch.tensor(x), _t(p), mc)
    binding = float((single - out).abs().max()) > 1e-3
    assert binding == (cf == 1.0)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("ep", EP_AXES)
def test_reference_equals_ep_and_counts_exchanges(cf, ep):
    x, p = _inputs("sigmoid")
    mc = _mc("sigmoid", cf)
    mesh = make_test_mesh(2, 4)
    G = 4 if ep == ("model",) else 8
    with TEP.count_exchanges() as st:
        out, laux = TEP.moe_block_ep(torch.tensor(x), _t(p), mc, mesh,
                                     ("data",), ep)
    ref, rlaux = TEP.moe_block_ep_reference(torch.tensor(x), _t(p), mc, 8)
    assert torch.allclose(out, ref, atol=TOL, rtol=0)
    assert abs(float(laux) - float(rlaux)) <= 1e-6
    # one dispatch and one combine exchange per EP group
    assert st.exchanges == 2 * (8 // G)
    C = max(int(np.ceil(8 * K / E * cf)), 1)
    per_source = E * C * D * 4                  # buckets (E, C, D) fp32
    assert st.bytes == 2 * 8 * per_source * (G - 1) // G
    assert st.seconds() is None


def test_ep_all_to_all_is_a_transpose():
    mesh = make_test_mesh(1, 4)
    blocks = [torch.arange(4 * 3).reshape(4, 3) + 100 * s for s in range(4)]
    with TEP.count_exchanges() as st:
        out = TEP.ep_all_to_all(blocks, mesh)
    for g in range(4):
        for s in range(4):
            assert torch.equal(out[g][s], blocks[s][g])
    assert st.exchanges == 1 and st.bytes == 12 * 3 * 8
    with pytest.raises(ValueError):
        TEP.ep_all_to_all(blocks[:3], mesh)


def test_local_dispatch_buckets_in_token_order():
    x = torch.arange(5 * 2, dtype=torch.float32).reshape(5, 2)
    top_e = torch.tensor([[0, 1], [0, 2], [0, 1], [2, 0], [1, 2]])
    top_w = torch.full((5, 2), 0.5)
    buckets, pos = TMOE._local_dispatch(x, top_w, top_e, 3, 2)
    # expert 0 keeps tokens 0 and 1 (token order), drops 2 and 3
    assert torch.equal(buckets[0], x[[0, 1]])
    assert pos[2, 0] == 2 and pos[3, 1] == 2
    assert torch.equal(buckets[1], x[[0, 2]])
    assert torch.equal(buckets[2], x[[1, 3]])


@pytest.mark.parametrize("T,route", [(64, "ep"), (60, "single")])
def test_moe_block_dispatch_rule(T, route):
    """Under an EP mesh context moe_block takes the EP path when the
    devices divide T (per-source capacity, which binds here), and the
    single-program semantics otherwise, also with the expert weights
    split over the mesh."""
    x, p = _inputs("softmax")
    x = torch.tensor(x).reshape(-1, D)[:T]
    mc = _mc("softmax", 1.0)
    mesh = make_test_mesh(2, 4)
    amap = {"tokens": ("data",), "experts": ("data", "model")}
    split = dict(_t(p))
    for name in ("w_gate", "w_up", "w_down"):
        split[name] = ExpertShards(split[name], mesh, ("data", "model"))
    with annotate.activate(mesh, amap, ep_shard_map=True):
        with TEP.count_exchanges() as st:
            out, _ = TMOE.moe_block(x, split, mc)
    assert annotate.active() is None
    if route == "ep":
        want, _ = TEP.moe_block_ep_reference(x, _t(p), mc, 8)
        assert st.exchanges == 2
    else:
        want, _ = TMOE.moe_block(x, _t(p), mc)
        assert st.exchanges == 0
    assert torch.allclose(out, want, atol=TOL, rtol=0)
    # no context: single-program, whatever the shapes
    out2, _ = TMOE.moe_block(x, split, mc)
    want2, _ = TMOE.moe_block(x, _t(p), mc)
    assert torch.allclose(out2, want2, atol=TOL, rtol=0)


def test_expert_shards_share_storage_on_repeated_devices():
    w = torch.randn(8, 4, 3)
    mesh = make_engine_mesh(4, devices=["cpu"] * 4)
    sh = ExpertShards(w, mesh, ("data", "model"))
    assert sh.G == 4 and sh.E_per == 2 and sh.ranks == [0, 1, 2, 3]
    for r in range(4):
        assert sh.home(r).data_ptr() == w[2 * r].data_ptr()
        assert torch.equal(sh.home(r), w[2 * r:2 * r + 2])
    with pytest.raises(ValueError):
        ExpertShards(torch.randn(6, 4, 3), mesh, ("data", "model"))


def test_engine_mesh_layout_and_errors(monkeypatch):
    mesh = make_test_mesh(2, 4)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.coords(6) == {"data": 1, "model": 2}
    assert mesh.index(mesh.coords(6), ("model", "data")) == 5
    assert mesh.distinct == [torch.device("cpu")]
    assert parse_mesh_devices("cuda:0x4") == ["cuda:0"] * 4
    assert parse_mesh_devices("cuda:0,cuda:1") == ["cuda:0", "cuda:1"]
    em = make_engine_mesh(4, devices=parse_mesh_devices("cpux4"))
    assert isinstance(em, EngineMesh) and em.lead == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        make_engine_mesh(4)
    tp = make_engine_mesh(2, 2, devices=["cpu"] * 4)
    assert tp.shape == {"data": 2, "model": 2}
    assert tp.coords(3) == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_engine_mesh(4, devices=["cpu"] * 3)
