"""PyTorch port: the training substrate (optimizer, schedules, data
pipeline, checkpoints, `Trainer`, the launcher's example) held against
the JAX package on the CPU.

The twins of `tests/test_train.py`'s six tests each assert what the
reference's test asserts, on the port, and hold the port against the
JAX function on the same inputs: AdamW on the quadratic (trajectories
within 1e-6), clipping (exact to 1e-6), the WSD shape (the schedules
equal to 1e-7 relative at every step), the synthetic LM and packing
(equal arrays), checkpoint shape validation (both packages refuse the
same templates).  Beside them:

  * one `adamw_update` on the same params, grads and state (fp32 and
    bf16 params, moments fp32) equal to the reference's within 1e-6;
  * the port's `Trainer` against the JAX `Trainer` on reduced
    granite-moe-1b-a400m for 5 steps from the same (bridged) weights on
    the same batches: per-step ce within 1e-4 relative, and every
    parameter within 2·lr·steps absolute (AdamW moves a parameter by at
    most about lr a step, so a parameter that took another path would
    sit further off);
  * a checkpoint the port's `Trainer` writes restores in the
    reference's `load_checkpoint` (its stacked layout, its path keys),
    and one the JAX `Trainer` writes restores in the port's `Trainer`,
    leaf for leaf;
  * the twin's own loss-decreases-and-restores test, and
    `examples/train_wsd_torch.py --device cpu` at a tiny size;
  * `examples/simulate_production_torch.py --quick` prints what
    `examples/simulate_production.py --quick` prints.
"""
import math
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as j_get_arch
from repro.data import pack_documents as j_pack
from repro.data import synthetic_batches as j_batches
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.train import Trainer as JTrainer
from repro.train import adamw_init as j_adamw_init
from repro.train import adamw_update as j_adamw_update
from repro.train import make_schedule as j_make_schedule
from repro.train.optimizer import clip_by_global_norm as j_clip

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.config import TrainConfig, get_arch
from repro_torch.data import pack_documents, synthetic_batches
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train import (
    Trainer, adamw_init, adamw_update, make_schedule,
)
from repro_torch.train.optimizer import clip_by_global_norm, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the twins of tests/test_train.py
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    jparams = {"w": jnp.asarray([5.0, -3.0])}
    opt, jopt = adamw_init(params), j_adamw_init(jparams)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, lr=5e-2,
                                      weight_decay=0.0)
        jgrads = jax.grad(lambda p: jnp.sum(p["w"] ** 2))(jparams)
        jparams, jopt, _ = j_adamw_update(jparams, jgrads, jopt, lr=5e-2,
                                          weight_decay=0.0)
    assert float(params["w"].abs().max()) < 1e-2
    assert np.allclose(_np(params["w"]), np.asarray(jparams["w"]),
                       atol=1e-6)
    assert int(opt["step"]) == int(jopt["step"]) == 300


def test_grad_clip():
    g = {"a": torch.tensor([3.0, 4.0])}          # norm 5
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0)
    jclipped, jnorm = j_clip({"a": jnp.asarray([3.0, 4.0])}, 1.0)
    assert abs(float(norm) - float(jnorm)) <= 1e-6
    assert np.allclose(_np(clipped["a"]), np.asarray(jclipped["a"]),
                       atol=1e-6)
    unclipped, _ = clip_by_global_norm(g, 10.0)
    assert torch.equal(unclipped["a"], g["a"])


def test_wsd_schedule_shape():
    fn = make_schedule("wsd", 1e-3, warmup_steps=10, total_steps=100,
                       stable_frac=0.8)
    assert float(fn(0)) == 0.0
    assert float(fn(10)) == pytest.approx(1e-3)
    assert float(fn(50)) == pytest.approx(1e-3)       # stable plateau
    assert float(fn(99)) < 0.5e-3                     # decay tail
    assert float(fn(79)) == pytest.approx(1e-3)
    for name in ("wsd", "cosine", "constant"):
        ours = make_schedule(name, 1e-3, 10, 100)
        ref = j_make_schedule(name, 1e-3, 10, 100)
        for step in range(0, 110, 3):
            a, b = float(ours(step)), float(ref(step))
            assert abs(a - b) <= 1e-7 * max(abs(b), 1e-12), (name, step)
        assert ours(torch.tensor(5, dtype=torch.int32)).dtype == torch.float32


def test_synthetic_lm_is_learnable_structure():
    lm = SyntheticLM(vocab=64, branching=4, seed=0)
    rng = np.random.default_rng(0)
    doc = lm.sample_doc(128, rng)
    for a, b in zip(doc[:-1], doc[1:]):
        assert b in lm.table[a]
    assert lm.optimal_ce() == pytest.approx(math.log(4))
    jlm = JSyntheticLM(vocab=64, branching=4, seed=0)
    assert np.array_equal(lm.table, jlm.table)
    assert np.array_equal(doc, jlm.sample_doc(128, np.random.default_rng(0)))
    for a, b in zip(synthetic_batches(64, 2, 16, num_batches=3),
                    j_batches(64, 2, 16, num_batches=3)):
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "targets"))


def test_packing_segments_and_targets():
    docs = [np.arange(5), np.arange(3), np.arange(7)]
    out = pack_documents(docs, seq_len=8)
    assert out["tokens"].shape[1] == 8
    for i in range(out["tokens"].shape[0]):
        seg = out["seg"][i]
        for j in range(8):
            if seg[j] >= 0 and (j == 7 or seg[j + 1] != seg[j]):
                assert out["targets"][i, j] == -100
    assert (out["positions"][out["seg"] == 0][:3] == [0, 1, 2]).all()
    ref = j_pack(docs, seq_len=8)
    assert set(out) == set(ref)
    assert all(np.array_equal(out[k], ref[k]) for k in ref)


def test_checkpoint_shape_validation():
    with tempfile.TemporaryDirectory() as d:
        tree = {"w": np.zeros((2, 3), np.float32),
                "t": torch.ones(2, 3, dtype=torch.bfloat16)}
        save_checkpoint(d, 5, tree)
        assert latest_step(d) == 5
        back, step, _ = load_checkpoint(d, tree)
        assert step == 5 and back["t"].dtype == np.float32
        assert np.array_equal(back["t"], np.ones((2, 3), np.float32))
        for load in (load_checkpoint, j_load):
            bad = {"w": np.zeros((3, 3), np.float32)}
            with pytest.raises(ValueError):
                load(d, bad)
            missing = {"v": np.zeros((2, 3), np.float32)}
            with pytest.raises(KeyError):
                load(d, missing)
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_trainer_loss_decreases_and_restores():
    cfg = get_arch("granite-moe-1b-a400m", reduced=True)
    tcfg = TrainConfig(global_batch=4, seq_len=32, lr=3e-3, total_steps=40,
                       warmup_steps=5, schedule="wsd")
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, tcfg, ckpt_dir=d, device="cpu")
        batches = synthetic_batches(cfg.vocab_size, 4, 32, branching=4)
        res = tr.fit(batches, steps=40, log_every=10, log_fn=lambda s: None)
        hist = res["history"]
        assert hist[-1][1] < hist[0][1]          # CE decreases
        tr.save()
        tr2 = Trainer(cfg, tcfg, ckpt_dir=d, device="cpu")
        assert tr2.step == 40 and int(tr2.opt_state["step"]) == 40
        for a, b in zip(tree_leaves(tr.params), tree_leaves(tr2.params)):
            assert torch.equal(a.detach(), b)
        for a, b in zip(tree_leaves(tr.opt_state), tree_leaves(
                tr2.opt_state)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the optimizer step and the Trainer against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_update_matches_jax(dtype, inplace):
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}}

    def tree(scale):
        def mk(s):
            if isinstance(s, dict):
                return {k: mk(v) for k, v in s.items()}
            return (rng.normal(size=s) * scale).astype(np.float32)
        return mk(shapes)
    p, g, mu, nu = tree(1.0), tree(3.0), tree(0.1), tree(0.1)
    nu = jax.tree.map(np.abs, nu)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
    jopt = {"mu": jax.tree.map(jnp.asarray, mu),
            "nu": jax.tree.map(jnp.asarray, nu),
            "step": jnp.asarray(6, jnp.int32)}
    jnew, jo, jm = j_adamw_update(jp, jg, jopt, 2e-3)

    def tt(a, dt=dtype):
        return {k: tt(v, dt) for k, v in a.items()} if isinstance(a, dict) \
            else torch.tensor(np.asarray(a, np.float32)).to(dt)
    tp = tt(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp))
    tg = tt(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jg))
    topt = {"mu": tt(mu, torch.float32), "nu": tt(nu, torch.float32),
            "step": torch.tensor(6, dtype=torch.int32)}
    new, o, m = adamw_update(tp, tg, topt, 2e-3, inplace=inplace)
    if inplace:
        assert new["a"] is tp["a"] and o["mu"]["a"] is topt["mu"]["a"]
    assert int(o["step"]) == 7 and o["mu"]["a"].dtype == torch.float32
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-6 * float(jm["grad_norm"])
    for a, b in zip(tree_leaves(new), jax.tree.leaves(jnew)):
        assert a.dtype == dtype
        b = np.asarray(b.astype(jnp.float32))
        # fp32: 1e-6; bf16: at most one rounding step of the stored value
        tol = 1e-6 if dtype == torch.float32 else 2 ** -8 * np.abs(b).max()
        assert np.abs(_np(a) - b).max() <= tol
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(o[name]), jax.tree.leaves(jo[name])):
            assert np.abs(_np(a) - np.asarray(b)).max() <= 1e-6


GRANITE = "granite-moe-1b-a400m"
STEPS, LR = 5, 3e-3


def _jax_and_port_trainers(ckpt=None, jckpt=None):
    """The JAX Trainer and the port's on reduced granite from the same
    weights (the JAX init's, bridged)."""
    jcfg = j_get_arch(GRANITE, reduced=True)
    cfg = get_arch(GRANITE, reduced=True)
    kw = dict(global_batch=2, seq_len=32, lr=LR, total_steps=STEPS,
              warmup_steps=1, schedule="wsd")
    jtr = JTrainer(jcfg, JTrainConfig(**kw), ckpt_dir=jckpt)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jtr.params),
                               device="cpu")
    tr = Trainer(cfg, TrainConfig(**kw), ckpt_dir=ckpt, device="cpu",
                 params=params)
    return jcfg, jtr, cfg, tr


def test_trainer_matches_jax_trainer():
    jcfg, jtr, cfg, tr = _jax_and_port_trainers()
    jh = jtr.fit(j_batches(jcfg.vocab_size, 2, 32, seed=3), STEPS,
                 log_every=1, log_fn=lambda s: None)["history"]
    th = tr.fit(synthetic_batches(cfg.vocab_size, 2, 32, seed=3), STEPS,
                log_every=1, log_fn=lambda s: None)["history"]
    assert [s for s, _ in jh] == [s for s, _ in th] == list(
        range(1, STEPS + 1))
    for (_s, a), (_t, b) in zip(jh, th):
        assert abs(a - b) <= 1e-4 * abs(a), (a, b)
    ref = jax.tree.map(np.asarray, jtr.params)
    got = params_to_numpy(cfg, tr.params)
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for key in path:
            g = g[key.key]
        assert np.abs(g - r).max() <= 2 * LR * STEPS, path
    assert int(tr.opt_state["step"]) == int(jtr.opt_state["step"]) == STEPS


def test_checkpoints_cross_packages():
    with tempfile.TemporaryDirectory() as port_dir, \
            tempfile.TemporaryDirectory() as jax_dir:
        jcfg, jtr, cfg, tr = _jax_and_port_trainers(port_dir, jax_dir)
        tr.fit(synthetic_batches(cfg.vocab_size, 2, 32, seed=5), 2,
               log_every=0)
        tr.save()
        template = {"params": jtr.params, "opt": jtr.opt_state}
        tree, step, _ = j_load(port_dir, template)
        assert step == 2 and int(tree["opt"]["step"]) == 2
        want = {"params": params_to_numpy(cfg, tr.params),
                "opt": {"mu": params_to_numpy(cfg, tr.opt_state["mu"]),
                        "nu": params_to_numpy(cfg, tr.opt_state["nu"])}}
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            if jax.tree_util.keystr(path) == "['opt']['step']":
                continue
            w = want
            for key in path:
                w = w[key.key]
            assert np.array_equal(np.asarray(leaf), w), path
        jtr.fit(j_batches(jcfg.vocab_size, 2, 32, seed=6), 3, log_every=0)
        jtr.save()
        back = Trainer(cfg, TrainConfig(global_batch=2, seq_len=32),
                       ckpt_dir=jax_dir, device="cpu")
        assert back.step == 3 and int(back.opt_state["step"]) == 3
        ref = {"params": jtr.params, "mu": jtr.opt_state["mu"],
               "nu": jtr.opt_state["nu"]}
        got = {"params": params_to_numpy(cfg, back.params),
               "mu": params_to_numpy(cfg, back.opt_state["mu"]),
               "nu": params_to_numpy(cfg, back.opt_state["nu"])}
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
            g = got
            for key in path:
                g = g[key.key]
            assert np.array_equal(np.asarray(leaf), g), path


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO)


def test_train_wsd_example_on_cpu():
    proc = _run([os.path.join(REPO, "examples", "train_wsd_torch.py"),
                 "--device", "cpu", "--steps", "15", "--batch", "2",
                 "--seq", "32"])
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-2000:]
    assert "on cpu" in out and "final CE" in out
    ces = [float(line.split("ce=")[1].split()[0])
           for line in out.splitlines() if line.startswith("step")]
    assert len(ces) == 15 and ces[-1] < ces[0]


def test_simulate_production_twin_prints_the_reference_summary():
    procs = [_run([os.path.join(REPO, "examples", name), "--quick"])
             for name in ("simulate_production.py",
                          "simulate_production_torch.py")]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-2000:]
        outs.append(out)
    assert outs[0] == outs[1] and "Decode: DP=32" in outs[0]


# ---------------------------------------------------------------------------
# abstract params and caches (the meta device)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b",
                                  "whisper-large-v3", "minicpm-2b"])
def test_abstract_params_match_jax_eval_shape(arch):
    """`abstract_params` of a full-size config (no storage: the meta
    device) has the shapes and dtypes of `jax.eval_shape` of the
    reference's init, layer by layer within each stack, the MTP head
    included."""
    from repro.models.model import abstract_params as j_abstract
    from repro_torch.bridge import _layer_slots
    from repro_torch.models.model import abstract_params
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    ours = abstract_params(cfg, torch.bfloat16)
    ref = j_abstract(jcfg, jnp.bfloat16)
    assert all(t.device.type == "meta" for t in tree_leaves(ours))

    def same(t, r, lead=()):
        if isinstance(r, dict):
            assert set(t) == set(r)
            for k in r:
                same(t[k], r[k], lead)
            return
        assert tuple(lead) + tuple(t.shape) == tuple(r.shape)
        assert str(t.dtype).replace("torch.", "") == str(r.dtype)
    for key in ("embed", "ln_f", "lm_head", "enc_ln_f", "mtp"):
        assert (key in ours) == (key in ref)
        if key in ref:
            same(ours[key], ref[key])
    slots = _layer_slots(cfg)
    for (key, i), layer in zip(slots, ours["layers"]):
        stack = ref["prefix"] if key == "prefix" else ref["blocks"][key]
        n = sum(k == key for k, _ in slots)
        same(layer, stack, (n,))
    for layer in ours.get("encoder", []):
        same(layer, ref["encoder"], (cfg.num_encoder_layers,))


@pytest.mark.parametrize("arch", ["deepseek-7b", "jamba-v0.1-52b",
                                  "whisper-large-v3"])
def test_abstract_cache_is_init_cache_on_meta(arch):
    from repro_torch.models.model import abstract_cache, init_cache
    cfg = get_arch(arch, reduced=True)
    ours = abstract_cache(cfg, 3, 40)
    ref = init_cache(cfg, 3, 40, dtype=torch.bfloat16, device="cpu")
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].device.type == "meta"
        assert ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype
    big = abstract_cache(get_arch(arch), 64, 32768)   # allocates nothing
    assert big["kv_pos"].shape == (64, 32768)
