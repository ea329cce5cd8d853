"""PyTorch port: the training forward's loss and gradients held against
the JAX package on the CPU.

  * For every registered architecture at its reduced size, with the JAX
    init's weights bridged over (`params_from_numpy`) and the same numpy
    batch (seeded tokens and targets with ignored positions; a packed
    batch from `pack_documents` on one dense and one SSM arch; stub
    frame or patch embeddings for whisper and internvl2-1b): the port's
    `forward_train` loss and metrics equal the reference's within 1e-5
    relative, and every gradient leaf, carried back into the reference's
    stacked layout by `params_to_numpy`, agrees with `jax.grad` of the
    reference's loss within 1e-3 of that leaf's largest magnitude
    (DeepSeek-V3's multi-token-prediction head included; a leaf the
    loss does not reach is zero on both sides).  Both sides run fp32;
    the gradients are the same sums in other orders, measured within
    2e-5 relative.
  * Kernel #2's and #4's autograd `Function`s (`flash_prefill_train`,
    whose backward is torch ops, and `ssd_chunk_train`) against autograd
    through their plain versions, within 1e-5 of each gradient's
    largest magnitude: #2 causal and not, with packed segments (pads
    included), a window, head dims 64, 120 and 128 and G > 1, also
    against `jax.vjp` of the reference's `gqa_reference`; #4 at chunk
    lengths up to its 256 and every (head dim, state dim) it takes.
  * `remat` True/"block" and "dots" giving the gradients of no remat,
    within 1e-6 of each leaf's largest.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch, list_archs
from repro.data import pack_documents
from repro.models import attention as JA
from repro.models import model as JM

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.kernels.flash_prefill import (
    flash_prefill_plain, flash_prefill_train,
)
from repro_torch.kernels.ssd_scan import ssd_chunk_plain, ssd_chunk_train
from repro_torch.models import model as TM
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

LOSS_TOL = 1e-5          # relative, loss and metrics
GRAD_TOL = 1e-3          # of each gradient leaf's largest magnitude
FN_TOL = 1e-5            # the Functions against autograd of the plain
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX cfg, JAX params, port cfg, numpy params) of a reduced arch."""
    cfg = get_arch(arch, reduced=True)
    params = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    return cfg, params, t_get_arch(arch, reduced=True), \
        jax.tree.map(np.asarray, params)


def _batch(cfg, packed, seed=0):
    """A numpy batch: random tokens and targets (some ignored), or
    documents packed into rows of S tokens (segments, positions, pads);
    stub frame or patch embeddings where the model takes them."""
    rng = np.random.default_rng(seed)
    if packed:
        docs = [rng.integers(0, cfg.vocab_size, n) for n in (9, 7, 11, 5, 13)]
        batch = pack_documents(docs, S)
        assert batch["tokens"].shape[0] == B and (batch["seg"] < 0).any()
    else:
        tgt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        tgt[0, -3:] = -100
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (B, S)).astype(np.int32),
                 "targets": tgt}
    n = (cfg.encoder_seq_len if cfg.is_encoder_decoder
         else cfg.num_patch_tokens)
    if n:
        batch["embeds"] = (rng.normal(size=(B, n, cfg.d_model))
                           * 0.1).astype(np.float32)
    return batch


def _port_loss_grads(tcfg, nparams, batch, remat=False):
    """(loss, metrics, gradient tree in the port's layout) of the port's
    `forward_train` on bridged weights."""
    params = params_from_numpy(tcfg, nparams, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = TM.forward_train(
        tcfg, params, {k: torch.tensor(v) for k, v in batch.items()},
        remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, tree_unflatten(params, grads)


_CASES = [(a, False) for a in list_archs()] + [("deepseek-7b", True),
                                               ("mamba2-370m", True)]


@pytest.mark.parametrize("arch,packed", _CASES,
                         ids=[f"{a}{'-packed' if p else ''}"
                              for a, p in _CASES])
def test_forward_train_loss_and_grads_match_jax(arch, packed):
    cfg, jparams, tcfg, nparams = _pair(arch)
    batch = _batch(cfg, packed)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(cfg, p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm, tg = _port_loss_grads(tcfg, nparams, batch)
    assert set(tm) == set(jm)
    if cfg.mtp_depth:
        assert "mtp_ce" in tm and "mtp" in tg
    for k in jm:
        a, b = float(jm[k]), float(tm[k].detach())
        assert abs(a - b) <= LOSS_TOL * max(abs(a), 1e-6), (k, a, b)
    assert abs(float(jl) - float(tl.detach())) <= LOSS_TOL * abs(float(jl))
    port = params_to_numpy(tcfg, tg)
    flat = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jg))
    assert len(flat) == len(jax.tree.leaves(port))
    for path, ref in flat:
        got = port
        for key in path:
            got = got[key.key]
        assert got.shape == ref.shape, path
        d = float(np.abs(got - ref).max())
        assert d <= GRAD_TOL * float(np.abs(ref).max()) or d == 0.0, (
            jax.tree_util.keystr(path), d, float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the autograd Functions against autograd through their plain versions
# ---------------------------------------------------------------------------

# (H, K, hd, Sq, Skv, causal, packed, window)
_FLASH_CASES = [
    (4, 4, 64, 40, 40, True, False, 0),
    (4, 2, 64, 40, 40, True, True, 0),          # G = 2, packed, pads
    (6, 2, 128, 33, 33, True, False, 7),        # G = 3, a window
    (8, 2, 120, 29, 29, True, True, 5),         # hd 120, G = 4
    (4, 4, 64, 17, 50, False, False, 0),        # cross-attention shape
    (2, 2, 128, 600, 600, True, True, 0),       # past one 512-row tile
    (14, 2, 64, 20, 20, False, True, 0),        # G = 7, not causal
]


def _flash_inputs(H, K, hd, Sq, Skv, causal, packed, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) * 0.5
               for s in ((2, Sq, H, hd), (2, Skv, K, hd), (2, Skv, K, hd)))
    do = rng.normal(size=(2, Sq, H, hd)).astype(np.float32)
    qp = np.tile(np.arange(Sq, dtype=np.int32), (2, 1))
    kp = np.tile(np.arange(Skv, dtype=np.int32), (2, 1))
    qs = np.zeros((2, Sq), np.int32)
    ks = np.zeros((2, Skv), np.int32)
    if packed:
        cut = Sq // 3
        qs[:, cut:] = ks[:, cut:] = 1
        qp[:, cut:] -= cut
        kp[:, cut:] -= cut
        qs[1, -4:] = ks[1, -4:] = -1          # a padded tail
    return q, k, v, do, qp, kp, qs, ks


def _close(a, b, tol=FN_TOL):
    a = a.detach().float() if isinstance(a, torch.Tensor) else \
        torch.tensor(np.asarray(a))
    b = b.detach().float() if isinstance(b, torch.Tensor) else \
        torch.tensor(np.asarray(b))
    assert a.shape == b.shape
    d = float((a - b).abs().max())
    assert d <= tol * max(float(b.abs().max()), 1e-30) or d == 0.0, d


@pytest.mark.parametrize("case", _FLASH_CASES, ids=lambda c: (
    "H{}K{}hd{}q{}kv{}c{}p{}w{}".format(*c)))
def test_flash_prefill_train_matches_plain_autograd_and_jax(case):
    H, K, hd, Sq, Skv, causal, packed, window = case
    q, k, v, do, qp, kp, qs, ks = _flash_inputs(H, K, hd, Sq, Skv, causal,
                                                packed)
    ints = [torch.tensor(a) for a in (qp, kp, qs, ks)]
    ins = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = flash_prefill_train(*ins, *ints, causal, window)
    got = torch.autograd.grad(out, ins, torch.tensor(do))
    ref_in = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    ref = flash_prefill_plain(*ref_in, *ints, causal, window)
    want = torch.autograd.grad(ref, ref_in, torch.tensor(do))
    _close(out, ref)
    for a, b in zip(got, want):
        _close(a, b)
    if packed:                    # a fully masked row: no gradient
        assert float(got[0][1, -4:].abs().max()) == 0.0

    def jf(q_, k_, v_):
        return JA.gqa_reference(q_, k_, v_, JA.build_mask(
            jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(qs),
            jnp.asarray(ks), causal, window))
    _jo, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(do))):
        _close(a, b)


@pytest.mark.parametrize("Q,nh,hp,ds", [(1, 2, 32, 16), (65, 3, 64, 32),
                                        (128, 2, 32, 64), (256, 2, 64, 128)])
def test_ssd_chunk_train_matches_plain_autograd(Q, nh, hp, ds):
    rng = np.random.default_rng(Q + ds)
    x = rng.normal(size=(2, 2, Q, nh, hp)).astype(np.float32) * 0.3
    dt = np.log1p(np.exp(rng.normal(size=(2, 2, Q, nh)) - 2)).astype(
        np.float32)
    A = -np.exp(np.linspace(0, 1, nh)).astype(np.float32)
    bc = rng.normal(size=(2, 2, Q, 2 * ds)).astype(np.float32) * 0.3
    dy = torch.tensor(rng.normal(size=(2, 2, Q, nh, hp)).astype(np.float32))
    dst = torch.tensor(rng.normal(size=(2, 2, nh, hp, ds)).astype(
        np.float32))

    def run(fn):
        ins = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, bc)]
        y, st = fn(ins[0], ins[1], ins[2], ins[3][..., :ds],
                   ins[3][..., ds:])
        return (y, st), torch.autograd.grad((y, st), ins, (dy, dst))
    out, got = run(ssd_chunk_train)
    ref, want = run(ssd_chunk_plain)
    for a, b in zip(out + got, ref + want):
        _close(a, b)


@pytest.mark.parametrize("arch", ["deepseek-7b", "jamba-v0.1-52b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("remat", [True, "dots"], ids=["block", "dots"])
def test_remat_gives_the_same_gradients(arch, remat):
    """Activation checkpointing of every block (and every encoder layer)
    recomputes the same function: the loss and every gradient leaf equal
    those of no remat within 1e-6 of the leaf's largest."""
    cfg, _jp, tcfg, nparams = _pair(arch)
    batch = _batch(cfg, False, seed=1)
    l0, _m0, g0 = _port_loss_grads(tcfg, nparams, batch)
    l1, _m1, g1 = _port_loss_grads(tcfg, nparams, batch, remat=remat)
    l0, l1 = float(l0.detach()), float(l1.detach())
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        _close(a, b, 1e-6)
