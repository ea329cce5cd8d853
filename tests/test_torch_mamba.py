"""PyTorch port: the Mamba2 (SSD) pieces against the JAX package, on the
CPU, with inputs made by numpy from a seed and fed to both:

  * the SSD kernel's plain version (`ssd_chunk_plain`, what the wrapper
    runs on the CPU) against `ssd_chunk_ref` and the Pallas kernel in
    interpret mode, at B·nc > 1 and nh in {2, 4};
  * the chunked scans (`ssd_chunked`, and `ssd_chunked_kernel`, the
    served path) against JAX `ssd_chunked`, with and without an initial
    state and with S not a multiple of the chunk;
  * `mamba_forward` split in two halves with the SSM and conv state
    carried, against the whole sequence and against JAX;
  * `mamba_decode_step` against JAX, on weights bridged from the JAX init;
  * the wrapper's argument checks.

Tolerance 1e-5 in fp32, as tests/test_mamba.py (the two frameworks sum
in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas
from repro.kernels.ssd_scan.ref import ssd_chunk_ref
from repro.models import mamba as JMB
from repro.models.model import init_params as j_init_params

from repro_torch.bridge import params_from_numpy
from repro_torch.config.base import get_arch as t_get_arch
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
from repro_torch.models import mamba as TMB

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _scan_inputs(seed, B, S, nh, hp, ds):
    """x (B,S,nh,hp), dt (B,S,nh), A (nh,), Bm/Cm (B,S,1,ds), fp32."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, nh, hp)) * 0.3).astype(np.float32)
    dt = _softplus(rng.normal(size=(B, S, nh)))
    A = (-np.exp(np.linspace(0.0, 1.0, nh))).astype(np.float32)
    Bm = (rng.normal(size=(B, S, 1, ds)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, 1, ds)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# ---------------------------------------------------------------------------
# the intra-chunk kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,nc,Q,nh,hp,ds", [
    (2, 3, 16, 4, 8, 8), (1, 2, 32, 2, 32, 16), (3, 2, 8, 4, 16, 32)])
def test_ssd_chunk_plain_matches_jax(B, nc, Q, nh, hp, ds):
    x, dt, A, Bm, Cm = _scan_inputs(B * 100 + Q, B, nc * Q, nh, hp, ds)
    chunked = (x.reshape(B, nc, Q, nh, hp), dt.reshape(B, nc, Q, nh), A,
               Bm.reshape(B, nc, Q, ds), Cm.reshape(B, nc, Q, ds))
    jy, js = ssd_chunk_ref(*map(jnp.asarray, chunked))
    py, ps = ssd_chunk_pallas(*map(jnp.asarray, chunked), interpret=True)
    before = ssd_chunk.launches
    ty, ts = ssd_chunk(*map(torch.tensor, chunked))        # CPU: plain
    assert ssd_chunk.launches == before
    assert ty.dtype == ts.dtype == torch.float32
    assert ts.shape == (B, nc, nh, hp, ds)
    # the port returns the state in the cache's (nh, hp, ds) order
    for y_ref, s_ref in ((jy, js), (py, ps)):
        assert _err(ty, y_ref) < TOL
        assert _err(ts, np.swapaxes(np.asarray(s_ref), -1, -2)) < TOL


def test_ssd_chunk_plain_ignores_dt_zero_padding():
    """A short chunk padded with dt = 0 (as `ssd_chunked_kernel` pads):
    the padded tokens change neither the real rows of y nor the state,
    whatever x, B and C hold there."""
    x, dt, A, Bm, Cm = _scan_inputs(4, 2, 32, 4, 16, 8)
    args = [torch.tensor(a) for a in (x, dt, A, Bm, Cm)]
    x5, dt4 = args[0].reshape(2, 1, 32, 4, 16), args[1].reshape(2, 1, 32, 4)
    b4, c4 = args[3].reshape(2, 1, 32, 8), args[4].reshape(2, 1, 32, 8)
    n = 21
    y, st = ssd_chunk_plain(x5[:, :, :n], dt4[:, :, :n], args[2],
                            b4[:, :, :n], c4[:, :, :n])
    dtp = dt4.clone()
    dtp[:, :, n:] = 0.0
    yp, stp = ssd_chunk_plain(x5, dtp, args[2], b4, c4)
    assert _err(yp[:, :, :n], y) < TOL
    assert _err(stp, st) < TOL


# ---------------------------------------------------------------------------
# chunked scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk,init", [
    (20, 8, False), (52, 16, True), (7, 16, True), (64, 16, False)])
def test_ssd_chunked_matches_jax(S, chunk, init):
    x, dt, A, Bm, Cm = _scan_inputs(S, 2, S, 4, 32, 16)
    h0 = (np.random.default_rng(9).normal(size=(2, 4, 32, 16)) * 0.2
          ).astype(np.float32) if init else None
    jy, jh = JMB.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                             None if h0 is None else jnp.asarray(h0))
    targs = [torch.tensor(a) for a in (x, dt, A, Bm, Cm)]
    th0 = None if h0 is None else torch.tensor(h0)
    for scan in (TMB.ssd_chunked, TMB.ssd_chunked_kernel):
        ty, th = scan(*targs, chunk, th0)
        assert ty.shape == (2, S, 4, 32) and th.shape == (2, 4, 32, 16)
        assert _err(ty, jy) < TOL, scan.__name__
        assert _err(th, jh) < TOL, scan.__name__
    ry, rh = TMB.ssd_reference(*targs, th0)
    assert _err(ry, jy) < TOL and _err(rh, jh) < TOL


def test_ssd_chunked_kernel_reads_strided_bc():
    """The served path hands the kernel B and C as slices of the [B|C]
    projection (no copy when S is a chunk multiple)."""
    x, dt, A, Bm, Cm = _scan_inputs(11, 1, 32, 2, 32, 16)
    bc = torch.tensor(np.concatenate([Bm, Cm], axis=-1))     # (1,32,1,32)
    tb, tc = bc[..., :16], bc[..., 16:]
    assert not tb.is_contiguous()
    assert ssd_ops._row_stride(tb.reshape(1, 2, 16, 16), "Bm") == 32
    y, h = TMB.ssd_chunked_kernel(torch.tensor(x), torch.tensor(dt),
                                  torch.tensor(A), tb, tc, 16)
    jy, jh = JMB.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 16)
    assert _err(y, jy) < TOL and _err(h, jh) < TOL


# ---------------------------------------------------------------------------
# the block: forward with carried state, and decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_pair():
    """Reduced mamba2-370m layer-0 mixer weights: the JAX init and the
    port's copy through the bridge."""
    cfg = get_arch("mamba2-370m", reduced=True)
    jp = jax.jit(j_init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tcfg = t_get_arch("mamba2-370m", reduced=True)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jm = jax.tree.map(lambda a: a[0], jp["blocks"]["p0"]["mamba"])
    return cfg.ssm, jm, tp["layers"][0]["mamba"], cfg.d_model


def test_bridge_keeps_ssm_scalars_fp32():
    cfg = get_arch("mamba2-370m", reduced=True)
    jp = jax.jit(j_init_params, static_argnums=(0, 2))(
        cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = params_from_numpy(t_get_arch("mamba2-370m", reduced=True),
                           jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp),
                           dtype=torch.bfloat16, device="cpu")
    m = tp["layers"][1]["mamba"]
    for name in ("A_log", "D_skip", "dt_bias"):
        assert m[name].dtype == torch.float32, name
    assert m["w_zx"].dtype == torch.bfloat16


def test_mamba_forward_split_matches_whole_and_jax(mamba_pair):
    sc, jm, tm, D = mamba_pair
    x = (np.random.default_rng(3).normal(size=(2, 45, D)) * 0.5
         ).astype(np.float32)
    jo, (jh, jcs) = JMB.mamba_forward(jnp.asarray(x), jm, sc)
    tx = torch.tensor(x)
    to, (th, tcs) = TMB.mamba_forward(tx, tm, sc)
    assert _err(to, jo) < TOL and _err(th, jh) < TOL
    for a, b in zip(tcs, jcs):
        assert _err(a, b) < TOL
    # two halves, carrying the ssm state and the conv tails
    o1, (h1, cs1) = TMB.mamba_forward(tx[:, :19], tm, sc)
    o2, (h2, cs2) = TMB.mamba_forward(tx[:, 19:], tm, sc, h1, cs1)
    assert _err(torch.cat([o1, o2], 1), to) < TOL
    assert _err(h2, th) < TOL
    for a, b in zip(cs2, tcs):
        assert _err(a, b) < TOL
    # the plain scan gives the same forward
    po, (ph, _) = TMB.mamba_forward(tx, tm, sc, scan=TMB.ssd_chunked)
    assert _err(po, to) < TOL and _err(ph, th) < TOL


def test_mamba_decode_step_matches_jax(mamba_pair):
    sc, jm, tm, D = mamba_pair
    rng = np.random.default_rng(4)
    di, nh, _ = TMB.ssm_dims(D, sc)
    x = (rng.normal(size=(3, 6, D)) * 0.5).astype(np.float32)
    h = (rng.normal(size=(3, nh, sc.head_dim, sc.d_state)) * 0.2
         ).astype(np.float32)
    cs = ((rng.normal(size=(3, sc.d_conv - 1, di)) * 0.3).astype(np.float32),
          (rng.normal(size=(3, sc.d_conv - 1, 2 * sc.d_state)) * 0.3
           ).astype(np.float32))
    jh, jcs = jnp.asarray(h), tuple(map(jnp.asarray, cs))
    th, tcs = torch.tensor(h), tuple(map(torch.tensor, cs))
    th_in = th.clone()
    for t in range(x.shape[1]):
        jo, (jh, jcs) = JMB.mamba_decode_step(jnp.asarray(x[:, t:t + 1]), jm,
                                              sc, jh, jcs)
        to, (th, tcs) = TMB.mamba_decode_step(torch.tensor(x[:, t:t + 1]),
                                              tm, sc, th, tcs)
        assert _err(to, jo) < TOL
        assert _err(th, jh) < TOL
        for a, b in zip(tcs, jcs):
            assert _err(a, b) < TOL
    # the inputs are not written: a dropped step leaves its state intact
    assert torch.equal(torch.tensor(h), th_in)


# ---------------------------------------------------------------------------
# the wrapper's argument checks (the kernel runs only on the card)
# ---------------------------------------------------------------------------

def _kernel_args(Q=32, nh=4, hp=32, ds=16, dtype=torch.float32):
    x = torch.zeros(1, 2, Q, nh, hp, dtype=dtype)
    dt = torch.zeros(1, 2, Q, nh)
    A = -torch.ones(nh)
    bc = torch.zeros(1, 2, Q, 2 * ds, dtype=dtype)
    return x, dt, A, bc[..., :ds], bc[..., ds:]


@pytest.mark.parametrize("bad", ["hp", "ds", "chunk", "dtype", "dt_dtype",
                                 "stride", "shape"])
def test_ssd_chunk_checks_refuse_what_the_kernel_does_not_take(bad):
    x, dt, A, Bm, Cm = _kernel_args()
    if bad == "hp":
        x, dt, A, Bm, Cm = _kernel_args(hp=48)
    elif bad == "ds":
        x, dt, A, Bm, Cm = _kernel_args(ds=24)
    elif bad == "chunk":
        x, dt, A, Bm, Cm = _kernel_args(Q=320)
    elif bad == "dtype":
        Bm = Bm.to(torch.bfloat16)
    elif bad == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    elif bad == "stride":
        Bm = torch.zeros(1, 2, 32, 32)[..., ::2]             # ds strided
    elif bad == "shape":
        Cm = Cm[:, :1]
    ssd_ops.check_args(*_kernel_args())                      # the good case
    with pytest.raises(ValueError):
        ssd_ops.check_args(x, dt, A, Bm, Cm)


def test_ssd_chunk_refuses_devices_without_a_kernel(monkeypatch):
    """CPU and `meta` tensors (the dry-run's shapes) take the plain
    version; any other non-CUDA device raises.  `meta` stands for such a
    device once it is taken out of `PLAIN_DEVICES`."""
    args = [a.to("meta") for a in _kernel_args()]
    before = ssd_chunk.launches
    y, st = ssd_chunk(*args)                     # the plain version
    assert y.device.type == "meta" and st.device.type == "meta"
    assert ssd_chunk.launches == before
    monkeypatch.setattr(ssd_ops, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError):
        ssd_chunk(*args)
    assert ssd_chunk.launches == before
