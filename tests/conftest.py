import os
import sys

import pytest

# NOTE: deliberately NO --xla_force_host_platform_device_count here — tests
# and benches must see the real (1-device) platform; only launch/dryrun.py
# forces 512 host devices (in its own process).
_HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(_HERE, "..", "src"))
sys.path.insert(0, _HERE)           # sibling imports (_hypothesis_shim)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavyweight model/jit cases (deselect with "
        "-m 'not slow' for the fast tier-1 loop)")
    config.addinivalue_line(
        "markers", "paged: paged (block-table) KV cache suite — the "
        "allocator/cache-surgery property tests run in the fast tier "
        "(scripts/ci.sh); the heavyweight cross-plane equivalence sweep "
        "is additionally @slow and only runs under --full")
    config.addinivalue_line(
        "markers", "mixed: unified mixed-batch plane suite (Sarathi-style "
        "piggybacking + length-bucketed formation) — runs FIRST in the "
        "fast tier (scripts/ci.sh), before the paged suite")
    config.addinivalue_line(
        "markers", "sharded: mesh-native real-plane suite — multi-device "
        "cases run in subprocesses with forced host devices (the device "
        "count must be pinned before jax initializes), so the suite is "
        "offline-safe under the normal 1-device platform")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA "
        "kernels); skipped without one — run on the card with "
        "`python -m pytest -m cuda tests/test_torch_cuda.py`")


# ---------------------------------------------------------------------------
# Memory-mapping guard.  Every jitted computation XLA:CPU compiles keeps
# LLVM ORC JIT code pages mapped for the life of the executable, several
# small mappings each; a full -x -q run accumulates tens of thousands and
# a process that crosses the kernel's vm.max_map_count (65530 default)
# SEGFAULTS inside the next backend_compile — the mmap failure surfaces
# as a crash, not an exception.  Dropping the jit caches at module
# boundaries frees the code pages (recompilation on next use is the only
# cost), so the suite's mapping footprint is bounded by its heaviest
# single module instead of its sum.
# ---------------------------------------------------------------------------

_MAPS_SOFT_LIMIT = 20_000


def _n_mappings() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:                     # non-Linux: nothing to guard
        return 0


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_code_mappings():
    yield
    if _n_mappings() > _MAPS_SOFT_LIMIT:
        import jax
        jax.clear_caches()


# ---------------------------------------------------------------------------
# Shared, session-scoped model setup. get_arch() is cheap but init_params +
# the first jitted forward of each (arch, shape) pair dominates the suite's
# runtime — cache them once per session instead of once per test.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="session")
def model_setup():
    """(arch, B, S, key) -> (cfg, params, tokens, embeds, full_logits, npre),
    memoized for the whole session."""
    import jax
    import jax.numpy as jnp
    from repro.config import get_arch
    from repro.models import init_params
    from repro.models.model import forward_full, logits_from_hidden

    cache = {}

    def get(arch, B=2, S=16, key=0):
        k = (arch, B, S, key)
        if k in cache:
            return cache[k]
        cfg = get_arch(arch, reduced=True)
        params = init_params(cfg, jax.random.PRNGKey(key))
        ks = jax.random.split(jax.random.PRNGKey(key + 1), 2)
        tokens = jax.random.randint(ks[0], (B, S), 0, cfg.vocab_size)
        embeds = None
        if cfg.is_encoder_decoder:
            embeds = jax.random.normal(
                ks[1], (B, cfg.encoder_seq_len, cfg.d_model)) * 0.1
        elif cfg.num_patch_tokens:
            embeds = jax.random.normal(
                ks[1], (B, cfg.num_patch_tokens, cfg.d_model)) * 0.1
        x, _, _, _ = forward_full(cfg, params, tokens, embeds=embeds)
        full_logits = logits_from_hidden(cfg, params, x)
        npre = x.shape[1] - S
        cache[k] = (cfg, params, tokens, embeds, full_logits, npre)
        return cache[k]
    return get
