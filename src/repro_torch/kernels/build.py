"""Build and load the port's CUDA kernels (`repro_torch/csrc/`).

One `torch.utils.cpp_extension.load` call compiles every source into
`<repo>/build/kernels/` for `sm_90a` at first use and loads the module;
later calls in the process return it.  Nothing is fetched: the sources
are the repository's.  Only `bindings.cpp` includes PyTorch's headers,
so the CUDA files compile in seconds.  `python -m
repro_torch.kernels.build` makes a second build, into
`<repo>/build/kernels_ptxas/`, whose log holds ptxas's registers, shared
memory and spills of every kernel.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = ("bindings.cpp", "paged_decode_attention.cu", "decode_attention.cu",
            "flash_prefill.cu", "ssd_chunk.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# devices whose tensors take each wrapper's plain version: the CPU (the
# tests) and `meta` (the dry-run's shapes, `launch.specs`); every other
# device launches the kernel or raises
PLAIN_DEVICES = ("cpu", "meta")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-lineinfo")

_lock = threading.Lock()
_ext = None


def build(build_dir: Path = BUILD_DIR, cuda_flags=CUDA_FLAGS,
          verbose: bool = False):
    """Compile every source into `build_dir` with `cuda_flags` and load
    the module (once per process: its name is fixed)."""
    from torch.utils.cpp_extension import load
    os.makedirs(build_dir, exist_ok=True)
    return load(
        name="repro_torch_kernels",
        sources=[str(_CSRC / s) for s in _SOURCES],
        build_directory=str(build_dir),
        extra_cflags=["-O3"],
        extra_cuda_cflags=list(cuda_flags),
        extra_include_paths=[str(_CSRC)],
        verbose=verbose)


def load_kernels(verbose: bool = False):
    """The compiled extension module (built on the first call)."""
    global _ext
    with _lock:
        if _ext is None:
            _ext = build(verbose=verbose)
        return _ext


if __name__ == "__main__":
    # Registers, shared memory and spills of every kernel: a build of its
    # own (build/kernels_ptxas/) with ptxas's report in the build log.
    #   python -m repro_torch.kernels.build 2>&1 \
    #       | grep -E "Compiling entry|Used|spill" | c++filt
    build(BUILD_DIR.parent / "kernels_ptxas", CUDA_FLAGS + ("-Xptxas=-v",),
          verbose=True)
