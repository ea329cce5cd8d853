"""Build and load the port's CUDA kernels (`repro_torch/csrc/`).

One `torch.utils.cpp_extension.load` call compiles every source into
`<repo>/build/kernels/` for `sm_90a` at first use and loads the module;
later calls in the process return it.  Nothing is fetched: the sources
are the repository's.  Only `bindings.cpp` includes PyTorch's headers,
so the CUDA files compile in seconds.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = ("bindings.cpp", "paged_decode_attention.cu", "decode_attention.cu",
            "flash_prefill.cu", "ssd_chunk.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-lineinfo")

_lock = threading.Lock()
_ext = None


def load_kernels(verbose: bool = False):
    """The compiled extension module (built on the first call)."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            os.makedirs(BUILD_DIR, exist_ok=True)
            _ext = load(
                name="repro_torch_kernels",
                sources=[str(_CSRC / s) for s in _SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                extra_include_paths=[str(_CSRC)],
                verbose=verbose)
        return _ext
