"""Hand-written CUDA kernels of the port, one package per TPU kernel of
`repro/kernels/`.  Each `ops.py` holds the kernel's Python wrapper (with
its launch counter) and the plain PyTorch version beside it; the CUDA
sources live in `repro_torch/csrc/` and are built by `build.py` at first
use.  Importing these modules never builds or imports anything CUDA."""
