"""repro_torch: the PyTorch/CUDA port of the SBS serving system in `repro`.

The port runs on an NVIDIA H100 (`device="cuda"`, the default of every
entry point) and on the CPU when a caller asks for it, as the parity
tests do.  It imports `torch` and never `jax`, and nothing of the `repro`
package: the scheduler layer (`config`, `configs`, `core`, and the
JAX-free `serving` modules) is a verbatim copy with renamed imports.
The attention hot path runs through hand-written CUDA kernels
(`repro_torch/csrc/`), each with a plain PyTorch version beside it.
"""

__version__ = "0.1.0"
