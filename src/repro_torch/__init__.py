"""repro_torch — the PyTorch/CUDA port of `repro` for one NVIDIA H100.

The layout mirrors `src/repro/` subpackage by subpackage. This package
imports torch and numpy, never jax and nothing of `repro`; the JAX
package stays the reference each part is checked against. Entry points
run on CUDA unless the caller passes `device="cpu"`.
"""
