"""PyTorch/CUDA port of ossid_code_tpu for NVIDIA Hopper (H100).

The JAX package `ossid_code_tpu` is the reference; this package re-implements
its serving path (DTOID detection over all templates, Zephyr hypothesis
scoring) in PyTorch, with the two TPU Pallas kernels replaced by CUDA C++
kernels for sm_90a under `csrc/` (built at first use by `kernels/build.py`).

Entry points run on the card unless the caller passes `device="cpu"`; on the
CPU every kernel wrapper takes its plain PyTorch version.
"""

from ossid_code_torch.device import resolve_device

__all__ = ["resolve_device"]
