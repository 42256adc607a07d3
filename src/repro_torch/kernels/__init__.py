"""repro_torch.kernels — hand-written CUDA kernels for Hopper.

Each kernel is a subpackage: ``csrc/<name>.cu`` (CUDA C++ for
``sm_90a`` with a plain C interface, built by :mod:`._build` at first
use), ``ops.py`` (the public wrapper, registered as a
``torch.library.custom_op``: it launches the kernel for a CUDA tensor
and takes the plain version for a CPU tensor) and ``ref.py`` (the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel to).

They replace the JAX package's five Pallas TPU kernels of the same
names: ``matmul`` carries the mxu scope (TCU|Scope), ``histogram`` the
histo scope (Histo|Scope), and ``flash_attention``, ``rmsnorm`` and
``ssd_scan`` (the Mamba2 SSD chunk kernel) the nn scope (cuDNN|Scope).
"""
