"""repro_torch — the SCOPE benchmarking framework on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100.  It imports
torch and numpy, never jax and nothing of ``repro``: what it needs of
the reference's jax-free modules it keeps as its own copy.  Its entry
points run on the card unless the caller asks for the CPU
(``python -m repro_torch run --device cpu``).
"""
