"""repro_torch.models — the PyTorch port of ``repro.models``.

So far only the subset of :mod:`.layers` that the nn scope reaches:
RMSNorm, GQA attention (the naive oracle and the chunked flash
formulation with its recompute backward), capacity-based MoE dispatch
and the Mamba2 SSD scans.  The model zoo (configs, transformer, ssm,
api) is later work.
"""
from . import layers

__all__ = ["layers"]
