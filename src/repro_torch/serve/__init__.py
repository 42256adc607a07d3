"""repro_torch.serve — batched LM serving on top of the model API.

The port of ``repro.serve``.
"""
from .engine import Request, ServeConfig, ServeEngine

__all__ = ["Request", "ServeConfig", "ServeEngine"]
