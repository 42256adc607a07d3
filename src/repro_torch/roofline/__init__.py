"""repro_torch.roofline — static performance analysis of traced
dry-run steps (the torch port of ``repro.roofline``)."""
from .analysis import (RooflineTerms, analyze_compiled, collective_bytes,
                       model_flops, roofline_terms)

__all__ = ["RooflineTerms", "analyze_compiled", "collective_bytes",
           "model_flops", "roofline_terms"]
