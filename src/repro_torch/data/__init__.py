"""repro_torch.data — deterministic sharded synthetic data pipeline."""
from .pipeline import DataConfig, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "SyntheticLM", "make_pipeline"]
