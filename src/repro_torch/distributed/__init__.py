"""repro_torch.distributed — the partition and logical rules that place
a state on a mesh (``partition``, ``logical``: DTensor placements on a
``DeviceMesh``), the gradient codecs with error feedback
(``compression``), and fault tolerance for the trainer (the straggler
watchdog)."""
from .straggler import DataReassigner, StragglerConfig, StragglerWatchdog

__all__ = ["DataReassigner", "StragglerConfig", "StragglerWatchdog"]
