"""repro_torch.distributed — the partition and logical rules that place
a state on a mesh (``partition``, ``logical``: DTensor placements on a
``DeviceMesh``), and fault tolerance for the trainer (the straggler
watchdog).  The reference's gradient compression is not ported yet."""
from .straggler import DataReassigner, StragglerConfig, StragglerWatchdog

__all__ = ["DataReassigner", "StragglerConfig", "StragglerWatchdog"]
