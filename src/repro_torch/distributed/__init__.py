"""repro_torch.distributed — fault tolerance for the trainer (the
straggler watchdog).  The reference's sharding rules, partition specs
and gradient compression need a mesh and are not ported yet."""
from .straggler import DataReassigner, StragglerConfig, StragglerWatchdog

__all__ = ["DataReassigner", "StragglerConfig", "StragglerWatchdog"]
