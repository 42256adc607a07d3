"""repro_torch.checkpoint — sharded, checksummed checkpoints in the JAX
package's on-disk format (each rank writing its own shards), their
restore onto a mesh of any shape, and the manager that saves them while
a trainer runs."""
from .manager import CheckpointManager
from .store import (load_checkpoint, load_manifest, restore_resharded,
                    save_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "load_manifest",
           "restore_resharded", "save_checkpoint"]
