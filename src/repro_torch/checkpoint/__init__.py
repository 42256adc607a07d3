"""repro_torch.checkpoint — sharded, checksummed checkpoints in the JAX
package's on-disk format."""
from .store import load_checkpoint, load_manifest, save_checkpoint

__all__ = ["load_checkpoint", "load_manifest", "save_checkpoint"]
