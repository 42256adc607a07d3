"""Plain PyTorch version of the RMSNorm kernel: ``rms_norm`` of the
port's layers (``repro.kernels.rmsnorm.ref.rmsnorm_ref``'s arithmetic:
float32 math, cast back to ``x.dtype``)."""
import torch

from ...models.layers import rms_norm


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    return rms_norm({"scale": scale}, x, eps)
