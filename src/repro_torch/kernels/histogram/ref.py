"""Plain PyTorch version of the histogram kernel: int32 counts of the
values in ``[0, nbins)``; out-of-range values are dropped, as the TPU
kernel's one-hot compare drops them."""
import torch


def histogram_ref(x: torch.Tensor, nbins: int) -> torch.Tensor:
    kept = x[(x >= 0) & (x < nbins)]
    return torch.bincount(kept, minlength=nbins).to(torch.int32)
