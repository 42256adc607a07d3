"""``python -m repro_torch`` — the SCOPE binary on PyTorch and CUDA."""
import sys

from repro_torch.core.main import main

if __name__ == "__main__":
    sys.exit(main())
