from .ops import histogram
from .ref import histogram_ref

__all__ = ["histogram", "histogram_ref"]
