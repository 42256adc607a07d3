from .ops import matmul
from .ref import bf16_ulp_error, matmul_ref

__all__ = ["matmul", "matmul_ref", "bf16_ulp_error"]
