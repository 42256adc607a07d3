"""Over the traced ``aten::mm``, ``addmm`` and ``bmm`` calls: the sum of
each call's least time on the card (its FLOPs at its dtype's peak, or
its operands and result once at the memory bandwidth, whichever is
longer) over their device time, in %."""
from bench.lib.readers import gemm_roofline


def read(rec):
    return gemm_roofline(rec)
