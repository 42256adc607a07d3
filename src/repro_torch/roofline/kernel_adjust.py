"""Hybrid roofline: measured graph traffic with the flash kernel's
analytic stream substituted.

The torch port of ``repro.roofline.kernel_adjust``.  The models'
attention is the plain chunked formulation (``layers._flash_fwd_scan``
and its recompute backward ``_flash_bwd_scan``): every [cq, ck] score
tile is an op's result, so the graph counts it through memory several
times over.  The port's flash kernel
(``kernels/flash_attention/csrc/flash_attention.cu``) keeps scores, the
running max and sum and the output accumulator on chip: its HBM
traffic is the q/k/v tile streams and the output write, so its
contribution is ANALYTIC:

  kernel_bytes/device =
      q read (Sq·H·D·eb)                    # streamed once
    + k,v reads (nq · Sk_eff · H · D · eb)  # re-streamed per q block
    + out write (Sq·H·D·eb)
  with Sk_eff = (diag-skip) half of Sk for causal, eb = element bytes.

The reference finds the pair scan's traffic as the HLO ``while`` bodies
whose trip counts equal the pair schedule's lengths; the port finds the
graph nodes traced inside the two scan functions (their
``traced_source`` tag).  On fake CUDA tensors in bf16 the two functions
trace the kernels' operators instead (as the card runs them,
``kernels.flash_attention.ops.takes_kernels``): their nodes carry the
kernels' own FLOPs, and their operand bytes are substituted the same
way.  Both numbers are reported; the substitution is
exact in FLOPs (same products) and conservative in bytes.
"""
from __future__ import annotations

from typing import Dict, Iterable, Set

#: the functions of the plain chunked attention's pair loops
FLASH_SOURCES = ("_flash_fwd_scan", "_flash_bwd_scan")


def flash_kernel_bytes(B_loc: int, Sq: int, Sk: int, H_loc: int, D: int,
                       causal: bool, elem_bytes: int = 2,
                       bq: int = 512) -> float:
    """Analytic per-device HBM traffic of a flash kernel with q tiles of
    ``bq`` rows."""
    nq = max(Sq // bq, 1)
    sk_eff = Sk / 2 if causal else Sk
    q_read = B_loc * Sq * H_loc * D * elem_bytes
    kv_read = 2 * B_loc * nq * sk_eff * H_loc * D * elem_bytes
    out_write = B_loc * Sq * H_loc * D * elem_bytes
    return q_read + kv_read + out_write


def attention_pair_trips(Sq: int, Sk: int, cq: int, ck: int) -> Set[int]:
    """The lengths of the chunk-pair schedules (all, off-diagonal,
    diagonal, and the full non-causal sweep) — the reference's trip
    counts of the pair-scan loops; in the port, how many times each
    pair loop's body is unrolled."""
    from repro_torch.models.layers import _chunk_pairs, _split_pairs
    trips = set()
    pairs = _chunk_pairs(Sq, Sk, min(cq, Sq), min(ck, Sk), True, True)
    offd, diag = _split_pairs(Sq, Sk, min(cq, Sq), min(ck, Sk), True, True)
    for t in (len(pairs), len(offd), len(diag)):
        if t > 1:
            trips.add(t)
    full = (Sq // min(cq, Sq)) * (Sk // min(ck, Sk))
    if full > 1:
        trips.add(full)           # non-causal/unsplit schedules
    return trips


def adjust_memory_term(stats, kernel_bytes: float,
                       sources: Iterable[str] = FLASH_SOURCES
                       ) -> Dict[str, float]:
    """``stats``: a traced cell's ``roofline.graph.GraphStats``.  Returns
    its measured bytes, the bytes of the nodes traced in the pair loops
    (``sources``), the kernel's analytic bytes and the adjusted total."""
    sources = tuple(sources)
    pair_bytes = sum(c.nbytes for c in stats.per_node
                     if c.source in sources)
    return {
        "measured_bytes": stats.bytes_accessed,
        "pair_scan_bytes": pair_bytes,
        "kernel_bytes": kernel_bytes,
        "adjusted_bytes": stats.bytes_accessed - pair_bytes + kernel_bytes,
    }
