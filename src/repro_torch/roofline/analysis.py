"""Three-term roofline of a traced dry-run cell, in H100 terms.

The torch port of ``repro.roofline.analysis``:

    compute    = FLOPs / peak bf16 FLOP/s
    memory     = HBM bytes / HBM bandwidth
    collective = collective bytes / one direction of NVLink

each over one rank's program (the traced graph is the per-rank step, so
the reference's ``X / (chips × rate)`` reduces to ``X / rate``).  The
peaks are the card's data-sheet entry (``core.sysinfo.target_hardware``)
where the reference reads ``TPU_V5E``; NVLink's 900 GB/s (SXM) is a
bidirectional aggregate, so a transfer's bytes go over half of it.  The
dominant term is the bottleneck a performance loop iterates on.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional

from repro_torch.core.sysinfo import target_hardware

from .graph import collective_bytes  # noqa: F401 - the package's export


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes_: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float              # MODEL_FLOPS / (per-rank FLOPs × chips)
    bytes_per_device: float = 0.0
    notes: str = ""
    per_kind: Dict[str, int] = field(default_factory=dict)

    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def model_flops(cfg, tokens: int, kind: str = "train") -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); 2·N·D for inference kinds."""
    n = cfg.num_active_params()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def roofline_terms(arch: str, shape: str, mesh_name: str, chips: int,
                   flops: float, bytes_accessed: float, coll_bytes: float,
                   mflops: float, bytes_per_device: float = 0.0,
                   notes: str = "", per_kind=None,
                   device_name: Optional[str] = None) -> RooflineTerms:
    """``flops``/``bytes_accessed``/``coll_bytes`` are PER RANK (the
    traced graph is one rank's program).  ``device_name``: the card
    whose data-sheet peaks to use (None: the H100 SXM)."""
    hw = target_hardware(device_name)
    compute_s = flops / hw["peak_bf16_flops"]
    memory_s = bytes_accessed / hw["hbm_bandwidth"]
    collective_s = coll_bytes / (hw["nvlink_bandwidth"] / 2)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=bytes_accessed,
        collective_bytes_=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mflops,
        useful_ratio=(mflops / (flops * chips) if flops else 0.0),
        bytes_per_device=bytes_per_device, notes=notes,
        per_kind=per_kind or {})


def analyze_compiled(traced, arch: str, shape: str, mesh_name: str,
                     chips: int, mflops: float, notes: str = "",
                     device_name: Optional[str] = None) -> RooflineTerms:
    """The roofline of a traced cell (``launch.dryrun.TracedCell``):
    its graph's per-rank FLOPs, bytes and collective bytes, and its
    static peak as the bytes per device."""
    st = traced.stats()
    return roofline_terms(arch, shape, mesh_name, chips, st.flops,
                          st.bytes_accessed, st.collective_bytes, mflops,
                          bytes_per_device=float(st.peak_bytes),
                          notes=notes, per_kind=dict(st.per_kind_bytes),
                          device_name=device_name)
