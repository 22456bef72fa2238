"""Roofline terms of a cell on the H100: the port of the ``Roofline`` of
the JAX package's ``analysis/roofline.py``, with the H100's rates in
place of the TPU v5e's.

Hardware constants, NVIDIA's data sheet for the H100 SXM 80GB HBM3 (not
measurements; a card set below its 700 W power limit runs slower):

  peak bf16:   989 TFLOP/s per card, dense tensor cores
  HBM3:        3.35 TB/s per card
  NVLink:      450 GB/s per card, each way (900 GB/s both ways)

The three terms are per-device seconds, comparable to each other:

  compute    = flops / PEAK_FLOPS
  memory     = hbm_bytes / HBM_BW
  collective = coll_bytes / LINK_BW

Not ported: the reference's ``from_compiled``, ``collective_bytes`` and
``_shape_bytes`` (and ``analysis/hlo_cost.py``, ``analysis/report.py``):
they read the per-device flops, bytes and collective operands out of
XLA's compiled HLO, and the port has no compiled program to read.  The
port's ``launch.dryrun`` records the compute and memory terms from the
model's FLOPs and the per-device argument bytes instead, and no
collective term (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 dense / card: H100 SXM data sheet
HBM_BW = 3.35e12             # B/s / card: H100 SXM 80GB HBM3 data sheet
LINK_BW = 450e9              # B/s / card each way: NVLink 4, data sheet


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes moved to or from HBM
    coll_bytes: float            # per-device collective operand bytes
    coll_breakdown: Dict[str, int]
    model_flops: float           # global analytic "useful" flops
    n_chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (per-device flops x chips): the redundant share."""
        denom = self.flops * self.n_chips
        return self.model_flops / denom if denom else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-roofline bound achieved by useful work:
        (model-flops time at peak) / (dominant term)."""
        t_ideal = self.model_flops / (self.n_chips * PEAK_FLOPS)
        t_dom = max(self.t_compute, self.t_memory, self.t_collective)
        return t_ideal / t_dom if t_dom else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "n_chips": self.n_chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
