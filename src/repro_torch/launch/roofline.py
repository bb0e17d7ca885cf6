"""Roofline terms of a dry-run trace (port of ``repro.launch.roofline``).

Hardware model: the H100 SXM at a 700 W power limit (NVIDIA's H100 data
sheet), the constants ``chip_smoke.py`` bounds its kernels with:
  989 TFLOP/s bf16 dense | 3.35 TB/s HBM3 | NVLink 4: 18 links, 900 GB/s.

Conventions:
  * the dry run counts each op on the local tensors of one device (rank
    0), so FLOPs and bytes are already per device, as JAX's post-SPMD
    ``cost_analysis`` is;
  * collective bytes: the local operand bytes of every all-gather /
    all-reduce / reduce-scatter / all-to-all the trace issued, and of the
    point-to-point sends of a halo exchange (counted as
    collective-permute). Wire multipliers as JAX's: all-reduce 2x (ring =
    reduce-scatter + all-gather), the others 1x;
  * links: 900 GB/s is NVIDIA's per-GPU NVLink figure, both directions
    counted (18 links of 50 GB/s; 450 GB/s each way), and the collective
    term divides the wire bytes by it as JAX's divides by its 4 links. An
    NVLink domain holds eight GPUs, so most groups of a 16 x 16 mesh (and
    every group along the pod axis) cross the network between nodes, which
    is far slower; the term is the NVLink-only bound, a lower bound on the
    collective time, and is reported as such.

Every figure these terms give is a prediction on those constants, not a
measurement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12          # bf16 dense / GPU
HBM_BW = 3.35e12             # bytes/s / GPU
LINK_BW = 50e9               # bytes/s / NVLink 4 link, both directions
LINKS_PER_CHIP = 18

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_WIRE_MULT = {"all-reduce": 2.0}


def collective_bytes(records: Iterable[Tuple[str, float]]
                     ) -> Dict[str, float]:
    """Per-collective-kind wire bytes from the trace's (kind, local operand
    bytes) records."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    for kind, n_bytes in records:
        out[kind] += float(n_bytes) * _WIRE_MULT.get(kind, 1.0)
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float                    # per-device FLOPs of the trace
    hbm_bytes: float                # per-device bytes accessed
    coll_bytes: float               # per-device wire bytes (all kinds)
    coll_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float              # 6*N*D (6*N_active*D for MoE)
    useful_ratio: float             # model_flops / traced flops

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(cost: Dict[str, float], coll: Dict[str, float],
            model_flops: float) -> RooflineTerms:
    """The three terms from per-device ``cost`` ({"flops", "bytes
    accessed"}) and per-kind wire bytes ``coll``."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = {k: float(coll.get(k, 0.0)) for k in COLLECTIVES}
    coll_total = sum(coll.values())

    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    collective_s = coll_total / (LINK_BW * LINKS_PER_CHIP)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm, coll_bytes=coll_total,
        coll_breakdown=coll, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0)


def model_flops_for(cfg, shape, n_devices: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE), per device.

    D = tokens processed by the step: B*S for train (x3 for bwd is already
    the 6 in 6ND), B*S for prefill (2ND forward only -> we use 2ND), B*1
    for decode (2ND)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens / n_devices
