"""Particle-engine dry run: the paper's own system on the production mesh.

The port of ``repro.launch.particle_dryrun``. The halo X-pencil plan with
Lennard-Jones runs at cluster-scale particle counts (N = division^3 * ppc,
33,554,432 at the defaults) on fake tensors, as ``launch/dryrun.py``
traces the LM cells: one slab per rank of a 1-D ``DeviceMesh``, the
production mesh's ``"data"`` axis (16 slabs on both meshes, as JAX's code
takes ``mesh.shape["data"]``) over the ``"fake"`` process group, every
rank passing the whole state, and the counts those of rank 0. The ghost
exchange's sends count as collective-permute, the results' all-gather as
all-gather. The per-shard capacity is JAX's: the uniform load with 1.3x
slack, rounded up to 8 (no positions exist at dry-run time). FLOPs are
torch's formulas, which count matrix products and not elementwise work,
so the force kernels' arithmetic shows in the roofline's useful work
(n * ppc * 27 * 0.52 pairs of 21 FLOP, over the mesh), not in ``flops``.

  PYTHONPATH=src python -m repro_torch.launch.particle_dryrun [--multi-pod | --both]

Each run writes
experiments/torch_dryrun/particle-xpencil__d<division>_ppc<ppc>__<mesh>.json;
its roofline is a prediction on the H100's constants, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core import Domain, ParticleState, make_lennard_jones
from ..core import api as A
from . import roofline as RL
from .dryrun import DEVICE, OUT_DIR, DeviceCounter, counting
from .mesh import fake_world, make_production_mesh


def run(multi_pod: bool, division: int = 128, ppc: int = 16,
        m_c: int = 32, mesh=None, out_dir=None) -> dict:
    """Trace one halo ``execute()`` and write its JSON; ``mesh`` defaults
    to the production mesh (which needs ``fake_world``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    domain = Domain.cubic(division, cutoff=1.0, periodic=True)
    n = division ** 3 * ppc
    n_shards = int(mesh["data"].size())
    cap = -(-int(n / n_shards * 1.3) // 8) * 8
    p = A.plan(domain, make_lennard_jones(), m_c=m_c, strategy="xpencil",
               backend="halo", device="cpu", mesh=mesh["data"],
               shard_axis="data", n_shards=n_shards, shard_cap=cap)
    counter = DeviceCounter()
    t0 = time.time()
    with FakeTensorMode():
        state = ParticleState(torch.zeros((n, 3)))
        with counting(counter):
            p.execute(state)
    cost = {"flops": counter.flops, "bytes accessed": counter.bytes}
    # interactions ~ N * 27 ppc * 0.52 (sphere / cube); 21 FLOP a pair
    inter = n * ppc * 27 * 0.52
    rec = {
        "arch": "particle-xpencil", "shape": f"d{division}_ppc{ppc}",
        "mesh": mesh_name, "n_devices": mesh.size(), "device": DEVICE,
        "particles": n, "m_c": m_c, "n_shards": n_shards, "shard_cap": cap,
        "compile_seconds": round(time.time() - t0, 1),
        "memory_analysis": {"argument_size_in_bytes": float(n * 3 * 4),
                            "temp_size_in_bytes": float(counter.peak)},
        "cost_analysis": cost,
        "collective_counts": counter.collective_counts(),
        "roofline": RL.analyze(cost, RL.collective_bytes(counter.collectives),
                               inter * 21 / mesh.size()).to_dict(),
    }
    out_dir = out_dir or OUT_DIR
    out = out_dir / f"particle-xpencil__d{division}_ppc{ppc}__{mesh_name}.json"
    out_dir.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2))
    r = rec["roofline"]
    print(f"[particle-dryrun] OK {mesh_name}: N={n:,} "
          f"trace={rec['compile_seconds']}s bytes/dev={r['hbm_bytes']:.3e} "
          f"coll/dev={r['coll_bytes']:.3e}B dominant={r['dominant']}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--division", type=int, default=128)
    ap.add_argument("--ppc", type=int, default=16)
    args = ap.parse_args()
    fake_world()
    if args.both:
        run(False, args.division, args.ppc)
        run(True, args.division, args.ppc)
    else:
        run(args.multi_pod, args.division, args.ppc)


if __name__ == "__main__":
    main()
