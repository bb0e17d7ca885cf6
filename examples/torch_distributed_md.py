"""Z-slab halo execution on the PyTorch/CUDA port through the plan API.

    PYTHONPATH=src python examples/torch_distributed_md.py [--shards 4]
        [--device cpu]

The port of ``distributed_md.py``. ``plan(..., backend="halo")``
partitions the domain into Z-slabs, exchanges ghost planes between them,
runs the chosen schedule per shard and returns forces in ordinary particle
order -- the same contract as every other backend. ``--shards`` takes the
place of the JAX script's ``--devices``: with no mesh the port stacks the
shards on the system axis of the one device (one launch of each kernel
for all of them), so no device count is emulated. The forces are compared
against the one-device plan and against the compacted per-shard path. It
runs on the CUDA card, and raises without one unless ``--device cpu`` is
given (the kernels' plain versions then run). The particles come from a
``torch.Generator`` seeded 0, so they differ from the JAX script's
(threefry) draw.
"""

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import Domain, ParticleState, make_lennard_jones, plan
from repro_torch.core._device import describe_device, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--division", type=int, default=8)
    ap.add_argument("--n", type=int, default=4_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe_device(dev))

    domain = Domain.cubic(args.division, cutoff=1.0, periodic=True)
    positions = domain.sample_uniform(
        args.n, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    kernel = make_lennard_jones()
    state = ParticleState(positions)

    p_halo = plan(domain, kernel, positions=positions, strategy="xpencil",
                  backend="halo", n_shards=args.shards, device=dev)
    print(f"{args.shards} shards on {dev}, grid {domain.ncells} split into "
          f"{p_halo.n_shards} Z-slabs ({domain.nz // p_halo.n_shards} "
          f"planes/shard, cap {p_halo.shard_cap}), N={positions.shape[0]}")

    p_ref = plan(domain, kernel, m_c=p_halo.m_c, strategy="xpencil",
                 device=dev)
    f_ref, _ = p_ref.execute(state)
    forces, pot = p_halo.execute(state)

    err = float(torch.abs(forces - f_ref).max())
    scale = float(torch.abs(f_ref).max())
    print(f"max |F_halo - F_single| = {err:.2e} (|F|_max = {scale:.2e})")
    assert err <= 3e-4 * max(scale, 1.0)

    # the compacted per-shard path: same forces, only active pencils staged
    p_comp = p_halo if p_halo.n_shards == 1 else plan(
        domain, kernel, m_c=p_halo.m_c, positions=positions,
        strategy="xpencil", backend="halo", n_shards=args.shards,
        compact=True, device=dev)
    f_comp, _ = p_comp.execute(state)
    same = torch.equal(forces, f_comp)
    print(f"compacted shards (max_active={p_comp.max_active}) "
          f"bit-identical to dense shards: {same}")
    assert same

    # overflow contract survives distribution: shrink the shard capacity
    # and let execute_or_replan grow it back
    grown_cap = None
    if p_halo.n_shards > 1:
        tight = dataclasses.replace(p_halo, shard_cap=8)
        assert tight.check_overflow(state)
        (f2, _), grown = tight.execute_or_replan(state)
        grown_cap = grown.shard_cap
        match = torch.equal(f2, forces)
        print(f"shard_cap overflow replanned: 8 -> {grown_cap}; "
              f"forces match: {match}")
        assert grown_cap > 8 and match

    print("halo backend matches the single-device engine.")
    return {"device": str(dev), "n_shards": p_halo.n_shards,
            "max_abs_err": err, "force_scale": scale,
            "compact_bit_equal": same, "grown_shard_cap": grown_cap}


if __name__ == "__main__":
    main()
