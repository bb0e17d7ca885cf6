"""Lennard-Jones MD on the PyTorch/CUDA port, a few hundred steps.

    PYTHONPATH=src python examples/torch_md_lennard_jones.py [--steps 300]
        [--backend cuda|reference] [--device cpu]

The port of ``md_lennard_jones.py``: plan once -> bin -> X-pencil
interactions -> velocity-Verlet, run by ``physics.run`` (the trajectory
engine, where JAX scans), reporting energy conservation -- the physical
correctness check for the whole stack. ``--backend cuda`` (the default)
runs the hand-written kernels; it runs on the CUDA card, and raises
without one unless ``--device cpu`` is given (the kernels' plain versions
then run). Positions and velocities come from ``torch.Generator``s seeded
0 and 1, so they differ from the JAX script's (threefry) draw.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import (Domain, ParticleState, make_lennard_jones,
                              plan, suggest_m_c)
from repro_torch.core._device import describe_device, resolve_device
from repro_torch.physics import init_state, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--division", type=int, default=5)
    ap.add_argument("--ppc", type=int, default=8)
    ap.add_argument("--dt", type=float, default=1e-4)
    ap.add_argument("--strategy", default="xpencil")
    ap.add_argument("--backend", default="cuda",
                    choices=["reference", "cuda"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe_device(dev))

    domain = Domain.cubic(args.division, cutoff=1.0, periodic=True)
    n = args.division ** 3 * args.ppc
    positions = domain.sample_uniform(
        n, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    velocities = 0.05 * torch.randn(
        positions.shape, generator=torch.Generator(device=dev).manual_seed(1),
        device=dev)

    kernel = make_lennard_jones(sigma=0.25, eps=1.0, softening=1e-4)
    m_c = max(16, suggest_m_c(domain, positions))
    p = plan(domain, kernel, m_c=m_c, strategy=args.strategy,
             backend=args.backend, device=dev)

    # relaxation: uniform-random placement overlaps particles inside the LJ
    # core; descend along clipped forces first (standard MD minimization)
    # so the dynamics start from a physical configuration.
    box = torch.tensor(domain.box, dtype=positions.dtype, device=dev)
    for _ in range(60):
        f, _ = p.execute(ParticleState(positions))
        step_vec = torch.clamp(f, -1.0, 1.0) * 2e-3
        positions = torch.remainder(positions + step_vec, box)
    state = init_state(p, positions, velocities)

    print(f"N={n} particles, grid {domain.ncells}, M_C={m_c}, "
          f"strategy={args.strategy}, backend={args.backend}")
    t0 = time.time()
    final, traces = run(p, state, n_steps=args.steps, dt=args.dt)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt_wall = time.time() - t0

    e = traces["total"]
    e0, e1 = float(e[0]), float(e[-1])
    drift = abs(e1 - e0) / (abs(e0) + 1e-12)
    print(f"{args.steps} steps in {dt_wall:.2f}s "
          f"({args.steps * n / dt_wall:,.0f} particle-steps/s)")
    for i in range(0, args.steps, max(1, args.steps // 10)):
        print(f"  step {i:4d}: E_tot={float(e[i]):+.5f} "
              f"KE={float(traces['kinetic'][i]):.5f} "
              f"PE={float(traces['potential'][i]):+.5f}")
    print(f"energy drift over run: {drift:.3e} "
          f"({'OK' if drift < 0.05 else 'HIGH'})")
    return {"device": str(dev), "n": n, "steps": args.steps, "drift": drift,
            "finite": bool(torch.isfinite(final.positions).all())}


if __name__ == "__main__":
    main()
