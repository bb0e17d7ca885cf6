"""SPH on the PyTorch/CUDA port: a weakly-compressible settling column
(the paper's §8 target domain).

    PYTHONPATH=src python examples/torch_sph_demo.py [--device cpu]

The port of ``sph_demo.py``. SPH is the paper's motivating application
(30-40 neighbors/particle = few particles per cell). The density loop and
the pressure forces both run through the plan/execute API's X-pencil
schedule (``repro_torch.physics.sph``), which on ``--backend cuda`` (the
default) is kernel B, twice a step. It runs on the CUDA card, and raises
without one unless ``--device cpu`` is given (the kernels' plain versions
then run). The particles come from a ``torch.Generator`` seeded 0, so
they differ from the JAX script's (threefry) draw.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import Domain, suggest_m_c
from repro_torch.core._device import describe_device, resolve_device
from repro_torch.physics.sph import SPHParams, density, pressure, sph_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--division", type=int, default=6)
    ap.add_argument("--n", type=int, default=4_000)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--backend", default="cuda",
                    choices=["reference", "cuda"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe_device(dev))

    d = args.division
    domain = Domain.cubic(d, cutoff=1.0)
    # a block of fluid in the lower half of the box (a new tensor, as JAX's
    # .at[:, 2].multiply(0.5) is)
    n = args.n
    pos = domain.sample_uniform(
        n, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    pos = pos * torch.tensor([1.0, 1.0, 0.5], device=dev)
    vel = torch.zeros_like(pos)
    params = SPHParams(h=1.0, rho0=float(n) / (d ** 3 / 2), c0=10.0,
                       mass=1.0)
    m_c = max(24, suggest_m_c(domain, pos))

    rho = density(domain, pos, params, m_c, backend=args.backend)
    print(f"N={n}, M_C={m_c}")
    print(f"initial density: mean={float(rho.mean()):.3f} "
          f"min={float(rho.min()):.3f} max={float(rho.max()):.3f}")
    p = pressure(rho, params)
    print(f"initial pressure: mean={float(p.mean()):.3f}")

    for it in range(args.steps):
        pos, vel, rho = sph_step(domain, pos, vel, params, m_c, dt=2e-3,
                                 backend=args.backend)
        if it % 5 == 0:
            print(f"  step {it:3d}: <rho>={float(rho.mean()):8.3f}  "
                  f"max|v|={float(torch.max(torch.abs(vel))):.4f}  "
                  f"z-center={float(pos[:, 2].mean()):.3f}")
    print("done (densities stay finite and bounded -> neighbor loops are "
          "consistent under motion)")
    return {"device": str(dev), "n": n, "steps": args.steps,
            "rho_mean": float(rho.mean()), "rho_max": float(rho.max()),
            "finite": bool(torch.isfinite(rho).all()
                           and torch.isfinite(pos).all())}


if __name__ == "__main__":
    main()
