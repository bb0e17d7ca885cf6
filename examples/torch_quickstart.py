"""Quickstart on the PyTorch/CUDA port: cutoff pair interactions through
the plan/execute API.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of ``quickstart.py``. Builds the paper's benchmark scene (uniform
particles, LJ kernel, cell width = cutoff), plans every (backend,
strategy) pair of the port's ``backend_matrix()`` -- on ``"cuda"`` the
hand-written kernels (X-pencil, All-in-SM, the SFC cluster kernel behind
``cell_dense``), on ``"reference"`` the plain PyTorch schedules -- and
cross-checks each against the O(N^2) oracle through the same
``plan(...).execute(state)`` front door. It runs on the CUDA card, and
raises without one unless ``--device cpu`` is given (the wrappers then run
their kernels' plain versions). The particles come from a
``torch.Generator`` seeded 0, so they differ from the JAX script's
(threefry) draw.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import (Domain, ParticleState, backend_matrix,
                              make_lennard_jones, plan, supports_layout)
from repro_torch.core._device import describe_device, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--division", type=int, default=6)
    ap.add_argument("--n", type=int, default=2_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe_device(dev))

    domain = Domain.cubic(division=args.division, cutoff=1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    positions = domain.sample_uniform(args.n, generator=gen, device=dev)
    kernel = make_lennard_jones(sigma=0.2)
    state = ParticleState(positions)

    # one-off static planning: measures M_C, and "auto" picks the schedule
    # with the least modelled HBM traffic per interaction
    auto = plan(domain, kernel, positions=positions, strategy="auto",
                device=dev)
    print(f"grid {domain.ncells}, N={positions.shape[0]}, M_C={auto.m_c}, "
          f'auto -> "{auto.strategy}"')

    oracle = plan(domain, kernel, m_c=auto.m_c, strategy="naive_n2",
                  device=dev)
    f_ref, pot_ref = oracle.execute(state)
    e_ref = 0.5 * float(torch.sum(pot_ref))
    fscale = float(torch.max(torch.abs(f_ref)))
    print(f"naive_n2 oracle          : E = {e_ref:+.4e}")

    errors = {}
    for backend, strategies in sorted(backend_matrix().items()):
        for strategy in strategies:
            # some pairs exist only under a non-dense layout (the cuda
            # cell_dense runner is the sfc cluster kernel)
            layout = ("dense" if supports_layout(backend, strategy, "dense")
                      else "sfc")
            p = plan(domain, kernel, m_c=auto.m_c, strategy=strategy,
                     backend=backend, layout=layout, positions=positions,
                     device=dev)
            forces, pot = p.execute(state)
            err = float(torch.max(torch.abs(forces - f_ref))) / fscale
            tag = strategy if layout == "dense" else f"{strategy}/{layout}"
            errors[f"{backend}/{tag}"] = err
            print(f"{backend:9s} {tag:14s}: "
                  f"E = {0.5 * float(torch.sum(pot)):+.4e} "
                  f"rel|dF| = {err:.2e}")
            np.testing.assert_allclose(forces.cpu().numpy() / fscale,
                                       f_ref.cpu().numpy() / fscale,
                                       rtol=3e-4, atol=3e-4)

    # the M_C safety net: many executes, replan only when a cell overflows
    (forces, _), p2 = auto.execute_or_replan(state)
    assert p2 is auto, "uniform scene should not need a replan"
    print("all schedules x backends agree; overflow check passed.")
    return {"device": str(dev), "auto": auto.strategy, "rel_err": errors,
            "replanned": p2 is not auto}


if __name__ == "__main__":
    main()
