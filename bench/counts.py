"""Work counts and the H100's published peaks.

The counts come from the inputs, not from any kernel: the unordered pairs
within the cutoff (counted by ``bench.reference``), the particles read once
and the forces and potential written once. So a share of the roofline is
the same arithmetic whatever strategy, layout or kernel runs.
"""

from __future__ import annotations

# H100 SXM peaks at a 700 W power limit (NVIDIA data sheet): the memory
# rate and the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# FLOP of r2 and the cutoff test (three subtractions, three multiplies, two
# adds and one compare); a pair within the cutoff costs its pair kernel's
# FLOP on top (21 for Lennard-Jones, the paper's convention).
DIST_FLOPS = 9

# Bytes a particle needs: x, y, z read once (float32), fx, fy, fz and the
# potential written once.
BYTES_PER_PARTICLE = 12 + 16


def bound_s(particles: float, pairs: float, pair_flops: int):
    """(least seconds the H100 needs, what sets it) to evaluate ``pairs``
    unordered pairs within the cutoff among ``particles`` particles."""
    t_bytes = particles * BYTES_PER_PARTICLE / HBM_BYTES_PER_S
    t_ops = pairs * (DIST_FLOPS + pair_flops) / F32_FLOPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def pair_flops_per_s_share(pairs: float, pair_flops: int,
                           seconds: float) -> float:
    """Percent of the float32 peak that ``pairs`` pair evaluations of
    ``pair_flops`` FLOP each over ``seconds`` reach."""
    return 100.0 * pairs * pair_flops / seconds / F32_FLOPS_PER_S

