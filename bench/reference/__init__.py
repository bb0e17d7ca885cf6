"""The plain reference: plain PyTorch, written for the benchmark.

It imports nothing of ``repro_torch``, ``repro`` or ``jax``, and takes
nothing the program made but the outputs it judges.
"""

from .lj import (baoab_step, lj_forces, rel_l2, verlet_step)  # noqa: F401
