"""PyTorch/CUDA port of ``repro``: the X-pencil force evaluation, dense,
occupancy-compacted and packed-row.

    from repro_torch.core import Domain, ParticleState, plan
    p = plan(domain, kernel, positions=pos)          # runs on the CUDA card
    forces, potential = p.execute(ParticleState(pos))

The JAX package ``repro`` is the reference this port is held against; the
port imports neither it nor JAX. Its kernels are hand-written CUDA C++ in
``repro_torch/kernels/csrc/``, built with ``nvcc`` at first use.
"""
