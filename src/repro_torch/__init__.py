"""PyTorch/CUDA port of ``repro``: the cutoff force evaluation by the
paper's schedules (X-pencil dense, occupancy-compacted and packed-row,
All-in-SM, Par-Part, Par-Cell) and Par-Cell over SFC cell clusters, and
the MD/SPH runs on top of it (``plan.trajectory``: ``repro_torch.traj``,
``physics``, ``ckpt``, ``testing.chaos``), the serving tier
(``repro_torch.serve``) and Z-slab halo execution (``backend="halo"``:
``repro_torch.dist``); on the LM side the dense archs (gemma2-2b,
qwen1.5-0.5b, codeqwen1.5-7b, starcoder2-3b) serving
(``repro_torch.models``) and training (``repro_torch.train``, ``optim``,
``data``, ``launch.train``).

    from repro_torch.core import Domain, ParticleState, plan
    p = plan(domain, kernel, positions=pos)          # runs on the CUDA card
    forces, potential = p.execute(ParticleState(pos))

The JAX package ``repro`` is the reference this port is held against; the
port imports neither it nor JAX. Its kernels are hand-written CUDA C++ in
``repro_torch/kernels/csrc/``, built with ``nvcc`` at first use.
"""
