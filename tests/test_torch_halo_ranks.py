"""The halo engine's route of one slab per rank (``plan(...,
backend="halo", mesh=DeviceMesh)``), run as ``torch.distributed`` gloo ranks
on the CPU, against the stacked route (``mesh=None``) bit for bit.

Each rank is a fresh Python process joined through a file store under
``tmp_path``; every rank passes the full state, exchanges its slab's
boundary planes with ranks r +/- 1 and returns the full result after an
``all_gather``. 4 ranks run the dense periodic, packed + compacted and sfc
paths and a batch of 2 systems; 2 ranks run open Z, where both neighbours
of a rank are one rank. The NCCL form of the same code needs one card per
rank, and so is not run here.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import Domain, ParticleState, clear_executor_cache, plan

torch.set_num_threads(1)

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
N = 1200

# name, periodic Z, plan options
CASES = {
    4: (("dense", True, dict(strategy="xpencil")),
        ("packed_compact", True, dict(strategy="xpencil", layout="packed",
                                      compact=True)),
        ("sfc", False, dict(strategy="cell_dense", layout="sfc"))),
    2: (("dense_open", False, dict(strategy="xpencil")),),
}

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    cases = eval(sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("halo",))
    from repro_torch.core import Domain, ParticleState, plan
    res = {}
    for name, periodic, kw in cases:
        dom = Domain.cubic(8, cutoff=1.0, periodic=periodic)
        pos = torch.from_numpy(np.random.default_rng(5).random(
            (%(n)d, 3)).astype(np.float32) * 8)
        p = plan(dom, positions=pos, m_c=16, backend="halo",
                 n_shards=world, mesh=mesh, device="cpu", **kw)
        res[name + "_f"], res[name + "_u"] = (
            t.numpy() for t in p.execute(ParticleState(pos)))
        if name == "dense":
            stack = torch.stack([pos, pos.flip(0)])
            fb, ub = p.execute_batch(ParticleState(stack))
            res["batch_f"], res["batch_u"] = fb.numpy(), ub.numpy()
            d = plan(dom, positions=pos, m_c=16, strategy="xpencil",
                     device="cpu").distribute(mesh, positions=pos)
            assert (d.n_shards, d.shard_axis, d.mesh) == (world, "halo",
                                                         mesh)
            res["distribute_f"] = d.execute(ParticleState(pos))[0].numpy()
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
""" % {"n": N})


def _run_ranks(world: int, tmp_path: pathlib.Path) -> list:
    """Launch ``world`` rank processes together; -> each rank's results."""
    store = tmp_path / f"store_{world}"
    outs = [tmp_path / f"rank{world}_{r}.npz" for r in range(world)]
    # the ranks talk over the loopback interface, whatever the host's
    # name resolves to
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), str(store),
         str(outs[r]), repr(CASES[world])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    runs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=240)
        finally:
            proc.kill()
        runs.append((proc.returncode, out[-2000:], err[-3000:]))
    assert all(rc == 0 for rc, _, _ in runs), runs
    return [np.load(o) for o in outs]


@pytest.mark.parametrize("world", [4, 2])
def test_every_rank_equals_the_stacked_shards(world, tmp_path):
    clear_executor_cache()
    ranks = _run_ranks(world, tmp_path)
    pos = torch.from_numpy(np.random.default_rng(5).random(
        (N, 3)).astype(np.float32) * 8)
    for name, periodic, kw in CASES[world]:
        dom = Domain.cubic(8, cutoff=1.0, periodic=periodic)
        p = plan(dom, positions=pos, m_c=16, backend="halo", n_shards=world,
                 device="cpu", **kw)
        want = [t.numpy() for t in p.execute(ParticleState(pos))]
        if name == "dense":
            stack = torch.stack([pos, pos.flip(0)])
            want_b = [t.numpy() for t in p.execute_batch(
                ParticleState(stack))]
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(got[name + "_f"], want[0])
            np.testing.assert_array_equal(got[name + "_u"], want[1])
            if name == "dense":
                np.testing.assert_array_equal(got["batch_f"], want_b[0])
                np.testing.assert_array_equal(got["batch_u"], want_b[1])
                np.testing.assert_array_equal(got["distribute_f"], want[0])
        assert np.abs(want[0]).max() > 0
