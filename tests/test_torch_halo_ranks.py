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

The launcher runs the ranks together under one deadline, each writing to
its own files (a rank never blocks on a full pipe while the launcher
waits on another), and reports every rank's output on any failure. A
rank saves its results, waits at a second file store until every rank has
saved (no rank tears its gloo sockets down while another still reads from
them), destroys the group and leaves by ``os._exit``: the interpreter's
own teardown aborted a rank now and then under load, after its results
were saved. Only the rendezvous is retried: if a rank exits before it
joined the group, the whole set is launched again once with a fresh
store.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import time

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
    import datetime
    import os
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
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("halo",))
    print("joined", flush=True)
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
    # every rank's gloo traffic has ended once all have saved: only then
    # does any rank close its sockets
    done = dist.FileStore(store + "_done", world)
    done.set(f"saved{rank}", "1")
    done.wait([f"saved{r}" for r in range(world)])
    dist.destroy_process_group()
    # skip the interpreter's teardown: the mesh still holds the gloo group,
    # and destroying it there can abort the process ("terminate called
    # without an active exception", its threads still joinable) after
    # every result is saved
    sys.stdout.flush()
    os._exit(0)
""" % {"n": N})


def _launch(world: int, run_dir: pathlib.Path, deadline_s: float = 300.0):
    """Run ``world`` rank processes together, each writing its stdout and
    stderr to files in ``run_dir``; kill them all at the deadline. ->
    [(returncode or None if killed, stdout, stderr), ...]"""
    run_dir.mkdir()
    # the ranks talk over the loopback interface, whatever the host's
    # name resolves to
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs, logs = [], []
    for r in range(world):
        out = open(run_dir / f"rank{r}.out", "w")
        err = open(run_dir / f"rank{r}.err", "w")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, str(r), str(world),
             str(run_dir / "store"), str(run_dir / f"rank{r}.npz"),
             repr(CASES[world])],
            env=env, stdout=out, stderr=err))
    end = time.monotonic() + deadline_s
    for proc in procs:
        try:
            proc.wait(timeout=max(end - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            break
    runs = []
    for r, (proc, (out, err)) in enumerate(zip(procs, logs)):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()
        runs.append((proc.returncode if proc.returncode >= 0 else None,
                     (run_dir / f"rank{r}.out").read_text()[-2000:],
                     (run_dir / f"rank{r}.err").read_text()[-3000:]))
    return runs


def _run_ranks(world: int, tmp_path: pathlib.Path) -> list:
    """Launch ``world`` rank processes together; -> each rank's results.
    A set in which a rank exited before it joined the group (the gloo
    rendezvous failed) is launched once more with a fresh store."""
    for attempt in range(2):
        run_dir = tmp_path / f"ranks{world}_{attempt}"
        runs = _launch(world, run_dir)
        joined = all("joined" in out for _, out, _ in runs)
        if joined or attempt:
            break
    assert all(rc == 0 for rc, _, _ in runs), runs
    return [np.load(run_dir / f"rank{r}.npz") for r in range(world)]


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
