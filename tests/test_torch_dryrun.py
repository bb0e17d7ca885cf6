"""The port's dry-run tools on a fake process group (no card, no data).

* :class:`DeviceCounter` counts one device's work: a product sharded on
  its contraction dim counts 2 * M * N * K / n FLOPs, not the global
  product, and its all-reduce the local operand bytes.
* The unsharded trace of a train step counts the FLOPs that
  ``FlopCounterMode`` counts on the real step.
* gemma2-2b's smoke config on a fake 2 x 2 mesh: its ``train_4k`` cell
  (``tests/test_dist.py``'s dry-run test held against the port) has
  FLOPs and collective bytes; prefill and decode cells trace too.
* The cost run's extrapolation from depths 1 and 2 gives the depth-4
  trace's FLOPs exactly, its bytes within 2 %.
* The particle dry run at a small division, and ``run_cell``'s records.

Every fake world is set up and torn down by a fixture, so no later test in
the worker sees a process group.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro_torch.configs import ShapeCell, get_config, get_smoke_config
from repro_torch.launch import costrun as CR
from repro_torch.launch import dryrun as D
from repro_torch.launch import particle_dryrun as PD
from repro_torch.launch.mesh import fake_world_scope, make_debug_mesh


@pytest.fixture(scope="module")
def world():
    with fake_world_scope(512):
        yield


def test_flops_are_one_devices_share(world):
    """A (M, K) x (K, N) product sharded 4 ways on K: each device does
    2 M N K / 4 FLOPs, and the all-reduce of its partial sums carries its
    local (M, N) fp32 block."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_debug_mesh(4, 1)
    m, k, n = 64, 1024, 32
    counter = D.DeviceCounter()
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(m, k), mesh, [Shard(1), Replicate()])
        b = distribute_tensor(torch.empty(k, n), mesh, [Shard(0), Replicate()])
        with D.counting(counter):
            c = (a @ b).redistribute(mesh, [Replicate(), Replicate()])
    assert tuple(c.shape) == (m, n)
    assert counter.flops == 2 * m * n * k / 4
    assert counter.collectives == [("all-reduce", m * n * 4)]


def test_unsharded_trace_counts_what_flop_counter_counts():
    """qwen1.5-0.5b's smoke train step: the fake, unsharded trace and
    ``FlopCounterMode`` around the real step on the CPU count the same
    FLOPs (nothing on the path branches on the tensors being fake)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import model as M
    from repro_torch.optim.adam import AdamConfig, init_opt_state
    from repro_torch.train.trainer import make_train_step
    cfg = get_smoke_config("qwen1.5-0.5b")
    cell = ShapeCell("t", 64, 4, "train")
    traced = D.lower_cell(cfg, cell, None)

    params = M.init_params(cfg, 0, device="cpu")
    opt_cfg = AdamConfig(moment_dtype=cfg.moment_dtype)
    opt = init_opt_state(params, opt_cfg)
    tokens = torch.zeros((4, 64), dtype=torch.int32)
    step = make_train_step(cfg, opt_cfg)
    with FlopCounterMode(display=False) as fc:
        step(params, opt, {"tokens": tokens, "labels": tokens})
    assert traced.cost["flops"] == fc.get_total_flops() > 0
    assert traced.coll == {k: 0.0 for k in traced.coll}
    assert traced.n_devices == 1


def test_dryrun_machinery_on_debug_mesh(world):
    """gemma2-2b's smoke config, ``train_4k`` on a 2 x 2 mesh: per-device
    FLOPs and collective bytes are positive, the peak of live bytes is
    above zero, and a prefill and a decode cell trace too."""
    cfg = get_smoke_config("gemma2-2b")
    mesh = make_debug_mesh(2, 2)
    tr = D.lower_cell(cfg, "train_4k", mesh)
    assert tr.cost["flops"] > 0 and tr.cost["bytes accessed"] > 0
    assert sum(tr.coll.values()) > 0
    assert tr.memory["temp_size_in_bytes"] > 0
    assert tr.n_devices == 4
    for cell in (ShapeCell("p", 1024, 8, "prefill"),
                 ShapeCell("d", 1024, 8, "decode")):
        tr = D.lower_cell(cfg, cell, mesh)
        assert tr.cost["flops"] > 0 and tr.memory[
            "output_size_in_bytes"] > 0


def test_costrun_extrapolation_is_exact_for_a_dense_stack(world):
    """counter(L) = a + b * L from depths 1 and 2 gives the depth-4
    trace's FLOPs exactly; bytes and the collective bytes (each kind
    clamped at 0, as ``measure`` clamps it) within 2 %: DTensor picks some
    layouts per op, and the few KB of scalar all-reduces (loss, gradient
    norm) change with depth."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    mesh = make_debug_mesh(2, 2)
    cell = ShapeCell("t", 32, 8, "train")
    c1, c2, c4 = (CR._counters(cfg, cell, mesh, n) for n in (1, 2, 4))
    assert c1["flops"] + (c2["flops"] - c1["flops"]) * 3 == c4["flops"]
    extrapolate = lambda a, b: a + (b - a) * 3  # noqa: E731
    assert extrapolate(c1["bytes"], c2["bytes"]) == pytest.approx(
        c4["bytes"], rel=0.02)
    coll = sum(max(0.0, extrapolate(c1["coll"][k], c2["coll"][k]))
               for k in c1["coll"])
    assert coll == pytest.approx(sum(c4["coll"].values()), rel=0.02)


def test_particle_dryrun_small(world, tmp_path):
    """The halo X-pencil plan at division 32: 16 slabs on the 16 x 16
    mesh's data axis, the ghost planes sent as collective-permute."""
    rec = PD.run(False, division=32, ppc=4, out_dir=tmp_path)
    assert rec["n_shards"] == 16 and rec["particles"] == 32 ** 3 * 4
    assert rec["shard_cap"] % 8 == 0
    assert rec["roofline"]["coll_breakdown"]["collective-permute"] > 0
    assert rec["roofline"]["model_flops"] == pytest.approx(
        32 ** 3 * 4 * 4 * 27 * 0.52 * 21 / 256)
    saved = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert saved["device"] == D.DEVICE


def test_run_cell_records(world, tmp_path, monkeypatch):
    """A skipped cell records JAX's reason; a cell whose trace raises
    records the error and its traceback; an OK cell JAX's keys."""
    rec = D.run_cell("gemma2-2b", "long_500k", False, out_dir=tmp_path)
    assert "sub-quadratic" in rec["skipped"]

    def boom(*a, **k):
        raise RuntimeError("no strategy")
    monkeypatch.setattr(D, "lower_cell", boom)
    rec = D.run_cell("gemma2-2b", "train_4k", False, out_dir=tmp_path)
    assert rec["error"] == "RuntimeError: no strategy"
    assert "boom" in rec["traceback"]
    monkeypatch.undo()

    small = dataclasses.replace(get_config("mamba2-130m"), n_layers=1)
    monkeypatch.setattr(D, "get_config", lambda arch: small)
    rec = D.run_cell("mamba2-130m", "decode_32k", False, out_dir=tmp_path,
                     mesh=make_debug_mesh(2, 2))
    for key in ("memory_analysis", "cost_analysis", "roofline",
                "params_total", "params_active", "compile_seconds", "remat",
                "microbatches"):
        assert key in rec
    assert rec["device"] == "cpu (fake tensors)"
    assert json.loads((tmp_path / "mamba2-130m__decode_32k__pod16x16.json")
                      .read_text())["roofline"]["flops"] > 0


def test_moe_dispatches_a_group_a_dp_shard(world):
    """On a mesh the MoE bins its tokens in ``_dp_groups()`` groups, one a
    DP shard (JAX's layout), each group binned on its own; without one it
    keeps a single group."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.dist import sharding as SH
    from repro_torch.models import moe as MOE
    mesh = make_debug_mesh(2, 2)
    assert MOE._dp_groups() == 1 and not MOE._ep(8)
    with FakeTensorMode():
        p = MOE.init_moe(torch.Generator().manual_seed(0), 16, 32, 8,
                         torch.float32, "cpu")
        x = torch.empty(4, 6, 16)
        with SH.use_mesh(mesh):
            assert MOE._dp_groups() == 2 and MOE._ep(8)
            dp = {k: distribute_tensor(v, mesh, [Replicate(), Replicate()])
                  for k, v in p.items()}
            MOE.moe_mlp.log = []
            out, aux = MOE.moe_mlp(
                distribute_tensor(x, mesh, [Shard(0), Replicate()]), dp,
                top_k=2, capacity_factor=1.25)
            [r], MOE.moe_mlp.log = MOE.moe_mlp.log, None
    assert tuple(out.shape) == (4, 6, 16) and tuple(aux.shape) == ()
    assert tuple(r.counts.shape) == (2, 8) and r.cap == MOE.moe_capacity(
        12, 8, 2, 1.25)
    assert tuple(r.counts.to_local().shape) == (1, 8)   # one group a shard
