"""The port's sharding rules, input stand-ins and roofline helpers against
the JAX package's.

* ``input_specs``: names, shapes and dtype names on every (config, shape)
  cell.
* ``_leaf_spec`` + ``sanitize`` over every leaf of every full config's
  params, ``batch_shardings`` on ``input_specs`` and ``cache_shardings`` on
  ``cache_spec``: the port on its production ``DeviceMesh``es (over a fake
  512-rank world, set up and torn down by this module), JAX on
  ``AbstractMesh``es of the same shapes, which need no devices. A port spec
  is a tuple of JAX's ``PartitionSpec`` entries, so the two compare
  directly.
* ``sanitize`` and the role resolution, including pure DP.
* ``model_flops_for`` at 256 and 512 devices, and ``report``'s tables on
  the same records.

JAX's ``launch.dryrun``, ``costrun`` and ``particle_dryrun`` set a 512
host-device flag when imported, so they are not imported here.
"""

from __future__ import annotations

import functools
import json

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.configs import input_specs as jax_input_specs
from repro.dist import sharding as JSH
from repro.launch import report as JREP
from repro.launch import roofline as JRL
from repro.models import model as JM
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 input_specs)
from repro_torch.dist import sharding as SH
from repro_torch.launch import report as REP
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (fake_world_scope, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models import model as M

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def world():
    with fake_world_scope(512):
        yield


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _port_param_shapes(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = M.init_params(get_config(arch), 0, device="cpu")
    return {k: tuple(v.shape) for k, v in _flat(params).items()}


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch):
    cfg = jax_config(arch)
    tree = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    return tree


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    got = input_specs(get_config(arch), shape)
    want = jax_input_specs(jax_config(arch), shape)
    assert list(got) == list(want)
    for name, (shp, dtype) in got.items():
        assert shp == tuple(want[name].shape), name
        assert str(dtype).removeprefix("torch.") == str(want[name].dtype)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_jax_leaf_by_leaf(world, arch, multi_pod):
    """Every param leaf, every batch input and every cache leaf of the
    full config gets JAX's spec, ``pure_dp`` as the config sets it."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    amesh = AbstractMesh(*MESHES[multi_pod])

    jtree = _jax_param_shapes(arch)
    want = {k: tuple(s.spec) for k, s in _flat(
        JSH.params_shardings(jcfg, amesh, jtree)).items()}
    shapes = _port_param_shapes(arch)
    assert set(shapes) == set(want)
    got = SH.params_shardings(cfg, mesh, {k: (v, None)
                                          for k, v in shapes.items()})
    assert got == want
    for key, shape in shapes.items():
        SH.set_pure_dp(cfg.pure_dp)
        JSH.set_pure_dp(jcfg.pure_dp)
        assert SH.sanitize(mesh, SH._leaf_spec(mesh, shape), shape) == \
            tuple(JSH.sanitize(amesh, JSH._leaf_spec(amesh, shape), shape))

    for shape in SHAPES:
        specs = input_specs(cfg, shape)
        jb = JSH.batch_shardings(jcfg, amesh, jax_input_specs(jcfg, shape))
        assert SH.batch_shardings(cfg, mesh, specs) == {
            k: tuple(v.spec) for k, v in jb.items()}
        cache = M.cache_spec(cfg, shape.global_batch, shape.seq_len)
        jc = JSH.cache_shardings(jcfg, amesh, JM.cache_spec(
            jcfg, shape.global_batch, shape.seq_len))
        assert SH.cache_shardings(cfg, mesh, cache) == {
            k: tuple(v.spec) for k, v in jc.items()}


def test_placements_of_a_spec(world):
    """A tuple entry shards one dim over each named mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    assert SH.placements(mesh, (("pod", "data"), "model")) == [
        Shard(0), Shard(0), Shard(1)]
    assert SH.placements(mesh, (None, "model", None)) == [
        Replicate(), Replicate(), Shard(1)]


@pytest.mark.parametrize("spec,shape,want", [
    (("data", "model"), (6, 7), ("data", None)),
    ((("data", "model"),), (8,), (("data", "model"),)),
    ((("data", "model"),), (6,), (None,)),
])
def test_sanitize_drops_nondividing_axes(world, spec, shape, want):
    """``tests/test_dist.py``'s cases on the 2 x 2 debug mesh."""
    mesh = make_debug_mesh(2, 2)
    assert SH.sanitize(mesh, spec, shape) == want
    amesh = AbstractMesh((2, 2), ("data", "model"))
    assert tuple(JSH.sanitize(amesh, jax.sharding.PartitionSpec(*spec),
                              shape)) == want


@pytest.mark.parametrize("pure_dp", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_role_axes_match_jax(world, pure_dp, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    amesh = AbstractMesh(*MESHES[multi_pod])
    SH.set_pure_dp(pure_dp)
    JSH.set_pure_dp(pure_dp)
    try:
        for role in (None, "dp", "tp", "data", "model"):
            assert SH._role_axes(mesh, role) == JSH._role_axes(amesh, role)
        with pytest.raises(ValueError):
            SH._role_axes(mesh, "ep")
    finally:
        SH.set_pure_dp(False)
        JSH.set_pure_dp(False)


def test_constrain_is_identity_without_a_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert SH.current_mesh() is None
    assert SH.constrain(x, "dp", "tp") is x
    assert SH.replicate_dim(x, 0) is x
    assert SH.role_size("tp") == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in SHAPES:
        for n in (256, 512):
            assert RL.model_flops_for(cfg, shape, n) == \
                JRL.model_flops_for(jcfg, shape, n)


def test_roofline_terms_on_h100_constants():
    t = RL.analyze({"flops": 989e12, "bytes accessed": 3.35e12},
                   RL.collective_bytes([("all-reduce", 450e9),
                                        ("all-gather", 0.0)]), 1.0)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.coll_bytes == 900e9                   # all-reduce: 2x on wire
    assert t.collective_s == pytest.approx(1.0)    # 18 links x 50 GB/s


def _records():
    ok = {"arch": "a", "shape": "train_4k", "mesh": "pod16x16", "tag": "",
          "compile_seconds": 12.3,
          "memory_analysis": {"argument_size_in_bytes": 3 * 2 ** 30,
                              "temp_size_in_bytes": 5.5 * 2 ** 30},
          "roofline": {"coll_bytes": 7.25e9, "compute_s": 0.5,
                       "memory_s": 0.25, "collective_s": 0.125,
                       "dominant": "compute", "useful_ratio": 0.75}}
    return [
        ok, dict(ok, mesh="pod2x16x16"),
        {"arch": "a", "shape": "long_500k", "mesh": "pod16x16",
         "skipped": "long_500k needs sub-quadratic attention; a is dense"},
        {"arch": "b", "shape": "decode_32k", "mesh": "pod16x16",
         "error": "RuntimeError: " + "x" * 100},
        dict(ok, arch="b", shape="prefill_32k"),
        dict(ok, tag="extra"),
    ]


def test_report_tables_match_jax(tmp_path, monkeypatch):
    """The same records, in JAX's directories and in the port's, render
    the same tables."""
    for sub in ("dryrun", "costrun", REP.DRYRUN, REP.COSTRUN):
        (tmp_path / sub).mkdir()
        for i, rec in enumerate(_records()):
            (tmp_path / sub / f"{i}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(JREP, "ROOT", tmp_path)
    monkeypatch.setattr(REP, "ROOT", tmp_path)
    assert REP.SHAPE_ORDER == JREP.SHAPE_ORDER
    assert REP.dryrun_table() == JREP.dryrun_table()
    assert REP.roofline_table() == JREP.roofline_table()
    assert "SKIP" in REP.dryrun_table() and "FAIL" in REP.dryrun_table()
