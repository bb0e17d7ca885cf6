"""Rules the port keeps, checked without a card.

  * The port and chip_smoke.py import neither JAX nor the JAX package.
  * Nothing in the port catches an exception, so no failed build or launch
    can fall back to something else.
  * Entry points run on the card unless the caller asks for the CPU; what
    is not ported raises and names the ROADMAP item that ports it.
  * Every C entry point that ``_build.py`` binds exists in ``csrc/*.cu``
    with the same arity and ctypes types (pointers and the stream as
    ``c_void_p``), so a mismatched binding shows here and not on the card.
"""

import ast
import ctypes
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (Domain, PairKernel, ParticleState,
                              full_pencil_occupancy, make_lennard_jones, plan,
                              scenarios, supports_compact, supports_layout,
                              tune)
from repro_torch.kernels import _build
from repro_torch.kernels.allin import allin_forces
from repro_torch.kernels.prefix_sum import prefix_sum
from repro_torch.kernels.sfc import cell_sfc_forces
from repro_torch.kernels.window_attn import window_attention
from repro_torch.kernels.xpencil import (xpencil_forces,
                                         xpencil_packed_forces,
                                         xpencil_sparse_forces)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_and_no_reference_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


# the dry-run tools record a cell whose trace raises, as JAX's do
RECORDERS = {PORT / "launch" / "dryrun.py": "run_cell",
             PORT / "launch" / "costrun.py": "measure"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_nothing_catches_exceptions(path):
    """No ``try`` in the port, with the exceptions whose contract is to
    catch: ``dist/fault.py::run_with_restarts``, the restart driver (JAX's
    ``repro.dist.fault``), which catches exactly ``RuntimeError`` and
    re-raises it once its restart budget is spent; and the dry-run tools'
    ``launch/dryrun.py::run_cell`` and ``launch/costrun.py::measure``
    (JAX's), which write a cell that raises into its JSON record, error
    and traceback, and go on to the next cell."""
    tree = ast.parse(path.read_text(), filename=str(path))
    tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    if path in RECORDERS:
        [fn] = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == RECORDERS[path]]
        assert [n for n in ast.walk(fn) if isinstance(n, ast.Try)] == \
            tries and len(tries) == 1, path
        [handler] = tries[0].handlers
        assert ast.unparse(handler.type) == "Exception", path
        assert "traceback.format_exc()" in ast.unparse(handler), path
        return
    if path == PORT / "dist" / "fault.py":
        [driver] = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                    and n.name == "run_with_restarts"]
        assert [n for n in ast.walk(driver) if isinstance(n, ast.Try)] == \
            tries and len(tries) == 1, path
        [handler] = tries[0].handlers
        assert ast.unparse(handler.type) == "RuntimeError", path
        assert [n for n in ast.walk(handler) if isinstance(n, ast.Raise)
                and n.exc is None], path          # the bare re-raise
        return
    assert not tries, path


def test_import_needs_no_nvcc_triton_or_jax(tmp_path):
    code = ("import sys, torch, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.convert, repro_torch.configs, repro_torch.models, "
            "repro_torch.models.serving, repro_torch.kernels.window_attn, "
            "repro_torch.physics, repro_torch.traj, repro_torch.ckpt, "
            "repro_torch.testing, repro_torch.dist, repro_torch.serve, "
            "repro_torch.optim, repro_torch.data, repro_torch.train, "
            "repro_torch.train.serve, repro_torch.launch.train, "
            "repro_torch.launch.dryrun, repro_torch.launch.costrun, "
            "repro_torch.launch.particle_dryrun, repro_torch.launch.report\n"
            "assert not torch.distributed.is_initialized()\n"
            "bad = [m for m in ('jax', 'triton', 'repro') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=120)


_CTYPE_OF = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}


def _c_param_type(decl):
    if "*" in decl:
        return ctypes.c_void_p
    words = [w for w in decl.split() if w != "const"][:-1]   # drop the name
    return _CTYPE_OF[" ".join(words)]


def test_bindings_match_cuda_sources():
    for source, entries in _build.SIGNATURES.items():
        text = (_build.CSRC / source).read_text()
        found = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
        assert set(entries) == set(found), source
        for name, argtypes in entries.items():
            params = [p.strip() for p in found[name].split(",")]
            assert [_c_param_type(p) for p in params] == list(argtypes), name
    assert set(_build.SIGNATURES) == {p.name for p in _build.CSRC.glob("*.cu")}


def test_library_name_tracks_source_hash():
    a = _build.library_path("xpencil.cu")
    assert a.parent == ROOT / "build" / "repro_torch"
    assert a.name.startswith("xpencil_") and a.suffix == ".so"
    assert _build.library_path("prefix_sum.cu") != a


def test_library_name_tracks_shared_headers(tmp_path, monkeypatch):
    """An edit to a shared ``csrc/*.cuh`` header renames every library,
    so no stale build of a source that includes it is loaded."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {s: _build.library_path(s) for s in _build.SIGNATURES}
    assert (tmp_path / "pair.cuh").exists()
    with open(tmp_path / "pair.cuh", "ab") as f:
        f.write(b"// edited\n")
    after = {s: _build.library_path(s) for s in _build.SIGNATURES}
    assert all(before[s] != after[s] for s in before)
    assert {p.stem.rsplit("_", 1)[0] for p in after.values()} == \
        {pathlib.Path(s).stem for s in _build.SIGNATURES}


def test_plan_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default runs there")
    dom = Domain.cubic(3)
    pos = torch.rand(20, 3) * 3       # strategy="auto" needs positions
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan(dom, positions=pos)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan(dom, positions=pos, device="cuda")
    assert plan(dom, positions=pos, device="cpu").device == \
        torch.device("cpu")


def test_samplers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default runs there")
    dom = Domain.cubic(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dom.sample_uniform(10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenarios.sample_gaussian_blob(dom, 10)
    assert dom.sample_uniform(10, device="cpu").device == torch.device("cpu")


def test_full_pencil_occupancy_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default runs there")
    dom = Domain.cubic(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        full_pencil_occupancy(dom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        full_pencil_occupancy(dom, "cuda")
    occ = full_pencil_occupancy(dom, "cpu")
    assert occ.active.device == torch.device("cpu")
    assert occ.active.tolist() == list(range(9)) and int(occ.n_active) == 9


@pytest.mark.parametrize("kwargs,item", [
    (dict(strategy="cell_dense", layout="sfc", backend="halo"), 11),
    (dict(strategy="allin", backend="halo"), 11),
    (dict(backend="halo"), 11),
    (dict(shard_counts=(2,)), 11),           # tune's halo shard-count axis
])
def test_unported_options_raise_with_roadmap_item(kwargs, item, tmp_path,
                                                  monkeypatch):
    """These options raised naming Queue 1 item ``item`` until that item
    ported them; now each builds and executes on the CPU: the halo plans
    (at the default one shard, and at two) equal to the one-device plan
    within a scale-relative 3e-4, ``tune``'s shard axis timing its halo
    twins."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    dom = Domain.cubic(4)
    pos = torch.rand(60, 3, generator=torch.Generator().manual_seed(item)) * 4
    state = ParticleState(pos)
    if "shard_counts" in kwargs:
        res = tune(dom, positions=pos, reps=2, budget_s=0.01, **kwargs)
        assert any(c.n_shards == 2 for c in res.timings)
        res.plan.execute(state)
        return
    want, _ = plan(dom, positions=pos, strategy="xpencil",
                   device="cpu").execute(state)
    scale = max(float(want.abs().max()), 1.0)
    for n_shards in (None, 2):
        p = plan(dom, positions=pos, device="cpu", n_shards=n_shards,
                 **kwargs)
        assert p.backend == "halo" and p.n_shards == (n_shards or 1)
        f, u = p.execute(state)
        assert float((f - want).abs().max()) / scale <= 3e-4


@pytest.mark.parametrize("kwargs", [
    dict(strategy="auto"), dict(strategy="autotune"),
    dict(strategy="auto", layout="sfc"),
    # on "cuda" this picks allin, which has no compacted path there (a
    # plan-time raise, tests/test_torch_traffic.py)
    dict(strategy="auto", compact=True, backend="reference"),
    dict(strategy="autotune", backend="reference"),
    dict(strategy="autotune", layout="sfc", backend="reference"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_auto_and_autotune_options_build_and_run(kwargs, tmp_path,
                                                 monkeypatch):
    """The options that raised until ROADMAP Queue 1 item 8 was ported now
    build a plan whose ``execute`` equals an explicit plan of the strategy
    it chose, bit for bit."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    dom = Domain.cubic(3)
    pos = torch.from_numpy(np.random.default_rng(0).random(
        (40, 3), dtype=np.float32) * 3)
    state = ParticleState(pos)
    p = plan(dom, positions=pos, device="cpu", **kwargs)
    explicit = plan(dom, positions=pos, device="cpu", strategy=p.strategy,
                    backend=p.backend, m_c=p.m_c, batch_size=p.batch_size,
                    box=p.box, compact=p.compact, max_active=p.max_active,
                    layout=p.layout, row_cap=p.row_cap, pair_cap=p.pair_cap)
    assert explicit == p
    for a, b in zip(p.execute(state), explicit.execute(state)):
        assert torch.equal(a, b)


def test_backend_matrix_mirrors_jax():
    """``"cuda"`` has what JAX's ``"pallas"`` has: xpencil (dense,
    compacted, packed), dense allin and cell_dense in the sfc layout only.
    ``"reference"`` has every strategy, compacted for the cell schedules.
    Asking the cuda backend for the rest raises at plan time."""
    dom = Domain.cubic(3)
    assert not supports_compact("cuda", "allin")
    assert supports_compact("cuda", "xpencil")
    for name in ("cell_dense", "xpencil", "allin"):
        assert supports_compact("reference", name)
    for backend in ("cuda", "reference"):
        assert supports_layout(backend, "cell_dense", "sfc")
        assert supports_compact(backend, "cell_dense", "sfc")
        assert not supports_layout(backend, "xpencil", "sfc")
    assert not supports_layout("cuda", "cell_dense", "dense")
    assert not supports_layout("cuda", "cell_dense", "packed")
    assert plan(dom, m_c=8, device="cpu", strategy="cell_dense",
                layout="sfc", pair_cap=8).backend == "cuda"
    assert not supports_compact("reference", "par_part")
    with pytest.raises(ValueError, match="no compacted path.*'allin'"):
        plan(dom, m_c=8, device="cpu", strategy="allin", compact=True,
             max_active=4)
    for name in ("cell_dense", "par_part"):
        with pytest.raises(ValueError, match=f"no backend 'cuda' for "
                                             f"strategy '{name}'"):
            plan(dom, m_c=8, device="cpu", strategy=name)
        assert plan(dom, m_c=8, device="cpu", strategy=name,
                    backend="reference")
    assert plan(dom, m_c=8, device="cpu", strategy="allin").box == (1, 1, 1)
    with pytest.raises(ValueError, match='layout="packed" is not defined'):
        plan(dom, m_c=8, device="cpu", strategy="allin", layout="packed",
             row_cap=8)


def test_unknown_backend_and_user_kernel_raise():
    dom = Domain.cubic(3)
    with pytest.raises(ValueError, match="no backend 'pallas'"):
        plan(dom, m_c=8, device="cpu", backend="pallas", strategy="xpencil")
    mine = PairKernel("mine", lambda r2: r2, lambda r2: r2, flops=2)
    with pytest.raises(ValueError, match="backend='reference'"):
        plan(dom, mine, m_c=8, device="cpu", strategy="xpencil")
    assert plan(dom, mine, m_c=8, device="cpu", backend="reference",
                strategy="xpencil")


def test_execute_refuses_state_on_another_device():
    p = plan(Domain.cubic(3), m_c=8, device="cpu", strategy="xpencil")
    pos = torch.rand(10, 3) * 3
    with pytest.raises(ValueError, match="move the state"):
        p.execute(ParticleState(pos.to("meta")))
    with pytest.raises(ValueError, match="move the state"):
        p.execute(ParticleState(pos, valid=torch.ones(10, dtype=torch.bool,
                                                      device="meta")))


def test_wrappers_refuse_other_devices():
    x = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        prefix_sum(x)
    plane = torch.zeros((3, 3, 24), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        xpencil_forces({"x": plane, "y": plane, "z": plane},
                       plane.to(torch.int32), nx=1, m_c=8,
                       kernel=make_lennard_jones(), cutoff2=1.0)
    ids = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        xpencil_sparse_forces({"x": plane, "y": plane, "z": plane},
                              plane.to(torch.int32), ids, nx=1, ny=1, m_c=8,
                              kernel=make_lennard_jones(), cutoff2=1.0)
    packed = torch.zeros((3, 3, 16), device="meta")
    pids = packed.to(torch.int32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        xpencil_packed_forces({"x": packed, "y": packed, "z": packed}, pids,
                              pids, torch.zeros((3, 3, 4), dtype=torch.int32,
                                                device="meta"), ids, nx=1,
                              ny=1, m_c=8, kernel=make_lennard_jones(),
                              cutoff2=1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        allin_forces({"x": plane, "y": plane, "z": plane},
                     plane.to(torch.int32), box=(1, 1, 1), m_c=8,
                     kernel=make_lennard_jones(), cutoff2=1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cell_sfc_forces({"x": plane, "y": plane, "z": plane},
                        plane.to(torch.int32), ids, ids.view(1, 1),
                        ids.view(1, 1, 1).expand(1, 27, 1), m_c=8,
                        kernel=make_lennard_jones(), cutoff2=1.0)
    qkv = torch.zeros((1, 2, 8, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        window_attention(qkv, qkv, qkv, window=4, blk=8)
    assert window_attention.launches == 0
    assert prefix_sum.launches == 0 and xpencil_forces.launches == 0
    assert xpencil_sparse_forces.launches == 0
    assert xpencil_packed_forces.launches == 0
    assert allin_forces.launches == 0 and cell_sfc_forces.launches == 0
