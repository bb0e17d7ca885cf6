"""Dry run: trace every (arch x shape x mesh) cell on the host.

The port of ``repro.launch.dryrun``. Where JAX lowers and compiles each
cell for 512 host-platform devices, the port traces the cell's step once
on fake tensors (``FakeTensorMode``: shapes and dtypes, no data) laid out
as DTensors on a ``DeviceMesh`` over the ``"fake"`` process group
(``launch/mesh.py``), from the point of view of rank 0:

  * params come from the port's ``init_params`` under ``FakeTensorMode``,
    the AdamW moments, the ``input_specs`` batch and the ``cache_spec``
    cache are fake tensors too, and each is distributed by the
    ``dist/sharding.py`` rules;
  * the port's own train step (``train/trainer.py::make_train_step``, with
    ``cfg.dryrun_microbatches``), prefill step or decode step runs inside
    ``use_mesh(mesh)``, so the model's ``constrain`` calls lay out its
    activations; tensors built inside the step (rope tables, masks) count
    as replicated (``implicit_replication``);
  * :class:`DeviceCounter` sees every op on one device's local tensors:
    FLOPs by ``torch.utils.flop_counter``'s formulas (matrix products;
    elementwise work counts none, as in ``FlopCounterMode``),
    bytes accessed (each op's inputs read once and outputs written once,
    unfused), the collectives DTensor issues (kind and local operand
    bytes; on a CPU mesh DTensor moves a shard from one dim to another by
    all-gather, where NCCL would use all-to-all) and the peak of live
    bytes made during the step;
  * the 2 x 16 x 16 mesh is traced on its 32 x 16 (pod x data) x model
    view (``mesh.layout_mesh``), the same shards.

Why the CPU and the plain versions: kernels A, G and Gb launch through
``ctypes`` on ``data_ptr()`` (``kernels/_build.py``), and a fake tensor
has no data, so on these CPU tensors their wrappers take the plain
versions, which compute the same functions. JAX's dry run makes the same
choice: its model calls the plain ``window_attention_blocked``, not its
Pallas kernel, and it compiles for host-platform devices. A decode cell
writes its token at the cache's last slot (``cache_index = S - 1``): the
port's decode step takes a Python int where JAX traces the index.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Per cell this writes experiments/torch_dryrun/<arch>__<shape>__<mesh>.json
with JAX's keys: memory_analysis, cost_analysis (per-device FLOPs and
bytes), the roofline terms on the H100's constants (``roofline.py``; a
prediction, not a measurement) and, beside them, the collective counts and
``"device": "cpu (fake tensors)"``. A skipped cell (JAX's rules) records
``skipped``, a cell that raises records ``error`` and ``traceback``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import pathlib
import time
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import (ARCH_IDS, SHAPES, ModelConfig, ShapeCell,
                       cell_is_runnable, get_config, input_specs,
                       shape_by_name)
from ..dist import sharding as SH
from ..models import model as M
from ..models.serving import make_decode_step, make_prefill_step
from ..optim.adam import AdamConfig, init_opt_state
from ..train.trainer import make_train_step
from . import roofline as RL
from .mesh import fake_world, layout_mesh, make_production_mesh

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "torch_dryrun")
DEVICE = "cpu (fake tensors)"

# ops that move no bytes: views, aliases, allocations, metadata
_FREE_OPS = {"aten::empty", "aten::empty_strided", "aten::empty_like",
             "aten::new_empty", "aten::new_empty_strided", "aten::detach",
             "aten::alias", "aten::lift_fresh", "prim::device",
             "aten::_local_scalar_dense", "_c10d_functional::wait_tensor"}

# (name prefix, kind, index of the operand in the op's args); the c10d
# ops take (outputs, inputs, ...) where they have both
_COLLECTIVE_KINDS = (("all_gather", "all-gather", 0),
                     ("reduce_scatter_tensor", "reduce-scatter", 0),
                     ("all_reduce", "all-reduce", 0),
                     ("all_to_all", "all-to-all", 0),
                     ("allgather", "all-gather", 1),
                     ("reduce_scatter_", "reduce-scatter", 1),
                     ("allreduce", "all-reduce", 0),
                     ("alltoall", "all-to-all", 1),
                     ("send", "collective-permute", 0))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(func, args) -> Optional[Tuple[str, int]]:
    """(kind, local operand bytes) of a collective op, else None. A
    receive is not counted: its bytes are the sender's."""
    if func.namespace not in ("_c10d_functional", "c10d"):
        return None
    name = func.__name__.split(".")[0]
    for key, kind, arg in _COLLECTIVE_KINDS:
        if name.startswith(key):
            return kind, sum(_nbytes(a) for a in tree_leaves(args[arg])
                             if isinstance(a, torch.Tensor))
    return None


class DeviceCounter(TorchDispatchMode):
    """Per-device costs of whatever runs under it.

    An op with a DTensor operand is handed back to DTensor (the mode
    returns ``NotImplemented``), which runs it as ops on the local
    shards, and those come back here: so every count is one device's.
    DTensor's own shape propagation (global shapes, no device work) is
    not counted while ``quiet`` is entered."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Tuple[str, float]] = []
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._quiet = 0

    def quiet(self) -> "_Quiet":
        return _Quiet(self)

    def collective_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kind, _ in self.collectives:
            out[kind] = out.get(kind, 0) + 1
        return out

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            self._storages[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        coll = _collective(func, args)
        if coll is not None:
            self.collectives.append(coll)
            return out
        if func.namespace == "c10d":              # recv, barrier, ...
            return out
        pkt = func._overloadpacket
        if pkt in self._flop_registry:
            self.flops += self._flop_registry[pkt](*args, **kwargs,
                                                   out_val=out)
        if not func.is_view and func._schema.name not in _FREE_OPS:
            self.bytes += sum(_nbytes(t) for t in flat + tree_leaves(out)
                              if isinstance(t, torch.Tensor))
            self._track(out)
        return out


class _Quiet:
    """While entered, the counter counts nothing (nests)."""

    def __init__(self, counter: DeviceCounter):
        self.counter = counter

    def __enter__(self):
        self.counter._quiet += 1

    def __exit__(self, *exc):
        self.counter._quiet -= 1


class counting:
    """``with counting(counter):`` runs under ``counter``, with DTensor's
    shape propagation (fake ops on global shapes) kept out of the counts.
    DTensor computes the local sizes of a strided shard with index tensors
    it reads back on the host; under ``FakeTensorMode`` that read fails, so
    the computation runs outside fake mode here. Each patch applies where
    this torch has the method, and is undone on the way out."""

    def __init__(self, counter: DeviceCounter):
        self.counter = counter

    def _quiet(self, fn, host: bool):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        counter = self.counter

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with counter.quiet(), (unset_fake_temporarily() if host
                                   else contextlib.nullcontext()):
                return fn(*args, **kwargs)
        return inner

    def __enter__(self):
        from torch.distributed.tensor import (_redistribute, _sharding_prop,
                                              placement_types)
        prop = _sharding_prop.ShardingPropagator
        strided = getattr(placement_types, "_StridedShard", None)
        patches = [(prop, name, False) for name in (
            "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
            if name in vars(prop)]
        if strided is not None and \
                "local_shard_size_and_offset" in vars(strided):
            patches.append((strided, "local_shard_size_and_offset", True))
        self.saved = [(cls, name, vars(cls)[name])
                      for cls, name, _ in patches]
        for cls, name, host in patches:
            fn = self._quiet(getattr(cls, name), host)
            if isinstance(vars(cls)[name], staticmethod):
                fn = staticmethod(fn)
            setattr(cls, name, fn)
        # DTensor plans each candidate redistribution anew while fake
        # tensors are live (it takes them for a trace with symbolic
        # shapes); the shapes here are concrete, so the plans are cached,
        # which on a 3-D mesh takes the planner's search from most of a
        # cell's time to nothing
        name = "_gen_transform_infos_non_cached"
        if hasattr(_redistribute, name):
            plan = functools.cache(getattr(_redistribute, name))
            self.saved.append((_redistribute, name,
                               getattr(_redistribute, name)))
            setattr(_redistribute, name,
                    lambda src, dst, graph=None: plan(src, dst, graph))
        self.counter.__enter__()
        return self.counter

    def __exit__(self, *exc):
        self.counter.__exit__(*exc)
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


def local_bytes(tree) -> int:
    """Bytes of one device's shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total


def _fake_tree(specs):
    """Empty tensors of a ``{name: (shape, dtype)}`` tree (under the
    caller's ``FakeTensorMode``)."""
    return {k: (_fake_tree(v) if isinstance(v, dict) else
                torch.zeros(v[0], dtype=v[1]))
            for k, v in specs.items()}


@dataclasses.dataclass
class Traced:
    """One cell's trace: per-device cost and memory, the collectives."""
    cost: Dict[str, float]
    memory: Dict[str, float]
    coll: Dict[str, float]
    coll_counts: Dict[str, int]
    shape: object
    n_devices: int


def lower_cell(cfg: ModelConfig, shape_name, mesh,
               remat: bool = True, microbatches: int = 1) -> Traced:
    """Build the cell's fake, distributed inputs and trace its step once
    under a :class:`DeviceCounter`. ``shape_name`` names a ``SHAPES``
    cell, or is a ``ShapeCell``; ``mesh=None`` traces the step unsharded,
    on one device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    shape = (shape_name if isinstance(shape_name, ShapeCell)
             else shape_by_name(shape_name))
    n_devices = 1 if mesh is None else mesh.size()
    mesh = None if mesh is None else layout_mesh(mesh)
    specs = input_specs(cfg, shape)
    SH.set_pure_dp(cfg.pure_dp)
    counter = DeviceCounter()

    def lay_out(tree, specs_of):
        return tree if mesh is None else SH.distribute(
            mesh, tree, specs_of(cfg, mesh, tree))

    with FakeTensorMode():
        plain = M.init_params(cfg, 0, device="cpu")
        params = lay_out(plain, SH.params_shardings)
        batch = {k: torch.zeros(s, dtype=d) for k, (s, d) in specs.items()}
        idx = shape.seq_len - 1
        cache_index = batch.pop("cache_index", None)
        batch = lay_out(batch, SH.batch_shardings)
        args = {"params": params, "batch": batch}
        if shape.kind == "train":
            opt_cfg = AdamConfig(moment_dtype=cfg.moment_dtype)
            opt = init_opt_state(plain, opt_cfg)
            if mesh is not None:
                p_specs = SH.opt_shardings(cfg, mesh, opt["m"], plain)
                opt = {"m": SH.distribute(mesh, opt["m"], p_specs),
                       "v": SH.distribute(mesh, opt["v"], p_specs),
                       "step": SH.distribute(mesh, {"s": opt["step"]},
                                             {"s": ()})["s"]}
            args["opt"] = opt
            step = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                                   remat=remat)
            run = lambda: step(params, opt, batch)  # noqa: E731
        elif shape.kind == "prefill":
            step = make_prefill_step(cfg)
            run = lambda: step(params, batch)  # noqa: E731
        else:
            cache = lay_out(_fake_tree(M.cache_spec(
                cfg, shape.global_batch, shape.seq_len)), SH.cache_shardings)
            args["cache"] = cache
            step = make_decode_step(cfg)
            run = lambda: step(params, cache, batch["tokens"],  # noqa: E731
                               idx)
        del plain
        arg_bytes = local_bytes(args) + (0 if cache_index is None else 4)
        scope = (contextlib.nullcontext() if mesh is None
                 else implicit_replication())
        with SH.use_mesh(mesh), scope, counting(counter):
            out = run()
        out_bytes = local_bytes(out)
    return Traced(
        cost={"flops": counter.flops, "bytes accessed": counter.bytes},
        memory={"argument_size_in_bytes": float(arg_bytes),
                "output_size_in_bytes": float(out_bytes),
                "temp_size_in_bytes": float(counter.peak)},
        coll=RL.collective_bytes(counter.collectives),
        coll_counts=counter.collective_counts(), shape=shape,
        n_devices=n_devices)


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             remat: bool = True, microbatches: int = 1,
             out_dir: Optional[pathlib.Path] = None,
             tag: str = "", mesh=None) -> Dict:
    """Trace one cell and write its JSON; ``mesh`` defaults to the
    production mesh (which needs ``fake_world``)."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    mesh_name = _mesh_name(multi_pod)
    out_dir = out_dir or OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    out_path = out_dir / f"{stem}.json"

    ok, reason = cell_is_runnable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": reason}
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] SKIP {stem}: {reason}")
        return rec

    if microbatches == 1 and shape.kind == "train":
        microbatches = cfg.dryrun_microbatches
    t0 = time.time()
    try:
        mesh = mesh or make_production_mesh(multi_pod=multi_pod)
        tr = lower_cell(cfg, shape_name, mesh, remat=remat,
                        microbatches=microbatches)
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] FAIL {stem}: {type(e).__name__}: {str(e)[:200]}")
        return rec

    mf = RL.model_flops_for(cfg, shape, tr.n_devices)
    terms = RL.analyze(tr.cost, tr.coll, mf)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "n_devices": tr.n_devices, "device": DEVICE,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "compile_seconds": round(time.time() - t0, 1),
        "memory_analysis": tr.memory,
        "cost_analysis": tr.cost,
        "collective_counts": tr.coll_counts,
        "roofline": terms.to_dict(),
        "remat": remat, "microbatches": microbatches,
    }
    out_path.write_text(json.dumps(rec, indent=2))
    print(f"[dryrun] OK   {stem}: {rec['compile_seconds']}s trace, "
          f"flops/dev={terms.flops:.3e}, coll={terms.coll_bytes:.3e}B, "
          f"dominant={terms.dominant}")
    return rec


def _init_worker() -> None:
    fake_world()


def run_cells(fn, cells, jobs: int = 1) -> None:
    """``fn(*cell)`` for every cell, in ``jobs`` worker processes (each
    with its own fake world) when ``jobs > 1``, in order otherwise."""
    if jobs <= 1:
        fake_world()
        for cell in cells:
            fn(*cell)
        return
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn"),
                                initializer=_init_worker) as pool:
        for f in [pool.submit(fn, *cell) for cell in cells]:
            f.result()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 mesh (default: 16x16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace cells in this many worker processes")
    args = ap.parse_args()

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                cells.append((a, s.name))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    # the long prefills first, so that parallel workers finish together
    order = {"prefill": 0, "train": 1, "decode": 2}
    cells.sort(key=lambda c: order[shape_by_name(c[1]).kind])
    run_cells(run_cell, [(arch, shape, mp, not args.no_remat,
                          args.microbatches, None, args.tag)
                         for arch, shape in cells for mp in meshes],
              args.jobs)


if __name__ == "__main__":
    main()
