"""Runs one cell: finds its files by name, drives its traffic kind, reads
its metrics and prints the result as the last line of standard output.

A traffic kind (``bench/traffic/<kind>.py``) has ``run(ctx)``: it builds
the inputs from ``ctx.seed``, warms up, calls ``ctx.window_started()``,
drives the program for ``ctx.seconds``, profiles a slice when
``ctx.trace``, calls ``ctx.read_peak()``, frees the program's state and
judges its outputs against the reference with ``ctx.check``. It fills
``ctx.obs``, which each metric's reader (``bench/metrics/<name>.py``,
``read(obs) -> float | None``) reads.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
from typing import Dict, List, Optional

import torch

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# the port's kernels by the prefix of their name on the card
FORCE_KERNELS = ("xpencil_kernel", "xpencil_packed_kernel", "allin_kernel",
                 "sfc_kernel")
SCAN_KERNELS = ("paper_scan_lookback",)
PACK_KERNELS = ("pack_rows_kernel", "pack_particles_kernel")

# the host's runtime calls that put work on the card
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                "cuMemcpy", "cuMemset")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, bench: pathlib.Path = BENCH):
    """(cell, config) of the cell ``name``: ``workloads/<name>.json`` and
    the configuration it names."""
    cell = load_json(bench / "workloads" / f"{name}.json")
    config = load_json(bench / "configs" / f"{cell['config']}.json")
    return cell, config


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics of ``BENCHMARK.json`` that ``cell`` reports: its
    per-layer metrics with ``trace``, else its end-to-end metrics."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_reader(name: str, bench: pathlib.Path = BENCH):
    """``read(obs)`` of ``metrics/<name>.py`` (the file name holds dots,
    so it is loaded by path)."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> List[str]:
    """The modules of ``names`` (default: those loaded) whose top-level
    name, the part before the first dot, is one of ``FORBIDDEN``:
    ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def quantile_p(values: List[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation (numpy's rule) of
    ``values``; +inf sorts last."""
    xs = sorted(values)
    if not xs:
        return math.nan
    rank = q / 100.0 * (len(xs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if rank > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


class Context:
    """What a traffic kind gets and fills."""

    def __init__(self, name: str, cell: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device, t0: float):
        self.name, self.cell, self.config = name, cell, config
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t0 = t0
        self.obs: Dict[str, object] = {"kind": cell["kind"]}
        self.checks: List[tuple] = []
        # with ``control``, the kind also judges the bfloat16 reference put
        # in the program's place (``bench/control.py``; never in a run)
        self.control = False
        self.control_checks: List[tuple] = []
        self.attempted = self.failed = 0
        self.peak = 0

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def log(self, *args) -> None:
        print(f"[{time.perf_counter() - self.t0:7.1f} s]", *args,
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def window_started(self) -> None:
        self.sync()
        self.obs["setup_s"] = time.perf_counter() - self.t0

    def read_peak(self) -> None:
        if self.on_card:
            self.peak = int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        """After the program's state is dropped: give its memory back."""
        import gc
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def check(self, name: str, value: float) -> None:
        self.checks.append((name, float(value),
                            float(self.cell["limits"][name])))

    def control_check(self, name: str, value: float) -> None:
        self.control_checks.append((name, float(value),
                                    float(self.cell["limits"][name])))

    def profile(self, fn, units: int) -> None:
        """Run ``fn()`` under ``torch.profiler`` (the card's activity) and
        put what it saw into ``obs["profile"]``. ``units`` is the steps,
        dispatches or calls that ``fn`` runs."""
        if not self.on_card:
            fn()
            return
        self.obs["profile"] = profile_card(fn, units, self.device)


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0]


def profile_card(fn, units: int, device) -> dict:
    """busy and window seconds, device seconds by kernel, the host's
    launch calls and the idle gaps of ``fn()`` under the profiler. Reads
    the profiler's raw records (``kineto_results``), which is fast where
    building its function events takes minutes for a few hundred steps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    host, spans = [], []
    by_name: Dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            nm = _short(e.name())
            by_name[nm] = by_name.get(nm, 0.0) + d * 1e-9
            spans.append((s, s + d, nm))
        else:
            host.append((s, s + d, e.name()))
    host.sort()
    spans.sort()
    launches = sum(1 for _, _, nm in host if nm.startswith(LAUNCH_CALLS))
    busy_ns, gaps = 0, {}
    cur_s = cur_e = None
    for s, e, nm in spans:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_ns += cur_e - cur_s
            label = f"{_host_call(host, (cur_e + s) // 2)} -> {nm}"
            gaps[label] = gaps.get(label, 0.0) + (s - cur_e) * 1e-9
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    if busy_ns <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    if not any(nm.startswith(FORCE_KERNELS) for nm in by_name):
        raise RuntimeError("the profile holds no record of a force kernel; "
                           f"device ops: {sorted(by_name)[:20]}")
    return {"busy_s": busy_ns * 1e-9, "window_s": t1 - t0, "units": units,
            "launch_calls": launches, "kernels": by_name,
            "idle_gaps": gaps}


def _host_call(host, t: int) -> str:
    """The name of the host's runtime call that spans time ``t``, or
    ``host`` when none does (Python between calls)."""
    i = bisect.bisect_right(host, (t, math.inf, ""))
    for s, e, nm in reversed(host[max(0, i - 8):i]):
        if e >= t:
            return nm
    return "host"


def kernel_seconds(prof: dict, prefixes) -> float:
    return sum(s for nm, s in prof["kernels"].items()
               if nm.startswith(prefixes))


def breakdown(prof: dict) -> dict:
    ops = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(prof["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, spec: dict, bench: pathlib.Path = BENCH,
             config_overrides: Optional[dict] = None,
             cell_overrides: Optional[dict] = None,
             control: bool = False) -> dict:
    """Run one cell and return the result object (the last line). The
    overrides shrink a cell for a test on the CPU; ``control`` also judges
    the bfloat16 control (under ``control_checks``)."""
    cell, config = load_cell(name, bench)
    cell = {**cell, **(cell_overrides or {})}
    config = {**config, **(config_overrides or {})}
    metrics = cell_metrics(spec, name, trace)
    readers = {m["name"]: load_reader(m["name"], bench) for m in metrics}
    kind = importlib.import_module(f"bench.traffic.{cell['kind']}")
    ctx = Context(name, cell, config, seed, seconds, trace, device, t0)
    ctx.control = control
    kind.run(ctx)
    out_metrics = {}
    for m in metrics:
        value = readers[m["name"]](ctx.obs)
        if value is None:
            if not trace:
                raise RuntimeError(f"cell {name} has no reading of its "
                                   f"end-to-end metric {m['name']}")
            continue
        out_metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in ctx.checks) and bool(ctx.checks)
    dev = ctx.device
    device_rec = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": 1, "memory_peak_bytes": ctx.peak}
    result = {"correct": correct, "attempted": ctx.attempted,
              "failed": ctx.failed, "metrics": out_metrics,
              "device": device_rec}
    prof = ctx.obs.get("profile")
    if trace and prof is not None:
        device_rec["busy_s"] = prof["busy_s"]
        device_rec["window_s"] = prof["window_s"]
        result["breakdown"] = breakdown(prof)
    if control:
        result["control_checks"] = {n: {"value": v, "limit": lim}
                                    for n, v, lim in ctx.control_checks}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in ctx.checks}
    return result


def card_state() -> str:
    """The card's name, power limit, clocks, temperature and draw."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def host_state() -> str:
    """This process's CPU seconds, the machine's load and its cores' mean
    clock: what tells a slow host from a slow card."""
    t = os.times()
    line = (f"process cpu user {t.user:.2f} s, sys {t.system:.2f} s; "
            f"load {os.getloadavg()[0]:.2f}")
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(x.split(":")[1]) for x in fh
                   if x.startswith("cpu MHz")]
        if mhz:
            line += f"; cores' mean clock {sum(mhz) / len(mhz):.0f} MHz"
    except (OSError, ValueError):
        pass
    return line


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {entry['chips']} CUDA device(s); "
              f"{seen} visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    print("card:", card_state(), file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), dev, t0, spec)
    print("card after:", card_state(), file=sys.stderr)
    print("host:", host_state(), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {n} = {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
