"""The benchmark's harness on the CPU: its files, its contract and a tiny
run of each cell against the reference."""

import ast
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from bench import harness, tiny

BENCH = harness.BENCH
SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_name_what_exists(cell):
    entry = {w["name"]: w for w in SPEC["workloads"]}[cell]
    spec, config = harness.load_cell(cell)
    assert spec["config"] == entry["config"] == config["name"]
    assert spec["traffic"] == entry["traffic"]
    assert (BENCH / "traffic" / f"{spec['kind']}.py").exists()
    assert spec["limits"]
    assert set(spec["tiny"]) == {"config", "cell"}
    conf = {c["name"]: c for c in SPEC["configs"]}[entry["config"]]
    assert conf["file"] == f"bench/configs/{config['name']}.json"
    assert conf["reduced"] == config["reduced"]
    assert conf["source"] == config["source"]


def test_every_file_is_used():
    cells = {p.name[:-5] for p in (BENCH / "workloads").glob("*.json")}
    assert cells == set(CELLS)
    configs = {p.name[:-5] for p in (BENCH / "configs").glob("*.json")}
    assert configs == {c["name"] for c in SPEC["configs"]}
    readers = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    metrics = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert readers == metrics
    for name in metrics:
        assert callable(harness.load_reader(name))


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_moves_is_reported_where_the_metric_is(metric):
    m = {x["name"]: x for x in SPEC["per_layer"]}[metric]
    moves = {x["name"]: x for x in SPEC["end_to_end"]}[m["moves"]]
    assert m["workloads"]
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in moves.get("workloads", [cell])
    for cell in CELLS:
        e2e = harness.cell_metrics(SPEC, cell, trace=False)
        assert len(e2e) >= 2 and harness.cell_metrics(SPEC, cell, True)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_against_the_reference(cell):
    r = tiny.run_tiny(cell, SPEC, control=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "control_checks", "checks"]
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    want = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    # the bfloat16 control, in the program's place, fails a number
    assert any(c["value"] > c["limit"]
               for c in r["control_checks"].values())


def test_a_cell_is_added_by_files(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench)
    cell = json.loads((bench / "workloads" / "wca-fluid.force.json")
                      .read_text())
    cell["config"], cell["traffic"] = "lj-melt", "closed-2"
    cell["tiny"] = {"config": {"unit_cells": 5, "cutoff": 1.6},
                    "cell": {"snapshots": 2, "jitter": 0.02}}
    (bench / "workloads" / "lj-melt.force.json").write_text(
        json.dumps(cell))
    (bench / "metrics" / "calls_in_window.force.py").write_text(
        "def read(obs):\n    return obs.get('force.calls')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "lj-melt.force", "config": "lj-melt",
                              "traffic": "closed-2", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "calls_in_window.force",
                               "unit": "calls", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["lj-melt.force"]})
    for m in spec["end_to_end"]:
        if m["name"] == "force_eval_ms":
            m["workloads"].append("lj-melt.force")
    r = tiny.run_tiny("lj-melt.force", spec, bench=bench)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"] and r["correct"]
    assert {"calls_in_window.force", "force_eval_ms",
            "setup_s"} == set(r["metrics"])


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "typing", "torch"}, path


def test_no_jax_or_repro_in_a_run():
    """In a fresh process: ``bench/run.py`` exits non-zero with no result
    where no card is visible, then a tiny run loads the harness, every
    traffic kind, reader and tool, and no forbidden module."""
    code = (
        "import contextlib, io, runpy, sys, torch\n"
        "sys.argv = ['bench/run.py', '--workload', 'lj-melt.traj',\n"
        "            '--seed', '1', '--seconds', '1', '--trace', '0']\n"
        "out = io.StringIO()\n"
        "try:\n"
        "    with contextlib.redirect_stdout(out):\n"
        "        runpy.run_path('bench/run.py', run_name='__main__')\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print(torch.cuda.is_available()\n"
        "      or (rc != 0 and not out.getvalue()))\n"
        "from bench import harness, tiny, control, sweep\n"
        "from bench.traffic import force, serve, traj\n"
        "spec = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        "tiny.run_tiny('wca-fluid.force', spec)\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.load_reader(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-3] == "True", out.stderr[-3000:]
    tops = eval(lines[-2])
    assert "repro_torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)
    assert lines[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch.core.api", "reprox", "jaxlib.xla_client", "repro",
         "flax_like", "torch"]) == ["jaxlib", "repro"]


def test_percentile_and_profile_summary_helpers():
    assert harness.quantile_p([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert harness.quantile_p([1.0] * 20 + [float("inf")], 95) == 1.0
    assert harness.quantile_p([1.0] * 10 + [float("inf")] * 10, 95) == \
        float("inf")
    assert harness._short("void (anonymous namespace)::allin_kernel<0>"
                          "(float const*, int)") == "allin_kernel<0>"


def test_tiny_cells_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        config, over = tiny.shrink(cell)
        r = harness.run_cell(cell, 7, 0.5, False, torch.device("cuda"), 0.0,
                             SPEC, config_overrides=config,
                             cell_overrides=over)
        assert r["correct"], r
