"""Render the dry-run tables from the port's experiments/ records.

The port of ``repro.launch.report``: the same columns over
``experiments/torch_dryrun`` and ``experiments/torch_costrun``. The
``compile_s`` column holds the port's trace seconds, and every roofline
figure is a prediction on the H100's constants (``roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.report [--section dryrun|roofline]
"""

from __future__ import annotations

import argparse
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[3] / "experiments"
DRYRUN, COSTRUN = "torch_dryrun", "torch_costrun"
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _load(sub):
    out = {}
    d = ROOT / sub
    if not d.exists():
        return out
    for p in sorted(d.glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("tag"):
            continue
        out[(r.get("arch"), r.get("shape"), r.get("mesh"))] = r
    return out


def dryrun_table() -> str:
    recs = _load(DRYRUN)
    lines = [
        "| arch | shape | mesh | status | compile_s | args GiB/dev | "
        "temp GiB/dev | collective GB/dev (production program) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    archs = sorted({k[0] for k in recs})
    for arch in archs:
        for shape in SHAPE_ORDER:
            for mesh in ("pod16x16", "pod2x16x16"):
                r = recs.get((arch, shape, mesh))
                if r is None:
                    continue
                if "skipped" in r:
                    lines.append(f"| {arch} | {shape} | {mesh} | SKIP "
                                 f"({r['skipped'].split(';')[0]}) | | | | |")
                    continue
                if "error" in r:
                    lines.append(f"| {arch} | {shape} | {mesh} | "
                                 f"FAIL {r['error'][:60]} | | | | |")
                    continue
                m = r.get("memory_analysis", {})
                lines.append(
                    f"| {arch} | {shape} | {mesh} | OK | "
                    f"{r.get('compile_seconds', '')} | "
                    f"{m.get('argument_size_in_bytes', 0) / 2**30:.2f} | "
                    f"{m.get('temp_size_in_bytes', 0) / 2**30:.2f} | "
                    f"{r['roofline']['coll_bytes'] / 1e9:.2f} |")
    return "\n".join(lines)


def roofline_table() -> str:
    """Single-pod roofline: cost-run counters, dominant term."""
    cost = _load(COSTRUN)
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL/HLO flops | roofline fraction | bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    archs = sorted({k[0] for k in cost})
    for arch in archs:
        for shape in SHAPE_ORDER:
            r = cost.get((arch, shape, "pod16x16"))
            if r is None:
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | SKIP | | | "
                             f"{r['skipped'].split(';')[0]} |")
                continue
            if "error" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | FAIL | | | "
                             f"{r['error'][:50]} |")
                continue
            rl = r["roofline"]
            terms = {"compute": rl["compute_s"], "memory": rl["memory_s"],
                     "collective": rl["collective_s"]}
            frac = terms["compute"] / max(terms.values())
            lines.append(
                f"| {arch} | {shape} | {rl['compute_s']:.4f} | "
                f"{rl['memory_s']:.4f} | {rl['collective_s']:.4f} | "
                f"{rl['dominant']} | {rl['useful_ratio']:.3f} | "
                f"{frac:.3f} | |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", choices=["dryrun", "roofline", "all"],
                    default="all")
    args = ap.parse_args()
    if args.section in ("dryrun", "all"):
        print("## Dry-run table\n")
        print(dryrun_table())
    if args.section in ("roofline", "all"):
        print("\n## Roofline table (single-pod, cost-run counters)\n")
        print(roofline_table())


if __name__ == "__main__":
    main()
