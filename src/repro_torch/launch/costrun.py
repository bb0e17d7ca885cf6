"""Roofline cost runs: per-device FLOP, byte and collective counts.

The port of ``repro.launch.costrun``. JAX needs a second tool because
XLA's cost analysis visits a loop body once, so its cost runs unroll the
layer scans (``REPRO_SCAN_UNROLL``) and use dense attention
(``REPRO_DENSE_ATTN``). The port's dry run is an eager trace that already
visits every layer and every attention chunk, so it reads neither knob;
what it keeps is JAX's method rule, which bounds the trace's time: a
config is traced at full depth when ``n_layers <= 8 * period`` and
``d_model <= 4096``, and otherwise at two reduced depths (one and two
homogeneity periods), every counter extrapolated linearly in depth,
counter(L) = a + b * L: exact for layer-homogeneous stacks, the intercept
holding the embedding, logits and optimizer terms. An encoder's remaining
layers are added at half the decoder slope, as JAX adds them.

  PYTHONPATH=src python -m repro_torch.launch.costrun --all

Per cell this writes experiments/torch_costrun/<arch>__<shape>__<mesh>.json
with the roofline terms on the H100's constants (a prediction, not a
measurement).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback

from ..configs import (ARCH_IDS, SHAPES, cell_is_runnable, get_config,
                       shape_by_name)
from . import roofline as RL
from .dryrun import OUT_DIR, lower_cell, run_cells
from .mesh import make_production_mesh

COST_DIR = OUT_DIR.parent / "torch_costrun"


def _period(cfg) -> int:
    if cfg.local_global:
        return 2
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        return cfg.hybrid_attn_every
    return 1


def _counters(cfg, shape_name, mesh, n_layers, enc_layers=None):
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers,
                               **({"n_enc_layers": enc_layers}
                                  if enc_layers is not None else {}))
    tr = lower_cell(cfg2, shape_name, mesh)
    return {"flops": tr.cost["flops"], "bytes": tr.cost["bytes accessed"],
            "coll": dict(tr.coll)}


def measure(arch: str, shape_name: str, multi_pod: bool = False,
            direct_layer_cap: int = 8, tag: str = "", mesh=None) -> dict:
    """Counters for the full config, via a full-depth trace or
    L-extrapolation. ``mesh`` defaults to the production mesh (which
    needs ``fake_world``)."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    COST_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    out_path = COST_DIR / f"{stem}.json"

    ok, reason = cell_is_runnable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": reason}
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.time()
    per = _period(cfg)
    try:
        mesh = mesh or make_production_mesh(multi_pod=multi_pod)
        if cfg.n_layers <= direct_layer_cap * per and cfg.d_model <= 4096:
            c_full = _counters(cfg, shape_name, mesh, cfg.n_layers)
            method = "direct"
            flops, bts = c_full["flops"], c_full["bytes"]
            coll = c_full["coll"]
        else:
            l1, l2 = per, 2 * per
            enc = None
            if cfg.n_enc_layers:
                enc = 2
            c1 = _counters(cfg, shape_name, mesh, l1, enc)
            c2 = _counters(cfg, shape_name, mesh, l2, enc)
            L = cfg.n_layers
            slope = {
                "flops": (c2["flops"] - c1["flops"]) / (l2 - l1),
                "bytes": (c2["bytes"] - c1["bytes"]) / (l2 - l1),
            }
            flops = c1["flops"] + slope["flops"] * (L - l1)
            bts = c1["bytes"] + slope["bytes"] * (L - l1)
            coll = {}
            for k in c1["coll"]:
                s = (c2["coll"][k] - c1["coll"][k]) / (l2 - l1)
                coll[k] = max(0.0, c1["coll"][k] + s * (L - l1))
            if cfg.n_enc_layers:
                # add the remaining encoder layers' slope (enc scales like a
                # bidirectional decoder layer; reuse decoder slope as bound)
                flops += slope["flops"] * (cfg.n_enc_layers - 2) * 0.5
                bts += slope["bytes"] * (cfg.n_enc_layers - 2) * 0.5
            method = f"extrapolated(L={l1},{l2})"
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[costrun] FAIL {stem}: {type(e).__name__}: {str(e)[:160]}")
        return rec

    cost = {"flops": flops, "bytes accessed": bts}
    terms = RL.analyze(cost, coll, RL.model_flops_for(cfg, shape,
                                                      mesh.size()))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "method": method, "n_devices": mesh.size(),
        "device": "cpu (fake tensors)",
        "compile_seconds": round(time.time() - t0, 1),
        "roofline": terms.to_dict(),
    }
    out_path.write_text(json.dumps(rec, indent=2))
    r = rec["roofline"]
    print(f"[costrun] OK   {stem} [{method}]: flops/dev={r['flops']:.3e} "
          f"bytes/dev={r['hbm_bytes']:.3e} coll/dev={r['coll_bytes']:.3e} "
          f"dominant={r['dominant']} useful={r['useful_ratio']:.3f}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace cells in this many worker processes")
    args = ap.parse_args()

    cells = ([(a, s.name) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    run_cells(measure, [(a, s, args.multi_pod, 8, args.tag)
                        for a, s in cells], args.jobs)


if __name__ == "__main__":
    main()
