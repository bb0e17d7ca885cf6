#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root. It builds both CUDA kernels from
``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version on the card, runs the main path (the dense X-pencil force
evaluation, ``plan(...).execute()``) at 1,048,576 particles and at 327,680,
checks the results, and times each layer with CUDA events. Any failed check
raises, so the exit code is non-zero. Without a CUDA device it exits 2 and
prints no result.

The line before the last is the card's ``nvidia-smi`` name and power limit,
the one before that a JSON object with one entry per kernel, and the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks at a 700 W power limit (NVIDIA data sheet): memory rate and
# the float32 rate outside the tensor cores (also used for int32 adds).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# FLOP of r2 and the cutoff test, which every candidate pair costs: three
# subtractions, three multiplies, two adds and one compare. A pair within the
# cutoff costs its pair kernel's ``flops`` on top.
DIST_FLOPS = 9

SCAN_SIZES = (1, 2, 3, 1000, 4097, 262_144, 2_097_157)
SCAN_TIMED_N = 262_144


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scale_rel_err(got, want) -> float:
    """max |got - want| / max(|want|max, 1): the repo's scale-relative
    measure (tests/test_dist.py)."""
    scale = max(float(want.abs().max()), 1.0)
    return float((got - want).abs().max()) / scale


def assert_scale_close(got, want, what: str, tol: float = 3e-4) -> float:
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: non-finite values")
    err = scale_rel_err(got.double(), want.double())
    if err > tol:
        raise AssertionError(f"{what}: scale-relative error {err:.3e} > {tol}")
    return err


def assert_term_close(got, want, size, what: str, tol: float) -> float:
    """|got - want| <= tol * (|want| + size), element by element, where
    ``size`` is the sum of the sizes of the element's own pair terms. Rounding
    cannot reach that; a wrong or missing term does, and a near-overlap
    elsewhere does not widen the tolerance. Returns the largest
    |got - want| / (|want| + size)."""
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: non-finite values")
    want = want.double()
    den = want.abs() + size.double()
    diff = (got.double() - want).abs()
    bad = diff > tol * den
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} elements differ by "
            f"more than {tol} of their term sizes, e.g. {got[bad][:3].tolist()}"
            f" vs {want[bad][:3].tolist()}")
    return float(torch.where(den > 0, diff / den, 0.0).max())


def candidate_pairs(domain, counts) -> int:
    """Pairs of real particles in neighbouring cells (the 27-cell stencil),
    self pairs excluded: what this input needs the kernel to consider."""
    nx, ny, nz = domain.ncells
    c = counts.view(nz, ny, nx).long()
    if domain.any_periodic:
        nbr = sum(torch.roll(c, (dz, dy, dx), (0, 1, 2))
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1))
    else:
        p = torch.nn.functional.pad(c, (1, 1, 1, 1, 1, 1))
        nbr = sum(p[1 + dz:nz + 1 + dz, 1 + dy:ny + 1 + dy, 1 + dx:nx + 1 + dx]
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1))
    return int((c * nbr).sum()) - int(c.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2

    from repro_torch.core import (Domain, ParticleState, make_gravity,
                                  make_high_flop, make_lennard_jones,
                                  make_low_flop, make_sph_density, plan)
    from repro_torch.core import prefix as plain_prefix
    from repro_torch.core import strategies as S
    from repro_torch.core.binning import bin_particles, dense_to_particles
    from repro_torch.core.interactions import PairKernel
    from repro_torch.kernels import _build
    from repro_torch.kernels.prefix_sum import prefix_sum
    from repro_torch.kernels.xpencil import xpencil_forces

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    log(f"device: {kind}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi[0]}")

    # -- build ---------------------------------------------------------------
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {nvcc.strip().splitlines()[-1]}; both kernels in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def plain(bins, nx, kern):
        """The plain X-pencil (kernel B's plain version) on ``bins``."""
        return S.xpencil_planes(bins.planes["x"], bins.planes["y"],
                                bins.planes["z"], bins.slot_id, nx=nx,
                                m_c=bins.m_c, kernel=kern, cutoff2=1.0)

    def term_sizes(bins, nx, kern):
        """Per target slot, the sum of the sizes of its pair terms: |coeff|
        * r bounds every force component's term, |potential| the
        potential's. Plain X-pencil runs with those as the potential."""
        return tuple(plain(bins, nx, PairKernel(
            f"{kern.name}_{part}_term_size", torch.zeros_like, f, flops=0))[3]
            for part, f in (("force", lambda r2: kern.coeff(r2).abs()
                             * r2.sqrt()),
                            ("potential", lambda r2: kern.potential(r2).abs())))

    def check_kernel_b(bins, nx, name, kern, label):
        """Kernel B against its plain version on ``bins``, every output
        element against its own term sizes (1e-4); low_flop also within
        rtol = atol = 1e-4 and the others scale-relative (3e-4).
        -> (kernel outputs, plain outputs, plain ms, term sizes, max abs
        error, max term-relative error)."""
        got = xpencil_forces(bins.planes, bins.slot_id, nx=nx, m_c=bins.m_c,
                             kernel=kern, cutoff2=1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(bins, nx, kern)
        end.record()
        end.synchronize()
        fsize, usize = term_sizes(bins, nx, kern)
        abs_err = term_err = 0.0
        for g, w, what in zip(got, want, ("fx", "fy", "fz", "pot")):
            what = f"xpencil {name} {label} {what}"
            size = usize if what.endswith("pot") else fsize
            term_err = max(term_err, assert_term_close(g, w, size, what,
                                                       1e-4))
            if name == "low_flop":
                if not torch.allclose(g, w, rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"{what}: not within 1e-4")
            else:
                assert_scale_close(g, w, what)
            abs_err = max(abs_err, float((g - w).abs().max()))
        return (got, want, start.elapsed_time(end), (fsize, usize), abs_err,
                term_err)

    # -- kernel A: the paper's scan, exactly equal to its plain versions ----
    scan_checks = 0
    for n in SCAN_SIZES:
        x = torch.randint(0, 10, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        got = prefix_sum(x)
        torch.cuda.synchronize()
        for name, want in (
                ("paper_prefix_sum", plain_prefix.paper_prefix_sum(x)),
                ("tiled_prefix_sum", plain_prefix.tiled_prefix_sum(x, 1024)),
                ("torch.cumsum", torch.cumsum(x, 0, dtype=torch.int32))):
            if not torch.equal(got, want):
                raise AssertionError(f"scan n={n} differs from {name}")
            scan_checks += 1
    x = torch.randint(0, 10, (SCAN_TIMED_N,), generator=gen, device=dev,
                      dtype=torch.int32)
    scan_ms = cuda_ms(lambda: prefix_sum(x), reps=200)
    scan_plain_ms = cuda_ms(lambda: plain_prefix.paper_prefix_sum(x),
                            reps=20)
    cumsum_ms = cuda_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32),
                        reps=200)
    scan_bound_ms = 1e3 * max(8 * SCAN_TIMED_N / HBM_BYTES_PER_S,
                              SCAN_TIMED_N / F32_OPS_PER_S)
    log(f"scan: exact at n={list(SCAN_SIZES)} ({scan_checks} checks); "
        f"n={SCAN_TIMED_N}: kernel {scan_ms:.4f} ms, plain {scan_plain_ms:.4f}"
        f" ms, torch.cumsum {cumsum_ms:.4f} ms, bound {scan_bound_ms:.5f} ms")

    # -- kernel B: X-pencil forces against the plain schedule ---------------
    kernels = {"lennard_jones": make_lennard_jones(),
               "low_flop": make_low_flop(), "high_flop": make_high_flop(),
               "gravity": make_gravity(), "sph_density": make_sph_density(1.0)}
    xp_checks = 0
    for periodic in (False, True):
        dom = Domain.cubic(16, cutoff=1.0, periodic=periodic)
        pos = dom.sample_uniform(16 ** 3 * 4, generator=gen, device=dev)
        bins = bin_particles(dom, pos, m_c=24)
        for name, kern in kernels.items():
            check_kernel_b(bins, 16, name, kern, f"div 16 periodic={periodic}")
            xp_checks += 4
    log(f"xpencil: 5 pair kernels x open/periodic at division 16, 4 per "
        f"cell, within tolerance ({xp_checks} checks)")

    # -- plan/execute against the O(N^2) oracle on the card ------------------
    for periodic in (False, True):
        dom = Domain.cubic(8, cutoff=1.0, periodic=periodic)
        pos = dom.sample_uniform(2000, generator=gen, device=dev)
        f, u = plan(dom, positions=pos).execute(ParticleState(pos))
        *nf, nu = S.naive_n2(dom, pos, make_lennard_jones())
        assert_scale_close(f, torch.stack(nf, -1),
                           f"plan vs naive_n2 forces periodic={periodic}")
        assert_scale_close(u, nu, f"plan vs naive_n2 potential "
                           f"periodic={periodic}")
    log("plan(device='cuda').execute() matches naive_n2 at division 8, "
        "2000 particles, open and periodic")

    # -- the main path at full size -----------------------------------------
    main_cases = [(64, 4, False), (32, 10, True)]
    results = []
    for division, ppc, periodic in main_cases:
        dom = Domain.cubic(division, cutoff=1.0, periodic=periodic)
        n = division ** 3 * ppc
        kern = make_lennard_jones()
        pos = dom.sample_uniform(n, generator=gen, device=dev)
        state = ParticleState(pos)
        p = plan(dom, kern, positions=pos, strategy="xpencil")

        prefix_sum.launches = 0
        xpencil_forces.launches = 0
        f, u = p.execute(state)
        torch.cuda.synchronize()
        launches = {"prefix_sum": prefix_sum.launches,
                    "xpencil_forces": xpencil_forces.launches}
        if min(launches.values()) < 1:
            raise AssertionError(f"main path skipped a kernel: {launches}")
        if not (bool(f.isfinite().all()) and bool(u.isfinite().all())):
            raise AssertionError("main path: non-finite output")

        # kernel B against its plain version on the main path's bins: LJ
        # (the main path's kernel) and three more pair kernels
        bins = p.bin(state)
        label = f"div {division} periodic={periodic}"
        kb, _, xp_plain_ms, (fsize, usize), xp_abs_err, xp_term_err = \
            check_kernel_b(bins, division, "lennard_jones", kern, label)
        for name in ("low_flop", "gravity", "sph_density"):
            check_kernel_b(bins, division, name, kernels[name], label)
            xp_checks += 4
        xp_checks += 4

        ref = plan(dom, kern, m_c=p.m_c, backend="reference")
        rf, ru = ref.execute(state)
        err_f = assert_scale_close(f, rf, "main path forces vs reference")
        err_u = assert_scale_close(u, ru, "main path potential vs reference")
        fsize_p, usize_p = dense_to_particles(dom, bins, fsize, fsize, fsize,
                                              usize)
        term_f = assert_term_close(f, rf, fsize_p,
                                   "main path forces vs reference", 1e-4)
        term_u = assert_term_close(u, ru, usize_p,
                                   "main path potential vs reference", 1e-4)
        if not periodic:
            net = float(f.double().sum(0).abs().max())
            total = float(f.double().abs().sum())
            if net > 1e-5 * total:
                raise AssertionError(f"net force {net:.3e} vs sum |F| "
                                     f"{total:.3e}: pair antisymmetry broken")


        reps = 10
        execute_ms = cuda_ms(lambda: p.execute(state), reps)
        bin_ms = cuda_ms(lambda: p.bin(state), reps)
        counts = bins.counts
        a_ms = cuda_ms(lambda: prefix_sum(counts), 50)
        b_ms = cuda_ms(lambda: xpencil_forces(
            bins.planes, bins.slot_id, nx=division, m_c=p.m_c, kernel=kern,
            cutoff2=1.0), reps)
        scatter_ms = cuda_ms(lambda: dense_to_particles(dom, bins, *kb),
                             reps)

        slots = bins.slot_id.numel()
        out_slots = kb[0].numel()
        xp_bytes = 4 * 4 * slots + 4 * 4 * out_slots
        pairs = candidate_pairs(dom, counts)
        within = int(plain(bins, division, PairKernel(
            "pairs_in_cutoff", torch.zeros_like, torch.ones_like,
            flops=0))[3].sum(dtype=torch.float64))
        xp_ops = pairs * DIST_FLOPS + within * kern.flops
        xp_bound_ms = 1e3 * max(xp_bytes / HBM_BYTES_PER_S,
                                xp_ops / F32_OPS_PER_S)
        dense_pairs = out_slots * 9 * 3 * p.m_c
        res = dict(division=division, ppc=ppc, periodic=periodic, n=n,
                   m_c=p.m_c, launches=launches, execute_ms=execute_ms,
                   bin_ms=bin_ms, scan_ms=a_ms, xpencil_ms=b_ms,
                   scatter_ms=scatter_ms, xpencil_plain_ms=xp_plain_ms,
                   xpencil_bound_ms=xp_bound_ms,
                   xpencil_bound_by=("bytes" if xp_bytes / HBM_BYTES_PER_S
                                     > xp_ops / F32_OPS_PER_S
                                     else "operations"),
                   xpencil_bytes=xp_bytes, xpencil_ops=xp_ops,
                   candidate_pairs=pairs, pairs_in_cutoff=within,
                   dense_slot_pairs=dense_pairs, xpencil_max_abs_err=xp_abs_err,
                   xpencil_term_rel_err=xp_term_err,
                   forces_vs_reference=err_f, potential_vs_reference=err_u,
                   forces_term_rel_err=term_f,
                   potential_term_rel_err=term_u,
                   n_cells=dom.n_cells)
        results.append(res)
        log("main path: " + json.dumps(res))

    first = results[0]
    report = {"kernels": [
        {"name": "prefix_sum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/prefix_sum.cu",
         "replaces": "src/repro/kernels/prefix_sum.py:66",
         "launches": first["launches"]["prefix_sum"], "max_abs_err": 0,
         "ms": scan_ms, "plain_ms": scan_plain_ms, "bound_ms": scan_bound_ms,
         "bound_by": "bytes", "library_ms": cumsum_ms,
         "shapes": f"int32 ({SCAN_TIMED_N},)", "checks_passed": scan_checks},
        {"name": "xpencil_forces", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/xpencil.cu",
         "replaces": "src/repro/kernels/xpencil.py:148",
         "launches": first["launches"]["xpencil_forces"],
         "max_abs_err": first["xpencil_max_abs_err"],
         "ms": first["xpencil_ms"], "plain_ms": first["xpencil_plain_ms"],
         "bound_ms": first["xpencil_bound_ms"],
         "bound_by": first["xpencil_bound_by"], "library_ms": None,
         "shapes": (f"4 x ({first['division'] + 2}, {first['division'] + 2}, "
                    f"{(first['division'] + 2) * first['m_c']}) -> 4 x "
                    f"({first['division']}, {first['division']}, "
                    f"{first['division'] * first['m_c']})"),
         "max_term_rel_err": first["xpencil_term_rel_err"],
         "checks_passed": xp_checks},
    ]}
    print(json.dumps(report))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
