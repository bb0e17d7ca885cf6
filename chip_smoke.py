#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root. It builds the CUDA kernels from
``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
together), holds each against its plain PyTorch version on the card, runs
the main paths through ``plan(...).execute()`` and checks and times them:

  * dense X-pencil (kernels A and B) at 1,048,576 particles (division 64)
    and 327,680 (division 32, periodic), and All-in-SM (kernels A and E,
    ``strategy="allin"``) on the same particles; kernel B, and kernel C on
    the clustered scene below, timed at their chunk width and at
    ``CHUNK_WIDTHS``, bit-equal at each, beside the TPU schedule's dense
    slot-pair count, the candidate-pair count (both counted from the bins)
    and the bound; kernel E at its block size and at ``ALLIN_THREADS``,
    bit-equal at each; B, E and F also with the low_flop pair kernel (what
    staging and compaction cost), and E and F's pair steps counted on the
    card against the candidate pairs;
  * packed rows (kernels A and D and the pack kernel), 1,048,576 uniform
    particles, division 64, launching exactly ``PACKED_LAUNCHES``; kernel
    D timed at every tile of pencils that fits, per call and back to back,
    bit-equal at each, with the low_flop pair kernel, and in turns with B
    on the same particles; the pack kernel (all of ``pack_rows``: cell
    counts, row scans, moves, fills, particle slots) against its plain
    version (JAX's ``pack_rows`` in PyTorch), every output torch.equal,
    timed beside it and its bound, per call and back to back, with the
    launch calls of ``pack_rows`` and of a packed and a dense
    ``execute()`` under ``torch.profiler``;
  * a clustered scene (Gaussian blob, 131,072 particles, division 64) with
    ``compact=True``, dense layout (kernels A and C) and packed layout
    (kernels A and D and the pack kernel), D and the pack kernel checked
    and timed as on the uniform scene;
  * a plan built on the uniform scene, run on the blob through
    ``execute_or_replan``, for the packed+compacted X-pencil and for
    All-in-SM (whose sub-box follows the grown ``m_c``); All-in-SM (kernel
    E) on the clustered scene, timed in turns with B;
  * the reference strategies (Par-Part, Par-Cell, All-in-SM, compacted and
    not) at division 12 and 8 against the O(N^2) oracle;
  * the SFC cluster layout (kernels A and F, ``strategy="cell_dense",
    layout="sfc"``) on both dense scenes and on the blob, and a plan sized
    on the blob, run on the uniform scene through ``execute_or_replan``,
    whose ``pair_cap`` grows.
  * batch: ``plan(...).execute_batch`` on stacked systems, (e) 8 systems
    at division 32 and (f) 64 at division 16 (each 1,048,576 particles in
    all) and 16 periodic at division 16, one of them padding throughout,
    each system drawn from its own generator; for every ``"cuda"`` path
    (dense, compacted, packed, packed + compacted, All-in-SM, SFC) each
    system ``torch.equal`` to ``execute()`` on it alone, every kernel of
    the path launched once a batch (kernel A too), the batched
    kernels against their batched plain versions (on (e) and the periodic
    scene) and, system by system, equal to a launch on one system alone
    (kernel D also at tiles that do not divide a system's rows), the CUDA
    launch calls of a call under ``torch.profiler`` (the same in five
    sessions) the same at 16 and 64 systems; the batch, the loop of
    ``execute()`` calls and each batched kernel beside B times one
    system's launch timed by CUDA events;
  * autotune: ``plan``'s default ``strategy="auto"`` on the uniform
    division-64 scene and, with ``layout="packed"`` (and compacted), on the
    blob, each pick's ``execute()`` equal to its explicit plan and to the
    dense X-pencil bit for bit, beside every strategy's modelled bytes per
    interaction; ``tune`` over the ``"cuda"`` backend on both scenes, every
    kept candidate timed (``core.timing.time_fn``), the winner equal to its
    explicit plan and timed by ``cuda_ms_queued`` too, a second ``tune`` a
    cache hit with no timing run; ``strategy="autotune", backend="all"`` at
    division 16, with the reference schedules timed on the card;
  * trajectory: ``plan(...).trajectory`` at division 64 periodic
    (1,048,576 particles on a jittered FCC lattice, LJ): with ``skin=0``
    each of the dense, packed, compacted and All-in-SM paths bit-equal to
    its ``reference_step`` loop (one ``execute()`` a step) and to each
    other; the default skin over 256 steps within JAX's tolerances of that
    loop with few rebins; a run stopped at step 128 and resumed from its
    checkpoint bit-equal to the uninterrupted one (dense, packed,
    langevin); an injected segment error retried bit for bit and an
    injected NaN rolled back; ms per step (skin, skin 0, the loop), the
    split of a skin step, launch calls and host syncs of a refresh and a
    rebin step, checkpoint bytes and times; one ``sph_step`` at division 32
    on kernel B against the reference backend;
  * serving: ``repro_torch.serve.ServingEngine`` (64 requests a batch,
    default ``strategy="auto"``) on two mixes of 1,024 requests at division
    16 (uniform; Gaussian blob and two-phase droplet), Poisson arrivals on
    a virtual clock at half the request rate of a full batch measured in a
    warm pass: every response ``torch.equal`` to its class plan's
    ``execute()``, no executor build and no timing run once warm, the same
    launch calls a dispatch at 16 and 64 requests; requests/s, latency
    percentiles, batch fill; one class with ``autotune=True`` (tuned once,
    then a cache hit); under injected ``serve.dispatch`` faults a packed
    class quarantined on a ``"cuda"`` dense plan and every ``"ok"``
    response equal to the fault-free run; ``execute_checked`` and
    ``obs.profile`` (with its Chrome trace) on the dense division-64 path;
    ``TrajectoryService``, two jobs of one class at division 32;
  * halo: ``plan(..., backend="halo", n_shards=4)`` on the division-64
    uniform scene, the four Z-slab shards stacked on the system axis of
    kernels A-F: the dense, compacted, packed + compacted, All-in-SM and
    SFC paths each against the same strategy's one-device ``execute()``
    (3e-4 scale-relative) with the same launches, compacted and packed
    bit-equal to dense, each force kernel on the stacked shards against
    its plain version on the first and last shard; division 32 periodic at
    2 and 4 shards; a batch of 4 systems at 4 shards equal to the loop;
    a shard lost at ``dist.exchange`` shrinking the dense and sfc plans to
    2 shards; halo and one-device times, launch calls, the partition and
    the exchange;
  * kernel G (sliding-window attention) against its plain version over a
    sweep of batch, GQA ratio, head_dim, window, softcap and dtype, and at
    the gemma2-2b shape, each case on the route ``route(dtype, D)`` names
    (bf16 wgmma/TMA or fp32 SIMT); the wgmma route's SASS counted for
    HGMMA and UTMALDG;
  * gemma2-2b serving at full width and depth (bf16 weights from the seed):
    ``generate`` on 2 prompts of 8192 tokens plus 16 greedy tokens, whose
    prefill runs kernel G in each of its 13 local layers, all on the
    wgmma route; prefill and decode timed (and the card's busy share under
    ``torch.profiler``); G on the first local layer's q, k, v against its
    plain version, timed beside ``scaled_dot_product_attention`` (the
    yardstick, never called by the port); the prefill's logits against a
    prefill that runs G's plain version instead, both against a prefill of
    the weights upcast to fp32, and the comparison once more under torch's
    default precision flags;
  * gemma2-2b training at full width and depth: kernel Gb (G's backward)
    against its plain version over a sweep, at the local layers' shape in
    bf16 and in fp32, each case on the route ``bwd_route(dtype, D)`` names
    (bf16 wgmma/TMA reading G's lse, or SIMT) and run twice bit-equal, the
    wgmma route's SASS counted, the gemma case timed beside its SIMT body
    and the backward of ``scaled_dot_product_attention``; three
    ``make_train_step`` steps on 2 x 8192 tokens (remat, AdamW), 26 G and
    13 Gb launches a step, all on the wgmma routes, timed and profiled; the first step against the same step with G and
    Gb's plain versions (the loss, every gradient against an fp32 model's,
    the updated params); the smoke-width model memorizing one batch.
  * examples: the eight ``examples/torch_*.py`` called in process
    (``main(argv)``) at the JAX scripts' default arguments, MD at 60 steps,
    division 4, ppc 5, ``torch_lm_serve`` once per ported arch and
    ``torch_lm_train`` on qwen1.5-0.5b and gemma2-2b at smoke width: what
    each returns held (every path on the oracle, MD drift < 0.05, SPH
    finite, halo shards equal to the one-device plan, no executor built in
    the serving steady state, a cached autotune plan with no timing run,
    one dispatch a batch, tokens in range, the smoke loss falling), with
    its seconds and the kernels it launched;
  * the dense archs qwen1.5-0.5b, codeqwen1.5-7b and starcoder2-3b at full
    width and depth (bf16 weights from the seed): ``generate`` on 2
    prompts of 4096 tokens plus 16 greedy tokens with no kernel launched
    (every layer global, so kernel G runs 0 times), prefill and decode
    timed and profiled, the first 4 decode steps' logits against a
    no-cache ``forward`` over the prompt and those tokens (relative L2
    <= 2e-2), the prefill's logits against a prefill of the weights upcast
    to fp32 (<= 5e-2); qwen1.5-0.5b's three train steps on 2 x 4096
    tokens, each loss within 2e-2 of the fp32-upcast model's;
  * the MoE archs at full width and reduced depth (grok-1-314b 4 of 64
    layers, arctic-480b 2 of 35; bf16): ``generate`` on 2 x 4096 + 16
    with kernel A launched exactly once a MoE layer in the prefill and in
    each decode step, the prefill's expert offsets ``torch.equal`` to
    ``paper_prefix_sum``'s, the dropped assignments a layer, prefill and
    decode timed and profiled, the decode cache against a no-cache
    forward where nothing drops, layer 0's MoE block in bf16 against a
    per-expert fp32 reference; mamba2-130m and zamba2-1.2b at full width
    and depth: a 2 x 4096 prefill timed and profiled, ``generate`` on 2 x
    256 + 16 (the prompt replayed through decode steps) with no kernel
    launched, the replay against a no-cache forward in fp32, the middle
    layer's blocks in bf16 against fp32; mamba2-130m's three train steps
    on 2 x 4096 tokens; grok-1-314b's smoke config memorizing one batch,
    kernel A twice a MoE layer a step.

Per particle, the compacted and packed paths and kernel E must equal the
dense X-pencil path (kernel B) bit for bit; kernel F sums in another order
than B, so it is held to B by the per-element tolerance, and to itself bit
for bit whatever the clustering. Any failed check raises, so the
exit code is non-zero. Without a CUDA device it exits 2 and prints no
result.

The line before the last is the card's ``nvidia-smi`` name and power limit,
the one before that a JSON object with one entry per kernel, and the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
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
SCAN_LONG_N = 16_777_219          # 16,385 tiles of look-back
SCAN_REUSED_CALLS = 50            # consecutive calls on one status buffer

DENSE_CASES = ((64, 4, False), (32, 10, True))   # division, per cell, periodic
PACKED_CASE = (64, 4)                             # division, per cell
BLOB_CASE = (64, 131_072, 0.1)                    # division, N, sigma_frac
CHECK_DIVISION = 16
CHUNK_WIDTHS = (8, 16, 32, 64)   # kernels B, C timed at these widths too
ALLIN_THREADS = (256, 512, 1024)  # kernel E timed at these block sizes too
SFC_CLUSTERINGS = ((4, "morton"), (8, "hilbert"))   # csize, curve
SFC_PLAIN_BATCH = 2048           # clusters per chunk of F's plain version

# execute_batch: B systems of division**3 * per cell particles each through
# one chain of launches; (e) and (f) hold 1,048,576 particles in all, the
# dense division-64 scene's count. The periodic (f) has one system that is
# padding throughout. Kernels are held against their plain versions on the
# scenes marked so; (f)'s launches are counted under torch.profiler at
# BATCH_PROFILED systems, in PROFILE_SESSIONS sessions each.
BATCH_SCENES = (  # name, B, division, per cell, periodic, kernel checks
    ("e", 8, 32, 4, False, True),
    ("f", 64, 16, 4, False, False),
    ("f periodic", 16, 16, 4, True, True),
)
BATCH_PATHS = (   # label, plan options, kernels launched once a batch
    ("dense", {"strategy": "xpencil"}, ("prefix_sum", "xpencil_forces")),
    ("compact", {"strategy": "xpencil", "compact": True},
     ("prefix_sum", "xpencil_sparse_forces")),
    ("packed", {"strategy": "xpencil", "layout": "packed"},
     ("prefix_sum", "pack_slots", "xpencil_packed_forces")),
    ("packed+compact", {"strategy": "xpencil", "layout": "packed",
                        "compact": True},
     ("prefix_sum", "pack_slots", "xpencil_packed_forces")),
    ("allin", {"strategy": "allin"}, ("prefix_sum", "allin_forces")),
    ("sfc", {"strategy": "cell_dense", "layout": "sfc"},
     ("prefix_sum", "cell_sfc_forces")),
)
BATCH_PROFILED = (16, 64)
# what one packed execute() launches: kernel A in the binning, the pack
# kernel (all of pack_rows, one call) and kernel D
PACKED_LAUNCHES = {"prefix_sum": 1, "pack_slots": 1,
                   "xpencil_packed_forces": 1}
PROFILE_SESSIONS = 5      # profiler sessions a count (``launches_in_turns``)

# plan.trajectory: division 64 periodic, 4 particles a cell on an FCC
# lattice jittered by at most 0.05 of a cell (uniform particles would put
# pairs ~1e-4 cutoffs apart, which LJ throws out of the box within a step),
# LJ at sigma 0.3 cutoff and eps 1e-4 (tests/test_traj.py's pair kernel at
# this cell width), velocities 0.1 * normal, dt 1e-3. Gate 1: skin 0 on
# every path, bit-equal to the reference_step loop; gate 2: the default
# skin against that loop over TRAJ_STEPS, JAX's tolerances, fewer than
# TRAJ_MAX_REBINS rebins; gate 3: resume at TRAJ_STEPS / 2; gate 4:
# injected faults; gate 5: one sph_step on TRAJ_SPH (division, per cell).
TRAJ_DIVISION, TRAJ_JITTER = 64, 0.05
TRAJ_SIGMA, TRAJ_EPS, TRAJ_VEL, TRAJ_DT = 0.3, 1e-4, 0.1, 1e-3
TRAJ_GATE1_STEPS, TRAJ_GATE1_SEG = 24, 8
TRAJ_STEPS, TRAJ_SEG, TRAJ_CK_EVERY, TRAJ_MAX_REBINS = 256, 32, 64, 26
TRAJ_SPH = (32, 10)
# sph_step's velocities and density, each to its own scale: float32
# rounding of ~42 terms a particle stays far below it, while a zero,
# flipped or 10x pressure scale (p2) is off by 1, 2 or 9
SPH_OWN_TOL = 1e-4
TRAJ_PATHS = (   # label, plan options, force kernels launched every step
    ("dense", {"strategy": "xpencil"}, ("xpencil_forces",)),
    ("packed", {"strategy": "xpencil", "layout": "packed"},
     ("pack_slots", "xpencil_packed_forces")),
    ("compact", {"strategy": "xpencil", "compact": True},
     ("xpencil_sparse_forces",)),
    ("allin", {"strategy": "allin"}, ("allin_forces",)),
)

# bf16 dense tensor-core peak of the H100 SXM at 700 W (NVIDIA data sheet):
# kernel G's operations bound on bf16 inputs
BF16_OPS_PER_S = 989e12

# gemma2-2b serving: 2 requests of 8192 prompt tokens (two windows of 4096,
# so every local layer takes kernel G), then 16 greedy tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "gemma2-2b", 2, 8192, 16
# kernel G against its plain version: tests/test_kernels.py's tolerances
G_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}
G_SWEEP_S, G_RAGGED_S = 256, 200
# prefill logits with kernel G against the prefill with G's plain version,
# both bf16: ||diff|| / ||plain|| over all logits. The two differ only in
# how G's fp32 sums round to bf16 (one flip is 2^-8 relative); a flip at a
# local layer's output passes through up to 26 bf16 residual layers, and
# sqrt(26) * 2^-8 = 0.020 is that accumulation taken as a random walk.
LOGITS_REL_TOL = 2e-2
# The bf16 prefill with kernel G against an fp32 model of the same weights
# (G's plain version in fp32), beside the bf16 prefill with G's plain
# version against the same fp32 model. The only difference between the two
# bf16 prefills is G's rounding (bf16 P in P . V, another summation order),
# one more rounding of the size of those the bf16 model already makes in
# every layer; 1.5x the plain-G prefill's distance leaves room for that one
# rounding and not for an error of the kernel, which would add a term of
# the logits' own size.
FP32_GATE_FACTOR = 1.5

# gemma2-2b training: one step of B x S tokens at full width and depth
# (bf16, remat, AdamW), the serving phase's shape, so every local layer runs
# kernels G and Gb over full windows; TRAIN_STEPS steps, the first one the
# main path whose launches are counted, the later ones timed
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8192, 3
# kernel Gb against its plain version: kernel G's tolerances, bf16 as a
# relative L2 over each gradient (one bf16 rounding of each output is
# 2^-9), fp32 within 3e-4 of each gradient's own largest element
GB_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}
GB_FP32_CASE = (1, 8, 4, 2048, 256, 512, 50.0)   # B, H, KH, S, D, window, cap
# the train step with G and Gb against the same step with their plain
# versions, from the same params and AdamW state: the loss and each updated
# leaf that does not start at zero within 2e-2 relative (L2), the
# prefill-logits gate's reasoning (bf16 roundings through 26 layers,
# sqrt(26) * 2^-8); each leaf's gradient within FP32_GATE_FACTOR x the
# plain-G gradient's distance to an fp32 model's (two bf16 paths differ by
# a few % in a gradient, as far as each lies from fp32)
STEP_REL_TOL = 2e-2
# the smoke-width model (fp32) memorizing one batch on the card: the twin
# of tests/test_train_ckpt_fault.py::test_loss_decreases (30 steps there)
SMOKE_TRAIN_STEPS, SMOKE_TRAIN_DROP = 50, 0.5

# the port's examples (examples/torch_*.py), called in process at the JAX
# scripts' default arguments (MD cut to the verify skill's size), lm_serve
# once per ported arch (at smoke width: 4 prompts of 12 tokens, 24 new) and
# lm_train on the LM examples' default arch and on gemma2-2b, whose local
# layers run kernels G and Gb
LM_PORTED = ("gemma2-2b", "qwen1.5-0.5b", "codeqwen1.5-7b", "starcoder2-3b",
             "grok-1-314b", "arctic-480b", "mamba2-130m", "zamba2-1.2b")
EXAMPLE_RUNS = (
    ("quickstart", ()),
    ("md_lennard_jones", ("--steps", "60", "--division", "4", "--ppc", "5")),
    ("sph_demo", ()),
    ("distributed_md", ()),
    ("serve_engine", ()),
    ("autotune_batch", ()),
    *(("lm_serve", ("--arch", a)) for a in LM_PORTED),
    *(("lm_train", ("--arch", a)) for a in ("qwen1.5-0.5b", "gemma2-2b")),
)
MD_DRIFT_TOL = 0.05          # the MD example's own OK/HIGH line

# the dense archs at full width and depth (bf16, seed 0), every layer on
# the global attention path: 2 prompts of 4096 tokens + 16 greedy tokens
DENSE_ARCHS = ("qwen1.5-0.5b", "codeqwen1.5-7b", "starcoder2-3b")
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 2, 4096, 16
# (a) the first DENSE_CACHE_STEPS decode steps' logits against a no-cache
# forward over prompt + generated tokens: both bf16, they differ in how
# each layer's attention sums (over the cache, or in the flash's chunks)
# and rounds to bf16, sqrt(L) * 2^-8 = 0.022 at L = 32 layers taken as a
# random walk
DENSE_CACHE_STEPS, CACHE_REL_TOL = 4, 2e-2
# (b) the bf16 prefill's logits against a prefill of the same weights in
# fp32: every bf16 rounding of the model (the gemma2-2b phase measures
# 0.0162 over its 26 layers on an H100, ``logits_g_vs_fp32_rel_l2``)
DENSE_FP32_REL_TOL = 5e-2
# qwen1.5-0.5b (the LM examples' default) trains at full width: steps of
# 2 x 4096 tokens, each bf16 loss within 2e-2 relative of the fp32-upcast
# model's loss on the same batch (STEP_REL_TOL's bf16 reasoning)
DENSE_TRAIN_ARCH, DENSE_TRAIN_STEPS = "qwen1.5-0.5b", 3


# the MoE archs at full width, their depth cut to what fits one 80 GB card
# with the bf16 weights (grok-1-314b ~9.8 GB a layer, arctic-480b ~27 GB),
# bf16, seed 0: generate on 2 x 4096 prompt tokens + 16 new, kernel A
# launched once a MoE layer in the prefill and in every decode step
MOE_ARCHS = (("grok-1-314b", 4), ("arctic-480b", 2))   # arch, layers kept
MOE_BATCH, MOE_PROMPT, MOE_NEW = 2, 4096, 16
# (a) decode vs a no-cache forward where no assignment drops: a short
# prompt, and the capacity factor E / top_k, at which an expert's
# capacity is every token (moe_capacity(T, E, k, E / k) > T), so nothing
# can drop; decode's capacity is the same 8 rows at either factor
MOE_CACHE_PROMPT = 64
# (b) one MoE block (layer 0's) in bf16 against an fp32 reference
# (each expert's weights upcast in turn, no capacity limit) whose input
# comes through layer 0 in fp32: on the tokens routed to the same experts
# in both and not dropped in the bf16 run, the bf16 block's relative L2
# (the bf16 roundings of the block's input, its GEMMs and their outputs,
# a few 2^-8 taken as a random walk)
BLOCK_REL_TOL = 2e-2
# the SSM archs at full width and depth (bf16, seed 0): the prefill of 2 x
# 4096 tokens timed; generate on 2 x 256 + 16, whose replay of the prompt
# is one decode step a token (a 4096-token replay would take minutes of
# launches). With random weights the Mamba stack amplifies each rounding:
# on an H100 the bf16 replay departs from a bf16 forward by 0.155 / 0.227
# (mamba2-130m / zamba2-1.2b; reported as bf16_cache_vs_forward_rel_l2),
# while one block in bf16 is within 0.003-0.008 of fp32. So (a), the
# replay's last logits and 3 decode steps against a no-cache forward, runs
# on the weights upcast to fp32, where the SSD's chunked sums and the
# recurrence's still differ by 3.5e-5 / 6.5e-5 through the depth; 1e-3
# leaves an order over that and fails a path that rounds to bf16 by two;
# and (b), bf16 against fp32, is held a block at a time: the middle
# layer's Mamba-2 mixer (and zamba2's shared attention and MLP) on the
# bf16 model's hidden state, BLOCK_REL_TOL as for the MoE block. The
# whole model's bf16 distances are reported, not held
SSM_ARCHS = ("mamba2-130m", "zamba2-1.2b")
SSM_REPLAY_PROMPT, SSM_CACHE_STEPS = 256, 3
SSM_FP32_CACHE_REL_TOL = 1e-3
# mamba2-130m trains at full width and depth on 2 x 4096 tokens; the MoE
# backward through the kernel-A dispatch runs on grok-1-314b's smoke config
# (full-width MoE training waits: one grok layer with AdamW is ~60 GB)
SSM_TRAIN_ARCH, SSM_TRAIN_STEPS = "mamba2-130m", 3
MOE_TRAIN_ARCH = "grok-1-314b"


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


def cuda_ms_queued(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds of ``fn()`` on the card, by CUDA events around ``reps``
    calls enqueued back to back: the device time of a call whose launch
    the host enqueues faster than the card runs it. ``cuda_ms`` records an
    event pair around each call on an idle card, so its time also holds the
    host's time to enqueue the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def assert_own_scale_close(got, want, what: str, tol: float) -> float:
    """max |got - want| / max |want|, with no floor of 1: for a quantity
    far below 1 (SPH's velocities after one step from rest are ~1e-5),
    where ``scale_rel_err`` would pass anything within an absolute tol."""
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{what}: non-finite values")
    scale = float(want.double().abs().max())
    if not scale > 0:
        raise AssertionError(f"{what}: the reference is all zero")
    err = float((got.double() - want.double()).abs().max()) / scale
    if err > tol:
        raise AssertionError(f"{what}: error {err:.3e} of its own scale > "
                             f"{tol}")
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
    self pairs excluded: what this input needs a kernel to consider."""
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


def touched_rows(domain, active) -> torch.Tensor:
    """(nz+2, ny+2) bool: the padded pencil rows that the 9-row stencils of
    the listed interior pencils read."""
    nx, ny, nz = domain.ncells
    a = active.long()
    z, y = a // ny + 1, a % ny + 1
    mark = torch.zeros((nz + 2, ny + 2), dtype=torch.bool, device=a.device)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            mark[z + dz, y + dy] = True
    return mark


def dense_read_bytes(bins, rows=None) -> int:
    """Bytes a kernel must read of the dense planes: 4 B of slot_id for
    every slot of the padded pencil rows it reads (all, or the ``rows``
    mask), and 12 B of x, y, z only for the slots that hold a particle."""
    sid = bins.slot_id if rows is None else bins.slot_id[rows]
    return 4 * sid.numel() + 12 * int((sid >= 0).sum())


def kernel_f_bytes(dom, bins, sfc) -> int:
    """Bytes kernel F must move for this pair list: the slots of every
    padded cell its kept codes read, as targets or sources (4 B of slot_id
    each, 12 B of x, y, z for a particle), the kept codes with their
    csize source bases, every cluster's target bases, and the tiles
    written once (16 B a slot)."""
    from repro_torch.core.binning import sfc_device_tables
    tables = sfc_device_tables(dom, sfc.csize, sfc.curve, bins.slot_id.device)
    n_pcells = bins.slot_id.numel() // bins.m_c
    n_clusters = tables["tgt_pcell"].shape[0]
    codes = sfc.codes[:min(int(sfc.n_pairs), sfc.pair_cap)].long()
    a, k = codes >> 5, codes & 31
    touched = torch.zeros(n_pcells + 1, dtype=torch.bool,
                          device=codes.device)
    touched[tables["src_pcell"][a, k].long().reshape(-1)] = True
    touched[tables["tgt_pcell"][a].long().reshape(-1)] = True
    touched = touched[:n_pcells]
    occupied = (bins.slot_id.view(n_pcells, bins.m_c) >= 0).sum(-1)
    return (4 * bins.m_c * int(touched.sum())
            + 12 * int(occupied[touched].sum())
            + 4 * (1 + sfc.csize) * codes.numel() + 4 * sfc.csize * n_clusters
            + 16 * n_clusters * sfc.csize * bins.m_c)


def shapes(d: int, width: str, out: str, **sizes) -> str:
    """The planes a kernel reads and the outputs it writes at division
    ``d``, for the kernels line."""
    return (f"(d+2, d+2, {width}) planes -> 4 x {out}, d = {d}, "
            + ", ".join(f"{k} = {v}" for k, v in sizes.items()))


def bound(n_bytes: float, n_ops: float):
    """(bound ms, what sets it) on the H100's peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def window_pairs(s: int, window: int) -> int:
    """In-window (q, k) pairs of one head: the sum over q of min(q+1,
    window)."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def kernel_g_bound(b, h, kh, s, d, window, itemsize):
    """(bound ms, what sets it, FLOP, bytes) of one call of kernel G: 4 D
    FLOP per in-window pair against the inputs' peak (bf16 tensor cores, or
    fp32 outside them), q, k, v read and o written once."""
    flops = 4 * d * b * h * window_pairs(s, window)
    n_bytes = itemsize * b * s * d * (2 * h + 2 * kh)
    peak = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", flops, n_bytes)


def check_kernel_g(gen, dev):
    """Kernel G against its plain version over the sweep; -> (checks, max
    abs error, launches by route). Each element within tol * (1 +
    |plain|); every bf16 case whose head_dim the tensor-core route takes
    must have taken it."""
    from repro_torch.kernels.window_attn import (route, window_attention,
                                                 window_attention_plain)
    cases = [(b, h, kh, G_SWEEP_S, d, window, softcap, dtype, 128)
             for b in (1, 2)
             for h, kh in ((4, 4), (8, 2), (6, 1), (8, 4), (8, 1))
             for d in (16, 64, 128, 256)
             for window in (5, 100, G_SWEEP_S + 44)   # < tile, ragged, > S
             for softcap in (0.0, 50.0)
             for dtype in (torch.float32, torch.bfloat16)]
    # S not a multiple of 64 (200) or of 128 (320); window 1, below the
    # 64-key tile, ragged, and >= S
    cases += [(1, 8, 2, s, d, window, 50.0, dtype, 8)
              for s in (G_RAGGED_S, 320) for d in (16, 64, 128, 256)
              for window in (1, 5, 77, s)
              for dtype in (torch.float32, torch.bfloat16)]
    # bf16 head dims between the powers of two, and GQA ratios 1 to 8
    cases += [(1, h, kh, G_SWEEP_S, d, 64, 50.0, torch.bfloat16, 128)
              for d in (32, 48, 80, 96, 112, 144, 160, 176, 192, 208, 224,
                        240)
              for h, kh in ((4, 4), (8, 4), (8, 2), (8, 1))]
    # B * H * S / 128 = 512 and 1,024 blocks: several waves of the 132 SMs
    cases += [(4, 16, 4, 1024, d, 300, 50.0, torch.bfloat16, 128)
              for d in (128, 256)]
    cases += [(1, 8, 4, LM_PROMPT, 256, 4096, 50.0, torch.bfloat16, 128)]
    max_err = 0.0
    by_route = dict.fromkeys(window_attention.launches_by_route, 0)
    for b, h, kh, s, d, window, softcap, dtype, blk in cases:
        amp = 4.0 if softcap else 1.0            # scores past the cap
        q = (torch.randn((b, h, s, d), generator=gen, device=dev) * amp)
        k = (torch.randn((b, kh, s, d), generator=gen, device=dev) * amp)
        v = torch.randn((b, kh, s, d), generator=gen, device=dev)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = dict(window_attention.launches_by_route)
        got = window_attention(q, k, v, window=window, blk=blk,
                               softcap=softcap)
        torch.cuda.synchronize()
        way = route(dtype, d)
        if window_attention.launches_by_route[way] != before[way] + 1:
            raise AssertionError(f"kernel G, D={d} {dtype}: did not take "
                                 f"the {way} route")
        by_route[way] += 1
        want = window_attention_plain(q, k, v, window=window, blk=blk,
                                      softcap=softcap).float()
        err = (got.float() - want).abs()
        tol = G_TOL[dtype]
        if got.dtype != dtype or not bool(got.isfinite().all()) or \
                bool((err > tol * (1 + want.abs())).any()):
            raise AssertionError(
                f"kernel G vs plain, B={b} H={h} KH={kh} S={s} D={d} "
                f"window={window} softcap={softcap} {dtype} ({way}): max "
                f"|diff| {float(err.max()):.3e} > {tol} (1 + |want|)")
        max_err = max(max_err, float(err.max()))
    return len(cases), max_err, by_route


def sass_counts(source: str):
    """{instruction: count} of the tensor-core and TMA instructions in the
    built library of ``csrc/<source>`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(source))],
                          check=True, capture_output=True, text=True).stdout
    return {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}


def logits_diff(got, want, chunk: int = 1024):
    """(||got - want|| / ||want||, max |got - want|) over (B, S, V) logits,
    a chunk of positions at a time on ``want``'s device."""
    num = den = 0.0
    worst = 0.0
    for i in range(0, want.shape[1], chunk):
        g = got[:, i:i + chunk].to(want.device).float()
        w = want[:, i:i + chunk].float()
        d = g - w
        num += float((d * d).sum())
        den += float((w * w).sum())
        worst = max(worst, float(d.abs().max()))
    return (num / den) ** 0.5, worst


def lm_serving(seed: int, dev, reset_launches, launch_counts,
               precision_defaults):
    """gemma2-2b at full width and depth: the main path (``generate``), its
    timing by layer, kernel G on the captured q, k, v against its plain
    version and the SDPA yardstick, the prefill's logits against a prefill
    with G's plain version, both against an fp32 model of the same weights,
    and the comparison again under torch's default precision flags."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.window_attn import (window_attention,
                                                 window_attention_plain)
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.serving import generate

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (LM_BATCH, LM_PROMPT)), device=dev)
    max_len = LM_PROMPT + LM_NEW
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts to 0, generate, counts read ---------------------
    reset_launches()
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompt, LM_NEW, max_len=max_len)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_local = cfg.n_layers // 2
    routes = dict(window_attention.launches_by_route)
    if launches != {"window_attention": n_local} or \
            routes != {"wgmma": n_local, "simt": 0}:
        raise AssertionError(f"generate launched {launches} by route "
                             f"{routes}, want window_attention {n_local} "
                             f"(one prefill), all on the wgmma route")
    if tuple(tokens.shape) != (LM_BATCH, LM_NEW) or \
            int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {tuple(tokens.shape)} out "
                             f"of range")
    if tuple(logits.shape) != (LM_BATCH, LM_PROMPT, cfg.vocab_size) or \
            not all(bool(logits[b].isfinite().all())
                    for b in range(LM_BATCH)):
        raise AssertionError("prefill logits: wrong shape or non-finite")
    first = tokens[:, 0]
    if not torch.equal(first, logits[:, -1].argmax(-1)):
        raise AssertionError("first generated token is not the prefill's "
                             "greedy token")
    del logits
    log(f"gemma2-2b main path: {n_params} parameters ({cfg.dtype}, seed "
        f"{seed}, "
        f"{init_s:.1f} s), generate {LM_BATCH} x {LM_PROMPT} prompt tokens "
        f"+ {LM_NEW} new in {generate_s:.2f} s, launches {launches} (G by "
        f"route {routes}), peak "
        f"{peak_gb:.2f} GB allocated; tokens {tokens.tolist()}")

    # -- prefill timed, q, k, v of the first local layer captured --------------
    captured = {}

    def capture(q, k, v, **kw):
        if not captured:
            captured.update(q=q, k=k, v=v, kw=kw)
        return window_attention(q, k, v, **kw)

    def timed_prefill():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = M.prefill(cfg, params, prompt, max_len=max_len)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    M.window_attention = capture
    (lg, cache), p_ms1 = timed_prefill()
    M.window_attention = window_attention
    del lg
    (logits_g, cache), p_ms2 = timed_prefill()
    if not torch.equal(logits_g[:, -1].argmax(-1), first):
        raise AssertionError("the timed prefill's greedy token differs from "
                             "generate's")

    # decode per token on the prefill's cache, as generate runs it
    tok = logits_g[:, -1:].argmax(-1)
    dec_ms = []
    for idx in range(LM_PROMPT, max_len - 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lg, cache = M.decode_step(cfg, params, cache, tok, idx)
        end.record()
        end.synchronize()
        dec_ms.append(start.elapsed_time(end))
        tok = lg.argmax(-1)
    decode_ms = statistics.median(dec_ms)
    # the card's busy share: kernel time under the profiler over the
    # unprofiled time (the last slot of the cache rewritten each step)
    decode_dev_ms, decode_launches, decode_kernels = device_time(
        lambda: M.decode_step(cfg, params, cache, tok, max_len - 1), reps=3)
    del cache
    prefill_dev_ms, prefill_launches, prefill_kernels = device_time(
        lambda: M.prefill(cfg, params, prompt, max_len=max_len))

    # -- kernel G on the captured gemma q, k, v --------------------------------
    q, k, v, kw = (captured[n] for n in ("q", "k", "v", "kw"))
    got = window_attention(q, k, v, **kw)
    want = window_attention_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()
    cap_err = (got.float() - want).abs()
    if bool((cap_err > G_TOL[q.dtype] * (1 + want.abs())).any()):
        raise AssertionError(f"kernel G vs plain on the captured gemma q, k, "
                             f"v: max |diff| {float(cap_err.max()):.3e}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    g_ms = cuda_ms(lambda: window_attention(q, k, v, **kw), reps=10)
    # G's device time per call: its kernels' share of the prefill's profile
    # (13 launches at this shape; a profiler session around G alone saw no
    # kernel on the card)
    g_dev_ms = group_kernel_times(prefill_kernels)["kernel G"] / n_local
    if g_dev_ms <= 0:
        raise AssertionError("the prefill's profile holds no kernel G time")
    g_plain_ms = cuda_ms(lambda: window_attention_plain(q, k, v, **kw),
                         reps=3)
    kw0 = dict(kw, softcap=0.0)
    g0_ms = cuda_ms(lambda: window_attention(q, k, v, **kw0), reps=10)
    pos = torch.arange(s, device=dev)
    band = (pos[None, :] <= pos[:, None]) & \
        (pos[:, None] - pos[None, :] < kw["window"])
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=band, enable_gqa=True)
    sdpa_err = float((sdpa().float() - window_attention(q, k, v, **kw0)
                      .float()).abs().max())
    sdpa_ms = cuda_ms(sdpa, reps=5)
    g_bound_ms, g_bound_by, g_flops, g_bytes = kernel_g_bound(
        b, h, kh, s, d, kw["window"], q.element_size())
    # rate-only reference: causal SDPA on the flash backend, softcap 0, over
    # all S (S + 1) / 2 causal pairs (another function: no window)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qe, ke, ve = (q, k.repeat_interleave(h // kh, 1),
                  v.repeat_interleave(h // kh, 1))
    causal_flops = 4 * d * b * h * s * (s + 1) // 2
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qe, ke, ve, is_causal=True), reps=5)
    causal_tflops = causal_flops / causal_ms / 1e9
    del qe, ke, ve

    # -- where the prefill's time goes: the layers on the same shapes ----------
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev).to(q.dtype)
    lp = M._index(params["layers"], 1)
    flash_ms = cuda_ms(lambda: A.attention(q, k, v, True, cfg.attn_softcap,
                                           cfg.attn_q_chunk,
                                           cfg.attn_k_chunk), reps=3)
    mlp_ms = cuda_ms(lambda: L.mlp(L.apply_norm(x, lp["norm2"], cfg.norm),
                                   lp["mlp"], cfg.act), reps=5)
    proj_ms = cuda_ms(lambda: (L.qkv_project(x, lp["attn"], cfg.n_heads,
                                             cfg.n_kv_heads, cfg.head_dim),
                               L.out_project(q, lp["attn"])), reps=5)
    layer_ms = {kind: cuda_ms(lambda i=i, loc=loc: M._decoder_layer(
        cfg, M._index(params["layers"], i), x, pos, loc), reps=3)
        for kind, i, loc in (("local", 0, True), ("global", 1, False))}
    logits_ms = cuda_ms(lambda: M._logits(cfg, params, x), reps=3)

    # -- end to end: the prefill with G's plain version --------------------------
    reset_launches()
    M.window_attention = window_attention_plain
    (logits_p, cache), plain_prefill_ms = timed_prefill()
    M.window_attention = window_attention
    if launch_counts():
        raise AssertionError(f"plain prefill launched {launch_counts()}")
    del cache
    rel, worst = logits_diff(logits_g, logits_p)
    last_g, last_p = logits_g[:, -1].float(), logits_p[:, -1].float()
    top2 = last_p.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    same_greedy = torch.equal(last_g.argmax(-1), last_p.argmax(-1))
    if rel > LOGITS_REL_TOL or not bool(logits_g[:, -1].isfinite().all()) \
            or (margin > 2 * worst and not same_greedy):
        raise AssertionError(f"prefill with kernel G vs with its plain "
                             f"version: relative L2 {rel:.3e} (tol "
                             f"{LOGITS_REL_TOL}), max |diff| {worst:.3e}, "
                             f"greedy equal {same_greedy} (margin "
                             f"{margin:.3e})")

    # -- both bf16 prefills against an fp32 model of the same weights -----------
    params32 = _map(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    reset_launches()
    M.window_attention = window_attention_plain
    logits_32, cache = M.prefill(cfg32, params32, prompt, max_len=max_len)
    M.window_attention = window_attention
    torch.cuda.synchronize()
    fp32_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del cache, params32
    if launch_counts():
        raise AssertionError(f"fp32 prefill launched {launch_counts()}")
    rel_g32, worst_g32 = logits_diff(logits_g, logits_32)
    rel_p32, worst_p32 = logits_diff(logits_p, logits_32)
    del logits_32
    log(f"gemma2-2b vs an fp32 model (G's plain version): relative L2 of the "
        f"bf16 prefill with kernel G {rel_g32:.6f}, with G's plain version "
        f"{rel_p32:.6f} (ratio {rel_g32 / rel_p32:.4f}, gate "
        f"{FP32_GATE_FACTOR}); max |diff| {worst_g32:.4f}, {worst_p32:.4f}")
    if not rel_g32 <= FP32_GATE_FACTOR * rel_p32:
        raise AssertionError(f"prefill with kernel G is {rel_g32:.4e} from "
                             f"the fp32 model, more than {FP32_GATE_FACTOR} "
                             f"x the plain-G prefill's {rel_p32:.4e}")
    del logits_p

    # -- G against its plain version again, under torch's default flags ---------
    strict = precision_flags()
    set_precision_flags(precision_defaults)
    (logits_gd, cache), default_prefill_ms = timed_prefill()
    del cache
    M.window_attention = window_attention_plain
    (logits_pd, cache), _ = timed_prefill()
    M.window_attention = window_attention
    del cache
    set_precision_flags(strict)
    rel_d, worst_d = logits_diff(logits_gd, logits_pd)
    rel_flags, _ = logits_diff(logits_gd, logits_g)
    del logits_pd, logits_g
    log(f"gemma2-2b under torch's defaults {precision_defaults}: prefill "
        f"with kernel G vs with its plain version, relative L2 {rel_d:.6f} "
        f"(tol {LOGITS_REL_TOL}), max |diff| {worst_d:.4f}; vs the same "
        f"prefill under the checks' flags {rel_flags:.6f}")
    if rel_d > LOGITS_REL_TOL or not bool(logits_gd[:, -1].isfinite().all()):
        raise AssertionError(f"under torch's default flags, prefill with "
                             f"kernel G vs its plain version: relative L2 "
                             f"{rel_d:.3e} (tol {LOGITS_REL_TOL})")
    del logits_gd
    res = {
        "case": f"{LM_ARCH} {cfg.dtype}, B={LM_BATCH}, prompt {LM_PROMPT}, "
                f"{LM_NEW} new tokens, max_len {max_len}",
        "n_params": n_params, "init_s": init_s, "generate_s": generate_s,
        "launches": launches, "peak_allocated_gb": peak_gb,
        "prefill_ms": [p_ms1, p_ms2], "decode_ms_per_token": decode_ms,
        "decode_ms_all": dec_ms,
        "prefill_device_ms": prefill_dev_ms,
        "prefill_busy_share": prefill_dev_ms / min(p_ms1, p_ms2),
        "prefill_device_ms_by_group": group_kernel_times(prefill_kernels),
        "prefill_top_kernels": [(k[:72], ms) for k, ms in
                                prefill_kernels[:8]],
        "decode_device_ms": decode_dev_ms,
        "decode_busy_share": decode_dev_ms / decode_ms,
        "decode_device_ms_by_group": group_kernel_times(decode_kernels),
        "decode_top_kernels": [(k[:72], ms) for k, ms in decode_kernels[:5]],
        "decode_launches_per_token": decode_launches,
        "prefill_launches": prefill_launches,
        "routes": routes,
        "kernel_g_ms": g_ms, "kernel_g_softcap0_ms": g0_ms,
        "kernel_g_device_ms": g_dev_ms,
        "kernel_g_tflops": g_flops / g_ms / 1e9,
        "sdpa_causal_flash_ms": causal_ms,
        "sdpa_causal_flash_tflops": causal_tflops,
        "kernel_g_plain_ms": g_plain_ms, "sdpa_ms": sdpa_ms,
        "sdpa_vs_g_softcap0_max_abs": sdpa_err,
        "kernel_g_bound_ms": g_bound_ms, "kernel_g_bound_by": g_bound_by,
        "kernel_g_gflop": g_flops / 1e9, "kernel_g_mbytes": g_bytes / 1e6,
        "kernel_g_captured_max_abs_err": float(cap_err.max()),
        "global_flash_ms": flash_ms, "mlp_ms": mlp_ms,
        "qkv_out_proj_ms": proj_ms, "local_layer_ms": layer_ms["local"],
        "global_layer_ms": layer_ms["global"], "logits_ms": logits_ms,
        "plain_prefill_ms": plain_prefill_ms,
        "logits_rel_l2": rel, "logits_max_abs_diff": worst,
        "logits_g_vs_fp32_rel_l2": rel_g32,
        "logits_plain_vs_fp32_rel_l2": rel_p32,
        "fp32_prefill_peak_allocated_gb": fp32_peak_gb,
        "default_flags": precision_defaults,
        "default_flags_prefill_ms": default_prefill_ms,
        "default_flags_logits_rel_l2": rel_d,
        "default_vs_strict_flags_rel_l2": rel_flags,
        "last_top2_margin": margin, "greedy_equal": same_greedy,
        "shapes": f"q ({b}, {h}, {s}, {d}), k, v ({b}, {kh}, {s}, {d}) "
                  f"{q.dtype}, window {kw['window']}, softcap "
                  f"{kw['softcap']}",
    }
    log("gemma2-2b: " + json.dumps(res))
    return res


def kernel_gb_bound(b, h, kh, s, d, window, itemsize, flop_per_pair=10):
    """(bound ms, what sets it, FLOP, bytes) of one call of kernel Gb: 10 D
    FLOP per in-window pair (q.k and dout.v recomputed, the dV, dK and dQ
    products; 14 D for the work the wgmma route does, which computes q.k
    and dout.v in both its dK/dV and its dQ launch) against the inputs'
    peak; q, k, v, out, dout read and dq, dk, dv written once."""
    flops = flop_per_pair * d * b * h * window_pairs(s, window)
    n_bytes = itemsize * b * s * d * (4 * h + 4 * kh)
    peak = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", flops, n_bytes)


def gb_inputs(gen, dev, b, h, kh, s, d, window, softcap, dtype, amp=2.0):
    """((q, k, v, kernel G's out, a random dout), G's lse) for kernel Gb;
    the lse is None where G's route is "simt" (its Gb computes its own)."""
    from repro_torch.kernels.window_attn import window_attention_with_lse
    q = (torch.randn((b, h, s, d), generator=gen, device=dev) * amp)
    k = (torch.randn((b, kh, s, d), generator=gen, device=dev) * amp)
    v = torch.randn((b, kh, s, d), generator=gen, device=dev)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    out, lse = window_attention_with_lse(q, k, v, window=window, blk=1,
                                         softcap=softcap)
    dout = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
    return (q, k, v, out, dout), lse


def check_gb_case(args, lse, window, softcap):
    """Kernel Gb on ``args`` = (q, k, v, out, dout) and G's ``lse`` against
    its plain version, twice, bit-equal, on the route ``bwd_route`` names;
    -> (max abs error, [error of dq, dk, dv]). bf16: relative L2 of each
    gradient; fp32: error of each gradient's own scale. At window 1 a row
    sees one key, so dq and dk are zero but for rounding: both are held to
    dv's scale."""
    from repro_torch.kernels.window_attn import (bwd_route,
                                                 window_attention_bwd,
                                                 window_attention_bwd_plain)
    q = args[0]
    way = bwd_route(q.dtype, q.shape[-1])
    before = window_attention_bwd.launches_by_route[way]
    got = window_attention_bwd(*args, window=window, softcap=softcap,
                               lse=lse)
    again = window_attention_bwd(*args, window=window, softcap=softcap,
                                 lse=lse)
    want = window_attention_bwd_plain(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    what = (f"kernel Gb vs plain, q {tuple(q.shape)} k "
            f"{tuple(args[1].shape)} window={window} softcap={softcap} "
            f"{q.dtype} ({way})")
    if window_attention_bwd.launches_by_route[way] != before + 2:
        raise AssertionError(f"{what}: did not take the {way} route")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two runs differ")
    tol = GB_TOL[q.dtype]
    errs, worst = [], 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        if g.dtype != torch.float32 or not bool(g.isfinite().all()):
            raise AssertionError(f"{what}: {name} non-finite")
        worst = max(worst, float((g - w).abs().max()))
        if window == 1 and name != "dv":
            errs.append(float((g - w).abs().max())
                        / float(want[2].float().abs().max()))
        elif q.dtype == torch.bfloat16:
            errs.append(float((g - w).norm() / w.norm()))
        else:
            errs.append(float((g - w).abs().max() / w.abs().max()))
        if not errs[-1] <= tol:
            raise AssertionError(f"{what}: {name} error {errs[-1]:.3e} > "
                                 f"{tol}")
    if any(t.dtype != q.dtype for t in got):
        raise AssertionError(f"{what}: outputs not in {q.dtype}")
    return worst, errs


def check_kernel_gb(gen, dev):
    """Kernel Gb against its plain version over a sweep (B, GQA ratio, D,
    windows 1 to past S, softcap, S not a multiple of the 32 or 64-row
    tiles, fp32 and bf16), each case run twice bit-equal on the route
    ``bwd_route`` names (bf16 at D 64 and 256: wgmma; D 20 and fp32:
    SIMT); -> (cases, max abs error, cases by route)."""
    from repro_torch.kernels.window_attn import bwd_route
    cases = [(b, h, kh, s, d, window, softcap, dtype)
             for b, h, kh in ((1, 4, 4), (2, 8, 2), (1, 8, 1))
             for s, d in ((256, 64), (200, 256), (130, 20))
             for window, softcap in ((1, 50.0), (37, 0.0), (64, 50.0),
                                     (300, 50.0))
             for dtype in (torch.float32, torch.bfloat16)]
    worst = 0.0
    by_route = {"wgmma": 0, "simt": 0}
    for b, h, kh, s, d, window, softcap, dtype in cases:
        args, lse = gb_inputs(gen, dev, b, h, kh, s, d, window, softcap,
                              dtype)
        worst = max(worst, check_gb_case(args, lse, window, softcap)[0])
        by_route[bwd_route(dtype, d)] += 1
    return len(cases), worst, by_route


def lm_training(seed: int, dev, reset_launches, launch_counts):
    """gemma2-2b training at full width and depth: kernel Gb at the local
    layers' shape against its plain version and the SDPA-backward
    yardstick, the main path (``make_train_step``: loss, gradients through
    G and Gb under remat, AdamW) counted and timed, the same first step with
    G and Gb swapped for their plain versions, and the smoke-width model
    memorizing one batch on the card."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.kernels.window_attn import (_bwd_simt, bwd_route,
                                                 window_attention,
                                                 window_attention_bwd,
                                                 window_attention_bwd_plain,
                                                 window_attention_plain,
                                                 window_attention_with_lse)
    from repro_torch.models import model as M
    from repro_torch.optim import AdamConfig, init_opt_state
    from repro_torch.train import make_loss_fn, make_train_step

    t_phase = time.perf_counter()
    split = {}                    # seconds of each part of the phase

    def mark(part):
        torch.cuda.synchronize()
        split[part] = time.perf_counter() - t_phase - sum(split.values())

    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = get_config(LM_ARCH)
    n_local = cfg.n_layers // 2

    # -- kernel Gb at the local layers' shape, bf16 softcap 50 -----------------
    shape = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ,
             cfg.head_dim, cfg.window)
    b, h, kh, s, d, window = shape
    gb_route = bwd_route(torch.bfloat16, d)
    if gb_route != "wgmma":
        raise AssertionError(f"kernel Gb at {shape} bf16 routes to "
                             f"{gb_route}, not wgmma")
    args, lse = gb_inputs(gen, dev, *shape, cfg.attn_softcap,
                          torch.bfloat16)
    gb_err, gb_errs = check_gb_case(args, lse, window, cfg.attn_softcap)
    kw = dict(window=window, softcap=cfg.attn_softcap)
    gb_ms = cuda_ms(lambda: window_attention_bwd(*args, **kw, lse=lse),
                    reps=5)
    gb_plain_ms = cuda_ms(lambda: window_attention_bwd_plain(*args, **kw),
                          reps=2)
    # softcap 0 needs G's lse of the uncapped scores
    lse0 = window_attention_with_lse(*args[:3], window=window, blk=1)[1]
    gb0_ms = cuda_ms(lambda: window_attention_bwd(*args, window=window,
                                                  lse=lse0), reps=3)
    del lse0
    # the SIMT body on the same inputs: the route this PR replaced here
    simt_out = tuple(torch.empty_like(t) for t in args[:3])
    gb_simt_ms = cuda_ms(lambda: _bwd_simt(*args, *simt_out, window,
                                           cfg.attn_softcap), reps=2,
                         warmup=1)
    del simt_out
    gb_bound_ms, gb_bound_by, gb_flops, gb_bytes = kernel_gb_bound(
        b, h, kh, s, d, window, 2)
    gb_work_bound_ms, _, gb_work_flops, _ = kernel_gb_bound(
        b, h, kh, s, d, window, 2, flop_per_pair=14)
    # the yardstick: SDPA's backward through autograd, band mask, softcap 0
    q, k, v, _, dout = (t.detach().requires_grad_() for t in args)
    del lse
    pos = torch.arange(s, device=dev)
    band = (pos[None, :] <= pos[:, None]) & \
        (pos[:, None] - pos[None, :] < window)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                       enable_gqa=True)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (q, k, v), dout, retain_graph=True), reps=3)
    del q, k, v, o, dout, band, args
    fp32_args, fp32_lse = gb_inputs(gen, dev, *GB_FP32_CASE, torch.float32)
    if fp32_lse is not None:
        raise AssertionError("kernel G's SIMT route returned an lse")
    gb32_err, gb32_errs = check_gb_case(fp32_args, None, GB_FP32_CASE[5],
                                        GB_FP32_CASE[6])
    gb32_ms = cuda_ms(lambda: window_attention_bwd(
        *fp32_args, window=GB_FP32_CASE[5], softcap=GB_FP32_CASE[6]),
        reps=3)
    del fp32_args
    log(f"kernel Gb at {shape} bf16 softcap {cfg.attn_softcap}, route "
        f"{gb_route}: relative "
        f"L2 (dq, dk, dv) {gb_errs} (tol {GB_TOL[torch.bfloat16]}), "
        f"bit-equal twice; {gb_ms:.3f} ms (softcap 0: {gb0_ms:.3f}), "
        f"{gb_flops / gb_ms / 1e9:.1f} TFLOP/s of the 10 D gradient, "
        f"{gb_work_flops / gb_ms / 1e9:.1f} of the 14 D work done; SIMT "
        f"body {gb_simt_ms:.3f} ms; plain "
        f"{gb_plain_ms:.3f} ms, bound "
        f"{gb_bound_ms:.4f} ms ({gb_bound_by}; the work done "
        f"{gb_work_bound_ms:.4f}), SDPA backward "
        f"{sdpa_bwd_ms:.3f} ms; fp32 {GB_FP32_CASE}: own-scale errors "
        f"{gb32_errs}, {gb32_ms:.3f} ms")
    torch.cuda.empty_cache()
    mark("kernel Gb checks and times")

    # -- the main path: make_train_step at full width and depth ----------------
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    params0 = _map(params, torch.clone)
    n_params = sum(t.numel() for t in _leaves(params))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batches = [dict(zip(("tokens", "labels"), batch_at(data, i, device=dev)))
               for i in range(TRAIN_STEPS)]
    opt_cfg = AdamConfig(total_steps=TRAIN_STEPS, warmup_steps=1,
                         moment_dtype=cfg.moment_dtype)
    step = make_train_step(cfg, opt_cfg)
    opt = init_opt_state(params, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, norms = [], [], []
    for i in range(TRAIN_STEPS):
        if i == 0:
            reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics, params, opt = step(params, opt, batches[i])
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 0:
            launches = launch_counts()
            routes = dict(window_attention.launches_by_route)
            gb_routes = dict(window_attention_bwd.launches_by_route)
            params_g1 = _map(params, torch.clone)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"window_attention": 2 * n_local, "window_attention_bwd": n_local}
    if launches != want or routes != {"wgmma": 2 * n_local, "simt": 0} or \
            gb_routes != {"wgmma": n_local, "simt": 0}:
        raise AssertionError(f"a train step launched {launches} (G by route "
                             f"{routes}, Gb {gb_routes}), want {want}, G "
                             f"and Gb all on the wgmma route (G: forward "
                             f"and remat's recompute)")
    if int(opt["step"]) != TRAIN_STEPS or not all(
            np.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train steps: losses {losses}, grad norms "
                             f"{norms}, AdamW step {int(opt['step'])}")
    ms = statistics.median(step_ms[1:])
    mark("init and train steps")
    dev_ms, kernels, launch_calls = profile_card_only(
        lambda: step(params, opt, batches[0]))
    mark("profiled step")
    by_group = group_kernel_times(kernels)
    # Gb's device time per call: its kernels' share of the step's profile
    # (13 calls; a profiler session around Gb alone, like one around G
    # alone, can see no kernel on the card)
    gb_dev_ms = by_group["kernel Gb"] / n_local
    if gb_dev_ms <= 0:
        raise AssertionError("the train step's profile holds no kernel Gb "
                             "time")
    log(f"gemma2-2b train step ({n_params} parameters, bf16, B={TRAIN_BATCH}"
        f" S={TRAIN_SEQ}, remat, AdamW): {ms:.1f} ms a step (steps "
        f"{[round(x, 1) for x in step_ms]}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak "
        f"{peak_gb:.2f} GB allocated; launches {launches}, Gb by route "
        f"{gb_routes}; losses {losses}, "
        f"grad norms {norms}; device busy {dev_ms / ms:.3f} of a step, "
        f"{launch_calls} launch calls a step; by group {by_group}")
    del opt
    torch.cuda.empty_cache()

    # -- the same first step with G and Gb's plain versions ---------------------
    class PlainWindow(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, window, blk, softcap):
            out = window_attention_plain(q, k, v, window=window, blk=blk,
                                         softcap=softcap)
            ctx.save_for_backward(q, k, v, out)
            ctx.kw = dict(window=window, softcap=softcap)
            return out

        @staticmethod
        def backward(ctx, dout):
            return (*window_attention_bwd_plain(*ctx.saved_tensors, dout,
                                                **ctx.kw), None, None, None)

    kernel_g = M.window_attention

    def plain_g(q, k, v, *, window, blk, softcap):
        return PlainWindow.apply(q, k, v, window, blk, softcap)

    def grads_at(p):
        """(loss, gradient leaves) of the first batch at params ``p``."""
        live = _map(p, lambda t: t.detach().requires_grad_())
        loss, _ = loss_fn(live, batches[0])
        return float(loss.detach()), torch.autograd.grad(
            loss, list(_leaves(live)))

    # the gradients, where the kernels' error enters linearly: each leaf's
    # bf16 gradient with G and Gb, and with their plain versions, against
    # the gradient of an fp32 model of the same weights (plain versions)
    del params
    torch.cuda.empty_cache()
    loss_fn = make_loss_fn(dataclasses.replace(cfg, dtype="float32"))
    M.window_attention = plain_g
    _, grads_32 = grads_at(_map(params0, lambda t: t.float()))
    _, grads_p = grads_at(params0)
    M.window_attention = kernel_g
    _, grads_g = grads_at(params0)
    paths = [path for path, _ in _paired(params0, params0)]
    grad_rel, grad_ratio = {}, {}
    for path, g, p_, w in zip(paths, grads_g, grads_p, grads_32):
        g, p_ = g.float(), p_.float()
        grad_rel[path] = float((g - p_).norm() / p_.norm())
        grad_ratio[path] = float((g - w).norm() / (p_ - w).norm())
    del grads_g, grads_p, grads_32
    worst_grad = max(grad_rel, key=grad_rel.get)
    worst_ratio = max(grad_ratio, key=grad_ratio.get)
    mark("gradients: G, plain, fp32")

    # the step: loss and updated params
    zero_init = {path for path, (a, _) in _paired(params0, params0)
                 if not bool(a.any())}
    opt = init_opt_state(params0, opt_cfg)
    M.window_attention = plain_g
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    metrics_p, params_p1, opt = step(params0, opt, batches[0])
    end.record()
    end.synchronize()
    M.window_attention = kernel_g
    plain_step_ms = start.elapsed_time(end)
    mark("plain-G step")
    if launch_counts():
        raise AssertionError(f"the plain-G step launched {launch_counts()}")
    loss_p, norm_p = float(metrics_p["loss"]), float(metrics_p["grad_norm"])
    loss_rel = abs(losses[0] - loss_p) / abs(loss_p)
    leaf_rel = {}
    for path, (a, b_) in _paired(params_g1, params_p1):
        leaf_rel[path] = float((a.float() - b_.float()).norm()
                               / b_.float().norm())
    # a leaf that starts at zero (the norms' scales) is its first AdamW
    # update, ~lr * sign(g) an element, so the sign of a gradient element
    # near 0 flips it by 2 lr: that measures Adam, not the kernels, and
    # such a leaf is held through its gradient above
    worst_leaf = max(set(leaf_rel) - zero_init, key=leaf_rel.get)
    worst_zero = max(zero_init, key=leaf_rel.get)
    log(f"train step with G and Gb vs their plain versions: loss "
        f"{losses[0]:.6f} vs {loss_p:.6f} (relative {loss_rel:.3e}, tol "
        f"{STEP_REL_TOL}); grad norm {norms[0]:.6f} vs {norm_p:.6f}; "
        f"gradients relative L2, worst leaf {worst_grad} "
        f"{grad_rel[worst_grad]:.3e}; distance to the fp32 model's gradient "
        f"over the plain-G one's, worst leaf {worst_ratio} "
        f"{grad_ratio[worst_ratio]:.4f} (gate {FP32_GATE_FACTOR}); updated "
        f"params relative L2, worst "
        f"leaf {worst_leaf} {leaf_rel[worst_leaf]:.3e} (zero-initialized: "
        f"{worst_zero} {leaf_rel[worst_zero]:.3e}); plain step "
        f"{plain_step_ms:.1f} ms")
    if not (loss_rel <= STEP_REL_TOL and np.isfinite(norm_p)
            and grad_ratio[worst_ratio] <= FP32_GATE_FACTOR
            and leaf_rel[worst_leaf] <= STEP_REL_TOL):
        raise AssertionError(f"train step with G and Gb vs plain: loss "
                             f"relative {loss_rel:.3e}, leaf {worst_leaf} "
                             f"{leaf_rel[worst_leaf]:.3e} (tol "
                             f"{STEP_REL_TOL}); gradient of {worst_ratio} "
                             f"{grad_ratio[worst_ratio]:.4f} x the plain-G "
                             f"gradient's distance to the fp32 model's "
                             f"(gate {FP32_GATE_FACTOR})")
    del params0, params_g1, params_p1, opt, batches
    torch.cuda.empty_cache()

    # -- the smoke-width model memorizes one batch on the card -------------------
    scfg = get_smoke_config(LM_ARCH)
    sparams = M.init_params(scfg, seed, device=dev)
    sopt_cfg = AdamConfig(lr=1e-3, total_steps=64, warmup_steps=2)
    sopt = init_opt_state(sparams, sopt_cfg)
    sstep = make_train_step(scfg, sopt_cfg)
    sbatch = dict(zip(("tokens", "labels"), batch_at(
        DataConfig(vocab_size=scfg.vocab_size, seq_len=32, global_batch=4),
        0, device=dev)))
    reset_launches()
    t0 = time.perf_counter()
    smoke_losses = []
    for _ in range(SMOKE_TRAIN_STEPS):
        m, sparams, sopt = sstep(sparams, sopt, sbatch)
        smoke_losses.append(float(m["loss"]))
    smoke_s = time.perf_counter() - t0
    mark("smoke width")
    smoke_launches = launch_counts()
    s_local = scfg.n_layers // 2
    if smoke_launches != {"window_attention": 2 * s_local * SMOKE_TRAIN_STEPS,
                          "window_attention_bwd": s_local * SMOKE_TRAIN_STEPS}:
        raise AssertionError(f"smoke training launched {smoke_launches}")
    if not smoke_losses[-1] < smoke_losses[0] - SMOKE_TRAIN_DROP:
        raise AssertionError(f"smoke training: loss {smoke_losses[0]:.4f} -> "
                             f"{smoke_losses[-1]:.4f}, want a drop of more "
                             f"than {SMOKE_TRAIN_DROP}")
    log(f"gemma2-2b smoke width ({scfg.dtype}) on one batch: loss "
        f"{smoke_losses[0]:.4f} -> {smoke_losses[-1]:.4f} in "
        f"{SMOKE_TRAIN_STEPS} steps, {smoke_s:.2f} s, launches "
        f"{smoke_launches}")

    res = {
        "case": f"{LM_ARCH} {cfg.dtype}, B={TRAIN_BATCH}, S={TRAIN_SEQ}, "
                f"remat, AdamW (moments {cfg.moment_dtype}), "
                f"{TRAIN_STEPS} steps",
        "n_params": n_params, "init_s": init_s, "launches": launches,
        "routes": routes, "gb_routes": gb_routes, "step_ms": ms,
        "step_ms_all": step_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
        "peak_allocated_gb": peak_gb, "losses": losses, "grad_norms": norms,
        "device_ms": dev_ms, "busy_share": dev_ms / ms,
        "launch_calls_per_step": launch_calls,
        "device_ms_by_group": by_group,
        "top_kernels": [(k_[:72], t) for k_, t in kernels[:8]],
        "plain_step_ms": plain_step_ms, "plain_loss": loss_p,
        "plain_grad_norm": norm_p, "loss_rel": loss_rel,
        "worst_grad": worst_grad, "worst_grad_rel_l2": grad_rel[worst_grad],
        "worst_grad_fp32_ratio_leaf": worst_ratio,
        "worst_grad_fp32_ratio": grad_ratio[worst_ratio],
        "grad_rel_l2": grad_rel, "grad_fp32_ratio": grad_ratio,
        "worst_leaf": worst_leaf, "worst_leaf_rel_l2": leaf_rel[worst_leaf],
        "worst_zero_init_leaf": worst_zero,
        "worst_zero_init_leaf_rel_l2": leaf_rel[worst_zero],
        "kernel_gb_route": gb_route,
        "kernel_gb_ms": gb_ms, "kernel_gb_softcap0_ms": gb0_ms,
        "kernel_gb_simt_ms": gb_simt_ms,
        "kernel_gb_work_bound_ms": gb_work_bound_ms,
        "kernel_gb_work_tflops": gb_work_flops / gb_ms / 1e9,
        "kernel_gb_device_ms": gb_dev_ms,
        "kernel_gb_device_ms_by_kernel": [
            (k_[:60], t / n_local) for k_, t in kernels
            if any(g in k_ for g in dict(KERNEL_GROUPS)["kernel Gb"])],
        "kernel_gb_plain_ms": gb_plain_ms,
        "kernel_gb_bound_ms": gb_bound_ms, "kernel_gb_bound_by": gb_bound_by,
        "kernel_gb_gflop": gb_flops / 1e9, "kernel_gb_mbytes": gb_bytes / 1e6,
        "kernel_gb_tflops": gb_flops / gb_ms / 1e9,
        "kernel_gb_rel_l2": gb_errs, "kernel_gb_max_abs_err": gb_err,
        "kernel_gb_fp32_case": GB_FP32_CASE, "kernel_gb_fp32_errs": gb32_errs,
        "kernel_gb_fp32_max_abs_err": gb32_err, "kernel_gb_fp32_ms": gb32_ms,
        "sdpa_bwd_ms": sdpa_bwd_ms,
        "smoke_losses": [smoke_losses[0], smoke_losses[-1]],
        "smoke_s": smoke_s, "smoke_launches": smoke_launches,
        "shapes": f"q, out, dout ({b}, {h}, {s}, {d}), k, v ({b}, {kh}, {s},"
                  f" {d}) bf16, window {window}, softcap {cfg.attn_softcap}",
    }
    res["phase_s"] = time.perf_counter() - t_phase
    res["phase_split_s"] = split
    log(f"training phase: {res['phase_s']:.1f} s, by part {split}")
    log("gemma2-2b training: " + json.dumps(res))
    return res


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module (its ``main(argv)``)."""
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example(name: str, argv, out: dict, launches: dict) -> None:
    """What example ``name`` returned, and the kernels it launched."""
    def need(cond, what):
        if not cond:
            raise AssertionError(f"example {name} {' '.join(argv)}: {what}"
                                 f"; returned {out}, launched {launches}")

    need(out["device"].startswith("cuda"), "did not run on the card")
    if name == "quickstart":
        need(max(out["rel_err"].values()) <= 3e-4 and not out["replanned"],
             "a path is off the oracle, or replanned")
        need({"prefix_sum", "xpencil_forces", "allin_forces",
              "cell_sfc_forces"} <= set(launches), "a cuda path's kernel "
             "was not launched")
    elif name == "md_lennard_jones":
        need(out["finite"] and out["drift"] < MD_DRIFT_TOL,
             f"energy drift {out['drift']:.3e} >= {MD_DRIFT_TOL}")
        need("xpencil_forces" in launches, "kernel B was not launched")
    elif name == "sph_demo":
        need(out["finite"] and 0.0 < out["rho_mean"] <= out["rho_max"],
             "densities not finite and positive")
        need(launches.get("xpencil_forces", 0) >= 2 * out["steps"],
             "kernel B not launched twice a step")
    elif name == "distributed_md":
        need(out["n_shards"] == 4 and out["compact_bit_equal"]
             and out["grown_shard_cap"] > 8
             and out["max_abs_err"] <= 3e-4 * max(out["force_scale"], 1.0),
             "halo shards off the one-device plan")
        need({"xpencil_forces", "xpencil_sparse_forces"} <= set(launches),
             "kernels B and C were not launched")
    elif name == "serve_engine":
        need(out["steady_state_recompiles"] == 0, "executors built in the "
             "steady state")
        need(out["ok"] == out["requests"], "a request was not served")
    elif name == "autotune_batch":
        need(out["cached_timing_runs"] == 0 and out["timed"] > 0,
             "the cached plan ran timing runs, or nothing was timed")
        need((out["batch_dispatches"], out["loop_dispatches"]) == (1, 8),
             "the batch took more than one dispatch")
    elif name == "lm_serve":
        from repro_torch.configs import get_smoke_config
        need(out["in_vocab"] and out["shape"] == (4, 24), "tokens out of "
             "range or shape")
        scfg = get_smoke_config(argv[1])
        # G once a local layer of the prefill (gemma2); A once a MoE layer
        # of the prefill and of each of the 23 decode steps
        want = ({"window_attention": 2} if scfg.local_global else
                {"prefix_sum": 24 * scfg.n_layers} if scfg.n_experts else {})
        need(launches == want, f"launched other than {want}")
    elif name == "lm_train":
        need(out["loss_falls"] and sorted(out["losses"])[-1] == 199,
             "the smoke loss did not fall over 200 steps")


def examples_phase(reset_launches, launch_counts):
    """The eight ``examples/torch_*.py`` called in process on the card,
    each with the launch counts set to 0 just before and read just after;
    the autotune cache and the checkpoints in fresh ``build/``
    directories, removed after. -> {"phase_s", "runs": {run: record},
    "launches": {kernel: launches over all runs}}"""
    import os
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = pathlib.Path(tempfile.mkdtemp(prefix="examples_",
                                            dir=ROOT / "build"))
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(scratch / "autotune")
    runs = {}
    for name, argv in EXAMPLE_RUNS:
        argv = list(argv)
        if name == "lm_train":
            argv += ["--ckpt-dir", str(scratch / f"ckpt_{argv[1]}")]
        mod = load_example(name)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        check_example(name, argv, out, launches)
        label = " ".join([name, *argv[:2]]) if name.startswith("lm_") \
            else name
        runs[label] = dict(seconds=seconds, launches=launches,
                           returned={k: v for k, v in out.items()
                                     if k != "rel_err"})
        log(f"example {label}: {seconds:.2f} s, launches {launches}")
    shutil.rmtree(scratch)
    os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE")
    totals = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            totals[k] = totals.get(k, 0) + v
    phase_s = time.perf_counter() - t_phase
    log("examples: " + json.dumps(runs))
    log(f"examples phase: {phase_s:.1f} s; by run "
        f"{ {k: round(v['seconds'], 2) for k, v in runs.items()} }")
    return {"phase_s": phase_s, "runs": runs, "launches": totals}


def upcast_in_place(tree) -> None:
    """Each leaf of ``tree`` replaced by its fp32 copy, one at a time, so
    each bf16 leaf is freed before the next is copied."""
    for k, v in tree.items():
        if isinstance(v, dict):
            upcast_in_place(v)
        else:
            tree[k] = v.float()


def dense_serving(arch: str, seed: int, dev, reset_launches, launch_counts):
    """One dense arch at full width and depth: ``generate`` counted (no
    kernel: every layer is global), prefill and decode timed and profiled,
    the decode cache against a no-cache forward (check a), the bf16
    prefill against a prefill of the weights upcast to fp32 (check b)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.serving import generate

    cfg = get_config(arch)
    if cfg.local_global:
        raise AssertionError(f"{arch} has local layers")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed)
    b, s, new = DENSE_BATCH, DENSE_PROMPT, DENSE_NEW
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                             device=dev)
    max_len = s + new
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts to 0, generate, counts read ---------------------
    reset_launches()
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompt, new, max_len=max_len)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches:
        raise AssertionError(f"{arch}: generate launched {launches}; every "
                             f"layer is global, kernel G must not run")
    if tuple(tokens.shape) != (b, new) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: generated tokens out of range")
    if tuple(logits.shape) != (b, s, cfg.vocab_size) or \
            not bool(logits.isfinite().all()):
        raise AssertionError(f"{arch}: prefill logits wrong shape or "
                             f"non-finite")
    if not torch.equal(tokens[:, 0], logits[:, -1].argmax(-1)):
        raise AssertionError(f"{arch}: first token is not the prefill's "
                             f"greedy token")
    del logits

    # -- prefill and decode timed; the decode steps' logits kept -------------------
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits_b, cache = M.prefill(cfg, params, prompt, max_len=max_len)
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(end)
    tok = logits_b[:, -1:].argmax(-1)
    fed, step_logits, dec_ms = [tok], [], []
    for idx in range(s, max_len - 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lg, cache = M.decode_step(cfg, params, cache, tok, idx)
        end.record()
        end.synchronize()
        dec_ms.append(start.elapsed_time(end))
        if len(step_logits) < DENSE_CACHE_STEPS:
            step_logits.append(lg[:, 0])
        tok = lg.argmax(-1)
        fed.append(tok)
    same_tokens = torch.equal(torch.cat(fed, dim=1), tokens)
    decode_ms = statistics.median(dec_ms)
    decode_dev_ms, decode_kernels, decode_calls = profile_card_only(
        lambda: M.decode_step(cfg, params, cache, tok, max_len - 1))
    del cache
    prefill_dev_ms, prefill_kernels, prefill_calls = profile_card_only(
        lambda: M.prefill(cfg, params, prompt, max_len=max_len))

    # -- (a) the decode cache against a no-cache forward ---------------------------
    n = DENSE_CACHE_STEPS
    seq = torch.cat([prompt, *fed[:n]], dim=1)
    reset_launches()
    full, _ = M.forward(cfg, params, seq, remat=False)
    if launch_counts():
        raise AssertionError(f"{arch}: forward launched {launch_counts()}")
    cache_rel, cache_worst = logits_diff(torch.stack(step_logits, 1),
                                         full[:, s:s + n])
    del full, step_logits
    if not cache_rel <= CACHE_REL_TOL:
        raise AssertionError(f"{arch}: {n} decode steps vs a no-cache "
                             f"forward, relative L2 {cache_rel:.3e} (tol "
                             f"{CACHE_REL_TOL})")

    # -- (b) the bf16 prefill against the same weights in fp32 ---------------------
    logits_host = logits_b.cpu()
    del logits_b
    upcast_in_place(params)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    reset_launches()
    logits_32, cache = M.prefill(cfg32, params, prompt, max_len=s)
    torch.cuda.synchronize()
    fp32_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del cache, params
    if launch_counts():
        raise AssertionError(f"{arch}: fp32 prefill launched "
                             f"{launch_counts()}")
    fp32_rel, fp32_worst = logits_diff(logits_host, logits_32)
    del logits_32, logits_host
    torch.cuda.empty_cache()
    if not fp32_rel <= DENSE_FP32_REL_TOL:
        raise AssertionError(f"{arch}: bf16 prefill vs fp32, relative L2 "
                             f"{fp32_rel:.3e} (tol {DENSE_FP32_REL_TOL})")
    return {
        "case": f"{arch} {cfg.dtype}, B={b}, prompt {s}, {new} new tokens",
        "n_params": n_params, "init_s": init_s, "generate_s": generate_s,
        "launches": launches, "peak_allocated_gb": peak_gb,
        "fp32_prefill_peak_allocated_gb": fp32_peak_gb,
        "prefill_ms": prefill_ms, "prefill_device_ms": prefill_dev_ms,
        "prefill_busy_share": prefill_dev_ms / prefill_ms,
        "prefill_launch_calls": prefill_calls,
        "prefill_tokens_per_s": b * s / prefill_ms * 1e3,
        "prefill_device_ms_by_group": group_kernel_times(prefill_kernels),
        "prefill_top_kernels": [(k[:72], ms) for k, ms in
                                prefill_kernels[:6]],
        "decode_ms_per_token": decode_ms, "decode_ms_all": dec_ms,
        "decode_device_ms": decode_dev_ms,
        "decode_busy_share": decode_dev_ms / decode_ms,
        "decode_launch_calls_per_token": decode_calls,
        "decode_device_ms_by_group": group_kernel_times(decode_kernels),
        "decode_tokens_equal_generate": same_tokens,
        "cache_vs_forward_rel_l2": cache_rel,
        "cache_vs_forward_max_abs": cache_worst,
        "bf16_vs_fp32_rel_l2": fp32_rel, "bf16_vs_fp32_max_abs": fp32_worst,
    }


def dense_training(seed: int, dev, reset_launches, launch_counts,
                   arch: str = DENSE_TRAIN_ARCH,
                   n_steps: int = DENSE_TRAIN_STEPS):
    """``arch`` (DENSE_TRAIN_ARCH, or SSM_TRAIN_ARCH) at full width and
    depth: ``n_steps`` ``make_train_step`` steps of DENSE_BATCH x
    DENSE_PROMPT tokens (bf16, remat, AdamW), each loss against the
    fp32-upcast model's loss on the same batch at the same params; no kernel
    launched (no local layer, no expert)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import model as M
    from repro_torch.optim import AdamConfig, init_opt_state
    from repro_torch.train import make_loss_fn, make_train_step

    cfg = get_config(arch)
    params = M.init_params(cfg, seed, device=dev)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=DENSE_PROMPT,
                      global_batch=DENSE_BATCH)
    batches = [dict(zip(("tokens", "labels"), batch_at(data, i, device=dev)))
               for i in range(n_steps)]
    opt_cfg = AdamConfig(total_steps=n_steps, warmup_steps=1,
                         moment_dtype=cfg.moment_dtype)
    step = make_train_step(cfg, opt_cfg)
    opt = init_opt_state(params, opt_cfg)
    loss32_fn = make_loss_fn(dataclasses.replace(cfg, dtype="float32"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, losses32, rels = [], [], [], []
    for i in range(n_steps):
        with torch.no_grad():
            l32, _ = loss32_fn(_map(params, lambda t: t.float()), batches[i])
            losses32.append(float(l32))
        del l32
        reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics, params, opt = step(params, opt, batches[i])
        end.record()
        end.synchronize()
        if launch_counts():
            raise AssertionError(f"{arch} train step launched "
                                 f"{launch_counts()}")
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        rels.append(abs(losses[-1] - losses32[-1]) / abs(losses32[-1]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or max(rels) > STEP_REL_TOL:
        raise AssertionError(f"{arch} train steps: losses "
                             f"{losses} vs fp32 {losses32}, relative "
                             f"{rels} (tol {STEP_REL_TOL})")
    ms = statistics.median(step_ms[1:])
    del params, opt, batches
    torch.cuda.empty_cache()
    return {"case": f"{arch} {cfg.dtype}, B={DENSE_BATCH}, "
                    f"S={DENSE_PROMPT}, remat, AdamW, {n_steps} "
                    f"steps",
            "step_ms": ms, "step_ms_all": step_ms,
            "tokens_per_s": DENSE_BATCH * DENSE_PROMPT / ms * 1e3,
            "peak_allocated_gb": peak_gb, "losses": losses,
            "fp32_losses": losses32, "loss_rel_to_fp32": rels}


def dense_lm_phase(seed: int, dev, reset_launches, launch_counts):
    """The three dense archs served at full width and depth, then
    DENSE_TRAIN_ARCH's train steps. -> {arch: record, "train": record}"""
    t_phase = time.perf_counter()
    out = {}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        out[arch] = dense_serving(arch, seed, dev, reset_launches,
                                  launch_counts)
        out[arch]["seconds"] = time.perf_counter() - t0
        log(f"{arch}: " + json.dumps(out[arch]))
    t0 = time.perf_counter()
    out["train"] = dense_training(seed, dev, reset_launches, launch_counts)
    out["train"]["seconds"] = time.perf_counter() - t0
    log(f"{DENSE_TRAIN_ARCH} training: " + json.dumps(out["train"]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"dense LM phase: {out['phase_s']:.1f} s")
    return out


def moe_block_input(cfg, params, tokens, dtype):
    """Layer 0's MoE block input (embedding, layer 0's attention and
    residual, norm2) with the weights in ``dtype``: in the model's dtype
    the same ops as the model's, in fp32 the upcast weights'."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import apply_norm

    lp = M._index(params["layers"], 0)
    conv = lambda tree: {k: v.to(dtype) for k, v in tree.items()}  # noqa: E731
    x = params["embed"][tokens].to(dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cfg_d = dataclasses.replace(cfg, dtype=str(dtype).split(".")[1])
    h, _, _ = M._self_attention(cfg_d, conv(lp["attn"]),
                                apply_norm(x, conv(lp["norm1"]), cfg.norm),
                                positions, False)
    return apply_norm(x + h, conv(lp["norm2"]), cfg.norm)


def moe_reference_block(x32, p, top_k: int, act):
    """One MoE block in fp32 without a capacity limit, the plain
    reference of check (b): the fp32 router, the top k of a stable
    descending sort (the lower expert first on a tie, as ``lax.top_k``),
    the gates renormalised, each expert's weights upcast in turn (never the
    whole expert tensor). x32 (T, d) -> (out (T, d), experts (T, k))."""
    probs = torch.softmax(x32 @ p["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(x32)
    for e in range(p["router"].shape[-1]):
        tok, j = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            rows = x32[tok]
            h = act(rows @ p["w_gate"][e].float()) * \
                (rows @ p["w_up"][e].float())
            out.index_add_(0, tok, (h @ p["w_down"][e].float())
                           * vals[tok, j, None])
    return out, idx


def moe_serving(arch: str, n_layers: int, seed: int, dev, reset_launches,
                launch_counts):
    """One MoE arch at full width, ``n_layers`` of its layers (bf16):
    ``generate`` counted (kernel A once a MoE layer in the prefill and in
    every decode step), prefill and decode timed and profiled, the
    prefill's expert offsets from kernel A against ``paper_prefix_sum``'s
    and its dropped assignments a layer, check (a) the decode cache against
    a no-cache forward where nothing drops, check (b) layer 0's MoE block
    in bf16 against an fp32 reference."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.prefix import exclusive_prefix_sum, paper_prefix_sum
    from repro_torch.kernels.prefix_sum import prefix_sum
    from repro_torch.models import model as M
    from repro_torch.models.layers import _act
    from repro_torch.models.moe import moe_capacity, moe_mlp
    from repro_torch.models.serving import generate

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    weight_gb = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) / 1e9
    rng = np.random.default_rng(seed)
    b, s, new = MOE_BATCH, MOE_PROMPT, MOE_NEW
    # a decode step reads every weight but the embedding table (each
    # expert's capacity buffer runs, JAX's design) and the bf16 KV cache
    decode_bytes = weight_gb * 1e9 - params["embed"].numel() * 2 + \
        2 * n_layers * b * cfg.n_kv_heads * (s + new) * cfg.head_dim * 2
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                             device=dev)
    max_len = s + new
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts to 0, generate, counts read ---------------------
    reset_launches()
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompt, new, max_len=max_len)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"prefix_sum": n_layers * new}:
        raise AssertionError(f"{arch}: generate launched {launches}, want "
                             f"kernel A {n_layers} x {new} times (a MoE "
                             f"layer of the prefill and of {new - 1} decode "
                             f"steps)")
    if tuple(tokens.shape) != (b, new) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: generated tokens out of range")
    if tuple(logits.shape) != (b, s, cfg.vocab_size) or \
            not bool(logits.isfinite().all()):
        raise AssertionError(f"{arch}: prefill logits wrong shape or "
                             f"non-finite")
    if not torch.equal(tokens[:, 0], logits[:, -1].argmax(-1)):
        raise AssertionError(f"{arch}: first token is not the prefill's "
                             f"greedy token")
    del logits

    # -- prefill timed, its routing kept; decode steps timed -----------------------
    moe_mlp.log = []
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits_b, cache = M.prefill(cfg, params, prompt, max_len=max_len)
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(end)
    prefill_launches = launch_counts()
    routing, moe_mlp.log = moe_mlp.log, None
    del logits_b
    if prefill_launches != {"prefix_sum": n_layers} or \
            len(routing) != n_layers:
        raise AssertionError(f"{arch}: a prefill launched "
                             f"{prefill_launches} over {len(routing)} MoE "
                             f"layers, want kernel A once a layer")
    cap = moe_capacity(b * s, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    for i, r in enumerate(routing):
        plain = exclusive_prefix_sum(r.counts, scan=paper_prefix_sum)
        if not torch.equal(r.offsets, plain) or r.cap != cap or \
                int(r.counts.sum()) != b * s * cfg.top_k:
            raise AssertionError(f"{arch} layer {i}: kernel A's expert "
                                 f"offsets differ from paper_prefix_sum's")
    dropped = [int((~r.keep).sum()) for r in routing]
    max_load = [int(r.counts.max()) for r in routing]
    counts0 = routing[0].counts
    del routing
    scan_ms = cuda_ms(lambda: prefix_sum(counts0), 20)
    scan_plain_ms = cuda_ms(lambda: paper_prefix_sum(counts0), 20)
    cumsum_ms = cuda_ms(lambda: torch.cumsum(counts0, 0), 20)
    tok = tokens[:, :1]
    dec_ms = []
    for idx in range(s, max_len - 1):
        reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lg, cache = M.decode_step(cfg, params, cache, tok, idx)
        end.record()
        end.synchronize()
        dec_ms.append(start.elapsed_time(end))
        if launch_counts() != {"prefix_sum": n_layers}:
            raise AssertionError(f"{arch}: a decode step launched "
                                 f"{launch_counts()}, want kernel A once a "
                                 f"layer")
        tok = lg.argmax(-1)
    decode_ms = statistics.median(dec_ms)
    decode_dev_ms, decode_kernels, decode_calls = profile_card_only(
        lambda: M.decode_step(cfg, params, cache, tok, max_len - 1))
    del cache
    prefill_dev_ms, prefill_kernels, prefill_calls = profile_card_only(
        lambda: M.prefill(cfg, params, prompt, max_len=max_len))

    # -- (a) the decode cache against a no-cache forward, nothing dropped ------
    cfg_a = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.top_k)
    pa, n = MOE_CACHE_PROMPT, DENSE_CACHE_STEPS
    moe_mlp.log = []
    lg, cache = M.prefill(cfg_a, params, prompt[:, :pa], max_len=pa + n)
    tok = lg[:, -1:].argmax(-1)
    fed, step_logits = [tok], []
    for idx in range(pa, pa + n):
        lg, cache = M.decode_step(cfg_a, params, cache, tok, idx)
        step_logits.append(lg[:, 0])
        tok = lg.argmax(-1)
        fed.append(tok)
    seq = torch.cat([prompt[:, :pa], *fed[:n]], dim=1)
    full_logits, _ = M.forward(cfg_a, params, seq, remat=False)
    dropped_a = sum(int((~r.keep).sum()) for r in moe_mlp.log)
    moe_mlp.log = None
    del cache
    cache_rel, cache_worst = logits_diff(torch.stack(step_logits, 1),
                                         full_logits[:, pa:pa + n])
    del full_logits, step_logits
    if dropped_a or not cache_rel <= CACHE_REL_TOL:
        raise AssertionError(f"{arch}: {n} decode steps vs a no-cache "
                             f"forward (prompt {pa}, capacity factor "
                             f"{cfg_a.capacity_factor}): {dropped_a} "
                             f"assignments dropped, relative L2 "
                             f"{cache_rel:.3e} (tol {CACHE_REL_TOL})")

    # -- (b) layer 0's MoE block, bf16 against an fp32 reference ----------------
    lp = M._index(params["layers"], 0)
    xb = moe_block_input(cfg, params, prompt, torch.bfloat16)
    x32 = moe_block_input(cfg, params, prompt, torch.float32)
    moe_mlp.log = []
    out_b, _ = moe_mlp(xb, lp["moe"], top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor, act=cfg.act)
    [rb], moe_mlp.log = moe_mlp.log, None
    out_32, idx32 = moe_reference_block(x32.reshape(b * s, -1), lp["moe"],
                                        cfg.top_k,
                                        lambda t: _act(t, cfg.act))
    mine = rb.gate_idx.sort(-1).values
    ref = idx32.sort(-1).values
    flipped = 1.0 - float((mine[:, :, None] == ref[:, None, :]).any(-1)
                          .float().mean())
    kept = rb.keep[rb.unsort].view(b * s, cfg.top_k).all(-1)
    same = (mine == ref).all(-1) & kept
    got = out_b.reshape(b * s, -1)[same].float()
    want = out_32[same]
    block_rel = float((got - want).norm() / want.norm())
    block_worst = float((got - want).abs().max())
    del xb, x32, out_b, out_32, got, want
    if not block_rel <= BLOCK_REL_TOL:
        raise AssertionError(f"{arch}: layer 0's MoE block in bf16 vs fp32 "
                             f"on {int(same.sum())} tokens, relative L2 "
                             f"{block_rel:.3e} (tol {BLOCK_REL_TOL})")
    del params, lp
    torch.cuda.empty_cache()
    return {
        "case": f"{arch} {cfg.dtype}, {n_layers} of {full.n_layers} layers, "
                f"B={b}, prompt {s}, {new} new tokens",
        "reduced": {"n_layers": [full.n_layers, n_layers]},
        "n_params": n_params, "weight_gb": weight_gb, "init_s": init_s,
        "generate_s": generate_s, "launches": launches,
        "peak_allocated_gb": peak_gb, "capacity": cap,
        "dropped_assignments_by_layer": dropped,
        "assignments_per_layer": b * s * cfg.top_k,
        "max_expert_load_by_layer": max_load,
        "kernel_a_ms_at_experts": scan_ms,
        "kernel_a_plain_ms_at_experts": scan_plain_ms,
        "cumsum_ms_at_experts": cumsum_ms,
        "prefill_ms": prefill_ms, "prefill_device_ms": prefill_dev_ms,
        "prefill_busy_share": prefill_dev_ms / prefill_ms,
        "prefill_launch_calls": prefill_calls,
        "prefill_tokens_per_s": b * s / prefill_ms * 1e3,
        "prefill_device_ms_by_group": group_kernel_times(prefill_kernels),
        "prefill_top_kernels": [(k[:72], ms) for k, ms in
                                prefill_kernels[:6]],
        "decode_ms_per_token": decode_ms, "decode_ms_all": dec_ms,
        "decode_device_ms": decode_dev_ms,
        "decode_busy_share": decode_dev_ms / decode_ms,
        "decode_launch_calls_per_token": decode_calls,
        "decode_device_ms_by_group": group_kernel_times(decode_kernels),
        "decode_bytes": decode_bytes,
        "decode_bound_ms": decode_bytes / HBM_BYTES_PER_S * 1e3,
        "cache_check": {"prompt": pa, "capacity_factor":
                        cfg_a.capacity_factor, "dropped": dropped_a},
        "cache_vs_forward_rel_l2": cache_rel,
        "cache_vs_forward_max_abs": cache_worst,
        "block_bf16_vs_fp32_rel_l2": block_rel,
        "block_bf16_vs_fp32_max_abs": block_worst,
        "block_tokens_compared": int(same.sum()),
        "block_assignments_flipped_share": flipped,
    }


def ssm_replay(cfg, params, prompt, tokens, n: int):
    """The prompt replayed through decode steps from a zeroed cache, then
    ``n`` decode steps teacher-forced on ``tokens``, each step timed by
    events. -> (logits at the prompt's last position and the n steps (B,
    n + 1, V), step ms, the cache)."""
    from repro_torch.models import model as M

    b, s = prompt.shape
    cache = M.init_cache(cfg, b, s + n + 1, device=prompt.device)
    dec_ms, kept = [], []
    for t in range(s + n):
        tok = prompt[:, t:t + 1] if t < s else tokens[:, t - s:t - s + 1]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lg, cache = M.decode_step(cfg, params, cache, tok, t)
        end.record()
        end.synchronize()
        dec_ms.append(start.elapsed_time(end))
        if t >= s - 1:
            kept.append(lg[:, 0])
    return torch.stack(kept, 1), dec_ms, cache


def ssm_blocks(cfg, lp, sp, x, positions):
    """The outputs of one layer's Mamba-2 mixer (``lp``) and, where the
    shared block ``sp`` is given, of its attention and MLP, on the hidden
    state ``x``, in the weights' dtype."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import apply_norm, mlp
    from repro_torch.models.ssm import mamba2_block

    out = {"mamba": mamba2_block(
        apply_norm(x, lp["norm1"], cfg.norm), lp["mamba"],
        d_inner=cfg.d_inner, state=cfg.ssm_state, n_heads=cfg.ssm_heads,
        headdim=cfg.ssm_headdim, chunk=cfg.ssm_chunk)}
    if sp is not None:
        out["shared attention"], _, _ = M._self_attention(
            cfg, sp["attn"], apply_norm(x, sp["norm1"], cfg.norm), positions,
            False)
        x2 = x + out["shared attention"]
        out["shared MLP"] = mlp(apply_norm(x2, sp["norm2"], cfg.norm),
                                sp["mlp"], cfg.act)
    return out


def ssm_serving(arch: str, seed: int, dev, reset_launches, launch_counts):
    """One SSM or hybrid arch at full width and depth (bf16): ``generate``
    on SSM_REPLAY_PROMPT tokens counted (no kernel on this path), the
    prefill of MOE_PROMPT tokens timed and profiled, the replay's decode
    steps timed; check (a) in fp32, the replay's last logits and
    SSM_CACHE_STEPS decode steps against a no-cache forward; check (b) the
    middle layer's Mamba-2 mixer (and zamba2's shared block) in bf16
    against fp32 on the bf16 model's hidden state. The whole model's bf16
    distances (replay vs forward, prefill vs fp32) are reported."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.serving import generate

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed)
    b, s_long, s, new = MOE_BATCH, MOE_PROMPT, SSM_REPLAY_PROMPT, MOE_NEW
    prompt_long = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                               (b, s_long)), device=dev)
    prompt = prompt_long[:, :s]
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts to 0, generate (replay), counts read -----------
    reset_launches()
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompt, new)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches:
        raise AssertionError(f"{arch}: generate launched {launches}; the "
                             f"SSM path runs no kernel")
    if tuple(tokens.shape) != (b, new) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab_size or \
            tuple(logits.shape) != (b, s, cfg.vocab_size) or \
            not bool(logits.isfinite().all()):
        raise AssertionError(f"{arch}: generated tokens or prefill logits "
                             f"out of range, wrong shape or non-finite")
    del logits

    # -- the long prefill timed and profiled ------------------------------------
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits_b, _ = M.prefill(cfg, params, prompt_long)
    end.record()
    end.synchronize()
    prefill_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    logits_host = logits_b.cpu()
    del logits_b
    prefill_dev_ms, prefill_kernels, prefill_calls = profile_card_only(
        lambda: M.prefill(cfg, params, prompt_long))

    # -- the replay, each decode step timed; bf16 against a forward ------------
    n = SSM_CACHE_STEPS
    replay_b, dec_ms, cache = ssm_replay(cfg, params, prompt, tokens, n)
    same_first = torch.equal(replay_b[:, 0].argmax(-1), tokens[:, 0])
    decode_ms = statistics.median(dec_ms)
    decode_dev_ms, decode_kernels, decode_calls = profile_card_only(
        lambda: M.decode_step(cfg, params, cache, tokens[:, n:n + 1], s + n))
    del cache
    seq = torch.cat([prompt, tokens[:, :n]], dim=1)
    full_b, _ = M.forward(cfg, params, seq, remat=False)
    bf16_cache_rel, _ = logits_diff(replay_b, full_b[:, s - 1:s + n])
    del full_b, replay_b

    # -- (b) the middle layer's blocks, bf16 against fp32 ----------------------
    mid = cfg.n_layers // 2
    cfg_mid = dataclasses.replace(cfg, n_layers=mid)
    positions = torch.arange(s_long, device=dev)
    x = M.embed_tokens(params["embed"], prompt_long)
    x = M._run_mamba_stack(cfg_mid, {
        "layers": _map(params["layers"], lambda t: t[:mid]),
        "shared_attn": params.get("shared_attn")}, x, positions)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lp, sp = M._index(params["layers"], mid), params.get("shared_attn")
    got = ssm_blocks(cfg, lp, sp, x, positions)
    want = ssm_blocks(cfg32, _map(lp, lambda t: t.float()),
                      sp and _map(sp, lambda t: t.float()), x.float(),
                      positions)
    block_rel = {k: float((got[k].float() - want[k]).norm()
                          / want[k].norm()) for k in got}
    del x, got, want, lp, sp
    if not max(block_rel.values()) <= BLOCK_REL_TOL:
        raise AssertionError(f"{arch}: layer {mid}'s blocks in bf16 vs "
                             f"fp32, relative L2 {block_rel} (tol "
                             f"{BLOCK_REL_TOL})")

    # -- the whole model upcast: the prefill's distance; (a) in fp32 -----------
    upcast_in_place(params)
    torch.cuda.empty_cache()
    logits_32, _ = M.prefill(cfg32, params, prompt_long)
    fp32_rel, fp32_worst = logits_diff(logits_host, logits_32)
    del logits_32, logits_host
    replay_32, _, cache = ssm_replay(cfg32, params, prompt, tokens, n)
    del cache
    full_32, _ = M.forward(cfg32, params, seq, remat=False)
    cache_rel, cache_worst = logits_diff(replay_32, full_32[:, s - 1:s + n])
    del full_32, replay_32, params
    torch.cuda.empty_cache()
    if not same_first or not cache_rel <= SSM_FP32_CACHE_REL_TOL:
        raise AssertionError(f"{arch}: in fp32, the replay's last logits "
                             f"and {n} decode steps vs a no-cache forward, "
                             f"relative L2 {cache_rel:.3e} (tol "
                             f"{SSM_FP32_CACHE_REL_TOL}); the bf16 replay's "
                             f"first token as generate's: {same_first}")
    return {
        "case": f"{arch} {cfg.dtype}, B={b}, prefill {s_long}; generate "
                f"on {s} + {new} (the prompt replayed)",
        "n_params": n_params, "init_s": init_s, "generate_s": generate_s,
        "launches": launches, "peak_allocated_gb": peak_gb,
        "prefill_ms": prefill_ms, "prefill_device_ms": prefill_dev_ms,
        "prefill_busy_share": prefill_dev_ms / prefill_ms,
        "prefill_launch_calls": prefill_calls,
        "prefill_tokens_per_s": b * s_long / prefill_ms * 1e3,
        "prefill_device_ms_by_group": group_kernel_times(prefill_kernels),
        "prefill_top_kernels": [(k[:72], ms) for k, ms in
                                prefill_kernels[:6]],
        "decode_ms_per_token": decode_ms,
        "decode_device_ms": decode_dev_ms,
        "decode_busy_share": decode_dev_ms / decode_ms,
        "decode_launch_calls_per_token": decode_calls,
        "decode_device_ms_by_group": group_kernel_times(decode_kernels),
        "replay_first_token_equal_generate": same_first,
        "fp32_cache_vs_forward_rel_l2": cache_rel,
        "fp32_cache_vs_forward_max_abs": cache_worst,
        "bf16_cache_vs_forward_rel_l2": bf16_cache_rel,
        "blocks_bf16_vs_fp32_rel_l2": block_rel,
        "bf16_vs_fp32_rel_l2": fp32_rel, "bf16_vs_fp32_max_abs": fp32_worst,
    }


def moe_smoke_training(seed: int, dev, reset_launches, launch_counts):
    """MOE_TRAIN_ARCH's smoke config memorizing one batch on the card in
    SMOKE_TRAIN_STEPS steps: the MoE backward through the kernel-A
    dispatch, kernel A launched twice a MoE layer a step (the forward and
    remat's recomputation)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import model as M
    from repro_torch.optim import AdamConfig, init_opt_state
    from repro_torch.train import make_train_step

    scfg = get_smoke_config(MOE_TRAIN_ARCH)
    sparams = M.init_params(scfg, seed, device=dev)
    sopt_cfg = AdamConfig(lr=1e-3, total_steps=64, warmup_steps=2)
    sopt = init_opt_state(sparams, sopt_cfg)
    sstep = make_train_step(scfg, sopt_cfg)
    sbatch = dict(zip(("tokens", "labels"), batch_at(
        DataConfig(vocab_size=scfg.vocab_size, seq_len=32, global_batch=4),
        0, device=dev)))
    reset_launches()
    t0 = time.perf_counter()
    losses, auxs = [], []
    for _ in range(SMOKE_TRAIN_STEPS):
        m, sparams, sopt = sstep(sparams, sopt, sbatch)
        losses.append(float(m["loss"]))
        auxs.append(float(m["aux"]))
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    want = {"prefix_sum": 2 * scfg.n_layers * SMOKE_TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"{MOE_TRAIN_ARCH} smoke training launched "
                             f"{launches}, want {want}")
    if not losses[-1] < losses[0] - SMOKE_TRAIN_DROP:
        raise AssertionError(f"{MOE_TRAIN_ARCH} smoke training: loss "
                             f"{losses[0]:.4f} -> {losses[-1]:.4f}, want a "
                             f"drop of more than {SMOKE_TRAIN_DROP}")
    return {"case": f"{scfg.name} ({scfg.dtype}) on one batch of 4 x 32, "
                    f"{SMOKE_TRAIN_STEPS} steps",
            "seconds": seconds, "launches": launches,
            "losses": losses[::10] + losses[-1:],
            "aux": auxs[::10] + auxs[-1:]}


def moe_ssm_lm_phase(seed: int, dev, reset_launches, launch_counts):
    """The MoE archs at full width and reduced depth, the SSM and hybrid
    archs at full width and depth, mamba2-130m's train steps and the MoE
    smoke config's training. -> {arch: record, "train", "moe_train",
    "launches": {kernel: main-path launches}}"""
    t_phase = time.perf_counter()
    out = {}
    for arch, n_layers in MOE_ARCHS:
        t0 = time.perf_counter()
        out[arch] = moe_serving(arch, n_layers, seed, dev, reset_launches,
                                launch_counts)
        out[arch]["seconds"] = time.perf_counter() - t0
        log(f"{arch}: " + json.dumps(out[arch]))
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        out[arch] = ssm_serving(arch, seed, dev, reset_launches,
                                launch_counts)
        out[arch]["seconds"] = time.perf_counter() - t0
        log(f"{arch}: " + json.dumps(out[arch]))
    t0 = time.perf_counter()
    out["train"] = dense_training(seed, dev, reset_launches, launch_counts,
                                  arch=SSM_TRAIN_ARCH,
                                  n_steps=SSM_TRAIN_STEPS)
    out["train"]["seconds"] = time.perf_counter() - t0
    log(f"{SSM_TRAIN_ARCH} training: " + json.dumps(out["train"]))
    out["moe_train"] = moe_smoke_training(seed, dev, reset_launches,
                                          launch_counts)
    log(f"{MOE_TRAIN_ARCH} smoke training: " + json.dumps(out["moe_train"]))
    launches = {}
    for rec in [out[a] for a, _ in MOE_ARCHS] + [out["moe_train"]]:
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"MoE/SSM LM phase: {out['phase_s']:.1f} s")
    return out


def precision_flags():
    """The three precision flags the card checks set, as they stand."""
    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "matmul.allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def set_precision_flags(flags) -> None:
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul.allow_tf32"]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        flags["matmul.allow_bf16_reduced_precision_reduction"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]


def profile_calls(fn, reps: int):
    """``torch.profiler``'s record of ``reps`` calls of ``fn()`` on an idle
    card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def host_launch_calls(fn, reps: int = 3) -> float:
    """The host's launch calls a call of ``fn()`` under ``torch.profiler``,
    whether or not the profile holds the card's records of them (it can
    hold none for a kernel launched alone from a ctypes library)."""
    cuda = torch.autograd.DeviceType.CUDA
    prof = profile_calls(fn, reps)
    return len({e.id for e in prof.events() if e.device_type != cuda
                and e.name.startswith(LAUNCH_CALLS)}) / reps


def device_kernels(prof, reps: int):
    """(device ms per call, device records per call, [(kernel, ms per
    call), ...] largest first) of a profile: the sum of the CUDA kernels'
    own times, which excludes the gaps in which the card waits for the
    host."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / reps)
                      for e in events), key=lambda kv: -kv[1])
    total = sum(ms for _, ms in kernels)
    if total <= 0:
        # the launch-count and device-time checks read this profile; one
        # that saw no kernel on the card would pass them untested
        raise AssertionError("torch.profiler recorded no device time")
    return total, sum(e.count for e in events) / reps, kernels


def profile_card_only(fn):
    """(device ms, [(kernel, ms), ...] largest first, the host's launch
    calls) of one call of ``fn()`` under ``torch.profiler`` with the CUDA
    activity only: the launch calls are CUDA runtime records, and without
    the CPU ops a train step's ~330,000 records parse in ~30 s where the
    CPU and CUDA activities' took ~190 s (measured on an H100)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in averages if e.device_type == cuda),
                     key=lambda kv: -kv[1])
    total = sum(ms for _, ms in kernels)
    if total <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    calls = sum(e.count for e in averages if e.device_type != cuda
                and e.key.startswith(LAUNCH_CALLS))
    return total, kernels, calls


def device_time(fn, reps: int = 1, sessions: int = 2):
    """``device_kernels`` of ``reps`` calls of ``fn()``, from the one of
    ``sessions`` profiles that holds the most records on the card (the
    profiler drops some, see ``LAUNCH_CALLS``)."""
    profs = [profile_calls(fn, reps) for _ in range(sessions)]
    return device_kernels(max(profs, key=lambda prof: sum(
        e.count for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA)), reps)


# The host's runtime calls that put work on the card. torch.profiler on the
# H100 keeps every such call but not every record of the work on the card:
# here a session of a batch path mostly lacked 17 or 19 of its 270-490
# records, now and then 48-106, once all of them, while its count of
# launch calls never changed. So a call's launches are counted on the host, where every
# session agrees; a record on the card carries its call's correlation id,
# which shows how many of them each session saw.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                "cuMemcpy", "cuMemset")


def launches_in_turns(fns: dict, reps: int, sessions: int) -> dict:
    """{key: dict(launches, device_ms, records_on_card)} of each
    ``fns[key]()`` under ``sessions`` profiler sessions a key, the keys in
    turns. ``launches``: the host's launch calls a call; ``records_on_card``:
    each session's records on the card a call that answer its own launch
    calls; ``device_ms``: the median over the sessions that hold any. A
    session that holds neither a launch call nor a record is left out.
    Raises when a key's launch calls differ between the other sessions or
    none of them holds a record on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    seen = {k: [] for k in fns}
    for _ in range(sessions):
        for k, fn in fns.items():
            prof = profile_calls(fn, reps)
            events = prof.events()
            calls = {e.id for e in events if e.device_type != cuda
                     and e.name.startswith(LAUNCH_CALLS)}
            on_card = calls & {e.id for e in events if e.device_type == cuda}
            ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == cuda) / 1e3 / reps
            seen[k].append((len(calls) / reps, len(on_card) / reps, ms))
    out = {}
    for k, runs in seen.items():
        calls = {c for c, n, _ in runs if c or n}
        held = [ms for _, n, ms in runs if n > 0]
        if len(calls) != 1 or not held:
            raise AssertionError(f"{k}: (launch calls, records on the card, "
                                 f"device ms) a call in {sessions} profiler "
                                 f"sessions: {runs}")
        out[k] = dict(launches=calls.pop(),
                      device_ms=statistics.median(held),
                      records_on_card=[n for _, n, _ in runs])
    return out


# kernel-name groups of the LM's device time, tried in order
KERNEL_GROUPS = (
    ("kernel Gb", ("bwd_stats_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel",
                   "bwd_sm90_prep_kernel", "bwd_sm90_dkdv_kernel",
                   "bwd_sm90_dq_kernel")),
    ("kernel G", ("window_attn",)),
    ("fp32 GEMM (flash and decode attention)", ("f32f32", "gemmSN", "sgemm",
                                                 "<float")),
    ("bf16 GEMM (projections, MLP, logits)", ("nvjet", "bf16")),
)


def group_kernel_times(kernels):
    """{group: device ms} of (kernel name, ms) pairs; the rest (elementwise,
    reductions, copies) under "other"."""
    out = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
    for name, ms in kernels:
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        out[group] += ms
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _paired(a, b, prefix=""):
    """(path, (leaf of a, leaf of b)) over two dicts of one structure."""
    if isinstance(a, dict):
        for k in a:
            yield from _paired(a[k], b[k], f"{prefix}/{k}")
    else:
        yield prefix, (a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def slot_pairs_visited(launch) -> int:
    """The pair steps a kernel E or F launch takes (``launch(visits)``
    adds them to a one-element int64 counter on the card)."""
    visits = torch.zeros(1, dtype=torch.int64, device="cuda")
    launch(visits)
    torch.cuda.synchronize()
    return int(visits)


def path_kernels(p) -> tuple:
    """The wrappers a ``"cuda"`` plan's ``execute()`` must launch (kernel A
    in every binning on the card); the reference schedules launch only A."""
    if p.backend != "cuda":
        return ("prefix_sum",)
    if p.layout == "packed":
        return ("prefix_sum", "pack_slots", "xpencil_packed_forces")
    if p.layout == "sfc":
        return ("prefix_sum", "cell_sfc_forces")
    if p.strategy == "allin":
        return ("prefix_sum", "allin_forces")
    return ("prefix_sum", "xpencil_sparse_forces" if p.compact
            else "xpencil_forces")


def autotune_phase(dom, kern, pos_u, pos_b, gen, dev, run_main,
                   assert_equal_results):
    """``plan``'s default ``strategy="auto"`` and the measured autotuner
    (``core.autotune.tune``) on the division-64 uniform scene (1,048,576
    particles) and the blob, then ``strategy="autotune", backend="all"`` at
    division 16, where the reference schedules are timed on the card too.

    Each pick and each winner runs through ``execute()`` with the launch
    counts set to 0 just before, and equals an explicit plan of the same
    choice bit for bit; the auto picks also equal the dense X-pencil's. A
    second ``tune`` on the same inputs is a cache hit with no timing run.
    The tuner's cache is a fresh directory under ``build/``, removed at the
    end."""
    import os
    import shutil
    import tempfile

    from repro_torch.core import (ParticleState, active_unit_count,
                                  choose_strategy, n_units, plan,
                                  supports_compact, traffic, tune)
    from repro_torch.core import autotune as at
    from repro_torch.core.domain import Domain

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    cache = tempfile.mkdtemp(prefix="autotune_cache_", dir=ROOT / "build")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
    out = {"cache_dir": str(pathlib.Path(cache).relative_to(ROOT))}

    def explicit(p, pos):
        return plan(p.domain, p.kernel, positions=pos, strategy=p.strategy,
                    backend=p.backend, m_c=p.m_c, batch_size=p.batch_size,
                    box=p.box, compact=p.compact, max_active=p.max_active,
                    layout=p.layout, row_cap=p.row_cap, pair_cap=p.pair_cap)

    def modelled(p, pos):
        ppc = pos.shape[0] / p.domain.n_cells
        return {name: r.hbm_bytes_per_interaction for name, r in
                traffic.model(p.domain, p.m_c, ppc).items()}

    # 1. strategy="auto", the default, at full width
    states = {"uniform": ParticleState(pos_u), "blob": ParticleState(pos_b)}
    auto = {}
    for label, pos, kw in (("uniform", pos_u, {}),
                           ("blob packed", pos_b, {"layout": "packed"}),
                           ("blob packed compact", pos_b,
                            {"layout": "packed", "compact": True})):
        state = states[label.split()[0]]
        p = plan(dom, kern, positions=pos, **kw)
        f, u, launches = run_main(p, state, f"auto {label}", path_kernels(p))
        assert_equal_results((f, u), explicit(p, pos).execute(state),
                             f"auto {label} vs its explicit plan")
        dense = plan(dom, kern, positions=pos, m_c=p.m_c,
                     strategy="xpencil").execute(state)
        assert_equal_results((f, u), dense,
                             f"auto {label} ({p.strategy}) vs dense X-pencil")
        bpi = modelled(p, pos)
        auto[label] = dict(strategy=p.strategy, layout=p.layout,
                           compact=p.compact, m_c=p.m_c, box=p.box,
                           launches=launches,
                           modelled_bytes_per_interaction=bpi)
        log(f"auto {label}: picks {p.strategy} (m_c {p.m_c}, box {p.box}); "
            f"modelled B/interaction {bpi}; launches {launches}; equal to "
            "its explicit plan and to the dense X-pencil")
    for label in ("blob packed", "blob packed compact"):
        if auto[label]["strategy"] != "xpencil":
            raise AssertionError(f"auto {label}: {auto[label]}")
    # compact=True on "cuda" would pick allin, which "cuda" runs dense only
    # (the plan raises; a CPU test holds that)
    u_mc = auto["uniform"]["m_c"]
    compact_pick = choose_strategy(dom, u_mc, pos_u.shape[0] / dom.n_cells,
                                   among=("cell_dense", "xpencil", "allin"))
    if compact_pick != "allin" or supports_compact("cuda", "allin"):
        raise AssertionError(f"auto compact=True: picks {compact_pick}, "
                             f"cuda compacted allin "
                             f"{supports_compact('cuda', 'allin')}")
    auto["uniform compact"] = dict(strategy=compact_pick,
                                   cuda_has_compacted_path=False)
    out["auto"] = auto

    # 2. tune at full width over the cuda backend
    def candidate_record(res, c, p_domain, pos):
        """A timed candidate, with the modelled bytes per interaction the
        tuner ranked it by (a compacted one at its measured fill)."""
        def fill_for(c):
            return (active_unit_count(p_domain, pos, c.strategy, box=c.box)
                    / n_units(p_domain, c.strategy, box=c.box))
        return dict(strategy=c.strategy, backend=c.backend, layout=c.layout,
                    compact=c.compact, m_c=c.m_c, box=c.box,
                    batch_size=c.batch_size, ms=res.timings[c] * 1e3,
                    reps=res.reps[c],
                    modelled_bytes_per_interaction=at._cost(
                        p_domain, pos.shape[0] / p_domain.n_cells, c,
                        fill_for))

    tuned = {}
    for label, pos in (("uniform", pos_u), ("blob", pos_b)):
        state = states[label]
        t0 = time.perf_counter()
        res = tune(dom, kern, pos, backends=("cuda",))
        tune_s = time.perf_counter() - t0
        n_space = len(res.timings) + len(res.pruned)
        if res.cache_hit or len(res.timings) != min(at.DEFAULT_TOP_K,
                                                    n_space):
            raise AssertionError(f"tune {label}: {len(res.timings)} timed of "
                                 f"{n_space}, cache hit {res.cache_hit}")
        timed = [candidate_record(res, c, dom, pos) for c in
                 sorted(res.timings, key=res.timings.get)]
        for rec in timed:
            log(f"  tune {label}: {rec}")
        w = res.candidate
        f, u, launches = run_main(res.plan, state, f"tuned {label}",
                                  path_kernels(res.plan))
        assert_equal_results((f, u), explicit(res.plan, pos).execute(state),
                             f"tuned {label} vs its explicit plan")
        runs = at.timing_run_count()
        again = tune(dom, kern, pos, backends=("cuda",))
        if not again.cache_hit or again.candidate != w or \
                at.timing_run_count() != runs:
            raise AssertionError(f"tune {label} again: cache hit "
                                 f"{again.cache_hit}, {again.candidate}, "
                                 f"timing runs {runs} -> "
                                 f"{at.timing_run_count()}")
        queued = cuda_ms_queued(lambda: res.plan.execute(state), 20)
        # the model's pick (plan's default) against the stopwatch's, in
        # turns; then the tuner once more without its cache
        pa = plan(dom, kern, positions=pos)
        turns = {"auto": [], "winner": []}
        for which in ("auto", "winner", "winner", "auto"):
            q = pa if which == "auto" else res.plan
            turns[which].append(cuda_ms_queued(lambda: q.execute(state), 20))
        retune = tune(dom, kern, pos, backends=("cuda",), use_cache=False)
        rw = retune.candidate
        tuned[label] = dict(
            winner=candidate_record(res, w, dom, pos), launches=launches,
            timed=timed, pruned=len(res.pruned),
            infeasible=len(res.infeasible), tune_s=tune_s,
            winner_time_fn_ms=res.timings[w] * 1e3,
            winner_cuda_ms_queued=queued,
            winner_time_fn_over_queued=res.timings[w] * 1e3 / queued,
            second_tune_cache_hit=True,
            auto_pick=dict(strategy=pa.strategy, m_c=pa.m_c, box=pa.box),
            auto_ms_queued_in_turns=turns["auto"],
            winner_ms_queued_in_turns=turns["winner"],
            retune_winner=candidate_record(retune, rw, dom, pos))
        log(f"tune {label}: {len(res.timings)} timed, {len(res.pruned)} "
            f"pruned, {len(res.infeasible)} refused by their kernel, in "
            f"{tune_s:.1f} s; winner {w.strategy} {w.layout} compact="
            f"{w.compact} m_c {w.m_c} box {w.box}: time_fn "
            f"{res.timings[w] * 1e3:.4f} ms ({res.reps[w]} reps), "
            f"cuda_ms_queued {queued:.4f} ms; launches {launches}; equal to "
            "its explicit plan; second tune a cache hit, no timing run")
        log(f"tune {label}: auto pick {pa.strategy} against the winner in "
            f"turns (queued ms): {turns}; re-tuned without the cache: "
            f"{rw.strategy} {rw.layout} compact={rw.compact} m_c {rw.m_c} "
            f"{retune.timings[rw] * 1e3:.4f} ms")
    out["tune"] = tuned

    # 3. the platform default set ("reference" and "cuda") at division 16
    dom16 = Domain.cubic(16, cutoff=1.0)
    pos16 = dom16.sample_uniform(16 ** 3 * 4, generator=gen, device=dev)
    state16 = ParticleState(pos16)
    t0 = time.perf_counter()
    res16 = tune(dom16, kern, pos16)
    tune16_s = time.perf_counter() - t0
    runs = at.timing_run_count()
    p16 = plan(dom16, kern, positions=pos16, strategy="autotune",
               backend="all")
    if p16 != res16.plan or at.timing_run_count() != runs or not {
            c.backend for c in res16.timings} == {"reference", "cuda"}:
        raise AssertionError(f"autotune backend='all' at division 16: "
                             f"{p16} vs {res16.plan}, timed backends "
                             f"{ {c.backend for c in res16.timings} }")
    f, u, launches = run_main(p16, state16, "autotune all division 16",
                              path_kernels(p16))
    assert_equal_results((f, u), explicit(p16, pos16).execute(state16),
                         "autotune all division 16 vs its explicit plan")
    timed16 = [candidate_record(res16, c, dom16, pos16) for c in
               sorted(res16.timings, key=res16.timings.get)]
    for rec in timed16:
        log(f"  tune division 16 (reference + cuda): {rec}")
    out["tune_all_division_16"] = dict(
        winner=candidate_record(res16, res16.candidate, dom16, pos16),
        timed=timed16, pruned=len(res16.pruned), tune_s=tune16_s,
        launches=launches, front_door_equal=True)
    log(f"tune division 16 over reference + cuda: winner "
        f"{res16.candidate}, {tune16_s:.1f} s; plan(strategy='autotune', "
        "backend='all') gives the same plan from the cache")

    shutil.rmtree(cache)
    os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"autotune phase: {out['phase_s']:.1f} s")
    return out


def fcc_lattice(division: int, jitter: float, gen, dev) -> torch.Tensor:
    """Four particles a unit cell on the FCC basis, offset by a quarter cell
    and each coordinate jittered uniformly by at most ``jitter`` of a cell:
    the nearest neighbours lie ~0.71 cell widths apart."""
    basis = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                          [0.0, 0.5, 0.5]], device=dev) + 0.25
    idx = torch.arange(division, device=dev, dtype=torch.float32)
    cz, cy, cx = torch.meshgrid(idx, idx, idx, indexing="ij")
    cells = torch.stack([cx, cy, cz], -1).reshape(-1, 1, 3)
    pos = (cells + basis).reshape(-1, 3)
    return pos + jitter * (2.0 * torch.rand(pos.shape, generator=gen,
                                            device=dev) - 1.0)


def trajectory_phase(seed: int, dev, reset_launches, launch_counts):
    """``plan(...).trajectory`` at division 64 (1,048,576 particles on an
    FCC lattice, LJ, periodic) on every ``"cuda"`` path, with the gates of
    the trajectory engine (see TRAJ_* above); then timings, the split of a
    skin step, launches and host syncs a step, checkpoint bytes and times,
    and one ``sph_step`` at division 32. -> record."""
    import shutil
    import tempfile
    import warnings

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core import (Domain, ParticleState, make_lennard_jones,
                                  plan, suggest_m_c)
    from repro_torch.core.binning import (dense_to_particles, image_positions,
                                          max_displacement, refresh_bins)
    from repro_torch.core.interactions import PairKernel
    from repro_torch.kernels.xpencil import xpencil_forces
    from repro_torch.physics import init_state, sph
    from repro_torch.physics import integrators as I
    from repro_torch.testing import chaos
    from repro_torch.traj import engine as TE
    from repro_torch.traj import monitors as M

    t_phase = time.perf_counter()
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(seed * 1_000_003 + 7_919)
    division = TRAJ_DIVISION
    dom = Domain.cubic(division, cutoff=1.0, periodic=True)
    kern = make_lennard_jones(sigma=TRAJ_SIGMA, eps=TRAJ_EPS)
    pos = fcc_lattice(division, TRAJ_JITTER, g, dev)
    vel = TRAJ_VEL * torch.randn(pos.shape, generator=g, device=dev)
    out["scene"] = dict(division=division, n=pos.shape[0], lattice="fcc",
                        jitter=TRAJ_JITTER, sigma=TRAJ_SIGMA, eps=TRAJ_EPS,
                        vel=TRAJ_VEL, dt=TRAJ_DT)

    def equal_md(a, b, what):
        for f in ("positions", "velocities", "forces", "potential"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                d = float((getattr(a, f) - getattr(b, f)).abs().max())
                raise AssertionError(f"{what}: {f} not bit-equal (max "
                                     f"|diff| {d:.3e})")

    def close_md(a, b, what):
        """Gate 2's tolerances (JAX's test_skin_reuse_few_rebins):
        positions (minimum image) and velocities, |diff| <= tol (1 + |b|)."""
        dpos = dom.minimum_image(a.positions - b.positions).abs()
        dvel = (a.velocities - b.velocities).abs()
        err = (float((dpos / (1 + b.positions.abs())).max()),
               float((dvel / (1 + b.velocities.abs())).max()))
        if not (bool(a.positions.isfinite().all())
                and bool(a.velocities.isfinite().all())
                and bool((dpos <= 1e-5 * (1 + b.positions.abs())).all())
                and bool((dvel <= 1e-4 * (1 + b.velocities.abs())).all())):
            raise AssertionError(f"{what}: beyond 1e-5 (positions) / 1e-4 "
                                 f"(velocities): {err}")
        return err

    def timed(fn):
        """(result, ms) of one call by CUDA events."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    phase_launches = {}

    def add_launches(counts):
        for k, v in counts.items():
            phase_launches[k] = phase_launches.get(k, 0) + v

    # gate 1: skin=0, every path equals its reference_step loop bit for bit
    gate1, ends, plans, md0s = {}, {}, {}, {}
    for label, kw, need in TRAJ_PATHS:
        p = plan(dom, kern, positions=pos, device=dev, **kw)
        md0 = init_state(p, pos, vel)
        plans[label], md0s[label] = p, md0
        reset_launches()
        res = p.trajectory(md0, TRAJ_GATE1_STEPS, TRAJ_DT, skin=0.0,
                           segment_len=TRAJ_GATE1_SEG)
        torch.cuda.synchronize()
        launches = launch_counts()
        add_launches(launches)
        short = [k for k in ("prefix_sum", *need)
                 if launches.get(k, 0) < TRAJ_GATE1_STEPS]
        if short or res.status != "ok" or res.rebins != TRAJ_GATE1_STEPS:
            raise AssertionError(f"trajectory gate 1 {label}: status "
                                 f"{res.status}, rebins {res.rebins}, "
                                 f"launches {launches}")
        step = TE.reference_step(p)
        md = md0
        for _ in range(TRAJ_GATE1_STEPS):
            md = step(md, TRAJ_DT)
        equal_md(res.state, md, f"trajectory gate 1 {label} vs its "
                 "reference_step loop")
        ends[label] = (res.state, md)
        gate1[label] = dict(m_c=p.m_c, launches=launches)
        log(f"trajectory gate 1 {label}: skin 0, {TRAJ_GATE1_STEPS} steps, "
            f"m_c {p.m_c}: bit-equal to the reference_step loop; launches "
            f"{launches}")
    for label in ends:
        equal_md(ends[label][0], ends["dense"][0],
                 f"trajectory gate 1 {label} vs dense")
    out["gate1"] = gate1

    # gate 2: the default skin against the reference loop carried on
    p, md0 = plans["dense"], md0s["dense"]
    reset_launches()
    res, skin_ms = timed(lambda: p.trajectory(md0, TRAJ_STEPS, TRAJ_DT,
                                              segment_len=TRAJ_SEG))
    launches = launch_counts()
    add_launches(launches)
    tp = res.plan
    if (res.status != "ok" or res.ladder_level != 0 or res.faults
            or res.rebins >= TRAJ_MAX_REBINS
            or launches.get("xpencil_forces", 0) < TRAJ_STEPS):
        raise AssertionError(f"trajectory gate 2: status {res.status}, "
                             f"level {res.ladder_level}, faults {res.faults}, "
                             f"rebins {res.rebins}, launches {launches}")
    step = TE.reference_step(p)
    md = ends["dense"][1]
    md, loop_ms = timed(lambda: _loop(step, md, TRAJ_STEPS - TRAJ_GATE1_STEPS,
                                      TRAJ_DT))
    err2 = close_md(res.state, md, "trajectory gate 2 (skin) vs the loop")
    res0, skin0_ms = timed(lambda: p.trajectory(
        md0, TRAJ_STEPS, TRAJ_DT, skin=0.0, segment_len=TRAJ_SEG))
    equal_md(res0.state, md, "trajectory skin 0, 256 steps, vs the loop")
    disp = res.traces["displacement"]
    out["gate2"] = dict(
        skin_domain=list(tp.domain.ncells), m_c=tp.m_c,
        eff_skin=res.eff_skin, rebins=res.rebins,
        rebin_steps=[int(i) for i in (res.traces["rebinned"] > 0).nonzero()[0]],
        launches=launches, max_rel_err=err2,
        closest_predicate_margin=float(abs(disp - res.eff_skin / 2).min()),
        ms_per_step=dict(skin=skin_ms / TRAJ_STEPS,
                         skin0=skin0_ms / TRAJ_STEPS,
                         execute_loop=loop_ms / (TRAJ_STEPS
                                                 - TRAJ_GATE1_STEPS)))
    log(f"trajectory gate 2: skin grid {tp.domain.ncells}, m_c {tp.m_c}, "
        f"eff skin {res.eff_skin:.4f}, {res.rebins} rebins in "
        f"{TRAJ_STEPS} steps at {out['gate2']['rebin_steps']}; within "
        f"{err2} of the reference loop; skin 0 over {TRAJ_STEPS} steps "
        f"bit-equal to it; ms per step {out['gate2']['ms_per_step']}")

    # gate 3: stop at 128, resume to 256: bit-identical
    (ROOT / "build").mkdir(exist_ok=True)
    gate3 = {}
    fulls = {"dense": res}
    for label, kw, integ in (("dense", {}, {}),
                             ("packed", {"layout": "packed"}, {}),
                             ("langevin", {}, dict(integrator="langevin",
                                                   gamma=0.1, kT=1e-3))):
        q = plans[label] if label in plans else plans["dense"]
        m0 = md0s["packed" if label == "packed" else "dense"]
        if label not in fulls:
            fulls[label] = q.trajectory(m0, TRAJ_STEPS, TRAJ_DT,
                                        segment_len=TRAJ_SEG, **integ)
        d = pathlib.Path(tempfile.mkdtemp(prefix="traj_ckpt_",
                                          dir=ROOT / "build"))
        opts = dict(segment_len=TRAJ_SEG, checkpoint_dir=d,
                    checkpoint_every=TRAJ_CK_EVERY, **integ)
        t0 = time.perf_counter()
        part = q.trajectory(m0, TRAJ_STEPS // 2, TRAJ_DT, **opts)
        part_s = time.perf_counter() - t0
        last = ckpt.latest_step(d)
        ck_bytes = sum(f.stat().st_size for f in
                       (d / f"step_{last:08d}").iterdir())
        again = q.trajectory(m0, TRAJ_STEPS, TRAJ_DT, **opts)
        shutil.rmtree(d)
        if (part.checkpoints != 2 or last != TRAJ_STEPS // 2
                or again.resumed_from != TRAJ_STEPS // 2
                or again.steps != TRAJ_STEPS or again.status != "ok"):
            raise AssertionError(f"trajectory gate 3 {label}: checkpoints "
                                 f"{part.checkpoints}, latest {last}, resumed "
                                 f"from {again.resumed_from}")
        equal_md(again.state, fulls[label].state,
                 f"trajectory gate 3 {label}: resumed vs uninterrupted")
        gate3[label] = dict(checkpoint_bytes=ck_bytes, part_s=part_s,
                            rebins=fulls[label].rebins)
        log(f"trajectory gate 3 {label}: stopped at {last}, resumed, "
            f"bit-equal to the uninterrupted run; a checkpoint is "
            f"{ck_bytes} bytes")
    equal_md(fulls["packed"].state, fulls["dense"].state,
             "trajectory packed vs dense, skin")
    out["gate3"] = gate3

    # checkpoint save and load of the skin run's carry, host clock
    carry = TE._init_carry(tp, 1.0, res.state.positions,
                           res.state.velocities, 0, {}, None,
                           torch.Generator(device=dev).get_state(),
                           res.state.forces, res.state.potential)
    d = pathlib.Path(tempfile.mkdtemp(prefix="traj_ckpt_", dir=ROOT / "build"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(d, 1, carry)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = ckpt.restore(d, carry)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    equal_md(back.md, carry.md, "checkpoint round trip")
    out["checkpoint"] = dict(
        bytes=sum(f.stat().st_size for f in (d / "step_00000001").iterdir()),
        save_s=save_s, load_s=load_s)
    shutil.rmtree(d)
    log(f"trajectory checkpoint: {out['checkpoint']}")

    # gate 4: injected faults
    with chaos.inject(chaos.FaultSpec("traj.step", "error", p=1.0, after=1,
                                      max_fires=1), seed=5):
        r_err = p.trajectory(md0, TRAJ_STEPS, TRAJ_DT, segment_len=TRAJ_SEG)
    if r_err.retries != 1 or r_err.status != "ok":
        raise AssertionError(f"trajectory gate 4 error: retries "
                             f"{r_err.retries}, status {r_err.status}")
    equal_md(r_err.state, res.state, "trajectory gate 4: retried vs clean")
    with chaos.inject(chaos.FaultSpec("traj.step", "nonfinite", p=1.0,
                                      after=1, max_fires=1), seed=3):
        r_nan = p.trajectory(md0, TRAJ_STEPS, TRAJ_DT, segment_len=TRAJ_SEG)
    if (r_nan.status != "ok" or r_nan.rollbacks != 1
            or r_nan.ladder_level != 0 or r_nan.steps != TRAJ_STEPS):
        raise AssertionError(f"trajectory gate 4 nonfinite: {r_nan.status}, "
                             f"rollbacks {r_nan.rollbacks}, level "
                             f"{r_nan.ladder_level}, faults {r_nan.faults}")
    err4 = close_md(r_nan.state, res.state,
                    "trajectory gate 4: rolled back vs clean")
    out["gate4"] = dict(error_faults=r_err.faults, nonfinite_faults=r_nan.faults,
                        nonfinite_forced_rebins=r_nan.forced_rebins,
                        nonfinite_max_rel_err=err4)
    log(f"trajectory gate 4: {out['gate4']}")

    # where a skin step's time goes, on the skin grid at the run's end
    co = I.coefficients(TRAJ_DT, 1.0, 0.1, 0.0)
    sdom = tp.domain
    md = carry.md
    gen = torch.Generator(device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    new_pos, v_staged = I.integ_drift("velocity_verlet", sdom, co, md, gen)
    img = image_positions(sdom, new_pos, carry.ref)
    bins = refresh_bins(sdom, carry.bins, img[None])
    fx, fy, fz, pot = xpencil_forces(bins.planes, bins.slot_id, nx=sdom.nx,
                                     m_c=bins.m_c, kernel=kern, cutoff2=1.0)
    forces, upot = TE._forces(tp, bins, img, {}, None)

    def monitors():
        ke, pe = TE._masked_energies(md.velocities, upot, None, 1.0)
        probes = TE._bound_probes(tp, bins, zero)
        return M.update(carry.mon, positions=new_pos, velocities=md.velocities,
                        forces=forces, potential=upot, valid=None, kinetic=ke,
                        potential_energy=pe, step_disp=zero.float(),
                        eff_skin=res.eff_skin, cell_max=probes[0],
                        row_max=probes[1], units=probes[2])

    pieces = {
        "drift": lambda: I.integ_drift("velocity_verlet", sdom, co, md, gen),
        "max_displacement x2": lambda: (
            max_displacement(sdom, new_pos, carry.ref),
            max_displacement(sdom, new_pos, md.positions)),
        "refresh_bins (image + scatter + ghosts)": lambda: refresh_bins(
            sdom, carry.bins, image_positions(sdom, new_pos,
                                              carry.ref)[None]),
        "kernel B on the skin grid": lambda: xpencil_forces(
            bins.planes, bins.slot_id, nx=sdom.nx, m_c=bins.m_c,
            kernel=kern, cutoff2=1.0),
        "scatter-back": lambda: dense_to_particles(sdom, bins, fx, fy, fz,
                                                   pot),
        "kick": lambda: I.integ_kick("velocity_verlet", co, v_staged,
                                     forces),
        "monitors (energies, probes, update)": monitors,
        "refresh step": lambda: TE._step(tp, "velocity_verlet", co,
                                         res.eff_skin, 1.0, carry, gen, {},
                                         None, zero),
        "rebin step": lambda: TE._step(tp, "velocity_verlet", co, 0.0, 1.0,
                                       carry, gen, {}, None, zero),
        "execute() at division 64": lambda: p.execute(ParticleState(md.positions)),
    }
    split = {k: cuda_ms(fn, reps=10) for k, fn in pieces.items()}
    split_queued = {k: cuda_ms_queued(fn, reps=10) for k, fn in pieces.items()
                    if k not in ("refresh step", "rebin step")}
    steps = launches_in_turns({k: pieces[k] for k in
                               ("refresh step", "rebin step",
                                "execute() at division 64")},
                              reps=3, sessions=3)
    syncs = {}
    for k in ("refresh step", "rebin step", "execute() at division 64"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pieces[k]()
            torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(0)
        syncs[k] = sum("synchroniz" in str(w.message) for w in caught)
    out["split_ms"] = split
    out["split_ms_queued"] = split_queued
    out["launches_a_call"] = {k: v["launches"] for k, v in steps.items()}
    if out["launches_a_call"] != TRAJ_LAUNCH_CALLS:
        raise AssertionError(f"launch calls a call {out['launches_a_call']}, "
                             f"want {TRAJ_LAUNCH_CALLS}")
    out["device_ms_a_call"] = {k: v["device_ms"] for k, v in steps.items()}
    out["host_syncs_a_call"] = syncs
    log(f"trajectory split (ms a call, events): {split}; queued: "
        f"{split_queued}; launch calls {out['launches_a_call']}; device ms "
        f"{out['device_ms_a_call']}; host syncs (sync debug mode) {syncs}")

    # gate 5: one SPH step on the division-32 periodic scene
    sdiv, sppc = TRAJ_SPH
    sdom32 = Domain.cubic(sdiv, cutoff=1.0, periodic=True)
    spos = sdom32.sample_uniform(sdiv ** 3 * sppc, generator=g, device=dev)
    m_c = suggest_m_c(sdom32, spos)
    params = sph.SPHParams(h=1.0, mass=1.0)
    zero_v = torch.zeros_like(spos)
    reset_launches()
    got, sph_ms = timed(lambda: sph.sph_step(sdom32, spos, zero_v, params,
                                             m_c, dt=1e-3))
    sph_launches = launch_counts()
    add_launches(sph_launches)
    want = sph.sph_step(sdom32, spos, zero_v, params, m_c, dt=1e-3,
                        backend="reference")
    # positions move by dt * v ~ 1e-8 of a box of 32: held scale-relative
    # as every position is; velocities and density each to their own
    # scale, with no floor, so a velocity of ~1e-5 keeps its digits
    errs = {"positions": assert_scale_close(got[0], want[0],
                                            "sph_step positions vs "
                                            "reference")}
    for a, b, what in zip(got[1:], want[1:], ("velocities", "density")):
        errs[what] = assert_own_scale_close(a, b, f"sph_step {what} vs "
                                            "reference", SPH_OWN_TOL)
    if sph_launches.get("xpencil_forces") != 2:
        raise AssertionError(f"sph_step: launches {sph_launches}")
    # the pressure force (kernel B with PairParams.p2 = the pressure scale)
    # per particle against the reference, within 1e-4 of its own term sizes:
    # a zero, flipped or mis-scaled p2 fails here (not counted as the main
    # path's launches)
    pkern = sph.make_pressure_kernel(params, float(params.rho0), 1.0)
    fp = plan(sdom32, pkern, m_c=m_c, strategy="xpencil", device=dev)
    pstate = ParticleState(spos)
    pf, _ = fp.execute(pstate)
    pref = dataclasses.replace(fp, backend="reference")
    rf, _ = pref.execute(pstate)
    size_k = PairKernel("sph_pressure_force_term_size", torch.zeros_like,
                        lambda r2: pkern.coeff(r2).abs() * r2.sqrt(),
                        flops=0)
    fsize = dataclasses.replace(pref, kernel=size_k).execute(pstate)[1]
    errs["pressure_force_term"] = assert_term_close(
        pf, rf, fsize[:, None], "sph pressure force vs reference", 1e-4)
    errs["pressure_force_own_scale"] = assert_own_scale_close(
        pf, rf, "sph pressure force vs reference", SPH_OWN_TOL)
    out["gate5_sph"] = dict(division=sdiv, n=spos.shape[0], m_c=m_c,
                            errors=errs, launches=sph_launches, ms=sph_ms,
                            max_abs_velocity=float(want[1].abs().max()))
    log(f"trajectory gate 5: sph_step at division {sdiv} ({spos.shape[0]} "
        f"particles, m_c {m_c}) on kernel B within {errs} of the reference "
        f"backend (velocities and density to their own scale, limit "
        f"{SPH_OWN_TOL}; the pressure force per particle to 1e-4 of its "
        f"term sizes); {sph_ms:.3f} ms; launches {sph_launches}")

    out["launches"] = phase_launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"trajectory phase: {out['phase_s']:.1f} s")
    return out


# The serving tier (ServingEngine, the regime of PERF.md's scene (f)): two
# classes at division 16, N in SERVE_CLASSES (n_cap 16,384, about 4 a cell,
# and 8,192), 1,024 requests a mix, Poisson arrivals on a VirtualClock from
# the seed at SERVE_LOAD times the request rate of one full SERVE_MAX_BATCH
# dispatch measured in the warm pass. Requests are made on the host, as a
# front door receives them; each batch moves to the card in one copy.
SERVE_DIVISION = 16
SERVE_CLASSES = ((12_289, 16_384), (6_145, 8_192))
SERVE_MIXES = (
    ("uniform", (("uniform", {}),)),
    ("clustered", (("gaussian_blob", {"sigma_frac": 0.15}),
                   ("two_phase", {"droplet_frac": 0.7, "radius_frac": 0.2}))),
)
SERVE_REQUESTS, SERVE_MAX_BATCH, SERVE_MAX_QUEUE = 1024, 64, 4096
SERVE_MAX_WAIT, SERVE_LOAD = 2e-3, 0.5
SERVE_CHAOS_REQUESTS = 96
# trajectory serving: two jobs of one class (n_cap 131,072), division 32
# periodic, on the trajectory phase's FCC lattice and LJ
SERVE_TRAJ_DIVISION, SERVE_TRAJ_N, SERVE_TRAJ_STEPS = 32, (120_000, 125_000), 64
# launch calls a call of the trajectory phase, measured before the executor
# cache came (PERF.md section 5): an explicit-strategy execute() and a
# trajectory step launch what they did then
TRAJ_LAUNCH_CALLS = {"refresh step": 180, "rebin step": 257,
                     "execute() at division 64": 148}


def serve_requests(mix, n_requests: int, seed: int):
    """The open-loop schedule of one mix: [(arrival offset in units of the
    mean gap, state on the host)], the gaps exponential, each request's
    class, scene and N drawn from one seeded generator."""
    import numpy as np

    from repro_torch.core import Domain, ParticleState, scenarios

    dom = Domain.cubic(SERVE_DIVISION, cutoff=1.0)
    rng = np.random.default_rng(seed)
    g = torch.Generator()
    g.manual_seed(seed)
    t, out = 0.0, []
    for _ in range(n_requests):
        t += rng.exponential(1.0)
        lo, hi = SERVE_CLASSES[rng.integers(len(SERVE_CLASSES))]
        scene, knobs = mix[rng.integers(len(mix))]
        n = int(rng.integers(lo, hi + 1))
        pos = scenarios.sample(scene, dom, n, generator=g, device="cpu",
                               **knobs)
        out.append((t, ParticleState(pos)))
    return dom, out


def serving_phase(seed: int, dev, smi: str, dom64, kern, pos_u,
                  reset_launches, launch_counts, assert_equal_results,
                  check_serving_batch):
    """The serving tier on the card (``repro_torch.serve``), then guarded
    execution, ``obs.profile`` and ``TrajectoryService``. -> record.

    * ``ServingEngine`` (default ``strategy="auto"``) on the two mixes of
      SERVE_MIXES: a warm pass (every request at once, full batches), the
      arrival rate set from it, then a measured pass on a fresh clock and
      metrics. Gates: every response of the measured pass ``torch.equal``
      to ``class_plan(sc).execute`` of its request; no executor build and
      no timing run after the warm pass; every kernel of each class's path
      launched in the measured pass (counts set to 0 just before); a
      dispatch makes the same launch calls at 16 and 64 requests; each
      class's force kernel on a full padded batch of its requests against
      its plain version (``check_serving_batch``).
    * one class with ``autotune=True``: tuned once; a second engine on the
      class is a cache hit with no timing run (cache under ``build/``).
    * chaos: a packed class whose breaker opens moves to a ``"cuda"`` dense
      plan; under a mixed ``serve.dispatch`` schedule every request ends
      with a definite status and each ``"ok"`` equals the fault-free run.
    * ``execute_checked`` on the dense division-64 path: a clean call and
      one after an injected ``core.dispatch`` error bit-equal to
      ``execute()``; ``obs.profile`` on the same plan, its Chrome trace.
    * ``TrajectoryService``: two jobs of one class; the first bit-equal to
      ``plan.trajectory`` of the unpadded state on the same skin plan, the
      second builds no executor."""
    import math
    import os
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.core import (Domain, ParticleState, api,
                                  make_lennard_jones, plan, recompile_count)
    from repro_torch.core import autotune as at
    from repro_torch.serve import (ServeMetrics, ServingEngine,
                                   TrajectoryRequest, TrajectoryService,
                                   VirtualClock, classify, quantize_batch,
                                   stack_states)
    from repro_torch.testing import chaos

    t_phase = time.perf_counter()
    out = {"device": smi}
    (ROOT / "build").mkdir(exist_ok=True)

    def to_dev(st):
        return ParticleState(st.positions.to(dev))

    def drive(eng, dom, schedule, gap):
        """Arrivals at ``gap`` clock-seconds a unit of the schedule; due
        buckets dispatch before each arrival. -> [(req_id, state)]"""
        ids = []
        for t, st in schedule:
            eng.clock.advance_to(t * gap)
            eng.poll()
            ids.append((eng.submit(dom, st), st))
        eng.clock.advance(eng.max_wait)
        eng.flush()
        return ids

    def launch_calls_a_dispatch(eng, dom, states):
        """Launch calls of one engine dispatch of 16 and of 64 requests
        (``launches_in_turns``): submitted, then flushed."""
        def dispatch(k):
            def run():
                for st in states[:k]:
                    eng.submit(dom, st)
                eng.flush()
                eng.take_responses()
            return run
        counts = launches_in_turns({k: dispatch(k) for k in (16, 64)},
                                   reps=1, sessions=3)
        return {k: v["launches"] for k, v in counts.items()}

    # 1. the two mixes
    mixes, serving_launches = {}, {}
    for index, (name, mix) in enumerate(SERVE_MIXES):
        dom, schedule = serve_requests(mix, SERVE_REQUESTS,
                                       seed * 1_000_003 + index)
        eng = ServingEngine(kern, max_batch=SERVE_MAX_BATCH,
                            max_queue=SERVE_MAX_QUEUE,
                            max_wait=SERVE_MAX_WAIT)
        t0 = time.perf_counter()
        drive(eng, dom, [(0.0, st) for _, st in schedule], 0.0)
        warm = eng.metrics.snapshot()
        if len(eng.take_responses()) != SERVE_REQUESTS:
            raise AssertionError(f"serving {name}: warm pass lost requests")
        full_s = eng.metrics.dispatch_latency.p(50.0)
        rate = SERVE_LOAD * SERVE_MAX_BATCH / full_s
        warm_s = time.perf_counter() - t0
        at.reset_timing_runs()
        rc0 = recompile_count()
        eng.clock, eng.metrics = VirtualClock(), ServeMetrics()
        reset_launches()
        ids = drive(eng, dom, schedule, 1.0 / rate)
        torch.cuda.synchronize()
        launches = launch_counts()
        snap = eng.metrics.snapshot()
        builds, timing_runs = recompile_count() - rc0, at.timing_run_count()
        if builds or timing_runs:
            raise AssertionError(f"serving {name}: {builds} executor builds, "
                                 f"{timing_runs} timing runs after warm-up")
        resp = {r.req_id: r for r in eng.take_responses()}
        classes, class_states = {}, {}
        for rid, st in ids:
            r = resp[rid]
            sc = classify(dom, eng.kernel, st.n, (), eng.min_n_cap)
            p = eng.class_plan(sc)
            classes[sc] = p
            class_states.setdefault(sc, []).append(st)
            if r.status != "ok":
                raise AssertionError(f"serving {name}: request {rid} "
                                     f"{r.status}")
            assert_equal_results((r.forces, r.potential),
                                 p.execute(to_dev(st)),
                                 f"serving {name} request {rid} vs "
                                 "class_plan(sc).execute")
        for sc, p in classes.items():
            short = [k for k in path_kernels(p)
                     if launches.get(k, 0) < 1]
            if short:
                raise AssertionError(f"serving {name} {sc.label()}: no "
                                     f"launch of {short}: {launches}")
        calls = launch_calls_a_dispatch(eng, dom, [
            st for _, st in schedule if st.n >= SERVE_CLASSES[0][0]])
        if calls[16] != calls[64]:
            raise AssertionError(f"serving {name}: a dispatch of 16 requests "
                                 f"makes {calls[16]} launch calls, of 64 "
                                 f"{calls[64]}")
        kernel_checks = {}
        for sc, p in classes.items():
            full = class_states[sc][:SERVE_MAX_BATCH]
            batched = stack_states(full, sc.n_cap,
                                   quantize_batch(len(full), SERVE_MAX_BATCH),
                                   dev)
            kernel_checks[sc.label()] = check_serving_batch(
                p, dom, batched, f"{name} {sc.label()}")
        for k, v in launches.items():
            serving_launches.setdefault(k, {})[name] = v / snap["batches"]
        mixes[name] = dict(
            requests=SERVE_REQUESTS, warm_pass_s=warm_s,
            warm_batches=warm["batches"], full_dispatch_ms=1e3 * full_s,
            rate_rps=rate, rps=snap["rps"], batches=snap["batches"],
            batch_fill=snap["batch_fill"], replans_warm=warm["replans"],
            total_ms={q: 1e3 * snap["total_latency"][f"{q}_s"]
                      for q in ("p50", "p99")},
            queue_ms={q: 1e3 * snap["queue_latency"][f"{q}_s"]
                      for q in ("p50", "p99")},
            dispatch_ms={q: 1e3 * snap["dispatch_latency"][f"{q}_s"]
                         for q in ("p50", "p99")},
            plans={sc.label(): dict(strategy=p.strategy, layout=p.layout,
                                    backend=p.backend, m_c=p.m_c)
                   for sc, p in classes.items()},
            launches=launches, launch_calls_a_dispatch=calls,
            kernel_checks=kernel_checks,
            max_term_rel_err=max(c["max_term_rel_err"]
                                 for c in kernel_checks.values()))
        log(f"serving {name} ({smi}): {SERVE_REQUESTS} requests at "
            f"{rate:.1f} req/s offered (half a full {SERVE_MAX_BATCH}-request "
            f"dispatch's rate, {1e3 * full_s:.3f} ms in the warm pass): "
            f"{snap['rps']:.1f} req/s served, {snap['batches']} dispatches, "
            f"fill {snap['batch_fill']:.3f}; ms p50/p99 total "
            f"{mixes[name]['total_ms']}, queue {mixes[name]['queue_ms']}, "
            f"dispatch {mixes[name]['dispatch_ms']}; plans "
            f"{mixes[name]['plans']}; launch calls a dispatch {calls}; "
            "every response torch.equal to class_plan(sc).execute; 0 "
            "executor builds, 0 timing runs after warm-up; each class's "
            f"kernel on a full padded batch vs plain: {kernel_checks}")
    out["mixes"] = mixes
    out["serving_launches"] = serving_launches

    # 2. autotune=True on one class: tuned once, then a cache hit
    dom, schedule = serve_requests(SERVE_MIXES[0][1], 2 * SERVE_MAX_BATCH,
                                   seed * 1_000_003 + 7)
    states = [st for _, st in schedule
              if st.n > SERVE_CLASSES[0][0] - 1][:SERVE_MAX_BATCH]
    cache = tempfile.mkdtemp(prefix="serve_autotune_", dir=ROOT / "build")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
    tuned = []
    for _ in range(2):
        eng = ServingEngine(kern, max_batch=SERVE_MAX_BATCH,
                            max_wait=SERVE_MAX_WAIT, autotune=True,
                            tune_opts=dict(backends=("cuda",),
                                           budget_s=0.05))
        at.reset_timing_runs()
        drive(eng, dom, [(0.0, st) for st in states], 0.0)
        resp = eng.take_responses()
        p = eng.class_plan(classify(dom, kern, states[0].n, ()))
        if not all(r.status == "ok" for r in resp):
            raise AssertionError("serving autotune: a request failed")
        tuned.append(dict(timing_runs=at.timing_run_count(),
                          cache_hits=eng.metrics.autotune_cache_hits,
                          strategy=p.strategy, layout=p.layout,
                          compact=p.compact))
    shutil.rmtree(cache)
    os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE")
    if not (tuned[0]["timing_runs"] > 0 and tuned[0]["cache_hits"] == 0
            and tuned[1]["timing_runs"] == 0 and tuned[1]["cache_hits"] == 1):
        raise AssertionError(f"serving autotune: {tuned}")
    out["autotune"] = tuned
    log(f"serving autotune=True: first engine tuned ({tuned[0]}), the "
        f"second a cache hit with 0 timing runs ({tuned[1]})")

    # 3. chaos on the card: the breaker of a packed class, then a mixed
    # schedule against a fault-free run of the same requests
    packed = dict(strategy="xpencil", layout="packed")
    eng = ServingEngine(kern, max_batch=8, max_wait=SERVE_MAX_WAIT,
                        max_retries=0, breaker_threshold=2,
                        breaker_recovery=100, plan_opts=packed)
    sc = classify(dom, kern, states[0].n, ())
    with chaos.inject(chaos.FaultSpec("serve.dispatch", "error",
                                      max_fires=2)):
        for st in states[:2]:
            eng.submit(dom, st)
            eng.flush()
    primary, quarantined = eng.class_primary(sc), eng.class_plan(sc)
    eng.submit(dom, states[2])
    eng.flush()
    last = eng.take_responses()[-1]
    if not (eng.class_breaker(sc).open and primary.layout == "packed"
            and quarantined == api.fallback_plan(primary)
            and quarantined.backend == "cuda"
            and quarantined.layout == "dense" and last.status == "ok"):
        raise AssertionError(f"serving chaos: breaker "
                             f"{eng.class_breaker(sc)}, primary {primary}, "
                             f"quarantined {quarantined}, {last.status}")
    assert_equal_results((last.forces, last.potential),
                         primary.execute(to_dev(states[2])),
                         "quarantined class (cuda dense) vs its packed "
                         "primary")
    log(f"serving chaos: a packed class's breaker opened after 2 faults; "
        f"quarantined on backend {quarantined.backend!r}, layout "
        f"{quarantined.layout!r}, equal to the packed primary bit for bit")

    _, chaos_schedule = serve_requests(SERVE_MIXES[0][1],
                                       SERVE_CHAOS_REQUESTS,
                                       seed * 1_000_003 + 11)

    def chaos_run(specs):
        eng = ServingEngine(kern, max_batch=8, max_wait=SERVE_MAX_WAIT,
                            max_retries=3, breaker_threshold=3,
                            breaker_recovery=3, plan_opts=packed)
        with chaos.inject(*specs, seed=seed) as st:
            ids = drive(eng, dom, chaos_schedule, 1e-3)
            for _ in range(500):
                if not eng.pending():
                    break
                eng.clock.advance(eng.retry_cap_s)
                eng.flush()
            fired = st.fire_count()
        resp = {r.req_id: r for r in eng.take_responses()}
        return eng, [resp[rid] for rid, _ in ids], fired

    _, clean, _ = chaos_run(())
    eng, faulty, fired = chaos_run((
        chaos.FaultSpec("serve.dispatch", "error", p=0.3),
        chaos.FaultSpec("serve.dispatch", "delay", p=0.2, param=1e-3),
        chaos.FaultSpec("serve.dispatch", "nonfinite", p=0.1)))
    statuses = {}
    for a, b in zip(clean, faulty):
        statuses[b.status] = statuses.get(b.status, 0) + 1
        if b.status not in ("ok", "failed", "deadline") or a.status != "ok":
            raise AssertionError(f"serving chaos: request {b.req_id} "
                                 f"{b.status} (fault-free {a.status})")
        if b.status == "ok":
            assert_equal_results((b.forces, b.potential),
                                 (a.forces, a.potential),
                                 f"serving chaos request {b.req_id} vs the "
                                 "fault-free run")
    snap = eng.metrics.snapshot()
    if eng.pending() or not fired or not statuses.get("ok"):
        raise AssertionError(f"serving chaos: pending {eng.pending()}, "
                             f"fired {fired}, statuses {statuses}")
    out["chaos"] = dict(requests=SERVE_CHAOS_REQUESTS, fired=fired,
                        statuses=statuses,
                        **{k: snap[k] for k in (
                            "faults", "retries", "nonfinite_batches",
                            "breaker_opens", "breaker_closes", "failed")})
    log(f"serving chaos: {SERVE_CHAOS_REQUESTS} requests under a mixed "
        f"serve.dispatch schedule ({fired} fires): {out['chaos']}; every "
        "ok response equal to the fault-free run's")

    # 4. execute_checked and obs.profile on the dense division-64 path
    state = ParticleState(pos_u)
    p = plan(dom64, kern, positions=pos_u, strategy="xpencil")
    want = p.execute(state)
    got, report = p.execute_checked(state)
    assert_equal_results(got, want, "execute_checked vs execute()")
    with chaos.inject(chaos.FaultSpec("core.dispatch", "error",
                                      max_fires=1)):
        got2, report2 = p.execute_checked(state)
    assert_equal_results(got2, want, "execute_checked after an injected "
                         "error vs execute()")
    if not (report.status == "ok" and report.retries == 0
            and report2.status == "ok" and report2.retries == 1
            and report2.faults):
        raise AssertionError(f"execute_checked: {report}; {report2}")
    checked_ms = cuda_ms(lambda: p.execute_checked(state), 10)
    execute_ms = cuda_ms(lambda: p.execute(state), 10)
    execute_queued_ms = cuda_ms_queued(lambda: p.execute(state), 10)
    rep = obs.profile(p, state, budget_s=0.2)
    trace_dir = tempfile.mkdtemp(prefix="profile_", dir=ROOT / "build")
    rep_t = obs.profile(p, state, reps=3, trace_dir=trace_dir)
    # obs.profile writes its Chrome trace as plan_profile.trace.json
    events = json.loads((pathlib.Path(trace_dir) / "plan_profile.trace.json"
                         ).read_text())["traceEvents"]
    shutil.rmtree(trace_dir)
    b_records = sum(1 for e in events if "xpencil_kernel" in e.get("name", "")
                    and e.get("cat") == "kernel")
    if not (math.isfinite(rep.drift) and rep.seconds_per_call > 0
            and events):
        raise AssertionError(f"obs.profile: {rep}; {len(events)} events")
    out["execute_checked"] = dict(ms=checked_ms, execute_ms=execute_ms,
                                  injected_retries=report2.retries,
                                  faults=report2.faults)
    out["profile"] = dict(seconds_per_call=rep.seconds_per_call,
                          reps=rep.reps, cuda_ms_queued=execute_queued_ms,
                          drift=rep.drift, modelled_bpi=rep.modelled_bpi,
                          measured_bpi=rep.measured_bpi,
                          traced_seconds_per_call=rep_t.seconds_per_call,
                          trace_events=len(events),
                          kernel_b_records=b_records,
                          traced_calls=rep_t.reps + 2)
    log(f"execute_checked, dense division 64 ({smi}): {checked_ms:.6f} ms "
        f"beside execute()'s {execute_ms:.6f} ms; clean and after an "
        f"injected error ({report2.faults}) bit-equal to execute(). "
        f"obs.profile: seconds_per_call {rep.seconds_per_call:.6e} "
        f"({rep.reps} reps) beside cuda_ms_queued {execute_queued_ms:.6f} ms; "
        f"drift {rep.drift:.4f}; Chrome trace {len(events)} events, "
        f"{b_records} kernel B records for {rep_t.reps + 2} calls (time_fn's "
        "warm-up, its sizing call and the reps; the profiler drops some)")

    # 5. TrajectoryService: two jobs of one class
    tdom = Domain.cubic(SERVE_TRAJ_DIVISION, cutoff=1.0, periodic=True)
    lj = make_lennard_jones(sigma=TRAJ_SIGMA, eps=TRAJ_EPS)
    g = torch.Generator(device=dev)
    g.manual_seed(seed * 1_000_003 + 13)
    lattice = fcc_lattice(SERVE_TRAJ_DIVISION, TRAJ_JITTER, g, dev)
    perm = torch.randperm(lattice.shape[0], generator=g, device=dev)
    lattice = lattice[perm]
    vel = TRAJ_VEL * torch.randn(lattice.shape, generator=g, device=dev)
    svc = TrajectoryService()
    jobs = []
    for i, n in enumerate(SERVE_TRAJ_N):
        rc0 = recompile_count()
        req = TrajectoryRequest(f"job-{i}", tdom, lj,
                                ParticleState(lattice[:n]), SERVE_TRAJ_STEPS,
                                TRAJ_DT, velocities=vel[:n],
                                opts={"segment_len": TRAJ_SEG})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = svc.submit(req)
        torch.cuda.synchronize()
        jobs.append(dict(n=n, status=res.status, s=time.perf_counter() - t0,
                         builds=recompile_count() - rc0,
                         rebins=res.result.rebins))
        if res.status != "ok":
            raise AssertionError(f"TrajectoryService job {i}: {res.status}")
        if i == 0:
            (base, traj), = svc._plans.values()
            direct = base.trajectory(ParticleState(lattice[:n]),
                                     SERVE_TRAJ_STEPS, TRAJ_DT,
                                     velocities=vel[:n], traj_plan=traj,
                                     segment_len=TRAJ_SEG)
            for f in ("positions", "velocities", "forces", "potential"):
                if not torch.equal(getattr(res.state, f),
                                   getattr(direct.state, f)):
                    raise AssertionError(f"TrajectoryService job 0: {f} not "
                                         "bit-equal to plan.trajectory")
    if jobs[1]["builds"] != 0:
        raise AssertionError(f"TrajectoryService: the second job of the "
                             f"class built {jobs[1]['builds']} executors")
    out["trajectory_service"] = jobs
    log(f"TrajectoryService ({smi}): division {SERVE_TRAJ_DIVISION} periodic, "
        f"{SERVE_TRAJ_STEPS} steps: {jobs}; job 0 bit-equal to "
        "plan.trajectory on the same skin plan, job 1 built no executor")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serving phase: {out['phase_s']:.1f} s")
    return out


# halo engine (backend="halo"): Z-slab shards stacked on the card
HALO_SHARDS = 4
HALO_PATHS = (   # label, plan options; each against the same strategy's
    ("dense", dict(strategy="xpencil")),                  # one-device plan
    ("compact", dict(strategy="xpencil", compact=True)),
    ("packed_compact", dict(strategy="xpencil", layout="packed",
                            compact=True)),
    ("allin", dict(strategy="allin")),
    ("sfc", dict(strategy="cell_dense", layout="sfc")),
)
HALO_PERIODIC = (32, 10, (2, 4))   # division, per cell, shard counts
HALO_BATCH = (4, 16, 4)            # systems, division, per cell


def halo_phase(seed: int, dev, smi: str, dom64, kern, pos_u, run_main,
               reset_launches, launch_counts, assert_equal_results,
               check_halo_shards):
    """The halo engine on the card (``plan(..., backend="halo")``, shards
    stacked on the system axis of kernels A-F). -> record.

    * division 64, open, 1,048,576 uniform particles, HALO_SHARDS shards:
      each path of HALO_PATHS against the same strategy's one-device
      ``execute()`` within a scale-relative 3e-4, with the same launches
      of each kernel (one force-kernel launch for all shards); compacted
      and packed + compacted equal to the dense halo path bit for bit;
      each path's force kernel on its stacked shards against its plain
      version on the first and last shard (``check_halo_shards``).
    * division 32 periodic at 2 and 4 shards: the dense halo against
      ``execute()``.
    * a batch of HALO_BATCH systems at 4 shards each: ``execute_batch``
      equal to the loop of ``execute()`` bit for bit, one force-kernel
      launch for the batch.
    * ``execute_checked`` with a shard lost at ``dist.exchange``: shrunk to
      2 shards, equal to the survivor plan bit for bit; the sfc plan's
      shrink re-measures its per-shard ``pair_cap`` and matches its
      one-device plan within a scale-relative 3e-4.
    * times: halo and one-device ``execute()`` (``cuda_ms_queued``), their
      launch calls (``launches_in_turns``), the partition, the ghost
      exchange of the dense planes, each force kernel on the stacked
      shards and B on the one-device bins."""
    from repro_torch.core import Domain, ParticleState, cell_counts, plan
    from repro_torch.core.binning import EMPTY_POS
    from repro_torch.dist import halo as H
    from repro_torch.dist.engine import halo_impl, shard_sfc_pairs
    from repro_torch.kernels.xpencil import xpencil_forces
    from repro_torch.testing import chaos

    t_phase = time.perf_counter()
    ns = HALO_SHARDS
    state = ParticleState(pos_u)
    out = {"device": smi, "case": f"uniform division {dom64.nx}, open",
           "n": pos_u.shape[0], "n_shards": ns, "paths": {}}
    launches_all = {}
    dense = None
    for label, opts in HALO_PATHS:
        p1 = plan(dom64, kern, positions=pos_u, **opts)
        ph = plan(dom64, kern, positions=pos_u, m_c=p1.m_c, backend="halo",
                  n_shards=ns, halo_inner="cuda", **opts)
        need = path_kernels(p1)
        f, u, launches = run_main(ph, state, f"halo {label}", need)
        f1, u1, launches1 = run_main(p1, state, f"one-device {label}", need)
        if launches != launches1:
            raise AssertionError(f"halo {label}: launches {launches}, the "
                                 f"one-device plan's {launches1}")
        err = max(assert_scale_close(f, f1, f"halo {label} forces"),
                  assert_scale_close(u, u1, f"halo {label} potential"))
        if label == "dense":
            dense = (f, u)
        elif label == "sfc":
            sfc_case = (ph, (f1, u1))
        elif label in ("compact", "packed_compact"):
            assert_equal_results((f, u), dense, f"halo {label} vs dense")
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        out["paths"][label] = dict(
            m_c=ph.m_c, shard_cap=ph.shard_cap, max_active=ph.max_active,
            row_cap=ph.row_cap, pair_cap=ph.pair_cap, box=ph.box,
            launches=launches, scale_rel_err_vs_one_device=err,
            halo_ms=cuda_ms_queued(lambda: ph.execute(state), 10),
            one_device_ms=cuda_ms_queued(lambda: p1.execute(state), 10),
            kernel_check=check_halo_shards(ph, state, label))
        log(f"halo {label}: " + json.dumps(out["paths"][label]))
    out["launches"] = launches_all

    # the cost of the halo: launch calls, partition, ghost exchange
    pd = plan(dom64, kern, positions=pos_u, m_c=out["paths"]["dense"]["m_c"],
              backend="halo", n_shards=ns, strategy="xpencil")
    p1 = plan(dom64, kern, positions=pos_u, strategy="xpencil")
    b1 = p1.bin(state)
    out["one_device_kernel_b_ms"] = cuda_ms_queued(lambda: xpencil_forces(
        b1.planes, b1.slot_id, nx=dom64.nx, m_c=b1.m_c, kernel=kern,
        cutoff2=1.0), 10)
    out["launch_calls"] = launches_in_turns(
        {"halo execute()": lambda: pd.execute(state),
         "one-device execute()": lambda: p1.execute(state)}, 3, 3)
    out["partition_ms"] = cuda_ms_queued(lambda: H.partition_by_shard(
        dom64, pos_u[None], None, ns, pd.shard_cap), 10)
    bins, inner = halo_impl(pd).layout(ParticleState(pos_u[None]))
    nz_loc, lz_loc = dom64.nz // ns, dom64.box[2] / ns

    def exchange_dense():
        for name, plane in bins.planes.items():
            H.exchange_halo(plane.unflatten(0, (1, ns)), n_shards=ns,
                            nz_loc=nz_loc, periodic_z=False, fill=EMPTY_POS,
                            coord_shift=lz_loc if name == "z" else 0.0)
        H.exchange_halo(bins.slot_id.unflatten(0, (1, ns)), n_shards=ns,
                        nz_loc=nz_loc, periodic_z=False, fill=-1)
    # each of the 4 planes: 2 boundary planes a shard read, 2 ghost planes
    # written
    plane_bytes = bins.slot_id[0, 0].numel() * 4
    out["exchange_bytes"] = 4 * 4 * ns * plane_bytes
    out["exchange_ms"] = cuda_ms_queued(exchange_dense, 10)
    out["exchange_bound_ms"] = out["exchange_bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"halo costs: launch calls {out['launch_calls']}, partition "
        f"{out['partition_ms']:.6f} ms, B one-device "
        f"{out['one_device_kernel_b_ms']:.6f} ms, exchange of the dense "
        f"planes {out['exchange_ms']:.6f} ms ({out['exchange_bytes']} B, "
        f"bound {out['exchange_bound_ms']:.6f} ms)")

    # periodic Z: the ring wraps
    g = torch.Generator(device=dev)
    g.manual_seed(seed * 1_000_003 + 24_024)
    division, ppc, counts = HALO_PERIODIC
    dom = Domain.cubic(division, cutoff=1.0, periodic=True)
    pos = dom.sample_uniform(division ** 3 * ppc, generator=g, device=dev)
    st = ParticleState(pos)
    p1 = plan(dom, kern, positions=pos, strategy="xpencil")
    f1, u1, _ = run_main(p1, st, "one-device periodic", path_kernels(p1))
    out["periodic"] = {}
    for n_sh in counts:
        ph = plan(dom, kern, positions=pos, m_c=p1.m_c, backend="halo",
                  n_shards=n_sh, strategy="xpencil")
        f, u, launches = run_main(ph, st, f"halo periodic {n_sh}",
                                  path_kernels(p1))
        out["periodic"][n_sh] = dict(
            launches=launches, scale_rel_err_vs_one_device=max(
                assert_scale_close(f, f1, f"halo periodic {n_sh} forces"),
                assert_scale_close(u, u1, f"halo periodic {n_sh} pot")),
            halo_ms=cuda_ms_queued(lambda: ph.execute(st), 10))
    out["periodic_one_device_ms"] = cuda_ms_queued(lambda: p1.execute(st), 10)

    # a batch of systems, each cut into shards: B * S systems in one chain
    n_sys, division, ppc = HALO_BATCH
    dom = Domain.cubic(division, cutoff=1.0)
    pos = torch.stack([dom.sample_uniform(division ** 3 * ppc, generator=g,
                                          device=dev) for _ in range(n_sys)])
    each = [ParticleState(pos[i]) for i in range(n_sys)]
    pb = plan(dom, kern, positions=pos[0], backend="halo", n_shards=ns,
              strategy="xpencil")
    for st in each:
        while pb.check_overflow(st):
            pb = pb.replan(st)
    reset_launches()
    fb, ub = pb.execute_batch(ParticleState(pos))
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != {"prefix_sum": 1, "xpencil_forces": 1}:
        raise AssertionError(f"halo batch: launches {launches}")
    for i, st in enumerate(each):
        assert_equal_results((fb[i], ub[i]), pb.execute(st),
                             f"halo batch system {i} vs execute()")
    out["batch"] = dict(systems=n_sys, division=division,
                        n=division ** 3 * ppc, launches=launches,
                        batch_ms=cuda_ms_queued(lambda: pb.execute_batch(
                            ParticleState(pos)), 10),
                        loop_ms=cuda_ms_queued(lambda: [pb.execute(st)
                                                        for st in each], 10))

    # a lost shard: elastic shrink to the survivors, on the card
    with chaos.inject(chaos.FaultSpec("dist.exchange", "shard_loss",
                                      max_fires=1)):
        (f, u), report = pd.execute_checked(state)
    if not (report.shard_shrinks == 1 and report.plan.n_shards == 2
            and report.status == "ok"):
        raise AssertionError(f"halo shard loss: {report}")
    assert_equal_results((f, u), report.plan.execute(state),
                         "halo shrink vs its survivor plan")
    out["shard_loss"] = dict(
        n_shards_after=report.plan.n_shards, faults=report.faults,
        scale_rel_err_vs_dense_halo=assert_scale_close(f, dense[0],
                                                       "halo shrink"))
    # the sfc plan's shrink: 2 slabs each hold about twice the cluster
    # pairs, so the survivor re-measures its per-shard pair_cap
    ps, (fs1, us1) = sfc_case
    with chaos.inject(chaos.FaultSpec("dist.exchange", "shard_loss",
                                      max_fires=1)):
        (f, u), report = ps.execute_checked(state)
    q = report.plan
    need = max(shard_sfc_pairs(dom64, cell_counts(dom64, pos_u), q.n_shards))
    if not (report.shard_shrinks == 1 and q.n_shards == 2
            and report.status == "ok" and q.pair_cap >= need):
        raise AssertionError(f"halo sfc shard loss: pair_cap {q.pair_cap}, "
                             f"{need} pairs needed; {report}")
    out["shard_loss_sfc"] = dict(
        n_shards_after=q.n_shards, pair_cap_before=ps.pair_cap,
        pair_cap_after=q.pair_cap, pairs_needed=need,
        scale_rel_err_vs_one_device=max(
            assert_scale_close(f, fs1, "halo sfc shrink forces"),
            assert_scale_close(u, us1, "halo sfc shrink potential")))
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _loop(step, md, n: int, dt: float):
    for _ in range(n):
        md = step(md, dt)
    return md


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2

    from repro_torch.core import (Domain, ParticleState, active_unit_count,
                                  cell_counts, full_pencil_occupancy,
                                  make_gravity, make_high_flop,
                                  make_lennard_jones, make_low_flop,
                                  make_sph_density, n_units, pack_rows,
                                  padded_row_counts, pencil_occupancy, plan,
                                  scenarios, suggest_m_c, suggest_row_cap)
    from repro_torch.core import prefix as plain_prefix
    from repro_torch.core import strategies as S
    from repro_torch.core.binning import (bin_particles, build_sfc_clusters,
                                          dense_to_particles,
                                          packed_to_particles, scatter_rows,
                                          sfc_device_slot_tables,
                                          sfc_n_clusters, sfc_pair_count,
                                          sfc_to_particles, system)
    from repro_torch.core.interactions import PairKernel
    from repro_torch.kernels import _build
    from repro_torch.core.binning import pack_slots_plain
    from repro_torch.kernels.allin import (allin_forces, allin_threads,
                                           halo_bytes)
    from repro_torch.kernels.pack import pack_slots
    from repro_torch.kernels.ops import (xpencil_interactions,
                                         xpencil_packed_interactions,
                                         xpencil_sparse_interactions)
    from repro_torch.kernels.prefix_sum import prefix_sum
    from repro_torch.kernels.sfc import cell_sfc_forces
    from repro_torch.kernels.window_attn import (window_attention,
                                                 window_attention_bwd)
    from repro_torch.kernels.xpencil import (MAX_SMEM, MAX_TILE_ROWS,
                                             chunk_cells, packed_smem_bytes,
                                             packed_tile_rows,
                                             pencil_smem_bytes,
                                             xpencil_forces,
                                             xpencil_packed_forces,
                                             xpencil_sparse_forces)

    wrappers = {"prefix_sum": prefix_sum, "pack_slots": pack_slots,
                "xpencil_forces": xpencil_forces,
                "xpencil_sparse_forces": xpencil_sparse_forces,
                "xpencil_packed_forces": xpencil_packed_forces,
                "allin_forces": allin_forces,
                "cell_sfc_forces": cell_sfc_forces,
                "window_attention": window_attention,
                "window_attention_bwd": window_attention_bwd}
    t_start = time.perf_counter()
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
    # every plain version and reference on the card: fp32 matmuls in full
    # fp32 (no TF32) and bf16 GEMMs without reduced-precision reductions;
    # torch's defaults are kept for the one comparison run under them
    precision_defaults = precision_flags()
    set_precision_flags(dict.fromkeys(precision_defaults, False))
    log(f"precision flags: {precision_flags()} (torch's defaults: "
        f"{precision_defaults})")

    # -- build ---------------------------------------------------------------
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {nvcc.strip().splitlines()[-1]}; all sources in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def plain(bins, nx, kern):
        """The plain X-pencil (kernel B's plain version) on ``bins``."""
        return S.xpencil_planes(bins.planes["x"], bins.planes["y"],
                                bins.planes["z"], bins.slot_id, nx=nx,
                                m_c=bins.m_c, kernel=kern, cutoff2=1.0)

    def size_kernels(kern):
        """Pair kernels whose potential channel sums, per target, the size
        of each pair term: |coeff| * r bounds every force component's term,
        |potential| the potential's."""
        return tuple(PairKernel(f"{kern.name}_{part}_term_size",
                                torch.zeros_like, f, flops=0)
                     for part, f in (("force", lambda r2: kern.coeff(r2).abs()
                                      * r2.sqrt()),
                                     ("potential",
                                      lambda r2: kern.potential(r2).abs())))

    def check_kernel(what, name, kern, launch, plain_of):
        """A kernel's outputs ``launch(kern)`` against its plain version
        ``plain_of(kern)``: every element within 1e-4 of |want| plus its
        own term sizes; low_flop also within rtol = atol = 1e-4 and the
        others scale-relative (3e-4). -> (kernel outputs, plain outputs,
        plain ms, term sizes, max abs error, max term-relative error)."""
        got = launch(kern)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain_of(kern)
        end.record()
        end.synchronize()
        fsize, usize = (plain_of(k)[3] for k in size_kernels(kern))
        abs_err = term_err = 0.0
        for g, w, part in zip(got, want, ("fx", "fy", "fz", "pot")):
            label = f"{what} {name} {part}"
            size = usize if part == "pot" else fsize
            term_err = max(term_err, assert_term_close(g, w, size, label,
                                                       1e-4))
            if name == "low_flop":
                if not torch.allclose(g, w, rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"{label}: not within 1e-4")
            else:
                assert_scale_close(g, w, label)
            abs_err = max(abs_err, float((g - w).abs().max()))
        return (got, want, start.elapsed_time(end), (fsize, usize), abs_err,
                term_err)

    def check_kernel_b(bins, nx, name, kern, label):
        return check_kernel(
            f"xpencil {label}", name, kern,
            lambda k: xpencil_forces(bins.planes, bins.slot_id, nx=nx,
                                     m_c=bins.m_c, kernel=k, cutoff2=1.0),
            lambda k: plain(bins, nx, k))

    def check_kernel_e(bins, box, name, kern, label):
        return check_kernel(
            f"allin box {box} {label}", name, kern,
            lambda k: allin_forces(bins.planes, bins.slot_id, box=box,
                                   m_c=bins.m_c, kernel=k, cutoff2=1.0),
            lambda k: S.allin_planes(bins.planes["x"], bins.planes["y"],
                                     bins.planes["z"], bins.slot_id, box=box,
                                     m_c=bins.m_c, kernel=k, cutoff2=1.0))

    def check_kernel_c(dom, bins, active, name, kern, label):
        nx, ny, _ = dom.ncells
        return check_kernel(
            f"xpencil_sparse {label}", name, kern,
            lambda k: xpencil_sparse_forces(bins.planes, bins.slot_id,
                                            active, nx=nx, ny=ny,
                                            m_c=bins.m_c, kernel=k,
                                            cutoff2=1.0),
            lambda k: S.xpencil_sparse_planes(
                bins.planes["x"], bins.planes["y"], bins.planes["z"],
                bins.slot_id, active, nx=nx, ny=ny, m_c=bins.m_c, kernel=k,
                cutoff2=1.0))

    def check_kernel_d(dom, packed, active, name, kern, label):
        """``active`` None: every row, as the main path launches it."""
        nx, ny, _ = dom.ncells
        args = (packed.planes, packed.slot_id, packed.slot_cell,
                packed.cell_offsets)
        rows = (full_pencil_occupancy(dom, dev).active.expand(
            *packed.slot_id.shape[:-3], -1) if active is None else active)
        return check_kernel(
            f"xpencil_packed {label}", name, kern,
            lambda k: xpencil_packed_forces(*args, active, nx=nx, ny=ny,
                                            m_c=packed.m_c, kernel=k,
                                            cutoff2=1.0),
            lambda k: S.xpencil_packed_planes(
                packed.planes["x"], packed.planes["y"], packed.planes["z"],
                *args[1:], rows, nx=nx, ny=ny, m_c=packed.m_c, kernel=k,
                cutoff2=1.0))

    def sfc_tiles(dom, bins, sfc, kern, plain=False):
        """Kernel F, or its plain version, over the pair list ``sfc``."""
        tgt, src = sfc_device_slot_tables(dom, bins.m_c, sfc.csize, sfc.curve,
                                          dev)
        if plain:
            return S.cell_sfc_tiles(
                bins.planes["x"], bins.planes["y"], bins.planes["z"],
                bins.slot_id, sfc.codes, tgt, src, m_c=bins.m_c, kernel=kern,
                cutoff2=1.0, batch_size=SFC_PLAIN_BATCH)
        return cell_sfc_forces(bins.planes, bins.slot_id, sfc.codes, tgt, src,
                               m_c=bins.m_c, kernel=kern, cutoff2=1.0)

    def check_kernel_f(dom, bins, sfc, name, kern, label):
        return check_kernel(
            f"cell_sfc csize {sfc.csize} {sfc.curve} {label}", name, kern,
            lambda k: sfc_tiles(dom, bins, sfc, k),
            lambda k: sfc_tiles(dom, bins, sfc, k, plain=True))

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0
        for w in (window_attention, window_attention_bwd):
            w.launches_by_route = dict.fromkeys(w.launches_by_route, 0)

    def launch_counts():
        return {n: w.launches for n, w in wrappers.items() if w.launches}

    def assert_equal_results(got, want, what):
        """Per particle (forces, potential) or per slot (fx, fy, fz, pot)."""
        parts = (("forces", "potential") if len(got) == 2
                 else ("fx", "fy", "fz", "pot"))
        for g, w, part in zip(got, want, parts):
            if not torch.equal(g, w):
                d = (g - w).abs().max()
                raise AssertionError(f"{what}: {part} not bit-equal "
                                     f"(max |diff| {float(d):.3e})")

    def chunk_sweep(what, launch, want, nx, m_c, reps=10):
        """Kernel B or C (``launch(cx_cells=...)``) at its policy's chunk
        width and at CHUNK_WIDTHS, each timed and each bit-equal to
        ``want``. -> {width: ms}"""
        widths = sorted({chunk_cells(nx, m_c)} | {
            w for w in CHUNK_WIDTHS
            if w <= nx and pencil_smem_bytes(w, m_c) <= MAX_SMEM})
        by_width = {}
        for w in widths:
            assert_equal_results(launch(cx_cells=w), want,
                                 f"{what} at chunk width {w} vs default")
            by_width[w] = cuda_ms(lambda: launch(cx_cells=w), reps)
        return by_width

    def threads_sweep(what, launch, want, reps=10):
        """Kernel E (``launch(threads=...)``) at ALLIN_THREADS, each
        bit-equal to ``want`` and timed in turns (ascending, then
        descending). -> {threads: mean ms}"""
        times = {t: [] for t in ALLIN_THREADS}
        for t in ALLIN_THREADS:
            assert_equal_results(launch(threads=t), want,
                                 f"{what} at {t} threads vs default")
        for t in ALLIN_THREADS + ALLIN_THREADS[::-1]:
            times[t].append(cuda_ms(lambda: launch(threads=t), reps))
        return {t: statistics.mean(v) for t, v in times.items()}

    def tile_sweep(what, launch, want, row_cap, reps=10):
        """Kernel D (``launch(tile_rows=...)``) at every tile of pencils
        that fits, each bit-equal to ``want`` and timed per call and back
        to back. -> ({tile_rows: ms}, {tile_rows: queued ms})"""
        times, queued = {}, {}
        for r in range(MAX_TILE_ROWS + 1):
            if packed_smem_bytes(r, row_cap) > MAX_SMEM:
                continue
            run = (lambda: launch(tile_rows=r))
            assert_equal_results(run(), want, f"{what} at tile_rows {r} vs "
                                 f"default")
            times[r] = cuda_ms(run, reps)
            queued[r] = cuda_ms_queued(run, 2 * reps)
        return times, queued

    def in_turns(fns, reps=10):
        """Each call of ``fns`` (name -> call) timed per call and back to
        back, in turns (in order, then reversed). -> ({name: mean ms},
        {name: mean queued ms})"""
        per, queued = {n: [] for n in fns}, {n: [] for n in fns}
        for n in [*fns, *reversed(fns)]:
            per[n].append(cuda_ms(fns[n], reps))
            queued[n].append(cuda_ms_queued(fns[n], reps))
        return ({n: statistics.mean(v) for n, v in per.items()},
                {n: statistics.mean(v) for n, v in queued.items()})

    PACK_OUTPUTS = ("slot_id", "slot_cell", "cell_offsets", "row_counts",
                    "particle_slot")

    def check_pack(dom, bins, row_cap, what):
        """The pack kernel (all of ``pack_rows``) against its plain version
        on ``bins``: every output torch.equal. -> (max |diff|, launch,
        plain launch)"""
        kw = dict(nx=dom.nx, ny=dom.ny, row_cap=row_cap)
        launch = (lambda: pack_slots(bins, **kw))
        plain_of = (lambda: pack_slots_plain(bins, **kw))
        got, want = launch(), plain_of()
        names = [*want[0], *PACK_OUTPUTS]
        err = 0.0
        for g, w, name in zip([*got[0].values(), *got[1:]],
                              [*want[0].values(), *want[1:]], names,
                              strict=True):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"pack kernel {what}: {name} differs "
                                     f"from its plain version")
            err = max(err, float((g.double() - w.double()).abs().max()))
        return err, launch, plain_of

    def pack_device_ms(fn, reps=5):
        """Device ms a call of the pack kernel's two grids in ``fn()`` (a
        packed ``execute()``), from ``torch.profiler``'s records on the
        card; None where the profile holds none of them."""
        _, _, kernels = device_kernels(profile_calls(fn, reps), reps)
        ms = [m for k, m in kernels
              if "pack_rows_kernel" in k or "pack_particles_kernel" in k]
        return sum(ms) if ms else None

    def pack_bound(bins, row_cap):
        """(bound ms, "bytes") of ``pack_rows``: the dense slot ids (each
        slot looked at once, to count like JAX), the fields of the slots it
        moves and the dense particle slots read once; the packed planes,
        ids, cells, the cell offsets (nx + 3 a row), the row counts and the
        packed particle slots written once."""
        sid = bins.slot_id
        nzp, nyp, width = sid.shape[-3:]
        n_rows = sid.numel() // width
        moved = int(torch.clamp((sid >= 0).sum(-1), max=row_cap).sum())
        n, n_f = bins.particle_slot.numel(), len(bins.planes)
        n_bytes = (4 * sid.numel() + 4 * n_f * moved + 8 * n
                   + 4 * (n_f + 2) * n_rows * row_cap
                   + 4 * n_rows * (width // bins.m_c + 1) + 4 * n_rows)
        return bound(n_bytes, 0)

    # -- kernel A: the paper's scan, exactly equal to its plain versions ----
    # the long and the repeated scans draw from a generator of their own,
    # so every later phase draws the data it drew before
    reuse_gen = torch.Generator(device=dev)
    reuse_gen.manual_seed(args.seed + 1)
    scan_checks = 0
    for n in (*SCAN_SIZES, SCAN_LONG_N):
        x = torch.randint(0, 10, (n,), device=dev, dtype=torch.int32,
                          generator=gen if n != SCAN_LONG_N else reuse_gen)
        got = prefix_sum(x)
        torch.cuda.synchronize()
        wants = [("torch.cumsum", torch.cumsum(x, 0, dtype=torch.int32)),
                 ("tiled_prefix_sum", plain_prefix.tiled_prefix_sum(x, 1024))]
        if n != SCAN_LONG_N:
            wants.append(("paper_prefix_sum",
                          plain_prefix.paper_prefix_sum(x)))
        for name, want in wants:
            if not torch.equal(got, want):
                raise AssertionError(f"scan n={n} differs from {name}")
            scan_checks += 1
    # consecutive calls on one stream's status buffer, lengths up and down
    reuse_sizes = [SCAN_TIMED_N, 5000, SCAN_LONG_N, 1, 70_001]
    for i in range(SCAN_REUSED_CALLS):
        x = torch.randint(-50, 50, (reuse_sizes[i % len(reuse_sizes)],),
                          generator=reuse_gen, device=dev, dtype=torch.int32)
        if not torch.equal(prefix_sum(x), torch.cumsum(x, 0,
                                                       dtype=torch.int32)):
            raise AssertionError(f"scan call {i} of {SCAN_REUSED_CALLS} on "
                                 f"one buffer differs from torch.cumsum")
        scan_checks += 1
    x = torch.randint(0, 10, (SCAN_TIMED_N,), generator=gen, device=dev,
                      dtype=torch.int32)
    # kernel and torch.cumsum measured the same way, in turns
    turns = {"A": [], "cumsum": []}
    for which in ("A", "cumsum", "cumsum", "A"):
        turns[which].append(cuda_ms(
            (lambda: prefix_sum(x)) if which == "A" else
            (lambda: torch.cumsum(x, 0, dtype=torch.int32)), reps=200))
    scan_ms, cumsum_ms = (statistics.mean(turns[k]) for k in ("A", "cumsum"))
    scan_plain_ms = cuda_ms(lambda: plain_prefix.paper_prefix_sum(x),
                            reps=20)
    # the process's first profiler session can miss a launch while the
    # card's tracing starts: open one before any launch is counted
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    scan_prof = launches_in_turns(
        {"A": lambda: prefix_sum(x),
         "cumsum": lambda: torch.cumsum(x, 0, dtype=torch.int32)},
        reps=20, sessions=3)
    (scan_dev_ms, scan_launches), (cumsum_dev_ms, cumsum_launches) = (
        (scan_prof[k]["device_ms"], scan_prof[k]["launches"])
        for k in ("A", "cumsum"))
    if scan_launches != 1:
        raise AssertionError(f"kernel A: {scan_launches} device launches per "
                             f"call under the profiler, want 1")
    scan_bound_ms = 1e3 * max(8 * SCAN_TIMED_N / HBM_BYTES_PER_S,
                              SCAN_TIMED_N / F32_OPS_PER_S)
    log(f"scan: exact at n={[*SCAN_SIZES, SCAN_LONG_N]} and over "
        f"{SCAN_REUSED_CALLS} calls on one buffer ({scan_checks} checks); "
        f"n={SCAN_TIMED_N}: kernel {scan_ms:.4f} ms (turns {turns['A']}), "
        f"torch.cumsum {cumsum_ms:.4f} ms (turns {turns['cumsum']}); device "
        f"time kernel {scan_dev_ms:.5f} ms in {scan_launches:g} launch(es), "
        f"torch.cumsum {cumsum_dev_ms:.5f} ms in {cumsum_launches:g}; plain "
        f"{scan_plain_ms:.4f} ms, bound {scan_bound_ms:.5f} ms")

    # -- kernels B, C, D against their plain versions; bit identity --------
    kernels = {"lennard_jones": make_lennard_jones(),
               "low_flop": make_low_flop(), "high_flop": make_high_flop(),
               "gravity": make_gravity(), "sph_density": make_sph_density(1.0)}
    xp_checks = sp_checks = pk_checks = ident_checks = al_checks = 0
    sfc_checks = sfc_ident_checks = pack_checks = 0
    div = CHECK_DIVISION
    for periodic in (False, True):
        dom = Domain.cubic(div, cutoff=1.0, periodic=periodic)
        label = f"div {div} periodic={periodic}"
        pos = dom.sample_uniform(div ** 3 * 4, generator=gen, device=dev)
        bins = bin_particles(dom, pos, m_c=24)
        packed = pack_rows(dom, bins, suggest_row_cap(dom, pos))
        # the same particles squeezed into the lower half in y: half of the
        # pencils are empty, so half of kernel C's list is padding
        half = pos * torch.tensor([1.0, 0.5, 1.0], device=dev)
        hbins = bin_particles(dom, half, m_c=suggest_m_c(dom, half))
        hocc = pencil_occupancy(dom, hbins.counts, div * div)
        if int(hocc.n_active) != div * div // 2:
            raise AssertionError(f"{int(hocc.n_active)} active pencils, "
                                 f"want {div * div // 2}")
        hpacked = pack_rows(dom, hbins, suggest_row_cap(dom, half))
        for b_, cap, what in ((bins, packed.row_cap, label),
                              (hbins, hpacked.row_cap, f"{label} half-empty"),
                              (bins, packed.row_cap // 2,
                               f"{label} row_cap overflow")):
            check_pack(dom, b_, cap, what)
            pack_checks += 1
        # kernel E at the plan's sub-box (within 48 KB of shared memory) and
        # at one past 48 KB, which needs the opt-in
        boxes = (S.shrink_to_divisors(dom, S.subbox_dims(dom, 24)), (4, 4, 2))
        if halo_bytes(boxes[0], 24) > 48 * 1024 or \
                halo_bytes(boxes[1], 24) <= 48 * 1024:
            raise AssertionError(f"boxes {boxes} do not straddle 48 KB")
        for name, kern in kernels.items():
            b_planes = check_kernel_b(bins, div, name, kern, label)[0]
            xp_checks += 4
            for box in boxes:
                e_planes = check_kernel_e(bins, box, name, kern, label)[0]
                al_checks += 4
                assert_equal_results(e_planes, b_planes, f"kernel E box "
                                     f"{box} vs B, {name} {label}")
                ident_checks += 1
            c_out = check_kernel_c(dom, hbins, hocc.active, name, kern,
                                   f"{label} half-empty")[0]
            b_out = xpencil_forces(hbins.planes, hbins.slot_id, nx=div,
                                   m_c=hbins.m_c, kernel=kern, cutoff2=1.0)
            rows = hocc.active.long()
            for c, b in zip(c_out, b_out):       # padding rows are pencil 0
                if not torch.equal(c, b.reshape(div * div, -1)[rows]):
                    raise AssertionError(f"kernel C rows differ from kernel "
                                         f"B's: {name} {label}")
            sp_checks += 5
            check_kernel_d(dom, packed, None, name, kern, label)
            check_kernel_d(dom, hpacked, hocc.active, name, kern,
                           f"{label} half-empty")
            pk_checks += 8
            # kernel F at two clusterings; per particle its bits do not
            # depend on the curve, csize or pair_cap
            f_runs = []
            for csize, curve in (*SFC_CLUSTERINGS, (1, "morton")):
                n_pairs = sfc_pair_count(dom, counts=bins.counts, csize=csize,
                                         curve=curve)
                for cap in (n_pairs, sfc_n_clusters(dom, csize) * 27):
                    sfc = build_sfc_clusters(dom, bins, cap, csize, curve)
                    if (csize, curve) in SFC_CLUSTERINGS and cap == n_pairs:
                        tiles = check_kernel_f(dom, bins, sfc, name, kern,
                                               label)[0]
                        sfc_checks += 4
                    else:
                        tiles = sfc_tiles(dom, bins, sfc, kern)
                    f_runs.append(sfc_to_particles(dom, sfc, *tiles))
            for run in f_runs[1:]:
                assert_equal_results(run, f_runs[0], f"kernel F clusterings, "
                                     f"{name} {label}")
                sfc_ident_checks += 1
            # per particle, on the card: B = C = D = D over active rows
            for b_, p_, occ_max in ((bins, packed, div * div),
                                    (hbins, hpacked, div * div)):
                want = xpencil_interactions(dom, b_, kern)
                for what, got in (
                        ("C", xpencil_sparse_interactions(dom, b_, kern,
                                                          occ_max)),
                        ("D", xpencil_packed_interactions(dom, p_, kern)),
                        ("D compact", xpencil_packed_interactions(
                            dom, p_, kern, occ_max))):
                    assert_equal_results(got, want, f"kernel {what} vs B, "
                                         f"{name} {label}")
                    ident_checks += 1
    log(f"kernels B, C, D, E: 5 pair kernels x open/periodic at division "
        f"{div}, within tolerance of their plain versions ({xp_checks} + "
        f"{sp_checks} + {pk_checks} + {al_checks} checks; E at boxes "
        f"{list(boxes)}); C and D per particle (every row and active rows) "
        f"and E per slot equal B bit for bit ({ident_checks} checks)")
    log(f"pack kernel: open/periodic at division {div}, uniform, half-empty "
        f"and an overflowing row_cap, every output torch.equal to the plain "
        f"version ({pack_checks} checks)")
    log(f"kernel F: 5 pair kernels x open/periodic at division {div}, "
        f"(csize, curve) {list(SFC_CLUSTERINGS)}, within tolerance of its "
        f"plain version ({sfc_checks} checks); per particle the same bits at "
        f"csize 1, 4, 8, Morton and Hilbert, pair_cap n_pairs and "
        f"n_clusters * 27 ({sfc_ident_checks} checks)")

    # -- plan/execute against the O(N^2) oracle on the card ------------------
    for periodic in (False, True):
        dom = Domain.cubic(8, cutoff=1.0, periodic=periodic)
        pos = dom.sample_uniform(2000, generator=gen, device=dev)
        f, u = plan(dom, positions=pos,
                    strategy="xpencil").execute(ParticleState(pos))
        *nf, nu = S.naive_n2(dom, pos, make_lennard_jones())
        assert_scale_close(f, torch.stack(nf, -1),
                           f"plan vs naive_n2 forces periodic={periodic}")
        assert_scale_close(u, nu, f"plan vs naive_n2 potential "
                           f"periodic={periodic}")
    log("plan(device='cuda').execute() matches naive_n2 at division 8, "
        "2000 particles, open and periodic")

    # -- the other strategies against the O(N^2) oracle at a small size ------
    matrix = []
    for division, periodic, scene in ((12, False, "blob"),
                                      (8, True, "uniform")):
        dom = Domain.cubic(division, cutoff=1.0, periodic=periodic)
        pos = (scenarios.sample_gaussian_blob(dom, 2000, generator=gen,
                                              device=dev, sigma_frac=0.15)
               if scene == "blob" else
               dom.sample_uniform(2000, generator=gen, device=dev))
        state = ParticleState(pos)
        kern = make_lennard_jones()
        *nf, nu = S.naive_n2(dom, pos, kern)
        nf = torch.stack(nf, -1)
        runs = {}
        for name, compact, backend in (
                ("par_part", False, "reference"),
                ("cell_dense", False, "reference"),
                ("cell_dense", True, "reference"),
                ("allin", False, "reference"), ("allin", True, "reference"),
                ("allin", False, "cuda")):
            p = plan(dom, kern, positions=pos, strategy=name,
                     backend=backend, compact=compact)
            f, u = p.execute(state)
            what = (f"{name} compact={compact} {backend} div {division} "
                    f"periodic={periodic}")
            errs = (assert_scale_close(f, nf, f"{what} forces vs naive_n2"),
                    assert_scale_close(u, nu, f"{what} potential vs "
                                       "naive_n2"))
            runs[(name, compact, backend)] = (f, u)
            matrix.append(dict(case=what, box=p.box, max_active=p.max_active,
                               n_units=(n_units(dom, name, box=p.box)
                                        if compact else None),
                               forces_vs_naive=errs[0],
                               potential_vs_naive=errs[1]))
        for name in ("cell_dense", "allin"):
            assert_equal_results(runs[(name, True, "reference")],
                                 runs[(name, False, "reference")],
                                 f"{name} compact vs dense, div {division}")
    log("strategy matrix vs naive_n2 (scale-relative 3e-4; compact = dense "
        "bit for bit for cell_dense and allin): " + json.dumps(matrix))

    def reference_checks(p, state, f, u, what, periodic, also=()):
        """The result of plan ``p`` against the ``"reference"`` backend of
        the same plan, and against each ``(label, (forces, potential))`` of
        ``also``, per particle within 1e-4 of its own term sizes and
        scale-relative 3e-4; net force ~ 0 in an open box. -> (scale errors,
        term errors, pairs within the cutoff)."""
        ref = dataclasses.replace(p, backend="reference")
        rf, ru = ref.execute(state)
        err_f = assert_scale_close(f, rf, f"{what} forces vs reference")
        err_u = assert_scale_close(u, ru, f"{what} potential vs reference")
        fsize, usize = (dataclasses.replace(ref, kernel=k).execute(state)[1]
                        for k in size_kernels(p.kernel))
        term_f = assert_term_close(f, rf, fsize[:, None],
                                   f"{what} forces vs reference", 1e-4)
        term_u = assert_term_close(u, ru, usize,
                                   f"{what} potential vs reference", 1e-4)
        for label, (af, au) in also:
            assert_scale_close(f, af, f"{what} forces vs {label}")
            assert_scale_close(u, au, f"{what} potential vs {label}")
            assert_term_close(f, af, fsize[:, None],
                              f"{what} forces vs {label}", 1e-4)
            assert_term_close(u, au, usize, f"{what} potential vs {label}",
                              1e-4)
        within = int(dataclasses.replace(ref, kernel=PairKernel(
            "pairs_in_cutoff", torch.zeros_like, torch.ones_like,
            flops=0)).execute(state)[1].sum(dtype=torch.float64))
        if not periodic:
            net = float(f.double().sum(0).abs().max())
            total = float(f.double().abs().sum())
            if net > 1e-5 * total:
                raise AssertionError(f"{what}: net force {net:.3e} vs sum "
                                     f"|F| {total:.3e}: antisymmetry broken")
        return (err_f, err_u), (term_f, term_u), within

    def run_main(p, state, what, need):
        """One ``execute()`` with every launch count set to 0 just before
        and read just after; ``need`` names the kernels it must launch."""
        reset_launches()
        f, u = p.execute(state)
        torch.cuda.synchronize()
        launches = launch_counts()
        missing = [k for k in need if not launches.get(k)]
        if missing:
            raise AssertionError(f"{what}: main path did not launch "
                                 f"{missing}: {launches}")
        if not (bool(f.isfinite().all()) and bool(u.isfinite().all())):
            raise AssertionError(f"{what}: non-finite output")
        return f, u, launches

    def sfc_case(dom, kern, pos, state, bins, dense_out, label, periodic,
                 reps=10):
        """Main case (d): ``layout="sfc"`` on a scene whose bins and dense
        X-pencil result ``dense_out`` are given; kernel F against its plain
        version, and F and B timed in turns on the same bins. -> record."""
        ps = plan(dom, kern, positions=pos, strategy="cell_dense",
                  layout="sfc")
        fs, us, launches = run_main(ps, state, f"sfc {label}",
                                    ("prefix_sum", "cell_sfc_forces"))
        if launches["cell_sfc_forces"] != 1 or ps.m_c != bins.m_c:
            raise AssertionError(f"sfc {label}: {launches}, m_c {ps.m_c} vs "
                                 f"{bins.m_c}")
        errs, terms, within = reference_checks(
            dataclasses.replace(ps, batch_size=SFC_PLAIN_BATCH), state, fs, us,
            f"sfc {label}", periodic, also=[("dense X-pencil path",
                                             dense_out)])
        sfc = ps.clusters(bins)
        if bool(sfc.overflowed):
            raise AssertionError(f"sfc {label}: pair list overflowed")
        kf, _, plain_ms, _, abs_err, term_err = check_kernel_f(
            dom, bins, sfc, "lennard_jones", kern, label)
        turns = {"B": [], "F": []}
        for which in ("B", "F", "F", "B"):        # in turns on the same bins
            turns[which].append(cuda_ms(
                (lambda: xpencil_forces(bins.planes, bins.slot_id, nx=dom.nx,
                                        m_c=bins.m_c, kernel=kern,
                                        cutoff2=1.0)) if which == "B" else
                (lambda: sfc_tiles(dom, bins, sfc, kern)), reps))
        b_ms, f_ms = (statistics.mean(turns[k]) for k in ("B", "F"))
        f_low_ms = cuda_ms(lambda: sfc_tiles(dom, bins, sfc,
                                             kernels["low_flop"]), reps)
        # pair steps: every real target against the real sources of its
        # kept slabs, itself included; a schedule that visits every slot
        # takes m_c steps a slab, each kept code for every real target of
        # its cluster
        tgt, src = sfc_device_slot_tables(dom, bins.m_c, sfc.csize,
                                          sfc.curve, dev)
        visited = slot_pairs_visited(lambda v: cell_sfc_forces(
            bins.planes, bins.slot_id, sfc.codes, tgt, src, m_c=bins.m_c,
            kernel=kern, cutoff2=1.0, visits=v))
        real_pairs = candidate_pairs(dom, bins.counts) + pos.shape[0]
        if visited != real_pairs:
            raise AssertionError(f"kernel F {label}: {visited} pair steps, "
                                 f"want {real_pairs} (real pairs, self "
                                 f"included)")
        kept = torch.bincount((sfc.codes.long() >> 5),
                              minlength=sfc_n_clusters(dom, sfc.csize) + 1)
        every_slot = int((sfc.cluster_counts.long() * kept[:-1]).sum()
                         * bins.m_c)
        f_bound_ms, f_bound_by = bound(
            kernel_f_bytes(dom, bins, sfc),
            candidate_pairs(dom, bins.counts) * DIST_FLOPS
            + within * kern.flops)
        return dict(
            case=f"sfc {label}", n=pos.shape[0], m_c=ps.m_c, csize=sfc.csize,
            curve=sfc.curve, n_clusters=sfc_n_clusters(dom, sfc.csize),
            pair_cap=ps.pair_cap, n_pairs=int(sfc.n_pairs),
            launches=launches,
            execute_ms=cuda_ms(lambda: ps.execute(state), reps),
            pair_list_ms=cuda_ms(lambda: ps.clusters(bins), reps),
            kernel_f_ms=f_ms, kernel_f_ms_turns=turns["F"],
            kernel_b_ms=b_ms, kernel_b_ms_turns=turns["B"],
            f_over_b=f_ms / b_ms, kernel_f_low_flop_ms=f_low_ms,
            kernel_f_pair_steps=visited,
            kernel_f_every_slot_steps_from_bins=every_slot,
            to_particles_ms=cuda_ms(lambda: sfc_to_particles(dom, sfc, *kf),
                                    reps),
            kernel_f_plain_ms=plain_ms, kernel_f_bound_ms=f_bound_ms,
            kernel_f_bound_by=f_bound_by,
            candidate_pairs_from_bins=candidate_pairs(dom, bins.counts),
            pairs_in_cutoff=within, kernel_f_max_abs_err=abs_err,
            kernel_f_term_rel_err=term_err, forces_vs_reference=errs[0],
            potential_vs_reference=errs[1], forces_term_rel_err=terms[0],
            potential_term_rel_err=terms[1])

    # -- the dense main path at full size -------------------------------------
    results = []
    sfc_results = []
    for division, ppc, periodic in DENSE_CASES:
        dom = Domain.cubic(division, cutoff=1.0, periodic=periodic)
        n = division ** 3 * ppc
        kern = make_lennard_jones()
        pos = dom.sample_uniform(n, generator=gen, device=dev)
        state = ParticleState(pos)
        p = plan(dom, kern, positions=pos, strategy="xpencil")
        label = f"div {division} periodic={periodic}"
        f, u, launches = run_main(p, state, f"dense {label}",
                                  ("prefix_sum", "xpencil_forces"))

        # kernel B against its plain version on the main path's bins: LJ
        # (the main path's kernel) and three more pair kernels
        bins = p.bin(state)
        kb, _, xp_plain_ms, (fsize, usize), xp_abs_err, xp_term_err = \
            check_kernel_b(bins, division, "lennard_jones", kern, label)
        for name in ("low_flop", "gravity", "sph_density"):
            check_kernel_b(bins, division, name, kernels[name], label)
            xp_checks += 4
        xp_checks += 4
        (err_f, err_u), (term_f, term_u), within = reference_checks(
            p, state, f, u, f"dense {label}", periodic)

        # main case (c): All-in-SM on the same particles, kernel E
        pe = plan(dom, kern, positions=pos, strategy="allin")
        fe, ue, launches_e = run_main(pe, state, f"allin {label}",
                                      ("prefix_sum", "allin_forces"))
        if launches_e["allin_forces"] != 1 or pe.m_c != p.m_c:
            raise AssertionError(f"allin {label}: {launches_e}, m_c "
                                 f"{pe.m_c} vs {p.m_c}")
        assert_equal_results((fe, ue), (f, u),
                             f"allin (kernel E) vs dense X-pencil, {label}")
        ke, _, e_plain_ms, _, e_abs_err, e_term_err = check_kernel_e(
            bins, pe.box, "lennard_jones", kern, label)
        al_checks += 4
        assert_equal_results(ke, kb, f"kernel E vs B planes, {label}")
        ident_checks += 1

        reps = 10
        execute_ms = cuda_ms(lambda: p.execute(state), reps)
        allin_execute_ms = cuda_ms(lambda: pe.execute(state), reps)
        bin_ms = cuda_ms(lambda: p.bin(state), reps)
        counts = bins.counts
        a_ms = cuda_ms(lambda: prefix_sum(counts), 50)
        # B and E in turns on the same bins: B, E, E, B
        turns = {"B": [], "E": []}
        for which in ("B", "E", "E", "B"):
            turns[which].append(cuda_ms(
                (lambda: xpencil_forces(bins.planes, bins.slot_id,
                                        nx=division, m_c=p.m_c, kernel=kern,
                                        cutoff2=1.0)) if which == "B" else
                (lambda: allin_forces(bins.planes, bins.slot_id, box=pe.box,
                                      m_c=p.m_c, kernel=kern, cutoff2=1.0)),
                reps))
        b_ms, e_ms = (statistics.mean(turns[k]) for k in ("B", "E"))
        scatter_ms = cuda_ms(lambda: dense_to_particles(dom, bins, *kb),
                             reps)
        b_by_width = chunk_sweep(
            f"kernel B {label}", lambda **kw: xpencil_forces(
                bins.planes, bins.slot_id, nx=division, m_c=p.m_c,
                kernel=kern, cutoff2=1.0, **kw), kb, division, p.m_c, reps)
        # the same launch with the cheapest pair kernel: what the staging,
        # the compaction and the barriers cost without LJ's arithmetic
        b_low_ms = cuda_ms(lambda: xpencil_forces(
            bins.planes, bins.slot_id, nx=division, m_c=p.m_c,
            kernel=kernels["low_flop"], cutoff2=1.0), reps)
        e_low_ms = cuda_ms(lambda: allin_forces(
            bins.planes, bins.slot_id, box=pe.box, m_c=p.m_c,
            kernel=kernels["low_flop"], cutoff2=1.0), reps)
        e_by_threads = threads_sweep(
            f"kernel E {label}", lambda **kw: allin_forces(
                bins.planes, bins.slot_id, box=pe.box, m_c=p.m_c,
                kernel=kern, cutoff2=1.0, **kw), ke, reps)
        e_visited = slot_pairs_visited(lambda v: allin_forces(
            bins.planes, bins.slot_id, box=pe.box, m_c=p.m_c, kernel=kern,
            cutoff2=1.0, visits=v))

        out_slots = kb[0].numel()
        pairs = candidate_pairs(dom, counts)
        if e_visited != pairs + n:
            raise AssertionError(f"kernel E {label}: {e_visited} pair steps, "
                                 f"want {pairs + n} (real pairs, self "
                                 f"included)")
        xp_bound_ms, xp_bound_by = bound(
            dense_read_bytes(bins) + 4 * 4 * out_slots,
            pairs * DIST_FLOPS + within * kern.flops)
        log(f"kernel B {label}: {b_ms:.6f} ms at chunk width "
            f"{chunk_cells(division, p.m_c)} (by width {b_by_width}); "
            f"{out_slots * 9 * 3 * p.m_c} dense slot pairs (the TPU "
            f"schedule's), {pairs} candidate pairs; {b_ms / xp_bound_ms:.1f}"
            f"x its {xp_bound_ms:.6f} ms bound ({xp_bound_by}); with the "
            f"low_flop pair kernel {b_low_ms:.6f} ms")
        log(f"kernel E {label}: {e_ms:.6f} ms at box {pe.box} and "
            f"{allin_threads(pe.box, p.m_c)} threads (B in turns "
            f"{b_ms:.6f}; by threads {e_by_threads}); low_flop "
            f"{e_low_ms:.6f} ms; {e_visited} pair "
            f"steps = {pairs} candidate pairs + {n} self pairs (counted "
            f"from the bins; a schedule over every slot of 27 cells would "
            f"take {n * 27 * p.m_c})")
        res = dict(case=f"dense {label}", division=division, ppc=ppc,
                   periodic=periodic, n=n, m_c=p.m_c, launches=launches,
                   execute_ms=execute_ms, bin_ms=bin_ms, scan_ms=a_ms,
                   xpencil_ms=b_ms, scatter_ms=scatter_ms,
                   xpencil_plain_ms=xp_plain_ms, xpencil_bound_ms=xp_bound_ms,
                   xpencil_bound_by=xp_bound_by,
                   xpencil_over_bound=b_ms / xp_bound_ms,
                   xpencil_chunk_cells=chunk_cells(division, p.m_c),
                   xpencil_ms_by_chunk_cells=b_by_width,
                   xpencil_low_flop_ms=b_low_ms,
                   candidate_pairs_from_bins=pairs,
                   pairs_in_cutoff=within,
                   dense_slot_pairs_from_bins=out_slots * 9 * 3 * p.m_c,
                   xpencil_max_abs_err=xp_abs_err,
                   xpencil_term_rel_err=xp_term_err,
                   forces_vs_reference=err_f, potential_vs_reference=err_u,
                   forces_term_rel_err=term_f, potential_term_rel_err=term_u,
                   n_cells=dom.n_cells, xpencil_ms_turns=turns["B"],
                   allin_launches=launches_e,
                   allin_execute_ms=allin_execute_ms, allin_ms=e_ms,
                   allin_ms_turns=turns["E"], allin_over_xpencil=e_ms / b_ms,
                   allin_plain_ms=e_plain_ms, allin_box=pe.box,
                   allin_smem_bytes=halo_bytes(pe.box, pe.m_c),
                   allin_blocks=dom.n_cells // (pe.box[0] * pe.box[1]
                                                * pe.box[2]),
                   allin_max_abs_err=e_abs_err,
                   allin_term_rel_err=e_term_err, allin_low_flop_ms=e_low_ms,
                   allin_threads=allin_threads(pe.box, pe.m_c),
                   allin_ms_by_threads=e_by_threads,
                   allin_pair_steps=e_visited,
                   allin_every_slot_steps_from_bins=n * 27 * p.m_c)
        results.append(res)
        log("main path: " + json.dumps(res))

        # main case (d): the SFC cluster layout on the same particles
        sfc_results.append(sfc_case(dom, kern, pos, state, bins, (f, u),
                                    label, periodic))
        sfc_checks += 4
        log("main path (d): " + json.dumps(sfc_results[-1]))
    dense_main = results[0]

    # -- the packed and compacted main paths at full size ----------------------
    def kernel_c_bound(dom, bins, occ, kern, within):
        act = occ.active[:int(occ.n_active)]
        n_bytes = (dense_read_bytes(bins, touched_rows(dom, act))
                   + 4 * act.numel() + 16 * act.numel() * dom.nx * bins.m_c)
        return bound(n_bytes, candidate_pairs(dom, bins.counts) * DIST_FLOPS
                     + within * kern.flops)

    def kernel_d_bound(dom, packed, active, kern, within):
        ny = dom.ny
        rows = touched_rows(dom, active)
        real = packed.row_counts
        a = active.long()
        listed_real = int(real[a // ny + 1, a % ny + 1].sum())
        n_bytes = (16 * int(real[rows].sum()) + 4 * int(rows.sum())
                   * (dom.nx + 3) + 4 * active.numel()
                   + (4 + 16) * listed_real)
        return bound(n_bytes, candidate_pairs(dom, packed.counts)
                     * DIST_FLOPS + within * kern.flops)

    kern = make_lennard_jones()
    reps = 10
    new_cases = {}

    # (a) packed rows, uniform: the paper's regime, as the dense main case
    division, ppc = PACKED_CASE
    dom = Domain.cubic(division, cutoff=1.0)
    pos_u = dom.sample_uniform(division ** 3 * ppc, generator=gen, device=dev)
    state_u = ParticleState(pos_u)
    pa = plan(dom, kern, positions=pos_u, layout="packed", strategy="xpencil")
    f, u, launches = run_main(pa, state_u, "packed uniform",
                              ("prefix_sum", "pack_slots",
                               "xpencil_packed_forces"))
    if launches != PACKED_LAUNCHES:
        raise AssertionError(f"packed uniform: launches {launches}, want "
                             f"{PACKED_LAUNCHES}")
    dense_u = plan(dom, kern, m_c=pa.m_c, strategy="xpencil").execute(state_u)
    assert_equal_results((f, u), dense_u, "packed vs dense, uniform")
    for layout in ("dense", "packed"):             # kernel C; D, active rows
        assert_equal_results(
            plan(dom, kern, positions=pos_u, m_c=pa.m_c, compact=True,
                 layout=layout, strategy="xpencil").execute(state_u),
            dense_u, f"compact {layout} vs dense, uniform")
    errs, terms, within = reference_checks(pa, state_u, f, u,
                                           "packed uniform", False)
    bins = pa.bin(state_u)
    packed = pa.pack(bins)
    every = full_pencil_occupancy(dom, dev).active
    kd, _, d_plain_ms, _, d_abs_err, d_term_err = check_kernel_d(
        dom, packed, None, "lennard_jones", kern, "main case (a)")
    pk_checks += 4
    d_bound_ms, d_bound_by = kernel_d_bound(dom, packed, every, kern, within)

    def d_uniform(k=kern, **kw):
        return xpencil_packed_forces(
            packed.planes, packed.slot_id, packed.slot_cell,
            packed.cell_offsets, None, nx=division, ny=division, m_c=pa.m_c,
            kernel=k, cutoff2=1.0, **kw)

    def b_uniform():
        return xpencil_forces(bins.planes, bins.slot_id, nx=division,
                              m_c=pa.m_c, kernel=kern, cutoff2=1.0)

    d_by_tiles, d_queued_by_tiles = tile_sweep(
        "kernel D, main case (a)", d_uniform, kd, pa.row_cap, reps)
    d_turns = {"D": [], "B": []}                  # on the same particles
    d_queued = {"D": [], "B": []}
    for which in ("D", "B", "B", "D"):
        fn = d_uniform if which == "D" else b_uniform
        d_turns[which].append(cuda_ms(fn, reps))
        d_queued[which].append(cuda_ms_queued(fn, 2 * reps))
    pack_err, pack_launch, pack_plain = check_pack(dom, bins, pa.row_cap,
                                                   "main case (a)")
    # its half-empty and periodic variants at full size
    half_u = pos_u * torch.tensor([1.0, 0.5, 1.0], device=dev)
    check_pack(dom, bin_particles(dom, half_u, m_c=suggest_m_c(dom, half_u)),
               suggest_row_cap(dom, half_u), "main case (a) half-empty")
    per64 = Domain.cubic(division, cutoff=1.0, periodic=True)
    check_pack(per64, bin_particles(per64, pos_u, m_c=pa.m_c),
               suggest_row_cap(per64, pos_u), "main case (a) periodic")
    pack_checks += 3
    pack_bound_ms, pack_bound_by = pack_bound(bins, pa.row_cap)
    pd = plan(dom, kern, m_c=pa.m_c, strategy="xpencil")
    exec_turns = in_turns({"packed": lambda: pa.execute(state_u),
                           "dense": lambda: pd.execute(state_u)}, reps)
    calls_a = launches_in_turns({"packed": lambda: pa.execute(state_u),
                                 "dense": lambda: pd.execute(state_u)},
                                reps=3, sessions=3)
    new_cases["a"] = dict(
        case="packed uniform", division=division, ppc=ppc, n=pos_u.shape[0],
        m_c=pa.m_c, row_cap=pa.row_cap,
        fullest_row=int(packed.row_counts.max()), launches=launches,
        execute_ms=cuda_ms(lambda: pa.execute(state_u), reps),
        dense_execute_ms=cuda_ms(lambda: plan(dom, kern, m_c=pa.m_c,
                                              strategy="xpencil").execute(
            state_u), reps),
        execute_ms_in_turns=exec_turns[0],
        execute_queued_ms_in_turns=exec_turns[1],
        bin_ms=cuda_ms(lambda: pa.bin(state_u), reps),
        pack_ms=cuda_ms(lambda: pa.pack(bins), reps),
        pack_queued_ms=cuda_ms_queued(lambda: pa.pack(bins), 2 * reps),
        pack_kernel_ms=cuda_ms(pack_launch, reps),
        pack_plain_ms=cuda_ms(pack_plain, reps),
        pack_bound_ms=pack_bound_ms, pack_bound_by=pack_bound_by,
        pack_max_abs_err=pack_err,
        pack_launch_calls=host_launch_calls(lambda: pa.pack(bins)),
        pack_device_ms=pack_device_ms(lambda: pa.execute(state_u)),
        execute_launch_calls=calls_a["packed"]["launches"],
        dense_execute_launch_calls=calls_a["dense"]["launches"],
        kernel_d_ms=cuda_ms(d_uniform, reps),
        kernel_d_tile_rows=packed_tile_rows(pa.row_cap, division ** 2),
        kernel_d_smem_bytes=packed_smem_bytes(
            packed_tile_rows(pa.row_cap, division ** 2), pa.row_cap),
        kernel_d_ms_by_tile_rows=d_by_tiles,
        kernel_d_queued_ms_by_tile_rows=d_queued_by_tiles,
        kernel_d_low_flop_ms=cuda_ms(lambda: d_uniform(kernels["low_flop"]),
                                     reps),
        kernel_d_ms_in_turns=statistics.mean(d_turns["D"]),
        kernel_b_ms_in_turns=statistics.mean(d_turns["B"]),
        kernel_d_queued_ms_in_turns=statistics.mean(d_queued["D"]),
        kernel_b_queued_ms_in_turns=statistics.mean(d_queued["B"]),
        pack_kernel_queued_ms=cuda_ms_queued(pack_launch, 2 * reps),
        kernel_d_plain_ms=d_plain_ms, kernel_d_bound_ms=d_bound_ms,
        kernel_d_bound_by=d_bound_by,
        unpack_ms=cuda_ms(lambda: packed_to_particles(dom, packed, *kd),
                          reps),
        candidate_pairs_from_bins=candidate_pairs(dom, bins.counts),
        pairs_in_cutoff=within, kernel_d_max_abs_err=d_abs_err,
        kernel_d_term_rel_err=d_term_err, forces_vs_reference=errs[0],
        potential_vs_reference=errs[1], forces_term_rel_err=terms[0],
        potential_term_rel_err=terms[1])
    log("main path: " + json.dumps(new_cases["a"]))
    ca = new_cases["a"]
    log(f"kernel D, main case (a): {ca['kernel_d_ms']:.6f} ms at tile_rows "
        f"{ca['kernel_d_tile_rows']} ({ca['kernel_d_smem_bytes']} B), "
        f"{ca['kernel_d_ms'] / d_bound_ms:.1f}x its {d_bound_ms:.6f} ms bound "
        f"({d_bound_by}); in turns D {d_turns['D']}, B {d_turns['B']}, "
        f"queued D {d_queued['D']}, B {d_queued['B']}; "
        f"low_flop {ca['kernel_d_low_flop_ms']:.6f} ms; by tile {d_by_tiles}, "
        f"queued {d_queued_by_tiles}")
    log(f"execute(), main case (a), in turns: {exec_turns[0]} ms, queued "
        f"{exec_turns[1]} ms")
    log(f"pack kernel, main case (a): {ca['pack_kernel_ms']:.6f} ms (queued "
        f"{ca['pack_kernel_queued_ms']:.6f}), plain "
        f"{ca['pack_plain_ms']:.6f} ms, bound {pack_bound_ms:.6f} ms "
        f"({pack_bound_by}); pack_rows {ca['pack_ms']:.6f} ms (queued "
        f"{ca['pack_queued_ms']:.6f}, {ca['pack_launch_calls']:g} launch "
        f"calls; device {ca['pack_device_ms']} ms in an execute()), "
        f"{pack_bound_ms / ca['pack_ms']:.3f} of its bound (queued "
        f"{pack_bound_ms / ca['pack_queued_ms']:.3f}); launch calls an "
        f"execute(): packed {ca['execute_launch_calls']:g}, dense "
        f"{ca['dense_execute_launch_calls']:g}")

    # (b) a clustered scene, compacted: dense layout (C), packed layout (D)
    division, n_blob, sigma_frac = BLOB_CASE
    dom = Domain.cubic(division, cutoff=1.0)
    pos_b = scenarios.sample_gaussian_blob(dom, n_blob, generator=gen,
                                           device=dev, sigma_frac=sigma_frac)
    state_b = ParticleState(pos_b)
    pb = plan(dom, kern, positions=pos_b, compact=True, strategy="xpencil")
    f, u, launches_c = run_main(pb, state_b, "compact blob",
                                ("prefix_sum", "xpencil_sparse_forces"))
    pbp = plan(dom, kern, positions=pos_b, compact=True, layout="packed",
               strategy="xpencil")
    fp, up, launches_d = run_main(pbp, state_b, "compact packed blob",
                                  ("prefix_sum", "pack_slots",
                                   "xpencil_packed_forces"))
    if launches_d != PACKED_LAUNCHES:
        raise AssertionError(f"compact packed blob: launches {launches_d}, "
                             f"want {PACKED_LAUNCHES}")
    dense_b = plan(dom, kern, m_c=pb.m_c, strategy="xpencil").execute(state_b)
    assert_equal_results((f, u), dense_b, "compact vs dense, blob")
    assert_equal_results((fp, up), dense_b, "compact packed vs dense, blob")
    assert_equal_results(plan(dom, kern, m_c=pb.m_c, layout="packed",
                              row_cap=pbp.row_cap,
                              strategy="xpencil").execute(state_b),
                         dense_b, "packed vs dense, blob")
    errs_c, terms_c, within_b = reference_checks(pb, state_b, f, u,
                                                 "compact blob", False)
    errs_d, terms_d, _ = reference_checks(pbp, state_b, fp, up,
                                          "compact packed blob", False)
    bins_b = pb.bin(state_b)
    occ = pencil_occupancy(dom, bins_b.counts, pb.max_active)
    kc, _, c_plain_ms, _, c_abs_err, c_term_err = check_kernel_c(
        dom, bins_b, occ.active, "lennard_jones", kern, "main case (b)")
    sp_checks += 4
    packed_b = pbp.pack(bins_b)
    _, _, db_plain_ms, _, db_abs_err, _ = check_kernel_d(
        dom, packed_b, occ.active, "lennard_jones", kern, "main case (b)")
    pk_checks += 4
    c_bound_ms, c_bound_by = kernel_c_bound(dom, bins_b, occ, kern, within_b)
    c_by_width = chunk_sweep(
        "kernel C, main case (b)", lambda **kw: xpencil_sparse_forces(
            bins_b.planes, bins_b.slot_id, occ.active, nx=division,
            ny=division, m_c=pb.m_c, kernel=kern, cutoff2=1.0, **kw), kc,
        division, pb.m_c, reps)
    db_bound_ms, db_bound_by = kernel_d_bound(
        dom, packed_b, occ.active[:int(occ.n_active)], kern, within_b)

    def d_blob(k=kern, **kw):
        return xpencil_packed_forces(
            packed_b.planes, packed_b.slot_id, packed_b.slot_cell,
            packed_b.cell_offsets, occ.active, nx=division, ny=division,
            m_c=pb.m_c, kernel=k, cutoff2=1.0, **kw)

    kdb = d_blob()
    db_by_tiles, db_queued_by_tiles = tile_sweep(
        "kernel D, main case (b)", d_blob, kdb, pbp.row_cap, reps)
    packb_err, packb_launch, packb_plain = check_pack(
        dom, bins_b, pbp.row_cap, "main case (b)")
    per64 = Domain.cubic(division, cutoff=1.0, periodic=True)
    check_pack(per64, bin_particles(per64, pos_b, m_c=pb.m_c),
               suggest_row_cap(per64, pos_b), "main case (b) periodic")
    pack_checks += 2
    packb_bound_ms, packb_bound_by = pack_bound(bins_b, pbp.row_cap)
    idx = occ.scatter_indices()
    nz_ny = dom.nz * dom.ny

    execb_turns = in_turns({"compact packed": lambda: pbp.execute(state_b),
                            "compact": lambda: pb.execute(state_b)}, reps)
    calls_b = launches_in_turns(
        {"compact packed": lambda: pbp.execute(state_b),
         "compact": lambda: pb.execute(state_b)}, reps=3, sessions=3)

    def scatter_back():
        planes = [scatter_rows(r, idx, nz_ny).view(dom.nz, dom.ny, -1)
                  for r in kc]
        return dense_to_particles(dom, bins_b, *planes)

    new_cases["b"] = dict(
        case="compact blob", division=division, n=n_blob,
        sigma_frac=sigma_frac, m_c=pb.m_c, max_active=pb.max_active,
        n_active=int(occ.n_active), n_units=nz_ny, row_cap=pbp.row_cap,
        fullest_row=int(packed_b.row_counts.max()),
        launches_compact=launches_c, launches_compact_packed=launches_d,
        execute_compact_ms=cuda_ms(lambda: pb.execute(state_b), reps),
        execute_compact_packed_ms=cuda_ms(lambda: pbp.execute(state_b), reps),
        execute_ms_in_turns=execb_turns[0],
        execute_queued_ms_in_turns=execb_turns[1],
        execute_dense_ms=cuda_ms(lambda: plan(dom, kern, m_c=pb.m_c,
                                              strategy="xpencil").execute(
            state_b), reps),
        bin_ms=cuda_ms(lambda: pb.bin(state_b), reps),
        occupancy_ms=cuda_ms(lambda: pencil_occupancy(
            dom, bins_b.counts, pb.max_active), reps),
        pack_ms=cuda_ms(lambda: pbp.pack(bins_b), reps),
        pack_queued_ms=cuda_ms_queued(lambda: pbp.pack(bins_b), 2 * reps),
        pack_kernel_ms=cuda_ms(packb_launch, reps),
        pack_plain_ms=cuda_ms(packb_plain, reps),
        pack_bound_ms=packb_bound_ms, pack_bound_by=packb_bound_by,
        pack_max_abs_err=packb_err,
        pack_launch_calls=host_launch_calls(lambda: pbp.pack(bins_b)),
        pack_device_ms=pack_device_ms(lambda: pbp.execute(state_b)),
        execute_launch_calls=calls_b["compact packed"]["launches"],
        compact_execute_launch_calls=calls_b["compact"]["launches"],
        kernel_c_ms=cuda_ms(lambda: xpencil_sparse_forces(
            bins_b.planes, bins_b.slot_id, occ.active, nx=division,
            ny=division, m_c=pb.m_c, kernel=kern, cutoff2=1.0), reps),
        kernel_c_plain_ms=c_plain_ms, kernel_c_bound_ms=c_bound_ms,
        kernel_c_bound_by=c_bound_by,
        kernel_c_chunk_cells=chunk_cells(division, pb.m_c),
        kernel_c_ms_by_chunk_cells=c_by_width,
        dense_slot_pairs_from_bins=kc[0].numel() * 9 * 3 * pb.m_c,
        kernel_b_ms=cuda_ms(lambda: xpencil_forces(
            bins_b.planes, bins_b.slot_id, nx=division, m_c=pb.m_c,
            kernel=kern, cutoff2=1.0), reps),
        kernel_d_ms=cuda_ms(d_blob, reps),
        kernel_d_queued_ms=cuda_ms_queued(d_blob, 2 * reps),
        pack_kernel_queued_ms=cuda_ms_queued(packb_launch, 2 * reps),
        kernel_d_tile_rows=packed_tile_rows(pbp.row_cap,
                                            occ.active.shape[0]),
        kernel_d_ms_by_tile_rows=db_by_tiles,
        kernel_d_queued_ms_by_tile_rows=db_queued_by_tiles,
        kernel_d_low_flop_ms=cuda_ms(lambda: d_blob(kernels["low_flop"]),
                                     reps),
        kernel_d_plain_ms=db_plain_ms, kernel_d_bound_ms=db_bound_ms,
        kernel_d_bound_by=db_bound_by,
        scatter_ms=cuda_ms(scatter_back, reps),
        candidate_pairs_from_bins=candidate_pairs(dom, bins_b.counts),
        pairs_in_cutoff=within_b, kernel_c_max_abs_err=c_abs_err,
        kernel_c_term_rel_err=c_term_err, kernel_d_max_abs_err=db_abs_err,
        forces_vs_reference=errs_c[0], potential_vs_reference=errs_c[1],
        forces_term_rel_err=terms_c[0], potential_term_rel_err=terms_c[1],
        packed_forces_term_rel_err=terms_d[0],
        packed_potential_term_rel_err=terms_d[1])
    log("main path: " + json.dumps(new_cases["b"]))
    cb = new_cases["b"]
    log(f"kernel C, main case (b): {cb['kernel_c_ms']:.6f} ms at chunk width "
        f"{cb['kernel_c_chunk_cells']} (by width {c_by_width}); "
        f"{cb['dense_slot_pairs_from_bins']} dense slot pairs (the TPU "
        f"schedule's, padding rows included), "
        f"{cb['candidate_pairs_from_bins']} candidate pairs; "
        f"{cb['kernel_c_ms'] / c_bound_ms:.1f}x its {c_bound_ms:.6f} ms bound "
        f"({c_bound_by})")
    log(f"kernel D, main case (b): {cb['kernel_d_ms']:.6f} ms at tile_rows "
        f"{cb['kernel_d_tile_rows']}, {cb['kernel_d_ms'] / db_bound_ms:.1f}x "
        f"its {db_bound_ms:.6f} ms bound ({db_bound_by}); queued "
        f"{cb['kernel_d_queued_ms']:.6f} ms; low_flop "
        f"{cb['kernel_d_low_flop_ms']:.6f} ms; by tile {db_by_tiles}, "
        f"queued {db_queued_by_tiles}")
    log(f"execute(), main case (b), in turns: {execb_turns[0]} ms, queued "
        f"{execb_turns[1]} ms")
    log(f"pack kernel, main case (b): {cb['pack_kernel_ms']:.6f} ms (queued "
        f"{cb['pack_kernel_queued_ms']:.6f}), plain "
        f"{cb['pack_plain_ms']:.6f} ms, bound {packb_bound_ms:.6f} ms; "
        f"pack_rows {cb['pack_ms']:.6f} ms (queued "
        f"{cb['pack_queued_ms']:.6f}, {cb['pack_launch_calls']:g} launch "
        f"calls; device {cb['pack_device_ms']} ms in an execute()), "
        f"{packb_bound_ms / cb['pack_ms']:.3f} of its bound (queued "
        f"{packb_bound_ms / cb['pack_queued_ms']:.3f}); launch calls an "
        f"execute(): compact packed {cb['execute_launch_calls']:g}, "
        f"compact {cb['compact_execute_launch_calls']:g}")
    sfc_results.append(sfc_case(dom, kern, pos_b, state_b, bins_b, dense_b,
                                f"blob div {division}", False))
    sfc_checks += 4
    log("main path (d): " + json.dumps(sfc_results[-1]))

    # (c) All-in-SM on the blob: kernel E, and B in turns, on its bins
    pe_b = plan(dom, kern, positions=pos_b, strategy="allin")
    fe, ue, launches_eb = run_main(pe_b, state_b, "allin blob",
                                   ("prefix_sum", "allin_forces"))
    if launches_eb["allin_forces"] != 1 or pe_b.m_c != pb.m_c:
        raise AssertionError(f"allin blob: {launches_eb}, m_c {pe_b.m_c} "
                             f"vs {pb.m_c}")
    assert_equal_results((fe, ue), dense_b, "allin (kernel E) vs dense, blob")
    keb, _, eb_plain_ms, _, eb_abs_err, eb_term_err = check_kernel_e(
        bins_b, pe_b.box, "lennard_jones", kern, "main case (b)")
    al_checks += 4

    def b_blob(k=kern):
        return xpencil_forces(bins_b.planes, bins_b.slot_id, nx=division,
                              m_c=pb.m_c, kernel=k, cutoff2=1.0)

    def e_blob(k=kern, visits=None):
        return allin_forces(bins_b.planes, bins_b.slot_id, box=pe_b.box,
                            m_c=pb.m_c, kernel=k, cutoff2=1.0, visits=visits)

    assert_equal_results(keb, b_blob(), "kernel E vs B planes, blob")
    ident_checks += 1
    turns = {"B": [], "E": []}
    for which in ("B", "E", "E", "B"):
        turns[which].append(cuda_ms(b_blob if which == "B" else e_blob,
                                    reps))
    eb_visited = slot_pairs_visited(lambda v: e_blob(visits=v))
    blob_pairs = candidate_pairs(dom, bins_b.counts)
    if eb_visited != blob_pairs + n_blob:
        raise AssertionError(f"kernel E blob: {eb_visited} pair steps, want "
                             f"{blob_pairs + n_blob}")
    eb_bound_ms, eb_bound_by = bound(
        dense_read_bytes(bins_b) + 4 * 4 * keb[0].numel(),
        blob_pairs * DIST_FLOPS + within_b * kern.flops)
    new_cases["c_blob"] = dict(
        case="allin blob", division=division, n=n_blob, m_c=pe_b.m_c,
        box=pe_b.box, smem_bytes=halo_bytes(pe_b.box, pe_b.m_c),
        launches=launches_eb,
        execute_ms=cuda_ms(lambda: pe_b.execute(state_b), reps),
        kernel_e_ms=statistics.mean(turns["E"]), kernel_e_ms_turns=turns["E"],
        kernel_b_ms=statistics.mean(turns["B"]), kernel_b_ms_turns=turns["B"],
        kernel_e_low_flop_ms=cuda_ms(
            lambda: e_blob(kernels["low_flop"]), reps),
        kernel_e_threads=allin_threads(pe_b.box, pe_b.m_c),
        kernel_e_ms_by_threads=threads_sweep(
            "kernel E blob", lambda **kw: allin_forces(
                bins_b.planes, bins_b.slot_id, box=pe_b.box, m_c=pb.m_c,
                kernel=kern, cutoff2=1.0, **kw), keb, reps),
        kernel_b_low_flop_ms=cuda_ms(
            lambda: b_blob(kernels["low_flop"]), reps),
        kernel_e_plain_ms=eb_plain_ms, kernel_e_max_abs_err=eb_abs_err,
        kernel_e_term_rel_err=eb_term_err, kernel_e_bound_ms=eb_bound_ms,
        kernel_e_bound_by=eb_bound_by, pair_steps=eb_visited,
        candidate_pairs_from_bins=blob_pairs,
        every_slot_steps_from_bins=n_blob * 27 * pe_b.m_c)
    log("main path (c) on the blob: " + json.dumps(new_cases["c_blob"]))

    # -- replan on the card: a plan sized on the uniform scene, run on the blob
    pu = plan(dom, kern, positions=pos_u, layout="packed", compact=True,
              strategy="xpencil")
    counts_b = cell_counts(dom, pos_b)
    over = {"m_c": int(counts_b.max()) > pu.m_c,
            "row_cap": int(padded_row_counts(dom, counts_b).max())
            > pu.row_cap,
            "max_active": active_unit_count(dom, pos_b) > pu.max_active}
    (f, u), p1 = pu.execute_or_replan(state_b)
    for name, overflowed in over.items():
        old, new = getattr(pu, name), getattr(p1, name)
        if (new > old) != overflowed or (new != old) != overflowed:
            raise AssertionError(f"replan: {name} {old} -> {new}, overflowed "
                                 f"{overflowed}")
    fresh = plan(dom, kern, m_c=p1.m_c, layout="packed", compact=True,
                 max_active=p1.max_active, row_cap=p1.row_cap,
                 strategy="xpencil").execute(state_b)
    assert_equal_results((f, u), fresh, "execute_or_replan vs a fresh plan")
    assert_equal_results((f, u), dense_b, "execute_or_replan vs dense")
    replan = {n: [getattr(pu, n), getattr(p1, n)] for n in over}
    log(f"replan: uniform plan on the blob grew {replan} (overflowed: "
        f"{over}); result equals a fresh plan's and the dense path's")

    # an allin plan sized on the uniform scene: its sub-box follows m_c
    pe0 = plan(dom, kern, positions=pos_u, strategy="allin")
    reset_launches()
    (f, u), pe1 = pe0.execute_or_replan(state_b)
    torch.cuda.synchronize()
    launches_r = launch_counts()
    grown_box = S.shrink_to_divisors(dom, S.subbox_dims(dom, pe1.m_c))
    if not (pe1.m_c > pe0.m_c and pe1.box == grown_box != pe0.box
            and launches_r.get("allin_forces") == 1):
        raise AssertionError(f"allin replan: m_c {pe0.m_c} -> {pe1.m_c}, box "
                             f"{pe0.box} -> {pe1.box} (want {grown_box}), "
                             f"launches {launches_r}")
    assert_equal_results((f, u), plan(dom, kern, m_c=pe1.m_c,
                                      strategy="xpencil").execute(state_b),
                         "replanned allin vs dense X-pencil, blob")
    log(f"allin replan: m_c {pe0.m_c} -> {pe1.m_c}, box {pe0.box} -> "
        f"{pe1.box} ({halo_bytes(pe0.box, pe0.m_c)} -> "
        f"{halo_bytes(pe1.box, pe1.m_c)} B of shared memory), launches "
        f"{launches_r}; result equals the dense X-pencil path's")

    # an sfc plan sized on the blob, run on the uniform scene: pair_cap grows
    ps0 = plan(dom, kern, positions=pos_b, strategy="cell_dense",
               layout="sfc")
    reset_launches()
    (f, u), ps1 = ps0.execute_or_replan(state_u)
    torch.cuda.synchronize()
    launches_r = launch_counts()
    if not (int(cell_counts(dom, pos_u).max()) <= ps0.m_c == ps1.m_c
            and ps1.pair_cap > ps0.pair_cap
            and ps1.pair_cap >= sfc_pair_count(dom, pos_u)
            and launches_r.get("cell_sfc_forces") == 1):
        raise AssertionError(f"sfc replan: m_c {ps0.m_c} -> {ps1.m_c}, "
                             f"pair_cap {ps0.pair_cap} -> {ps1.pair_cap}, "
                             f"launches {launches_r}")
    assert_equal_results((f, u), plan(dom, kern, m_c=ps1.m_c,
                                      strategy="cell_dense", layout="sfc",
                                      pair_cap=ps1.pair_cap).execute(state_u),
                         "replanned sfc vs a fresh plan, uniform")
    log(f"sfc replan: a plan sized on the blob, on the uniform scene: "
        f"pair_cap {ps0.pair_cap} -> {ps1.pair_cap}, m_c {ps0.m_c} kept, "
        f"launches {launches_r}; result equals a fresh plan's")

    # -- autotune: strategy="auto" and the measured tuner on the same scenes --
    autotune_rec = autotune_phase(dom, kern, pos_u, pos_b, gen, dev, run_main,
                                  assert_equal_results)
    log("main path (autotune): " + json.dumps(autotune_rec))

    # -- trajectory: plan.trajectory, MD over many steps on every path -------
    traj_rec = trajectory_phase(args.seed, dev, reset_launches, launch_counts)
    log("main path (trajectory): " + json.dumps(traj_rec))

    def check_serving_batch(p, dom, batched, label):
        """The force kernel of class plan ``p``'s path, launched once on a
        full padded serving batch (the shapes a dispatch gives it); its
        first and last systems held against the plain version on each
        alone, with check_kernel's tolerances (a system's rows depend on
        its own planes only; the plain versions take about a second a
        system at m_c 184). -> record"""
        if p.backend != "cuda":
            raise AssertionError(f"serving {label}: class plan off the "
                                 f"kernels: {p}")
        bins = p.bin(batched)
        nx, ny = dom.nx, dom.ny
        n_sys = bins.slot_id.shape[0]
        sel = (0, n_sys - 1)
        kw = dict(m_c=p.m_c, cutoff2=1.0)
        name = path_kernels(p)[-1]
        if p.layout == "packed":
            pk = p.pack(bins)
            act = (pencil_occupancy(dom, bins.counts, p.max_active).active
                   if p.compact else None)
            rows = (full_pencil_occupancy(dom, dev).active.expand(n_sys, -1)
                    if act is None else act)

            def launch(k):
                return xpencil_packed_forces(
                    pk.planes, pk.slot_id, pk.slot_cell, pk.cell_offsets,
                    act, nx=nx, ny=ny, kernel=k, **kw)

            def plain_one(i, k):
                q = system(pk, i)
                return S.xpencil_packed_planes(
                    q.planes["x"], q.planes["y"], q.planes["z"], q.slot_id,
                    q.slot_cell, q.cell_offsets, rows[i], nx=nx, ny=ny,
                    kernel=k, **kw)
        elif p.layout == "sfc":
            sfc = p.clusters(bins)

            def launch(k):
                return sfc_tiles(dom, bins, sfc, k)

            def plain_one(i, k):
                return sfc_tiles(dom, system(bins, i), system(sfc, i), k,
                                 plain=True)
        elif p.strategy == "allin":
            def launch(k):
                return allin_forces(bins.planes, bins.slot_id, box=p.box,
                                    kernel=k, **kw)

            def plain_one(i, k):
                b = system(bins, i)
                return S.allin_planes(b.planes["x"], b.planes["y"],
                                      b.planes["z"], b.slot_id, box=p.box,
                                      kernel=k, **kw)
        else:
            act = (pencil_occupancy(dom, bins.counts, p.max_active).active
                   if p.compact else None)

            def launch(k):
                if act is None:
                    return xpencil_forces(bins.planes, bins.slot_id, nx=nx,
                                          kernel=k, **kw)
                return xpencil_sparse_forces(bins.planes, bins.slot_id, act,
                                             nx=nx, ny=ny, kernel=k, **kw)

            def plain_one(i, k):
                b = system(bins, i)
                if act is None:
                    return plain(b, nx, k)
                return S.xpencil_sparse_planes(
                    b.planes["x"], b.planes["y"], b.planes["z"], b.slot_id,
                    act[i], nx=nx, ny=ny, kernel=k, **kw)
        res = check_kernel(
            f"serving {label} {name} (systems {sel} of {n_sys})",
            p.kernel.name, p.kernel,
            lambda k: tuple(o[list(sel)] for o in launch(k)),
            lambda k: tuple(torch.stack(o) for o in
                            zip(*(plain_one(i, k) for i in sel))))
        return dict(kernel=name, systems=n_sys, systems_checked=list(sel),
                    m_c=p.m_c, box=p.box, max_abs_err=res[4],
                    max_term_rel_err=res[5], plain_ms=res[2])

    # -- serving: ServingEngine, execute_checked, obs.profile, trajectories --
    serve_rec = serving_phase(args.seed, dev, smi[0], dom, kern, pos_u,
                              reset_launches, launch_counts,
                              assert_equal_results, check_serving_batch)
    log("main path (serving): " + json.dumps(serve_rec))

    def check_halo_shards(p, state, label):
        """The force kernel of halo plan ``p``'s path, launched once on its
        stacked shards (the layout data ``dist.engine`` gives the inner
        backend); its first and last shards held against the plain version
        on each alone, with check_kernel's tolerances (a shard's rows
        depend on its own planes only). -> record"""
        from repro_torch.dist.engine import halo_impl
        data, inner = halo_impl(p).layout(ParticleState(state.positions[None]))
        ldom = inner.domain
        nx, ny = ldom.nx, ldom.ny
        n_sys = p.n_shards
        sel = (0, n_sys - 1)
        kw = dict(m_c=p.m_c, cutoff2=1.0)
        name = path_kernels(inner)[-1]
        if p.layout == "packed":
            # the pack kernel on the stacked shards' bins, slot ids offset
            # by each shard's index, as the engine hands them pack_rows
            import repro_torch.dist.engine as E
            seen, real = [], E.pack_rows
            E.pack_rows = (lambda d, b, row_cap: seen.append((d, b, row_cap))
                           or real(d, b, row_cap))
            halo_impl(p).layout(ParticleState(state.positions[None]))
            E.pack_rows = real
            sdom, sbins, scap = seen[0]
            if not bool((sbins.slot_id[1] >= sbins.particle_slot.shape[-1])
                        .any()):
                raise AssertionError("halo shards: no offset slot id")
            check_pack(sdom, sbins, scap, f"halo {label}, {n_sys} stacked "
                       "shards")
            act = (pencil_occupancy(ldom, data.counts, p.max_active).active
                   if p.compact else None)
            rows = (full_pencil_occupancy(ldom, dev).active.expand(n_sys, -1)
                    if act is None else act)

            def launch(k):
                return xpencil_packed_forces(
                    data.planes, data.slot_id, data.slot_cell,
                    data.cell_offsets, act, nx=nx, ny=ny, kernel=k, **kw)

            def plain_one(i, k):
                q = system(data, i)
                return S.xpencil_packed_planes(
                    q.planes["x"], q.planes["y"], q.planes["z"], q.slot_id,
                    q.slot_cell, q.cell_offsets, rows[i], nx=nx, ny=ny,
                    kernel=k, **kw)
        elif p.layout == "sfc":
            def launch(k):
                return sfc_tiles(ldom, data.bins, data, k)

            def plain_one(i, k):
                return sfc_tiles(ldom, system(data.bins, i), system(data, i),
                                 k, plain=True)
        elif p.strategy == "allin":
            def launch(k):
                return allin_forces(data.planes, data.slot_id, box=p.box,
                                    kernel=k, **kw)

            def plain_one(i, k):
                b = system(data, i)
                return S.allin_planes(b.planes["x"], b.planes["y"],
                                      b.planes["z"], b.slot_id, box=p.box,
                                      kernel=k, **kw)
        else:
            act = (pencil_occupancy(ldom, data.counts, p.max_active).active
                   if p.compact else None)

            def launch(k):
                if act is None:
                    return xpencil_forces(data.planes, data.slot_id, nx=nx,
                                          kernel=k, **kw)
                return xpencil_sparse_forces(data.planes, data.slot_id, act,
                                             nx=nx, ny=ny, kernel=k, **kw)

            def plain_one(i, k):
                b = system(data, i)
                if act is None:
                    return plain(b, nx, k)
                return S.xpencil_sparse_planes(
                    b.planes["x"], b.planes["y"], b.planes["z"], b.slot_id,
                    act[i], nx=nx, ny=ny, kernel=k, **kw)
        res = check_kernel(
            f"halo {label} {name} (shards {sel} of {n_sys})",
            p.kernel.name, p.kernel,
            lambda k: tuple(o[list(sel)] for o in launch(k)),
            lambda k: tuple(torch.stack(o) for o in
                            zip(*(plain_one(i, k) for i in sel))))
        return dict(kernel=name, shards=n_sys, shards_checked=list(sel),
                    m_c=p.m_c, box=p.box, max_abs_err=res[4],
                    max_term_rel_err=res[5], plain_ms=res[2],
                    kernel_ms=cuda_ms_queued(lambda: launch(p.kernel), 10))

    # -- halo: backend="halo", Z-slab shards stacked on the card -------------
    halo_rec = halo_phase(args.seed, dev, smi[0], dom, kern, pos_u, run_main,
                          reset_launches, launch_counts, assert_equal_results,
                          check_halo_shards)
    log("main path (halo): " + json.dumps(halo_rec))

    # -- batch: B stacked systems through one chain of launches --------------
    def stacked_systems(index, n_sys, division, ppc, periodic):
        """B uniform systems of division**3 * ppc particles, each drawn from
        its own generator seeded from --seed, the scene and its index; the
        periodic scene's system 1 is padding throughout."""
        dom = Domain.cubic(division, cutoff=1.0, periodic=periodic)
        pos = []
        for i in range(n_sys):
            g = torch.Generator(device=dev)
            g.manual_seed(args.seed * 1_000_003 + 10_007 * index + i)
            pos.append(dom.sample_uniform(division ** 3 * ppc, generator=g,
                                          device=dev))
        pos = torch.stack(pos)
        valid = None
        if periodic:
            valid = torch.ones(pos.shape[:2], dtype=torch.bool, device=dev)
            valid[1] = False
        return dom, ParticleState(pos, valid=valid)

    def covering_plan(dom, states, **kw):
        """A plan whose bounds are measured on the first system, grown
        through the replan contract while some system overflows one. ->
        (plan, bounds grown)"""
        each = [system(states, i) for i in range(states.positions.shape[0])]
        p = p0 = plan(dom, kern, positions=each[0].positions, **kw)
        grown = True
        while grown:
            grown = False
            for st in each:
                while p.check_overflow(st):
                    p, grown = p.replan(st), True
        return p, p is not p0

    def batch_kernels(label, p, dom, states, check, what):
        """The kernels of path ``label`` on the batch's layout data: each
        against its batched plain version (``check``), each system's rows
        equal to a launch on that system alone (the first and the last),
        the batched launch timed beside one system's alone. -> {kernel:
        record}"""
        bins = p.bin(states)
        n_sys = bins.slot_id.shape[0]
        nx, ny = dom.nx, dom.ny
        kw = dict(kernel=kern, cutoff2=1.0)
        runs = {}                         # kernel -> (run(i), check())
        if label == "dense":
            def run(i=None):
                bn = bins if i is None else system(bins, i)
                return xpencil_forces(bn.planes, bn.slot_id, nx=nx,
                                      m_c=p.m_c, **kw)
            runs["xpencil_forces"] = (run, lambda: check_kernel_b(
                bins, nx, "lennard_jones", kern, what))
        elif label == "compact":
            act = pencil_occupancy(dom, bins.counts, p.max_active).active

            def run(i=None):
                bn = bins if i is None else system(bins, i)
                return xpencil_sparse_forces(
                    bn.planes, bn.slot_id, act if i is None else act[i],
                    nx=nx, ny=ny, m_c=p.m_c, **kw)
            runs["xpencil_sparse_forces"] = (run, lambda: check_kernel_c(
                dom, bins, act, "lennard_jones", kern, what))
        elif label.startswith("packed"):
            pk = p.pack(bins)
            act = (pencil_occupancy(dom, bins.counts, p.max_active).active
                   if p.compact else None)

            def run(i=None, **tile):
                q = pk if i is None else system(pk, i)
                a = act if act is None or i is None else act[i]
                return xpencil_packed_forces(
                    q.planes, q.slot_id, q.slot_cell, q.cell_offsets, a,
                    nx=nx, ny=ny, m_c=p.m_c, **kw, **tile)
            runs["xpencil_packed_forces"] = (run, lambda: check_kernel_d(
                dom, pk, act, "lennard_jones", kern, what))
            def run_pack(i=None):
                bn = bins if i is None else system(bins, i)
                planes, *rest = pack_slots(bn, nx=nx, ny=ny,
                                           row_cap=p.row_cap)
                return (*planes.values(), *rest)
            runs["pack_slots"] = (run_pack, lambda: check_pack(
                dom, bins, p.row_cap, what))
        elif label == "allin":
            def run(i=None):
                bn = bins if i is None else system(bins, i)
                return allin_forces(bn.planes, bn.slot_id, box=p.box,
                                    m_c=p.m_c, **kw)
            runs["allin_forces"] = (run, lambda: check_kernel_e(
                bins, p.box, "lennard_jones", kern, what))
        else:
            sfc = p.clusters(bins)
            tgt, src = sfc_device_slot_tables(dom, p.m_c, sfc.csize,
                                              sfc.curve, dev)

            def run(i=None):
                bn = bins if i is None else system(bins, i)
                return cell_sfc_forces(
                    bn.planes, bn.slot_id,
                    sfc.codes if i is None else sfc.codes[i], tgt, src,
                    m_c=p.m_c, **kw)
            runs["cell_sfc_forces"] = (run, lambda: check_kernel_f(
                dom, bins, sfc, "lennard_jones", kern, what))
        out = {}
        for name, (run, check_fn) in runs.items():
            rec = {}
            # the pack kernel is checked on every scene, (f)'s stack too
            if check or name == "pack_slots":
                res = check_fn()
                rec["max_abs_err"] = (res[0] if name == "pack_slots"
                                      else res[4])
                if name != "pack_slots":
                    rec["max_term_rel_err"] = res[5]
                    rec["plain_ms"] = res[2]
            got = run()
            for i in (0, n_sys - 1):
                assert_equal_results(
                    tuple(g[i] for g in got), run(i),
                    f"{what} {name}: system {i} of the batch vs alone")
            if name == "xpencil_packed_forces":
                # tiles that do not divide a system's rows: a tiling of the
                # flat batch list would put them across two systems
                n_rows = dom.nz * dom.ny if act is None else act.shape[-1]
                tiles = sorted(
                    r for r in {0, 1, 3, 5, 7, 13, MAX_TILE_ROWS,
                                packed_tile_rows(p.row_cap, n_sys * n_rows)}
                    if packed_smem_bytes(r, p.row_cap) <= MAX_SMEM)
                for r in tiles:
                    assert_equal_results(run(tile_rows=r), got,
                                         f"{what} kernel D at tile_rows {r}")
                rec["tile_rows"] = packed_tile_rows(p.row_cap,
                                                    n_sys * n_rows)
                rec["tile_rows_checked"] = tiles
            rec["ms"] = cuda_ms(run, reps)
            rec["alone_ms"] = cuda_ms(lambda: run(0), reps)
            rec["systems_times_alone_ms"] = n_sys * rec["alone_ms"]
            out[name] = rec
        return out

    batch_records = []
    batch_checks = 0
    for index, (name, n_sys, division, ppc, periodic, check) in enumerate(
            BATCH_SCENES):
        dom, states = stacked_systems(index, n_sys, division, ppc, periodic)
        each = [system(states, i) for i in range(n_sys)]
        rec = dict(scene=name, systems=n_sys, division=division, ppc=ppc,
                   periodic=periodic, n_per_system=division ** 3 * ppc,
                   n_total=n_sys * division ** 3 * ppc,
                   padding_systems=[1] if periodic else [], paths={})
        for label, kw, need in BATCH_PATHS:
            what = f"batch {name} {label}"
            p, grown = covering_plan(dom, states, **kw)
            reset_launches()
            fb, ub = p.execute_batch(states)
            torch.cuda.synchronize()
            launches = launch_counts()
            want = {k: 1 for k in need}
            if launches != want:
                raise AssertionError(f"{what}: launches {launches}, want "
                                     f"{want} for the whole batch")
            if not (bool(fb.isfinite().all()) and bool(ub.isfinite().all())):
                raise AssertionError(f"{what}: non-finite output")
            for i, st in enumerate(each):
                assert_equal_results((fb[i], ub[i]), p.execute(st),
                                     f"{what}: system {i} vs execute()")
                batch_checks += 1
            if periodic and (bool(fb[1].any()) or bool(ub[1].any())):
                raise AssertionError(f"{what}: the padding system is not 0")
            batch_ms = cuda_ms(lambda: p.execute_batch(states), reps)
            loop_ms = cuda_ms(lambda: [p.execute(st) for st in each], 3,
                              warmup=1)
            path = dict(
                launches=launches, m_c=p.m_c, max_active=p.max_active,
                row_cap=p.row_cap, pair_cap=p.pair_cap, box=p.box,
                bounds_grown_past_first_system=grown, batch_ms=batch_ms,
                per_system_ms=batch_ms / n_sys, loop_ms=loop_ms,
                loop_per_system_ms=loop_ms / n_sys,
                execute_ms=cuda_ms(lambda: p.execute(each[0]), reps),
                loop_over_batch=loop_ms / batch_ms,
                kernels=batch_kernels(label, p, dom, states, check, what))
            if name == "f":
                # every CUDA launch of one call, under torch.profiler
                fns = {b: (lambda sub=ParticleState(states.positions[:b]):
                           p.execute_batch(sub)) for b in BATCH_PROFILED}
                fns[1] = lambda: p.execute(each[0])
                profiled = launches_in_turns(fns, reps=3,
                                             sessions=PROFILE_SESSIONS)
                profiled[1]["call"] = "execute()"
                counts = {profiled[b]["launches"] for b in BATCH_PROFILED}
                if len(counts) != 1:
                    raise AssertionError(f"{what}: CUDA launches a batch "
                                         f"depend on B: {profiled}")
                path["profiled"] = profiled
                path["device_busy_share"] = (
                    profiled[n_sys]["device_ms"] / batch_ms
                    if n_sys in profiled else None)
            rec["paths"][label] = path
            log(f"batch {name} {label}: " + json.dumps(path))
        batch_records.append(rec)
    batch_by_kernel, batch_launches = {}, {}
    for rec in batch_records:
        for label, path in rec["paths"].items():
            for kname, krec in path["kernels"].items():
                batch_by_kernel.setdefault(kname, {})[
                    f"{rec['scene']} {label}"] = krec
            for kname, n in path["launches"].items():
                batch_launches.setdefault(kname, set()).add(n)
    log(f"batch: {len(BATCH_SCENES)} scenes x {len(BATCH_PATHS)} paths, "
        f"every system equal to execute() bit for bit ({batch_checks} "
        f"checks), each kernel launched once a batch")

    # -- kernel G against its plain version; gemma2-2b serving ---------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g_checks, g_sweep_err, g_by_route = check_kernel_g(gen, dev)
    log(f"kernel G: {g_checks} cases (B, H/KH 1-8, D, window 1 to > S, "
        f"softcap, fp32 and bf16, S not a multiple of 64 or 128, several "
        f"waves, the gemma shape) within {G_TOL[torch.float32]} (fp32) / "
        f"{G_TOL[torch.bfloat16]} (bf16) of (1 + |plain|); routes "
        f"{g_by_route}; max |diff| {g_sweep_err:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    g_sass = sass_counts("window_attn_sm90.cu")
    log(f"kernel G wgmma route SASS (cuobjdump -sass): {g_sass}")
    if not (g_sass["HGMMA"] and g_sass["UTMALDG"]):
        raise AssertionError(f"kernel G's wgmma route: no HGMMA or UTMALDG "
                             f"in its SASS: {g_sass}")
    lm = lm_serving(args.seed, dev, reset_launches, launch_counts,
                    precision_defaults)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gb_checks, gb_sweep_err, gb_by_route = check_kernel_gb(gen, dev)
    gb_sass = sass_counts("window_attn_bwd_sm90.cu")
    if not (gb_sass["HGMMA"] and gb_sass["UTMALDG"]):
        raise AssertionError(f"kernel Gb's wgmma route: no HGMMA or UTMALDG "
                             f"in its SASS: {gb_sass}")
    log(f"kernel Gb: {gb_checks} cases (B, H/KH 1-8, D 20-256, window 1 to "
        f"> S, softcap, fp32 and bf16, S not a multiple of 32 or 64; "
        f"routes {gb_by_route}; wgmma route SASS {gb_sass}) within "
        f"{GB_TOL[torch.float32]} (fp32, own scale) / "
        f"{GB_TOL[torch.bfloat16]} (bf16, relative L2) of the plain "
        f"version, each bit-equal over two runs; max |diff| "
        f"{gb_sweep_err:.3e}; {time.perf_counter() - t0:.1f} s")
    train = lm_training(args.seed, dev, reset_launches, launch_counts)
    torch.cuda.empty_cache()
    examples_rec = examples_phase(reset_launches, launch_counts)
    torch.cuda.empty_cache()
    dense_rec = dense_lm_phase(args.seed, dev, reset_launches, launch_counts)
    torch.cuda.empty_cache()
    moe_ssm_rec = moe_ssm_lm_phase(args.seed, dev, reset_launches,
                                   launch_counts)

    a, b = new_cases["a"], new_cases["b"]
    sfc_main = sfc_results[0]
    report = {"kernels": [
        {"name": "prefix_sum", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/prefix_sum.cu",
         "replaces": "src/repro/kernels/prefix_sum.py:66",
         "launches": a["launches"]["prefix_sum"], "main_case": a["case"],
         "max_abs_err": 0, "ms": scan_ms, "plain_ms": scan_plain_ms,
         "bound_ms": scan_bound_ms, "bound_by": "bytes",
         "library_ms": cumsum_ms, "shapes": f"int32 ({SCAN_TIMED_N},)",
         "device_ms": scan_dev_ms, "device_launches": scan_launches,
         "library_device_ms": cumsum_dev_ms,
         "library_device_launches": cumsum_launches,
         "kernel_route": "single-pass decoupled look-back, one launch",
         "checks_passed": scan_checks},
        {"name": "xpencil_forces", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/xpencil.cu",
         "replaces": "src/repro/kernels/xpencil.py:148",
         "launches": dense_main["launches"]["xpencil_forces"],
         "main_case": dense_main["case"],
         "max_abs_err": dense_main["xpencil_max_abs_err"],
         "ms": dense_main["xpencil_ms"],
         "plain_ms": dense_main["xpencil_plain_ms"],
         "bound_ms": dense_main["xpencil_bound_ms"],
         "bound_by": dense_main["xpencil_bound_by"], "library_ms": None,
         "shapes": shapes(dense_main["division"], "(d+2)*m_c",
                          "(d, d*m_c)", m_c=dense_main["m_c"]),
         "max_term_rel_err": dense_main["xpencil_term_rel_err"],
         "chunk_cells": dense_main["xpencil_chunk_cells"],
         "ms_by_chunk_cells": dense_main["xpencil_ms_by_chunk_cells"],
         "checks_passed": xp_checks},
        {"name": "xpencil_sparse_forces", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/xpencil.cu",
         "replaces": "src/repro/kernels/xpencil.py:244",
         "launches": b["launches_compact"]["xpencil_sparse_forces"],
         "main_case": b["case"], "max_abs_err": b["kernel_c_max_abs_err"],
         "ms": b["kernel_c_ms"], "plain_ms": b["kernel_c_plain_ms"],
         "bound_ms": b["kernel_c_bound_ms"],
         "bound_by": b["kernel_c_bound_by"], "library_ms": None,
         "shapes": shapes(b["division"], "(d+2)*m_c", "(max_active, d*m_c)",
                          m_c=b["m_c"], max_active=b["max_active"]),
         "max_term_rel_err": b["kernel_c_term_rel_err"],
         "chunk_cells": b["kernel_c_chunk_cells"],
         "ms_by_chunk_cells": b["kernel_c_ms_by_chunk_cells"],
         "checks_passed": sp_checks},
        {"name": "xpencil_packed_forces", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/xpencil.cu",
         "replaces": "src/repro/kernels/xpencil.py:393",
         "launches": a["launches"]["xpencil_packed_forces"],
         "main_case": a["case"], "max_abs_err": a["kernel_d_max_abs_err"],
         "ms": a["kernel_d_ms"], "plain_ms": a["kernel_d_plain_ms"],
         "bound_ms": a["kernel_d_bound_ms"],
         "bound_by": a["kernel_d_bound_by"], "library_ms": None,
         "shapes": shapes(a["division"], "row_cap", "(d*d, row_cap)",
                          row_cap=a["row_cap"],
                          tile_rows=a["kernel_d_tile_rows"],
                          smem_bytes=a["kernel_d_smem_bytes"]),
         "max_term_rel_err": a["kernel_d_term_rel_err"],
         "low_flop_ms": a["kernel_d_low_flop_ms"],
         "ms_in_turns_with_b": a["kernel_d_ms_in_turns"],
         "kernel_b_ms_in_turns": a["kernel_b_ms_in_turns"],
         "queued_ms_in_turns_with_b": a["kernel_d_queued_ms_in_turns"],
         "kernel_b_queued_ms_in_turns": a["kernel_b_queued_ms_in_turns"],
         "queued_ms_by_case": {b["case"]: b["kernel_d_queued_ms"]},
         "ms_by_tile_rows": a["kernel_d_ms_by_tile_rows"],
         "queued_ms_by_tile_rows": a["kernel_d_queued_ms_by_tile_rows"],
         "ms_by_case": {a["case"]: a["kernel_d_ms"],
                        b["case"]: b["kernel_d_ms"]},
         "checks_passed": pk_checks},
        {"name": "pack_slots", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pack.cu",
         "replaces": "src/repro/core/binning.py:548 pack_rows (plain JAX)",
         "launches": a["launches"]["pack_slots"], "main_case": a["case"],
         "max_abs_err": max(a["pack_max_abs_err"], b["pack_max_abs_err"]),
         "ms": a["pack_kernel_ms"], "plain_ms": a["pack_plain_ms"],
         "bound_ms": a["pack_bound_ms"], "bound_by": a["pack_bound_by"],
         "library_ms": None,
         "shapes": shapes(a["division"], "(d+2)*m_c",
                          "(d+2, d+2, row_cap) planes", m_c=a["m_c"],
                          row_cap=a["row_cap"]),
         "pack_rows_ms": a["pack_ms"],
         "pack_rows_ms_by_case": {a["case"]: a["pack_ms"],
                                  b["case"]: b["pack_ms"]},
         "pack_rows_queued_ms_by_case": {a["case"]: a["pack_queued_ms"],
                                         b["case"]: b["pack_queued_ms"]},
         "device_ms_by_case": {a["case"]: a["pack_device_ms"],
                               b["case"]: b["pack_device_ms"]},
         "share_of_bound_by_case": {
             c["case"]: c["pack_bound_ms"] / c["pack_ms"] for c in (a, b)},
         "bound_ms_by_case": {a["case"]: a["pack_bound_ms"],
                              b["case"]: b["pack_bound_ms"]},
         "launch_calls_a_call": a["pack_launch_calls"],
         "execute_launch_calls": {
             "packed": a["execute_launch_calls"],
             "dense": a["dense_execute_launch_calls"],
             "compact packed blob": b["execute_launch_calls"],
             "compact blob": b["compact_execute_launch_calls"]},
         "queued_ms_by_case": {a["case"]: a["pack_kernel_queued_ms"],
                               b["case"]: b["pack_kernel_queued_ms"]},
         "ms_by_case": {a["case"]: a["pack_kernel_ms"],
                        b["case"]: b["pack_kernel_ms"]},
         "checks_passed": pack_checks},
        {"name": "allin_forces", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/allin.cu",
         "replaces": "src/repro/kernels/allin.py:129",
         "launches": dense_main["allin_launches"]["allin_forces"],
         "main_case": f"allin {dense_main['case']}",
         "max_abs_err": dense_main["allin_max_abs_err"],
         "ms": dense_main["allin_ms"],
         "plain_ms": dense_main["allin_plain_ms"],
         "bound_ms": dense_main["xpencil_bound_ms"],
         "bound_by": dense_main["xpencil_bound_by"], "library_ms": None,
         "shapes": shapes(dense_main["division"], "(d+2)*m_c",
                          "(d, d*m_c)", m_c=dense_main["m_c"],
                          box=dense_main["allin_box"],
                          smem_bytes=dense_main["allin_smem_bytes"]),
         "max_term_rel_err": dense_main["allin_term_rel_err"],
         "low_flop_ms": dense_main["allin_low_flop_ms"],
         "threads": dense_main["allin_threads"],
         "ms_by_threads": dense_main["allin_ms_by_threads"],
         "pair_steps": dense_main["allin_pair_steps"],
         "ms_by_case": {r["case"]: r["allin_ms"] for r in results}
         | {"blob": new_cases["c_blob"]["kernel_e_ms"]},
         "checks_passed": al_checks},
        {"name": "cell_sfc_forces", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sfc.cu",
         "replaces": "src/repro/kernels/sfc.py:139",
         "launches": sfc_main["launches"]["cell_sfc_forces"],
         "main_case": sfc_main["case"],
         "max_abs_err": sfc_main["kernel_f_max_abs_err"],
         "ms": sfc_main["kernel_f_ms"],
         "plain_ms": sfc_main["kernel_f_plain_ms"],
         "bound_ms": sfc_main["kernel_f_bound_ms"],
         "bound_by": sfc_main["kernel_f_bound_by"], "library_ms": None,
         "shapes": shapes(dense_main["division"], "(d+2)*m_c",
                          "(n_clusters, csize*m_c)", m_c=sfc_main["m_c"],
                          csize=sfc_main["csize"],
                          n_clusters=sfc_main["n_clusters"],
                          pair_cap=sfc_main["pair_cap"],
                          n_pairs=sfc_main["n_pairs"]),
         "max_term_rel_err": sfc_main["kernel_f_term_rel_err"],
         "low_flop_ms": sfc_main["kernel_f_low_flop_ms"],
         "pair_steps": sfc_main["kernel_f_pair_steps"],
         "ms_by_case": {r["case"]: r["kernel_f_ms"] for r in sfc_results},
         "checks_passed": sfc_checks},
        {"name": "window_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/window_attn_sm90.cu (bf16, "
                   "D % 16 == 0), src/repro_torch/kernels/csrc/"
                   "window_attn.cu (fp32, other D)",
         "replaces": "src/repro/kernels/window_attn.py:104",
         "launches": lm["launches"]["window_attention"],
         "main_case": lm["case"],
         "max_abs_err": max(g_sweep_err, lm["kernel_g_captured_max_abs_err"]),
         "ms": lm["kernel_g_ms"], "plain_ms": lm["kernel_g_plain_ms"],
         "bound_ms": lm["kernel_g_bound_ms"],
         "bound_by": lm["kernel_g_bound_by"], "library_ms": lm["sdpa_ms"],
         "library_call": "scaled_dot_product_attention(attn_mask=band, "
                         "enable_gqa=True), softcap 0",
         "device_ms": lm["kernel_g_device_ms"],
         "device_ms_from": "torch.profiler, the prefill's 13 launches",
         "kernel_route": "wgmma (bf16 tensor cores, TMA); main path routes "
                         f"{lm['routes']}, sweep routes {g_by_route}",
         "tflops": lm["kernel_g_tflops"],
         "sdpa_causal_flash_ms": lm["sdpa_causal_flash_ms"],
         "sdpa_causal_flash_tflops": lm["sdpa_causal_flash_tflops"],
         "sass": g_sass, "training_launches":
             train["launches"]["window_attention"],
         "shapes": lm["shapes"], "checks_passed": g_checks + 1},
        {"name": "window_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/window_attn_bwd_sm90.cu",
         "simt_source": "src/repro_torch/kernels/csrc/window_attn_bwd.cu",
         "replaces": None,
         "replaces_note": "kernel G's gradient; JAX trains through XLA's "
                          "autodiff of window_attention_blocked",
         "launches": train["launches"]["window_attention_bwd"],
         "main_case": train["case"],
         "max_abs_err": max(gb_sweep_err, train["kernel_gb_max_abs_err"],
                            train["kernel_gb_fp32_max_abs_err"]),
         "ms": train["kernel_gb_ms"], "plain_ms": train["kernel_gb_plain_ms"],
         "bound_ms": train["kernel_gb_bound_ms"],
         "bound_by": train["kernel_gb_bound_by"],
         "library_ms": train["sdpa_bwd_ms"],
         "library_call": "scaled_dot_product_attention(attn_mask=band, "
                         "enable_gqa=True), softcap 0: its backward "
                         "through autograd",
         "softcap0_ms": train["kernel_gb_softcap0_ms"],
         "device_ms": train["kernel_gb_device_ms"],
         "device_ms_from": "torch.profiler, a train step's 13 calls",
         "kernel_route": "wgmma (bf16 tensor cores, TMA; prep, dK/dV, dQ "
                         "launches; reads G's lse); main path routes "
                         f"{train['gb_routes']}, sweep routes {gb_by_route}; "
                         "fp32 and other D: SIMT (stats, dK/dV, dQ)",
         "simt_ms": train["kernel_gb_simt_ms"],
         "work_bound_ms": train["kernel_gb_work_bound_ms"],
         "work_tflops": train["kernel_gb_work_tflops"],
         "sass": gb_sass,
         "tflops": train["kernel_gb_tflops"],
         "rel_l2": train["kernel_gb_rel_l2"],
         "fp32_case": {"shape": train["kernel_gb_fp32_case"],
                       "errs": train["kernel_gb_fp32_errs"],
                       "ms": train["kernel_gb_fp32_ms"]},
         "training_launches": train["launches"]["window_attention_bwd"],
         "shapes": train["shapes"], "checks_passed": gb_checks + 2},
    ]}
    for entry in report["kernels"]:
        entry["trajectory_launches"] = traj_rec["launches"].get(
            entry["name"], 0)
        entry["serving_launches"] = serve_rec["serving_launches"].get(
            entry["name"], {})
        entry["halo_launches"] = halo_rec["launches"].get(entry["name"], 0)
        entry["examples_launches"] = examples_rec["launches"].get(
            entry["name"], 0)
        entry["dense_lm_launches"] = sum(
            dense_rec[a]["launches"].get(entry["name"], 0)
            for a in DENSE_ARCHS)
        entry["moe_lm_launches"] = moe_ssm_rec["launches"].get(
            entry["name"], 0)
        if entry["name"] in batch_launches:
            entry["launches_per_execute_batch"] = sorted(
                batch_launches[entry["name"]])
            entry["execute_batch"] = batch_by_kernel.get(entry["name"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
