"""Kernel G's lse residual and kernel Gb's routes, on the CPU.

Kernel Gb's wgmma route reads the log-sum-exp kernel G writes in its
forward instead of recomputing the scores. Here, on CPU tensors, the plain
versions carry that contract: G's plain lse against the residual JAX's
``_flash_fwd`` keeps (full causal) and a numpy log-sum-exp over the band,
Gb's plain version given the lse against the one that recomputes it, the
autograd path (which now hands the forward's lse to the backward) against
JAX's vjp of ``window_attention_blocked``, and the route function and the
wgmma route's tile and shared-memory constants against the CUDA source.
Inputs are made with numpy from a seed. Tolerances: 1e-5 for an lse (fp32
sums in another order), 1e-6 scale-relative between the two plain
backwards (one exp of the same row's lse), 3e-4 scale-relative against
JAX's gradients (tests/test_kernels.py's fp32 tolerance).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels import _build
from repro_torch.kernels._common import MAX_SMEM
from repro_torch.kernels.window_attn import (BWD_WGMMA_STAGES,
                                             BWD_WGMMA_TILE, MAX_D,
                                             bwd_route, bwd_wgmma_smem_bytes,
                                             route, window_attention,
                                             window_attention_bwd,
                                             window_attention_bwd_plain,
                                             window_attention_plain,
                                             window_attention_with_lse)

torch.set_num_threads(1)

SRC = _build.CSRC / "window_attn_bwd_sm90.cu"


def _rand(rng, *shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


def _scale_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _band_lse(q, k, window, softcap):
    """numpy log-sum-exp of each row's scaled, capped scores over its
    window, in float64."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    kk = np.repeat(k.astype(np.float64), h // kh, axis=1)
    sc = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) * d ** -0.5, kk)
    if softcap > 0.0:
        sc = softcap * np.tanh(sc / softcap)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    sc = np.where((j <= i) & (i - j < window), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    return (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("h,kh,s,d,softcap", [
    (4, 2, 32, 16, 50.0), (4, 4, 24, 8, 0.0), (8, 1, 40, 16, 50.0)],
    ids=["gqa2-cap", "mha", "gqa8-cap"])
def test_plain_lse_matches_jax_flash_residual(h, kh, s, d, softcap):
    """At window >= S (full causal) the plain G's lse is the residual JAX's
    ``_flash_fwd`` saves for its backward, within 1e-5, and its output is
    the one without ``return_lse``."""
    rng = np.random.default_rng(s + h)
    q, k = _rand(rng, 2, h, s, d, scale=3.0), _rand(rng, 2, kh, s, d,
                                                     scale=3.0)
    v = _rand(rng, 2, kh, s, d)
    _, res = JA._flash_fwd(*map(jnp.asarray, (q, k, v)), True, softcap, 8,
                           8)
    want = np.asarray(res[4]).reshape(2, h, s)
    ts = [torch.tensor(a) for a in (q, k, v)]
    out, lse = window_attention_plain(*ts, window=s + 5, blk=8,
                                      softcap=softcap, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, h, s)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(out, window_attention_plain(*ts, window=s + 5, blk=8,
                                                   softcap=softcap))


@pytest.mark.parametrize("s,window,blk,softcap", [
    (40, 13, 8, 50.0), (64, 8, 16, 0.0), (48, 1, 16, 50.0)],
    ids=["ragged-window", "window-tiles", "window1"])
def test_plain_lse_matches_numpy_band(s, window, blk, softcap):
    """At window < S the plain G's lse is a numpy log-sum-exp over each
    row's band within 1e-5, and the autograd-free wrapper gives the same on
    CPU tensors."""
    rng = np.random.default_rng(s * window)
    q, k = _rand(rng, 1, 4, s, 8, scale=3.0), _rand(rng, 1, 2, s, 8,
                                                     scale=3.0)
    v = _rand(rng, 1, 2, s, 8)
    ts = [torch.tensor(a) for a in (q, k, v)]
    _, lse = window_attention_plain(*ts, window=window, blk=blk,
                                    softcap=softcap, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), _band_lse(q, k, window, softcap),
                               rtol=0, atol=1e-5)
    _, lse2 = window_attention_with_lse(*ts, window=window, blk=blk,
                                        softcap=softcap)
    assert torch.equal(lse2, lse)


@pytest.mark.parametrize("s,window,softcap,h,kh", [
    (40, 13, 0.0, 4, 2), (64, 8, 50.0, 4, 4), (24, 100, 50.0, 2, 1),
    (48, 1, 50.0, 4, 2)],
    ids=["ragged-window", "window-tiles", "window-past-s", "window1"])
def test_plain_bwd_with_lse_equals_recomputed(s, window, softcap, h, kh):
    """Gb's plain version given G's lse equals the one that recomputes it,
    within 1e-6 of each gradient's scale (dv's at window 1, where dq and dk
    are zero but for rounding)."""
    rng = np.random.default_rng(s + window)
    q, k = _rand(rng, 1, h, s, 8, scale=3.0), _rand(rng, 1, kh, s, 8,
                                                     scale=3.0)
    v, do = _rand(rng, 1, kh, s, 8), _rand(rng, 1, h, s, 8)
    ts = [torch.tensor(a) for a in (q, k, v)]
    out, lse = window_attention_plain(*ts, window=window, blk=8,
                                      softcap=softcap, return_lse=True)
    args = (*ts, out, torch.tensor(do))
    got = window_attention_bwd_plain(*args, window=window, softcap=softcap,
                                     lse=lse)
    want = window_attention_bwd_plain(*args, window=window, softcap=softcap)
    via_wrapper = window_attention_bwd(*args, window=window, softcap=softcap,
                                       lse=lse)
    floor = float(want[2].abs().max())
    for g, w, x in zip(got, want, via_wrapper):
        assert torch.equal(g, x)
        scale = floor if window == 1 else float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("h,kh,window,softcap", [
    (4, 2, 8, 50.0), (8, 1, 16, 0.0)], ids=["gqa2-cap", "gqa8"])
def test_autograd_hands_the_lse_to_the_backward(h, kh, window, softcap,
                                                monkeypatch):
    """Through ``window_attention``'s autograd the backward receives the
    forward's lse (it is not recomputed), and the gradients stay within
    3e-4 of jax.grad of JAX's window_attention_blocked; without a gradient
    (``torch.no_grad``) the forward keeps no lse."""
    from repro_torch.kernels import window_attn as WA
    rng = np.random.default_rng(h * window)
    s, d = 32, 16
    q, k = _rand(rng, 2, h, s, d, scale=3.0), _rand(rng, 2, kh, s, d,
                                                     scale=3.0)
    v, do = _rand(rng, 2, kh, s, d), _rand(rng, 2, h, s, d)
    seen, real = [], WA.window_attention_bwd

    def spy(*a, **kw):
        seen.append(kw["lse"])
        return real(*a, **kw)
    monkeypatch.setattr(WA, "window_attention_bwd", spy)
    calls = []
    real_fwd = WA._forward

    def fwd_spy(*a, **kw):
        calls.append(kw["with_lse"])
        return real_fwd(*a, **kw)
    monkeypatch.setattr(WA, "_forward", fwd_spy)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = window_attention(*ts, window=window, blk=8, softcap=softcap)
    got = torch.autograd.grad(out, ts, torch.tensor(do))
    assert calls == [True] and len(seen) == 1 and seen[0] is not None
    _, lse = window_attention_plain(*ts, window=window, blk=8,
                                    softcap=softcap, return_lse=True)
    assert torch.equal(seen[0], lse.detach())

    def f(q, k, v):
        return jnp.sum(JA.window_attention_blocked(
            q, k, v, window=window, softcap=softcap) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, g, w in zip("qkv", got, want):
        assert _scale_rel(g.numpy(), w) <= 3e-4, name
    with torch.no_grad():
        window_attention(*ts, window=window, blk=8, softcap=softcap)
    assert calls == [True, False]


def test_bwd_route_equals_route():
    """Gb takes the tensor cores exactly where G does (the wgmma backward
    reads the lse only G's wgmma route writes): every dtype and D <= 256."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in range(1, MAX_D + 1):
            assert bwd_route(dtype, d) == route(dtype, d), (dtype, d)
    assert bwd_route(torch.bfloat16, 256) == "wgmma"
    assert bwd_route(torch.bfloat16, 20) == "simt"
    assert bwd_route(torch.float32, 256) == "simt"


def test_wgmma_bwd_constants_match_the_cuda_source():
    """The wrapper's tile rows, stages and shared-memory bytes are the
    source's (``kTile``, ``kStages``, ``dkdv_smem_bytes``,
    ``dq_smem_bytes``): at D = 256 the figures its header states, and
    within a block's 227 KB at every D the route takes."""
    src = SRC.read_text()
    assert f"constexpr int kTile = {BWD_WGMMA_TILE};" in src
    assert f"constexpr int kStages = {BWD_WGMMA_STAGES};" in src
    assert bwd_wgmma_smem_bytes(256) == (215_080, 197_672)
    assert "dK/dV\n// 215,080 B" in src and "dQ 197,672 B" in src
    for d in range(16, MAX_D + 1, 16):
        assert max(bwd_wgmma_smem_bytes(d)) <= MAX_SMEM, d


@pytest.mark.parametrize("source,entry,n_args", [
    ("window_attn_sm90.cu", "window_attention_sm90", 14),
    ("window_attn_bwd_sm90.cu", "window_attention_bwd_sm90", 20)])
def test_new_signatures_have_one_ctypes_entry_per_c_argument(source, entry,
                                                             n_args):
    """G's entry with its lse pointer and Gb's wgmma entry: one argtype a C
    parameter, pointers (the lse, the scratch, the stream) as c_void_p."""
    text = (_build.CSRC / source).read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
    params = [p.strip() for p in params.split(",")]
    argtypes = _build.SIGNATURES[source][entry]
    assert len(params) == len(argtypes) == n_args
    for p, t in zip(params, argtypes):
        assert (t is ctypes.c_void_p) == ("*" in p), p


def test_bwd_on_the_cpu_takes_bf16_and_checks_the_lse_shape():
    """On CPU tensors the wrapper runs the plain version whatever the
    dtype, and an lse of the wrong shape raises before anything runs."""
    rng = np.random.default_rng(1)
    q = torch.tensor(_rand(rng, 1, 4, 16, 16)).bfloat16()
    k = torch.tensor(_rand(rng, 1, 2, 16, 16)).bfloat16()
    _, lse = window_attention_plain(q, k, k, window=4, blk=8,
                                    return_lse=True)
    dq, dk, dv = window_attention_bwd(q, k, k, q, q, window=4, lse=lse)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    with pytest.raises(ValueError, match="lse must have shape"):
        window_attention_bwd(q, k, k, q, q, window=4, lse=lse[:, :2])
