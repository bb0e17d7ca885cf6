"""Kernel G's plain version and the port's attention paths against JAX.

Inputs are made with numpy from a seed and go through the port's
``window_attention`` (on CPU tensors: the plain version), JAX's Pallas
``window_attention`` in interpret mode (as tests/test_kernels.py runs it)
and the port's ``window_attention_ref``. Tolerances are the JAX kernel
tests': 3e-4 in fp32, 2e-2 in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import window_attention as jax_window_attention
from repro.kernels import ref as JR
from repro.models import attention as JA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels.window_attn import (MAX_D, route, smem_bytes,
                                             wgmma_smem_bytes,
                                             window_attention,
                                             window_attention_plain)
from repro_torch.kernels._common import MAX_SMEM
from repro_torch.models import attention as TA

torch.set_num_threads(1)

TOL = {"float32": 3e-4, "bfloat16": 2e-2}


def _qkv(b, h, kh, s, d, dtype="float32", seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32) * scale
    k = rng.standard_normal((b, kh, s, d)).astype(np.float32) * scale
    v = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    if dtype == "bfloat16":     # round once so both sides see the same bits
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _vs_jax(b, h, kh, s, d, window, blk, softcap=0.0, dtype="float32",
            scale=1.0):
    q, k, v = _qkv(b, h, kh, s, d, dtype, scale=scale)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = window_attention(tq, tk, tv, window=window, blk=blk,
                           softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jax_window_attention(*(_jax(a, dtype) for a in (q, k, v)),
                                window=window, blk=blk, softcap=softcap,
                                interpret=True)
    ref = TR.window_attention_ref(tq, tk, tv, window=window, softcap=softcap)
    tol = TOL[dtype]
    _close(got.float(), want, tol)
    _close(got.float(), ref.float(), tol)


@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("window,blk", [(16, 8), (32, 16), (64, 8)])
def test_plain_matches_jax_kernel_and_ref(h, kh, window, blk):
    _vs_jax(2, h, kh, 64, 16, window, blk)


@pytest.mark.parametrize("window", [5, 13, 64, 200],
                         ids=["below-tile", "not-a-multiple", "equal-S",
                              "above-S"])
def test_plain_windows(window):
    _vs_jax(1, 4, 2, 64, 8, window, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_softcap_and_dtypes(dtype):
    _vs_jax(1, 4, 2, 32, 8, 16, 8, softcap=20.0, dtype=dtype, scale=3.0)
    _vs_jax(1, 4, 4, 32, 8, 8, 8, dtype=dtype)


def test_ref_matches_jax_ref():
    q, k, v = _qkv(2, 6, 2, 48, 8, seed=3, scale=2.0)
    want = JR.window_attention_ref(q, k, v, window=12, softcap=30.0)
    got = TR.window_attention_ref(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), window=12, softcap=30.0)
    _close(got, want, 1e-5)


def test_wrapper_contract():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 2, 32, 8))
    assert torch.equal(ops.window_attention(q, k, v, window=8, blk=8),
                       window_attention_plain(q, k, v, window=8, blk=8))
    with pytest.raises(ValueError, match="multiple of blk"):
        window_attention(q, k, v, window=8, blk=12)
    with pytest.raises(ValueError, match="H % KH"):
        window_attention(q[:, :3], k, v, window=8, blk=8)
    with pytest.raises(ValueError, match="window 0"):
        window_attention(q, k, v, window=0, blk=8)
    window_attention.launches = 0
    window_attention.launches_by_route = dict.fromkeys(("wgmma", "simt"), 0)
    window_attention(q, k, v, window=8, blk=8)
    window_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), window=8,
                     blk=8)
    assert window_attention.launches == 0        # CPU: the plain version
    assert window_attention.launches_by_route == {"wgmma": 0, "simt": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_window_attention_blocked_matches_jax(dtype, softcap):
    q, k, v = _qkv(2, 4, 2, 32, 16, dtype, seed=4, scale=2.0)
    want = JA.window_attention_blocked(*(_jax(a, dtype) for a in (q, k, v)),
                                       window=8, softcap=softcap)
    got = TA.window_attention_blocked(*(_torch(a, dtype) for a in (q, k, v)),
                                      window=8, softcap=softcap)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float(), want, TOL[dtype])
    # kernel G's plain version computes the same function
    plain = window_attention(*(_torch(a, dtype) for a in (q, k, v)), window=8,
                             blk=8, softcap=softcap)
    _close(plain.float(), got.float(), TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 16)])
def test_flash_attention_matches_jax(causal, s, chunk):
    q, k, v = _qkv(2, 4, 2, s, 16, seed=5, scale=2.0)
    want = JA.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal,
                              50.0, chunk, chunk)
    got = TA.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), causal, 50.0, chunk, chunk)
    _close(got, want, 3e-4)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_jax(window):
    q, _, _ = _qkv(2, 4, 2, 1, 16, seed=6)
    _, k, v = _qkv(2, 4, 2, 20, 16, seed=7)
    want = JA.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.int32(13), window=window, softcap=50.0)
    got = TA.decode_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), 13, window=window,
                              softcap=50.0)
    _close(got, want, 3e-4)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 16, "simt"), (torch.float32, 256, "simt"),
    (torch.bfloat16, 20, "simt"), (torch.bfloat16, 8, "simt"),
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 48, "wgmma"), (torch.bfloat16, 264, "simt")])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    """fp32 stays on the CUDA cores (TF32 would miss 3e-4); bf16 takes the
    tensor cores where wgmma's depth of 16 divides D."""
    assert route(dtype, d) == want


def test_wgmma_route_shared_memory():
    """Q (128 rows), K and V (2 stages of 64 keys) in bf16, 7 mbarriers and
    1 KB of alignment slack: 197,688 B at D = 256, under the 227 KB a block
    may opt in to, for every D the route takes."""
    assert wgmma_smem_bytes(256) == 2 * 256 * (128 + 4 * 64) + 56 + 1024
    assert wgmma_smem_bytes(256) == 197_688
    assert wgmma_smem_bytes(128) == 99_384
    for d in range(16, MAX_D + 1, 16):
        assert route(torch.bfloat16, d) == "wgmma"
        assert wgmma_smem_bytes(d) <= MAX_SMEM
    assert smem_bytes(256) == 99_328                 # the SIMT route's
