"""The port's Mamba-2 block (``repro_torch/models/ssm.py``) against the JAX
package's ``repro/models/ssm.py``, on the CPU.

Inputs from a numpy seed, weights from JAX's ``init_mamba2`` (with its
zero-initialised ``a_log``, ``dt_bias``, ``conv_b`` and ``norm_scale``
replaced by seeded values, so every term is exercised), in float32. SSD
at chunk 4, 8 and 32 and at a length no chunk divides (JAX's dt = 0
padding) within 1e-5 scale-relative of JAX's and of a numpy step-by-step
recurrence (tests/test_moe.py's reference); the causal conv and the
segment sums within 1e-6; ``mamba2_block`` and 6 ``mamba2_decode`` steps
(output and both caches) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JSSM
from repro_torch.models import ssm as TSSM

torch.set_num_threads(1)

TOL = 1e-5
B, D, D_INNER, HEADDIM, STATE, CONV = 2, 32, 64, 16, 8, 4
N_HEADS = D_INNER // HEADDIM


def _scale_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ssd_inputs(s, seed=0, h=2, p=4, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((B, s, n)).astype(np.float32)
    cm = rng.standard_normal((B, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


def _naive_ssd(x, dt, a, bm, cm):
    h = np.zeros((x.shape[0], x.shape[2], x.shape[3], bm.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        decay = np.exp(dt[:, t] * a)
        dx = x[:, t] * dt[:, t][..., None]
        h = h * decay[..., None, None] + np.einsum("bhp,bn->bhpn", dx,
                                                   bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, cm[:, t]))
    return np.stack(ys, 1)


@pytest.mark.parametrize("s,chunk", [(32, 4), (32, 8), (32, 32), (30, 8),
                                     (13, 32)])
def test_ssd_chunked_matches_jax_and_the_recurrence(s, chunk):
    args = _ssd_inputs(s)
    got = TSSM.ssd_chunked(*(torch.tensor(v) for v in args), chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == args[0].shape
    want = np.asarray(JSSM.ssd_chunked(*(jnp.asarray(v) for v in args),
                                       chunk))
    assert _scale_rel(got.numpy(), want) <= TOL
    assert _scale_rel(got.numpy(), _naive_ssd(*args)) <= 1e-4


def test_causal_conv_and_segsum_match_jax():
    rng = np.random.default_rng(1)
    u = rng.standard_normal((B, 9, 6)).astype(np.float32)
    w = rng.standard_normal((CONV, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = TSSM._causal_conv(torch.tensor(u), torch.tensor(w), torch.tensor(b))
    assert _scale_rel(got.numpy(), JSSM._causal_conv(u, w, b)) <= 1e-6
    x = rng.standard_normal((2, 3, 7)).astype(np.float32)
    got, want = TSSM._segsum(torch.tensor(x)).numpy(), np.asarray(
        JSSM._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def _block_params(seed=0):
    jp = JSSM.init_mamba2(jax.random.PRNGKey(seed), D, D_INNER, N_HEADS,
                          STATE, CONV, jnp.float32)
    rng = np.random.default_rng(seed + 10)
    tree = {k: np.asarray(v) for k, v in jp.items()}
    for k in ("a_log", "dt_bias", "conv_b", "norm_scale"):
        tree[k] = (0.3 * rng.standard_normal(tree[k].shape)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.tensor(v) for k, v in tree.items()})


def test_init_mamba2_has_jax_shapes_and_dtypes():
    jp = JSSM.init_mamba2(jax.random.PRNGKey(0), D, D_INNER, N_HEADS, STATE,
                          CONV, jnp.bfloat16)
    tp = TSSM.init_mamba2(torch.Generator().manual_seed(0), D, D_INNER,
                          N_HEADS, STATE, CONV, torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in tp.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    for k in ("a_log", "dt_bias", "conv_b", "norm_scale"):
        assert not tp[k].any(), k
    assert bool((tp["d_skip"] == 1).all())
    cache = TSSM.init_mamba_cache(B, D_INNER, STATE, N_HEADS, HEADDIM, CONV,
                                  torch.bfloat16, "cpu")
    jcache = JSSM.init_mamba_cache(B, D_INNER, STATE, N_HEADS, HEADDIM, CONV,
                                   jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    assert cache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("s,chunk", [(24, 8), (21, 8)])
def test_mamba2_block_matches_jax(s, chunk):
    jp, tp = _block_params()
    x = np.random.default_rng(2).standard_normal((B, s, D)).astype(np.float32)
    kw = dict(d_inner=D_INNER, state=STATE, n_heads=N_HEADS,
              headdim=HEADDIM, chunk=chunk)
    want = JSSM.mamba2_block(jnp.asarray(x), jp, **kw)
    got = TSSM.mamba2_block(torch.tensor(x), tp, **kw)
    assert _scale_rel(got.numpy(), want) <= TOL


def test_mamba2_decode_steps_match_jax_and_the_block():
    """Six single-token steps from a zeroed cache: each output and the
    final conv window and SSM state within TOL of JAX's, and the outputs
    within TOL of ``mamba2_block`` over the same six tokens."""
    jp, tp = _block_params(1)
    s = 6
    x = np.random.default_rng(3).standard_normal((B, s, D)).astype(np.float32)
    kw = dict(d_inner=D_INNER, state=STATE, n_heads=N_HEADS,
              headdim=HEADDIM)
    jc = JSSM.init_mamba_cache(B, D_INNER, STATE, N_HEADS, HEADDIM, CONV,
                               jnp.float32)
    tc = TSSM.init_mamba_cache(B, D_INNER, STATE, N_HEADS, HEADDIM, CONV,
                               torch.float32, "cpu")
    conv, ssm = tc["conv"], tc["ssm"]
    outs = []
    for t in range(s):
        jy, jc = JSSM.mamba2_decode(jnp.asarray(x[:, t:t + 1]), jp, jc, **kw)
        ty, tc = TSSM.mamba2_decode(torch.tensor(x[:, t:t + 1]), tp, tc,
                                    **kw)
        assert _scale_rel(ty.numpy(), jy) <= TOL, t
        outs.append(ty)
    assert tc["conv"] is conv and tc["ssm"] is ssm        # in place
    for k in ("conv", "ssm"):
        assert _scale_rel(tc[k].numpy(), jc[k]) <= TOL, k
    full = TSSM.mamba2_block(torch.tensor(x), tp, chunk=4, **kw)
    assert _scale_rel(torch.cat(outs, 1).numpy(), full.numpy()) <= TOL
