"""The port's §6 scan against the JAX package's (bit-exact, integer data)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import prefix as jprefix
from repro.kernels.prefix_sum import prefix_sum as jax_pallas_prefix_sum
from repro_torch.core import prefix as tprefix
from repro_torch.kernels import ref as tref
from repro_torch.kernels.prefix_sum import TILE, prefix_sum, status_words

torch.set_num_threads(1)

_J_INC = jax.jit(jprefix.paper_prefix_sum)
_J_EXC = jax.jit(jprefix.exclusive_prefix_sum)

SIZES = [1, 2, 3, 7, 8, 9, 1000, 4097]


def _counts(n, seed=0):
    return np.random.default_rng(seed + n).integers(0, 12, n).astype(np.int32)


@pytest.mark.parametrize("n", SIZES)
def test_scans_equal_jax_and_cumsum(n):
    x = _counts(n)
    inc = np.cumsum(x).astype(np.int32)
    exc = np.concatenate([[0], inc[:-1]]).astype(np.int32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tprefix.paper_prefix_sum(t).numpy(), inc)
    np.testing.assert_array_equal(tprefix.exclusive_prefix_sum(t).numpy(), exc)
    np.testing.assert_array_equal(
        np.asarray(_J_INC(jnp.asarray(x))), inc)
    np.testing.assert_array_equal(
        np.asarray(_J_EXC(jnp.asarray(x))), exc)
    # the wrapper on a CPU tensor runs the plain version
    np.testing.assert_array_equal(prefix_sum(t).numpy(), inc)
    np.testing.assert_array_equal(
        tprefix.exclusive_prefix_sum(t, scan=prefix_sum).numpy(), exc)
    np.testing.assert_array_equal(tref.prefix_sum_ref(t).numpy(), inc)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("tile", [2, 8, 1024])
def test_tile_composed_scan_equals_cumsum(n, tile):
    """The CUDA kernel's three-pass composition, in plain PyTorch."""
    x = _counts(n, seed=1)
    np.testing.assert_array_equal(
        tprefix.tiled_prefix_sum(torch.from_numpy(x), tile).numpy(),
        np.cumsum(x).astype(np.int32))


@pytest.mark.parametrize("n", SIZES + [16, 1024, 2 ** 20])
def test_operation_counts_equal_jax(n):
    assert tprefix.operation_counts(n) == jprefix.operation_counts(n)
    assert tprefix.blelloch_counts(n) == jprefix.blelloch_counts(n)
    assert tprefix.paper_height(n) == jprefix.paper_height(n)


@pytest.mark.parametrize("n", [1, 5, 16, 33])
def test_jax_pallas_kernel_agrees(n):
    x = _counts(n, seed=2)
    got = np.asarray(jax_pallas_prefix_sum(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(
        got, tprefix.paper_prefix_sum(torch.from_numpy(x)).numpy())


def test_scratch_matches_recursion():
    """The kernel's status buffer: the ticket counter, then two arrays
    (alternate launches) of one status word per tile, the carries the
    look-back reads where the three-pass scan recursed over tile totals."""
    assert TILE == 1024
    assert status_words(1) == status_words(1024) == 3
    assert status_words(1025) == 5
    assert status_words(2_097_157) == 1 + 2 * 2049
    assert status_words(262_144) == 1 + 2 * 256
    # a tile's carry is the scan of the totals before it, as the
    # look-back computes it
    x = torch.from_numpy(_counts(5000, seed=3))
    totals = torch.stack([t.sum() for t in x.split(TILE)])
    carry = torch.cumsum(totals, 0) - totals
    got = tprefix.tiled_prefix_sum(x, TILE)
    for i, c in enumerate(carry.tolist()):
        tile = x[i * TILE:(i + 1) * TILE]
        assert torch.equal(got[i * TILE:(i + 1) * TILE],
                           torch.cumsum(tile, 0, dtype=torch.int32) + c)
