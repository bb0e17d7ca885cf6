"""The CUDA kernels against their plain versions, on the card.

Skipped without a CUDA device (decided inside the fixture, never at import).
On the card: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` repeats these checks at the main path's sizes.
"""

import pytest
import torch

from repro_torch.core import Domain, ParticleState, make_low_flop, plan
from repro_torch.core import prefix as plain_prefix
from repro_torch.core import strategies as S
from repro_torch.core.binning import bin_particles
from repro_torch.kernels.prefix_sum import prefix_sum
from repro_torch.kernels.xpencil import xpencil_forces

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 5000, 1024 ** 2 + 3])
def test_scan_kernel_exact(gen, n):
    x = torch.randint(0, 10, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    assert torch.equal(prefix_sum(x), torch.cumsum(x, 0, dtype=torch.int32))
    assert torch.equal(plain_prefix.exclusive_prefix_sum(x, scan=prefix_sum),
                       plain_prefix.exclusive_prefix_sum(x))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m_c", [8, 24, 300])
def test_xpencil_kernel_matches_plain(gen, periodic, m_c):
    dom = Domain(box=(5.0, 4.0, 3.0), ncells=(5, 4, 3), cutoff=1.0,
                 periodic=periodic)
    pos = dom.sample_uniform(240, generator=gen, device="cuda")
    bins = bin_particles(dom, pos, m_c=m_c)
    kern = make_low_flop()
    got = xpencil_forces(bins.planes, bins.slot_id, nx=5, m_c=m_c,
                         kernel=kern, cutoff2=1.0)
    want = S.xpencil_planes(bins.planes["x"], bins.planes["y"],
                            bins.planes["z"], bins.slot_id, nx=5, m_c=m_c,
                            kernel=kern, cutoff2=1.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_main_path_launches_both_kernels(gen):
    dom = Domain.cubic(6, periodic=True)
    pos = dom.sample_uniform(800, generator=gen, device="cuda")
    p = plan(dom, positions=pos)
    prefix_sum.launches = xpencil_forces.launches = 0
    f, u = p.execute(ParticleState(pos))
    torch.cuda.synchronize()
    assert prefix_sum.launches == 1 and xpencil_forces.launches == 1
    assert bool(f.isfinite().all()) and bool(u.isfinite().all())
