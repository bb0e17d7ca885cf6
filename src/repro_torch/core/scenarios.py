"""Inhomogeneous particle scenarios (port of ``repro.core.scenarios``).

The regimes the paper's "few particles per cell" premise comes from (SPH
free surfaces, astrophysical clustering, droplets) are inhomogeneous: most
cells, and so most pencils, are empty. These samplers make such scenes; they
drive the occupancy-compacted path.

Every sampler has the signature ``(domain, n, *, generator=None,
device=None, **knobs) -> (n, 3)`` float32 positions strictly inside the
box. ``device`` None means the CUDA card and raises when none is visible;
``generator`` must live on ``device``. Torch's generators do not give
``jax.random``'s numbers, so a test that compares the two packages makes
its positions with numpy instead.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ._device import resolve_device
from .domain import Domain

# margin keeping clipped samples strictly inside the open box
_EDGE = 1e-4


def _box(domain: Domain, device) -> torch.Tensor:
    return torch.tensor(domain.box, dtype=torch.float32, device=device)


def _clip(domain: Domain, pos: torch.Tensor) -> torch.Tensor:
    box = _box(domain, pos.device)
    return torch.minimum(torch.clamp(pos, min=_EDGE), box - _EDGE)


def _unit_directions(n: int, generator, device) -> torch.Tensor:
    d = torch.randn((n, 3), generator=generator, device=device)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def sample_uniform(domain: Domain, n: int, *,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
    """The paper's homogeneous baseline (fill fraction ~1 at useful N)."""
    return domain.sample_uniform(n, generator=generator, device=device)


def sample_gaussian_blob(domain: Domain, n: int, *,
                         generator: Optional[torch.Generator] = None,
                         device=None, sigma_frac: float = 0.08,
                         center_frac: float = 0.5) -> torch.Tensor:
    """One Gaussian cluster: ``sigma = sigma_frac * min(box)`` around
    ``center_frac * box``. Small ``sigma_frac`` -> few active pencils."""
    device = resolve_device(device)
    sigma = sigma_frac * float(min(domain.box))
    pos = (_box(domain, device) * center_frac
           + sigma * torch.randn((n, 3), generator=generator, device=device))
    return _clip(domain, pos)


def sample_two_phase(domain: Domain, n: int, *,
                     generator: Optional[torch.Generator] = None,
                     device=None, droplet_frac: float = 0.9,
                     radius_frac: float = 0.15) -> torch.Tensor:
    """A dense spherical droplet in a thin vapour (SPH free-surface
    regime): ``droplet_frac`` of the particles fill a ball of radius
    ``radius_frac * min(box)`` at the centre, the rest spread uniformly."""
    device = resolve_device(device)
    n_drop = int(n * droplet_frac)
    box = _box(domain, device)
    radius = radius_frac * float(min(domain.box))
    d = _unit_directions(n_drop, generator, device)
    r = radius * torch.rand((n_drop, 1), generator=generator,
                            device=device) ** (1.0 / 3.0)
    vapor = domain.sample_uniform(n - n_drop, generator=generator,
                                  device=device)
    return _clip(domain, torch.cat([box * 0.5 + d * r, vapor]))


def sample_power_law_cluster(domain: Domain, n: int, *,
                             generator: Optional[torch.Generator] = None,
                             device=None, n_clusters: int = 4,
                             alpha: float = 2.5, r_min_frac: float = 0.01,
                             r_max_frac: float = 0.25) -> torch.Tensor:
    """Particles around ``n_clusters`` centres with a power-law radial
    falloff ``p(r) ~ r^-alpha`` between ``r_min_frac`` and ``r_max_frac``
    of the box (astrophysical regime: dense cores, sparse halos)."""
    device = resolve_device(device)
    box = _box(domain, device)
    centers = torch.rand((n_clusters, 3), generator=generator,
                         device=device) * box
    assign = torch.randint(0, n_clusters, (n,), generator=generator,
                           device=device)
    d = _unit_directions(n, generator, device)
    scale = float(min(domain.box))
    r_min, r_max = r_min_frac * scale, r_max_frac * scale
    u = torch.rand((n, 1), generator=generator, device=device)
    if abs(alpha - 1.0) < 1e-6:
        r = r_min * (r_max / r_min) ** u
    else:
        # inverse CDF of p(r) ~ r^-alpha on [r_min, r_max]
        e = 1.0 - alpha
        r = (r_min ** e + u * (r_max ** e - r_min ** e)) ** (1.0 / e)
    return _clip(domain, centers[assign] + d * r)


SCENARIOS: Dict[str, Callable[..., torch.Tensor]] = {
    "uniform": sample_uniform,
    "gaussian_blob": sample_gaussian_blob,
    "two_phase": sample_two_phase,
    "power_law_cluster": sample_power_law_cluster,
}


def sample(name: str, domain: Domain, n: int, **kwargs) -> torch.Tensor:
    """Sample a named scenario (``SCENARIOS`` registry)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name](domain, n, **kwargs)
