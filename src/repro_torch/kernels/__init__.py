"""Hand-written CUDA kernels of the port (built with nvcc at first use).

xpencil      the paper's X-pencil schedule (csrc/xpencil.cu)
prefix_sum   the paper's §6 scan (csrc/prefix_sum.cu)

Each kernel has a wrapper that runs its plain PyTorch version on CPU
tensors and launches the kernel on CUDA tensors. Importing this package
registers the X-pencil kernel as the ``"cuda"`` backend of the port's own
registry, so ``plan(domain, kernel, positions=pos)`` runs it.
"""

from ..core.api import InteractionPlan, ParticleState, register_backend
from ..core.binning import CellBins
from .ops import prefix_sum, xpencil_interactions

__all__ = ["prefix_sum", "xpencil_interactions"]


@register_backend("cuda", "xpencil")
def _cuda_xpencil(plan: InteractionPlan, bins: CellBins,
                  state: ParticleState):
    return xpencil_interactions(plan.domain, bins, plan.kernel)
