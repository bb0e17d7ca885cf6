"""Hand-written CUDA kernels of the port (built with nvcc at first use).

xpencil      the paper's X-pencil schedule, dense (kernel B), compacted
             (kernel C) and packed-row (kernel D) (csrc/xpencil.cu)
allin        the paper's All-in-SM schedule (kernel E, csrc/allin.cu)
sfc          Par-Cell over the SFC cluster-pair list (kernel F,
             csrc/sfc.cu)
prefix_sum   the paper's §6 scan (kernel A, csrc/prefix_sum.cu)
pack         the packed-row layout: counts, row scans, slot moves and
             the particle map (``pack_slots``, csrc/pack.cu; all of
             core.binning.pack_rows)
window_attn  causal sliding-window attention of the LM's local layers
             (kernel G: bf16 on tensor cores, csrc/window_attn_sm90.cu;
             fp32 and other head dims on CUDA cores, csrc/window_attn.cu)

Each kernel has a wrapper that runs its plain PyTorch version on CPU
tensors and launches the kernel on CUDA tensors. Importing this package
registers the force kernels as the ``"cuda"`` backend of the port's own
registry, so ``plan(domain, kernel, positions=pos)`` runs them. As the JAX
package's ``"pallas"`` backend, it has ``xpencil`` (dense, compacted,
packed), dense ``allin`` and ``cell_dense`` in the SFC cluster layout only
(``layout="sfc"``, where ``compact=True`` changes nothing); the other
strategies, and ``cell_dense`` in the dense layout, run on
``"reference"``.
"""

from ..core.api import InteractionPlan, ParticleState, register_backend
from ..core.binning import CellBins, PackedRows, SfcClusters
from .ops import (allin_interactions, cell_sfc_interactions, prefix_sum,
                  window_attention, xpencil_interactions,
                  xpencil_packed_interactions, xpencil_sparse_interactions)

__all__ = ["allin_interactions", "cell_sfc_interactions", "prefix_sum",
           "window_attention", "xpencil_interactions",
           "xpencil_packed_interactions", "xpencil_sparse_interactions"]


@register_backend("cuda", "xpencil", compact=True,
                  sources=("prefix_sum.cu", "xpencil.cu"))
def _cuda_xpencil(plan: InteractionPlan, bins: CellBins,
                  state: ParticleState):
    if plan.compact:
        return xpencil_sparse_interactions(plan.domain, bins, plan.kernel,
                                           plan.max_active)
    return xpencil_interactions(plan.domain, bins, plan.kernel)


@register_backend("cuda", "allin", sources=("prefix_sum.cu", "allin.cu"))
def _cuda_allin(plan: InteractionPlan, bins: CellBins, state: ParticleState):
    return allin_interactions(plan.domain, bins, plan.kernel, plan.box)


@register_backend("cuda", "xpencil", compact=True, layout="packed",
                  sources=("prefix_sum.cu", "pack.cu", "xpencil.cu"))
def _cuda_xpencil_packed(plan: InteractionPlan, packed: PackedRows,
                         state: ParticleState):
    return xpencil_packed_interactions(
        plan.domain, packed, plan.kernel,
        max_active=plan.max_active if plan.compact else None)


@register_backend("cuda", "cell_dense", compact=True, layout="sfc",
                  sources=("prefix_sum.cu", "sfc.cu"))
def _cuda_cell_sfc(plan: InteractionPlan, sfc: SfcClusters,
                   state: ParticleState):
    return cell_sfc_interactions(plan.domain, sfc, plan.kernel)
