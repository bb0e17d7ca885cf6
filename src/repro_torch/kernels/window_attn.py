"""Sliding-window attention: the wrapper of kernel G.

Replaces ``repro/kernels/window_attn.py::window_attention``, the Pallas
flash-style kernel that keeps a query block resident while the KV blocks
inside the window stream through, and never loads those outside it. The
signature, layout and contract are JAX's: q (B, H, S, D), k and v
(B, KH, S, D), ``H % KH == 0`` and ``S % blk == 0``; the output has q's
dtype. ``blk`` sets the query block of the plain version; kernel G tiles
by its own rows and masks ragged tiles itself.

Kernel G has two routes, chosen by :func:`route` from the dtype and D:

* ``"wgmma"`` (``csrc/window_attn_sm90.cu``): bf16 with ``D % 16 == 0``
  and ``D <= 256``, on Hopper's tensor cores (wgmma, TMA, a warp-specialised
  producer); P is rounded to bf16 before P . V;
* ``"simt"`` (``csrc/window_attn.cu``): fp32, and bf16 at other head dims,
  in fp32 on the CUDA cores.

On a CPU tensor the wrapper runs :func:`window_attention_plain`; on a CUDA
tensor it launches kernel G or raises. ``window_attention.launches`` counts
the launches, ``window_attention.launches_by_route`` the launches of each
route.

``window_attention`` is a ``torch.autograd.Function``. Where a gradient is
wanted, its forward also keeps each row's log-sum-exp (kernel G's wgmma
route writes it, G's plain version computes it), as JAX's ``_flash_fwd``
keeps its residuals. Its backward is :func:`window_attention_bwd`, which
runs :func:`window_attention_bwd_plain` on a CPU tensor and on a CUDA
tensor launches kernel Gb or raises. Gb has two routes, chosen by
:func:`bwd_route` exactly as G's are:

* ``"wgmma"`` (``csrc/window_attn_bwd_sm90.cu``): bf16 with ``D % 16 == 0``
  and ``D <= 256``; reads G's lse (a missing lse raises), one dK/dV and one
  dQ launch on the tensor cores after a prep launch, P and dS rounded to
  bf16 before the products;
* ``"simt"`` (``csrc/window_attn_bwd.cu``): fp32 and the other head dims,
  fp32 arithmetic on the CUDA cores; it computes the lse itself.

Both take three launches a call, use no atomics and give the same bits
from run to run. ``window_attention_bwd.launches`` counts its calls on the
card, ``window_attention_bwd.launches_by_route`` the calls of each route.
JAX has no Pallas backward: it trains through XLA's autodiff of the plain
``window_attention_blocked``.
"""

from __future__ import annotations

import torch

from ._common import MAX_SMEM, launch

NEG_INF = -1.0e30
MAX_D = 256
TILE_Q, TILE_K = 32, 32               # window_attn.cu kBQ, kBK
WGMMA_Q, WGMMA_K, WGMMA_STAGES = 128, 64, 2   # window_attn_sm90.cu
BWD_TILE = 32                         # window_attn_bwd.cu kBQ = kBK
BWD_WGMMA_TILE, BWD_WGMMA_STAGES = 64, 2   # window_attn_bwd_sm90.cu
BWD_PLAIN_BLOCK = 128                 # queries a block of Gb's plain version
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, d: int) -> str:
    """Kernel G's route for inputs of ``dtype`` and head_dim ``d``: bf16
    with ``d % 16 == 0`` and ``d <= 256`` takes the tensor cores (bf16 wgmma
    needs a depth of 16); everything else the fp32 CUDA-core body, where
    TF32 tensor cores would miss the fp32 tolerance of 3e-4."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= MAX_D:
        return "wgmma"
    return "simt"


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """Kernel Gb's route: ``"wgmma"`` exactly where :func:`route` gives
    kernel G's tensor-core route, whose lse the wgmma backward reads;
    ``"simt"`` elsewhere."""
    return route(dtype, d)


def smem_bytes(d: int) -> int:
    """Shared memory the SIMT route stages per block: fp32 Q and K tiles at
    an odd number of float4s per row, and the V tile (window_attn.cu
    ``smem_bytes``)."""
    padded = 4 * ((d + 3) // 4 | 1)
    return 4 * ((TILE_Q + TILE_K) * padded + TILE_K * d)


def wgmma_smem_bytes(d: int) -> int:
    """Shared memory the wgmma route asks for per block (window_attn_sm90.cu
    ``smem_bytes``): the bf16 Q tile, the two-stage K and V ring, seven
    mbarriers and 1 KB to align the base to the 128-byte swizzle's
    1024-byte atom."""
    return (2 * d * (WGMMA_Q + 2 * WGMMA_STAGES * WGMMA_K)
            + 8 * (1 + 3 * WGMMA_STAGES) + 1024)


def bwd_smem_bytes(d: int) -> int:
    """Shared memory kernel Gb's dK/dV launch stages per block, its
    largest (window_attn_bwd.cu ``dkdv_smem``): fp32 Q, dout, K and V tiles
    at kernel G's padded stride, the P and dS tiles, lse and delta."""
    padded = 4 * ((d + 3) // 4 | 1)
    return 4 * (4 * BWD_TILE * padded + 2 * BWD_TILE * BWD_TILE
                + 2 * BWD_TILE)


def bwd_wgmma_smem_bytes(d: int):
    """(dK/dV launch, dQ launch): shared memory a block of Gb's wgmma route
    asks for (window_attn_bwd_sm90.cu ``dkdv_smem_bytes``,
    ``dq_smem_bytes``). dK/dV: resident K and V tiles, a two-stage ring of
    Q and dout tiles with their lse2 and delta rows, the 64 x 64 fp32 P
    hand-over; dQ: resident Q and dout, a two-stage K and V ring; each
    with its mbarriers and 1 KB to align the base."""
    tile = 2 * BWD_WGMMA_TILE * d
    bars = 8 * (1 + 2 * BWD_WGMMA_STAGES)
    dkdv = (2 * tile + BWD_WGMMA_STAGES * (2 * tile + 8 * BWD_WGMMA_TILE)
            + 4 * BWD_WGMMA_TILE ** 2 + bars + 1024)
    dq = 2 * tile + BWD_WGMMA_STAGES * 2 * tile + bars + 1024
    return dkdv, dq


def _check(q, k, v, window: int, blk: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"window_attention: q (B, H, S, D) and k, v "
                         f"(B, KH, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or h % kh:
        raise ValueError(f"window_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} need equal B, S, D and H % KH "
                         f"== 0")
    if blk < 1 or s % blk:
        raise ValueError(f"window_attention: S = {s} must be a multiple of "
                         f"blk = {blk}")
    if window < 1:
        raise ValueError(f"window_attention: window {window} < 1")


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, window: int, blk: int = 128,
                           softcap: float = 0.0, return_lse: bool = False):
    """Kernel G's plain version: for each block of ``blk`` queries, the
    exact masked softmax over the keys of its window, in fp32. With
    ``return_lse`` -> (out, lse): lse float32 (B, H, S), each row's
    natural-log log-sum-exp of its scaled, capped scores (kernel G's
    residual)."""
    _check(q, k, v, window, blk)
    b, h, s, d = q.shape
    kh = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, kh, h // kh, s, d) * scale
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:-1], device=q.device)
    pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, blk):
        q1 = q0 + blk
        k0 = max(0, q0 - window + 1)
        sc = qf[..., q0:q1, :] @ kf[..., k0:q1, :].transpose(-1, -2)
        if softcap > 0.0:
            sc = softcap * torch.tanh(sc / softcap)
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        mask = (kp <= qp) & (qp - kp < window)
        sc = torch.where(mask, sc, NEG_INF)
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[..., q0:q1, :] = (p @ vf[..., k0:q1, :]) / l
        lse[..., q0:q1] = (m + torch.log(l))[..., 0]
    out = out.reshape(b, h, s, d).to(q.dtype)
    return (out, lse.reshape(b, h, s)) if return_lse else out


def _check_cuda(what: str, tensors) -> None:
    """Raise unless the named tensors share one dtype, float32 or bfloat16,
    and one device."""
    (_, first), rest = tensors[0], tensors[1:]
    if first.dtype not in _DTYPE_CODE or any(
            t.dtype != first.dtype or t.device != first.device
            for _, t in rest):
        got = ", ".join(f"{n} {t.dtype} on {t.device}" for n, t in tensors)
        raise ValueError(f"{what} takes {', '.join(n for n, _ in tensors)} "
                         f"of one dtype, float32 or bfloat16, on one device; "
                         f"got {got}")


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, blk: int = 128,
                     softcap: float = 0.0) -> torch.Tensor:
    """Causal sliding-window attention: key j is visible to query i when
    ``j <= i`` and ``i - j < window``. Returns (B, H, S, D) in q's dtype.
    Differentiable in q, k and v (kernel Gb on the card)."""
    _check(q, k, v, window, blk)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention runs on cpu or cuda, not "
                         f"{q.device}")
    # the lse residual only where a backward can follow (not in prefill)
    want_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _WindowAttention.apply(q, k, v, window, blk, softcap, want_lse)


def window_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, window: int, blk: int = 128,
                              softcap: float = 0.0):
    """Kernel G's forward with its residual, no autograd: -> (out, lse),
    lse float32 (B, H, S) as :func:`window_attention_plain` gives it with
    ``return_lse``. On the card lse is None where G's route is ``"simt"``
    (its body writes none; Gb's SIMT route computes its own)."""
    _check(q, k, v, window, blk)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _forward(q, k, v, window=window, blk=blk, softcap=softcap,
                    with_lse=True)


class _WindowAttention(torch.autograd.Function):
    """Kernel G forward, kernel Gb backward (plain versions on the CPU).
    Saves q, k, v, the output and, where the forward computed it, each
    row's log-sum-exp, as JAX's ``_flash_fwd`` saves its residuals."""

    @staticmethod
    def forward(ctx, q, k, v, window, blk, softcap, want_lse):
        out, lse = _forward(q, k, v, window=window, blk=blk,
                            softcap=softcap, with_lse=want_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = window_attention_bwd(q, k, v, out, dout,
                                          window=ctx.window,
                                          softcap=ctx.softcap, lse=lse)
        return dq, dk, dv, None, None, None, None


def _forward(q, k, v, *, window: int, blk: int, softcap: float,
             with_lse: bool = False):
    """Kernel G on a CUDA tensor, its plain version on a CPU tensor; -> (out,
    lse), lse None unless ``with_lse`` and the CPU or G's wgmma route."""
    if q.device.type == "cpu":
        if with_lse:
            return window_attention_plain(q, k, v, window=window, blk=blk,
                                          softcap=softcap, return_lse=True)
        return window_attention_plain(q, k, v, window=window, blk=blk,
                                      softcap=softcap), None
    _check_cuda("window_attention: kernel G", [("q", q), ("k", k),
                                               ("v", v)])
    b, h, s, d = q.shape
    if d > MAX_D:
        raise ValueError(f"window_attention: kernel G takes head_dim <= "
                         f"{MAX_D}, got {d}")
    way = route(q.dtype, d)
    if way == "simt" and smem_bytes(d) > MAX_SMEM:
        raise ValueError(f"window_attention: head_dim {d} needs "
                         f"{smem_bytes(d)} bytes of shared memory, at most "
                         f"{MAX_SMEM}")
    if way == "simt" and b * h > 65535:
        raise ValueError(f"window_attention: B * H = {b * h} > 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = None
    if way == "wgmma":
        # TMA reads q, k and v from 16-byte aligned bases
        bad = [n for n, t in (("q", q), ("k", k), ("v", v))
               if t.data_ptr() % 16]
        if bad:
            raise ValueError(f"window_attention: kernel G's wgmma route "
                             f"needs 16-byte aligned {bad}")
        if with_lse:
            lse = torch.empty((b, h, s), dtype=torch.float32,
                              device=q.device)
        launch("window_attn_sm90.cu", "window_attention_sm90", q, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if lse is None else lse.data_ptr(), b, h, k.shape[1],
               s, d, int(window), float(softcap), 1.0 / (d ** 0.5))
    else:
        launch("window_attn.cu", "window_attention_fwd", q, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1],
               s, d, int(window), float(softcap), 1.0 / (d ** 0.5),
               _DTYPE_CODE[q.dtype])
    window_attention.launches += 1
    window_attention.launches_by_route[way] += 1
    return out, lse


window_attention.launches = 0
window_attention.launches_by_route = {"wgmma": 0, "simt": 0}


# ---------------------------------------------------------------------------
# backward: kernel Gb
# ---------------------------------------------------------------------------


def window_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, *, window: int,
                               softcap: float = 0.0, lse=None):
    """Kernel Gb's plain version: the gradient of
    :func:`window_attention_plain` by its explicit formulas, per block of
    ``BWD_PLAIN_BLOCK`` queries over the keys of its window, in fp32 (JAX's
    ``_flash_bwd`` on the window's band): P from each row's log-sum-exp
    (``lse``, the forward's residual, or recomputed here when None),
    ``delta = rowsum(dout * out)``, the softcap derivative with ``s / cap``
    clipped to [-1, 1], dK and dV summed over the GQA group. -> (dq, dk,
    dv) in the inputs' dtypes."""
    _check(q, k, v, window, 1)
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, kh, g, s, d) * scale
    dof = dout.float().reshape(b, kh, g, s, d)
    delta = (dof * out.float().reshape(b, kh, g, s, d)).sum(-1)
    if lse is not None:
        lse = lse.float().reshape(b, kh, g, s, 1)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dq = torch.empty_like(qf)
    dk = torch.zeros((b, kh, s, d), device=q.device)
    dv = torch.zeros((b, kh, s, d), device=q.device)
    pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, BWD_PLAIN_BLOCK):
        q1 = min(q0 + BWD_PLAIN_BLOCK, s)
        k0 = max(0, q0 - window + 1)
        sc = qf[..., q0:q1, :] @ kf[..., k0:q1, :].transpose(-1, -2)
        if softcap > 0.0:
            sc = softcap * torch.tanh(sc / softcap)
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        mask = (kp <= qp) & (qp - kp < window)
        sc = torch.where(mask, sc, NEG_INF)
        row_lse = (torch.logsumexp(sc, -1, keepdim=True) if lse is None
                   else lse[..., q0:q1, :])
        p = torch.where(mask, torch.exp(sc - row_lse), 0.0)
        dp = dof[..., q0:q1, :] @ vf[..., k0:q1, :].transpose(-1, -2)
        ds = p * (dp - delta[..., q0:q1, None])
        if softcap > 0.0:
            t = torch.clamp(sc / softcap, -1.0, 1.0)
            ds = ds * (1.0 - t * t)
        dq[..., q0:q1, :] = ds @ kf[..., k0:q1, :]
        dk[:, :, k0:q1] += (ds.transpose(-1, -2) @ qf[..., q0:q1, :]).sum(2)
        dv[:, :, k0:q1] += (p.transpose(-1, -2) @ dof[..., q0:q1, :]).sum(2)
    return ((dq * scale).reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def window_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, dout: torch.Tensor, *,
                         window: int, softcap: float = 0.0, lse=None):
    """The gradient of :func:`window_attention` at output ``out`` and
    output gradient ``dout``, given the forward's residual ``lse`` (float32
    (B, H, S), or None): kernel Gb on CUDA tensors, its plain version on
    CPU tensors. Gb's wgmma route needs ``lse`` and raises without it; the
    SIMT route and the plain version recompute it when None. -> (dq (B, H,
    S, D), dk, dv (B, KH, S, D)) in the inputs' dtype."""
    _check(q, k, v, window, 1)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"window_attention_bwd: out and dout must have q's "
                         f"shape {tuple(q.shape)}, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}")
    if lse is not None and tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"window_attention_bwd: lse must have shape "
                         f"{tuple(q.shape[:3])}, got {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, out, dout, window=window,
                                          softcap=softcap, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    _check_cuda("window_attention_bwd: kernel Gb",
                [("q", q), ("k", k), ("v", v), ("out", out),
                 ("dout", dout)])
    b, h, s, d = q.shape
    if d > MAX_D:
        raise ValueError(f"window_attention_bwd: kernel Gb takes head_dim "
                         f"<= {MAX_D}, got {d}")
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    way = bwd_route(q.dtype, d)
    if way == "wgmma":
        _bwd_wgmma(q, k, v, out, dout, lse, dq, dk, dv, window, softcap)
    else:
        _bwd_simt(q, k, v, out, dout, dq, dk, dv, window, softcap)
    window_attention_bwd.launches += 1
    window_attention_bwd.launches_by_route[way] += 1
    return dq, dk, dv


def _bwd_wgmma(q, k, v, out, dout, lse, dq, dk, dv, window, softcap):
    """Kernel Gb's tensor-core route on contiguous bf16 tensors."""
    b, h, s, d = q.shape
    if lse is None:
        raise ValueError("window_attention_bwd: kernel Gb's wgmma route "
                         "reads kernel G's lse residual; none was given")
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"window_attention_bwd: lse must be float32 on "
                         f"{q.device}, got {lse.dtype} on {lse.device}")
    lse = lse.contiguous()
    # TMA reads q, k, v and dout from 16-byte aligned bases
    bad = [n for n, t in (("q", q), ("k", k), ("v", v), ("dout", dout))
           if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"window_attention_bwd: kernel Gb's wgmma route "
                         f"needs 16-byte aligned {bad}")
    # lse * log2(e) and delta, rows padded to the 64-row tile
    rows = -(-s // BWD_WGMMA_TILE) * BWD_WGMMA_TILE
    scratch = torch.empty((2, b * h, rows), dtype=torch.float32,
                          device=q.device)
    launch("window_attn_bwd_sm90.cu", "window_attention_bwd_sm90", q,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(), b, h,
           k.shape[1], s, d, int(window), float(softcap), 1.0 / (d ** 0.5))


def _bwd_simt(q, k, v, out, dout, dq, dk, dv, window, softcap):
    """Kernel Gb's SIMT route on contiguous fp32 or bf16 tensors."""
    b, h, s, d = q.shape
    if bwd_smem_bytes(d) > MAX_SMEM:
        raise ValueError(f"window_attention_bwd: head_dim {d} needs "
                         f"{bwd_smem_bytes(d)} bytes of shared memory, at "
                         f"most {MAX_SMEM}")
    if b * h > 65535:
        raise ValueError(f"window_attention_bwd: B * H = {b * h} > 65535")
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    launch("window_attn_bwd.cu", "window_attention_bwd", q, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), b, h, k.shape[1], s, d, int(window),
           float(softcap), 1.0 / (d ** 0.5), _DTYPE_CODE[q.dtype])


window_attention_bwd.launches = 0
window_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}
