"""Train-step factories (port of ``repro.train.trainer``).

``make_train_step`` returns the step

    loss -> grad -> (optional int8 compression) -> AdamW -> updated state

with masked next-token CE in fp32 with z-loss, remat per decoder layer
(``models/model.py``), microbatch gradient accumulation (grads summed in
fp32 and averaged, as JAX's microbatch scan does) and the params and
moments updated in place where JAX donates its buffers. Gradients come from
``torch.autograd.grad`` over detached aliases of the leaves, so the params
themselves never require grad and the serving entry points on the same
params build no graph. On the card the local layers' attention runs kernel
G forward and kernel Gb backward.

Where the port differs: JAX's ``dist/sharding.py::constrain`` calls are
GSPMD layout hints that do nothing without a device mesh; the port trains
on one device and leaves them out (``dist/sharding.py`` waits with
``launch/``, ROADMAP Queue 1 item 13.6). The gold logit is read by
``gather``, the same value as JAX's iota comparison (which avoids a gather
along a vocab-sharded axis). JAX's ``REPRO_LOSS_CHUNKS`` and
``REPRO_SCAN_UNROLL`` environment knobs serve its dry-run tools and are not
read. The step's metrics add ``grad_norm``, the global norm of the
gradients before clipping.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist.compress import compress_grads_int8, decompress_grads_int8
from ..models import model as M
from ..optim.adam import (AdamConfig, adam_update, global_norm, tree_leaves,
                          tree_map)

Tensor = torch.Tensor


def _nll(logits: Tensor, labels: Tensor, z_loss: float
         ) -> Tuple[Tensor, Tensor]:
    """Per-token (nll + z-loss, valid) in fp32; label -1 is not valid."""
    lf = logits.float()
    m = lf.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    gold = lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return lse - gold + z_loss * lse ** 2, (labels >= 0).float()


def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None,
                  z_loss: float = 1e-4) -> Tensor:
    """Masked token-mean CE (+ z-loss) in fp32; handles padded slots via
    label == -1 and logits that are longer than labels (the leading
    positions score nothing)."""
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    nll, valid = _nll(logits, labels, z_loss)
    if mask is not None:
        valid = valid * mask
    return torch.sum(nll * valid) / valid.sum().clamp_min(1.0)


def _chunk_ce(logits_fn: Callable, xch: Tensor, lch: Tensor, head: Tensor,
              z_loss: float) -> Tuple[Tensor, Tensor]:
    nll, valid = _nll(logits_fn(xch @ head), lch, z_loss)
    return torch.sum(nll * valid), valid.sum()


def chunked_cross_entropy(logits_fn: Callable, x: Tensor, labels: Tensor,
                          head: Tensor, n_chunks: int = 8,
                          z_loss: float = 1e-4) -> Tensor:
    """CE with the (B, S_chunk, V) logits made one sequence chunk at a
    time, each chunk under ``torch.utils.checkpoint``: its logits are
    recomputed in the backward pass, so the full (B, S, V) fp32 logits
    never exist. ``logits_fn(x_chunk @ head)`` applies the softcap."""
    b, s, d = x.shape
    n_chunks = min(n_chunks, s)
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    total = count = torch.zeros((), device=x.device)
    for i in range(n_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        t, c = checkpoint(_chunk_ce, logits_fn, x[:, sl], labels[:, sl],
                          head, z_loss, use_reentrant=False)
        total, count = total + t, count + c
    return total / count.clamp_min(1.0)


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 1e-2,
                 loss_chunks: int = 0, remat: bool = True) -> Callable:
    """-> loss_fn(params, batch) -> (loss, {"ce", "aux"}); the CE over
    ``loss_chunks`` sequence chunks (0: JAX's default of 8)."""
    loss_chunks = loss_chunks or 8

    def loss_fn(params, batch: Dict[str, Tensor]):
        extras = {k: v for k, v in batch.items()
                  if k not in ("tokens", "labels")}
        x, aux = M.forward_hidden(cfg, params, batch["tokens"], remat=remat,
                                  **extras)
        labels = batch["labels"]
        if x.shape[1] != labels.shape[1]:
            x = x[:, x.shape[1] - labels.shape[1]:]
        ce = chunked_cross_entropy(M.logits_transform(cfg), x, labels,
                                   M.lm_head(cfg, params),
                                   n_chunks=loss_chunks)
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: AdamConfig,
                    microbatches: int = 1,
                    compress_pod_grads: bool = False,
                    remat: bool = True) -> Callable:
    """-> train_step(params, opt_state, batch) -> (metrics, params, opt),
    params and opt updated in place. The encoder-decoder and the VLM,
    which the port does not have, raise here (ROADMAP Queue 1 items 13.4,
    13.5)."""
    M.check_ported(cfg)
    loss_fn = make_loss_fn(cfg, remat=remat)

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, parts = loss_fn(live, batch)
        # a leaf the loss does not read (a Mamba layer's ``norm2``, which
        # JAX's init makes too) gets a zero gradient, as under jax.grad
        grads = iter(torch.autograd.grad(loss, list(tree_leaves(live)),
                                         materialize_grads=True))
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                tree_map(lambda _: next(grads), live))

    def train_step(params, opt_state, batch: Dict[str, Tensor]):
        if microbatches > 1:
            split = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), device=batch["tokens"].device)
            for i in range(microbatches):
                mb_loss, _, g = grads_of(params,
                                         {k: v[i] for k, v in split.items()})
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                loss = loss + mb_loss
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            parts = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
        else:
            loss, parts, grads = grads_of(params, batch)

        if compress_pod_grads:
            # int8 + per-tensor scale, JAX's wire format between pods
            packed, scales = compress_grads_int8(grads)
            grads = decompress_grads_int8(packed, scales)

        metrics = {"loss": loss, **parts, "grad_norm": global_norm(grads)}
        params, opt_state = adam_update(params, grads, opt_state, opt_cfg)
        return metrics, params, opt_state

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = loss_fn(params, batch)
        return {"loss": loss, **parts}

    return eval_step
