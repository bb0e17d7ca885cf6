"""Training (port of ``repro.train``): loss, train and eval steps; the LM
serving helpers re-exported from ``models.serving`` as JAX's package
does."""

from .trainer import (cross_entropy, make_eval_step, make_loss_fn,
                      make_train_step)
from ..models.serving import generate, make_decode_step, make_prefill_step

__all__ = ["cross_entropy", "make_eval_step", "make_loss_fn",
           "make_train_step", "generate", "make_decode_step",
           "make_prefill_step"]
