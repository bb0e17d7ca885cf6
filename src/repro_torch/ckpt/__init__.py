"""Checkpoints of tensor trees (port of ``repro.ckpt``)."""

from . import checkpoint

__all__ = ["checkpoint"]
