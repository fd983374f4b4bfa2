"""Circuit queue states (the JAX package's `ops/queues.py`, the part the
Fiat-Shamir challenge derivation needs).

A full-state queue's tail IS the 12-lane sponge state; a push replaces the
rate lanes with the 8-element encoding and permutes.  The chains themselves
are computed by the native runtime (`runtime/native.py`).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QueueState:
    """head lanes, tail lanes, length (a python int)."""

    head: torch.Tensor  # (W,)
    tail: torch.Tensor  # (W,)
    length: int
