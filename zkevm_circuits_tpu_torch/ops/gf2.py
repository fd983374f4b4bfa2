"""Goldilocks quadratic extension GF(p^2) = GF(p)[x] / (x^2 - 7).

An element is a pair (c0, c1) of base-field tensors, a = c0 + c1 * x.
"""

from __future__ import annotations

import dataclasses

import torch

from . import gf

W_NONRESIDUE = 7


@dataclasses.dataclass(frozen=True)
class GF2:
    c0: torch.Tensor
    c1: torch.Tensor

    @property
    def shape(self):
        return tuple(self.c0.shape)


def from_base(c0: torch.Tensor) -> GF2:
    return GF2(c0, torch.zeros_like(c0))


def add(a: GF2, b: GF2) -> GF2:
    return GF2(gf.add(a.c0, b.c0), gf.add(a.c1, b.c1))


def sub(a: GF2, b: GF2) -> GF2:
    return GF2(gf.sub(a.c0, b.c0), gf.sub(a.c1, b.c1))


def mul(a: GF2, b: GF2) -> GF2:
    """(a0 + a1 x)(b0 + b1 x) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) x."""
    t0 = gf.mul(a.c0, b.c0)
    t1 = gf.mul(a.c1, b.c1)
    c0 = gf.add(t0, gf.mul_const(t1, W_NONRESIDUE))
    cross = gf.mul(gf.add(a.c0, a.c1), gf.add(b.c0, b.c1))
    return GF2(c0, gf.sub(gf.sub(cross, t0), t1))


def square(a: GF2) -> GF2:
    return mul(a, a)


def inv(a: GF2) -> GF2:
    """1 / (c0 + c1 x) = (c0 - c1 x) / (c0^2 - 7 c1^2)."""
    norm = gf.sub(gf.square(a.c0), gf.mul_const(gf.square(a.c1), W_NONRESIDUE))
    ninv = gf.inv(norm)
    return GF2(gf.mul(a.c0, ninv), gf.neg(gf.mul(a.c1, ninv)))

