"""Goldilocks field arithmetic in plain torch, for the benchmark's references.

p = 2^64 - 2^32 + 1.  An element is one int64 holding the canonical u64 bit
pattern, the layout the program's tensors have, so that a reference value and
a program value compare with `==`.  torch's int64 add, sub and mul wrap modulo
2^64, which gives the u64 bits; a right shift is masked to be logical, and an
unsigned compare flips the sign bit of both sides.

Written apart from the program: it imports nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1  # 2^64 mod p
_SIGN = -(1 << 63)
_P_I64 = P - (1 << 64)
M32 = 0xFFFFFFFF


def i64(v: int) -> int:
    """a u64 python int as the int64 with its bits."""
    v %= 1 << 64
    return v - (1 << 64) if v >> 63 else v


def tensor(values, device=None) -> torch.Tensor:
    """python ints or numpy u64 (reduced mod p) as an int64 tensor."""
    arr = np.asarray(values, dtype=object)
    flat = np.array([i64(int(v) % P) for v in arr.reshape(-1)], dtype=np.int64)
    return torch.from_numpy(flat.reshape(arr.shape)).to(device)


def to_ints(x: torch.Tensor) -> list:
    """the canonical values as python ints (nested lists)."""
    return (x.detach().cpu().numpy().view(np.uint64).astype(object)).tolist()


def _shr32(x: torch.Tensor) -> torch.Tensor:
    return (x >> 32) & M32


def _lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ _SIGN) < (b ^ _SIGN)


def canonical(x: torch.Tensor) -> torch.Tensor:
    return torch.where((x ^ _SIGN) >= (_P_I64 ^ _SIGN), x - _P_I64, x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    # a carry out of 2^64 drops 2^64 = EPS (mod p)
    return canonical(torch.where(_lt(s, a), s + EPS, s))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p: the 128-bit product from 32-bit limbs, then
    x_lo + x_hi_lo * 2^64 + x_hi_hi * 2^96 = x_lo + x_hi_lo * EPS - x_hi_hi."""
    a0, a1 = a & M32, _shr32(a)
    b0, b1 = b & M32, _shr32(b)
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = _shr32(ll) + (lh & M32) + (hl & M32)  # < 3 * 2^32
    lo = (ll & M32) | ((mid & M32) << 32)
    hi = hh + _shr32(lh) + _shr32(hl) + _shr32(mid)
    hi_lo, hi_hi = hi & M32, _shr32(hi)
    t = lo - hi_hi
    t = torch.where(_lt(lo, hi_hi), t - EPS, t)
    u = hi_lo * EPS
    s = t + u
    return canonical(torch.where(_lt(s, u), s + EPS, s))


def prefix_product(x: torch.Tensor) -> torch.Tensor:
    """inclusive running product along dim 0 (a log-depth scan)."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], mul(x[d:], x[:-d])])
        d *= 2
    return x
