"""Goldilocks field arithmetic on torch tensors.

p = 2^64 - 2^32 + 1.  A field element is one ``torch.int64`` holding the
canonical u64 bit pattern (the JAX package's (lo, hi) u32 pair is a TPU
layout and is not carried over).  A CUDA kernel reads the same storage as
``uint64_t*`` and numpy views it as ``uint64`` without a copy.

torch has no usable unsigned 64-bit arithmetic, so the unsigned operations
are written on int64, whose add, sub and mul wrap modulo 2^64:

* ``>>`` on int64 is arithmetic, so every right shift is masked (``_shr``);
* an unsigned compare flips the sign bit of both sides first (``_ult``);
* a 64x64 -> 128 product is built from four 32x32 -> 64 limb products whose
  carries are collected in a sum that cannot overflow (``_mul128``).

The 128 -> 64 reduction uses 2^64 == 2^32 - 1 and 2^96 == -1 (mod p), as
the JAX package and the C++ runtime do.  Every op is elementwise and
broadcasts like the torch ops it is made of; results are canonical unless
the name says ``lazy``.  The JAX package's `expand_dims`, `stack` and `concat`
are `unsqueeze`, `torch.stack` and `torch.cat` at the call site: a field
tensor is a plain tensor.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

MODULUS = 0xFFFFFFFF00000001  # 2^64 - 2^32 + 1
EPSILON = 0xFFFFFFFF  # 2^64 - MODULUS
MULTIPLICATIVE_GENERATOR = 7
TWO_ADICITY = 32

_SIGN = -(1 << 63)
_P = MODULUS - (1 << 64)  # MODULUS as an int64 bit pattern
_M32 = 0xFFFFFFFF


def _i64(v: int) -> int:
    """u64 python int -> the int64 with the same bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """logical right shift of a u64 bit pattern."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """unsigned a < b."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _uge_p(x: torch.Tensor) -> torch.Tensor:
    """unsigned x >= MODULUS."""
    return (x ^ _SIGN) >= (_P ^ _SIGN)


# ---------------------------------------------------------------------------
# construction and conversion
#
# The raw constructors (`from_u64`, `constant`, `zeros`, `ones`, `geometric`)
# keep torch's own convention: `device=None` is torch's default device, the
# CPU unless the caller changed it.  The port's rule that `None` means the
# card belongs to the entry points and the public state constructors, which
# resolve it through `utils/device.py:resolve_device` before they come here.
# ---------------------------------------------------------------------------


def from_u64(x: Any, device=None) -> torch.Tensor:
    """python ints / numpy u64 -> canonical int64 tensor (reduced mod p);
    `device` as torch reads it (None: torch's default device)."""
    arr = np.asarray(x, dtype=np.uint64) % np.uint64(MODULUS)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64)).to(device)


def to_u64(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 with the same bits."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """u32 values (ints or bools, already < 2^32 <= p) as field elements."""
    return x.to(torch.int64)


def constant(value: int, device=None) -> torch.Tensor:
    """a 0-d field element; `device` as torch reads it."""
    return torch.tensor(_i64(int(value) % MODULUS), dtype=torch.int64, device=device)


def zeros(shape, device=None) -> torch.Tensor:
    """`device` as torch reads it (None: torch's default device)."""
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ones(shape, device=None) -> torch.Tensor:
    """`device` as torch reads it (None: torch's default device)."""
    return torch.ones(shape, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# field ops
# ---------------------------------------------------------------------------


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """any u64 -> [0, p) by one conditional subtract (2^64 < 2p)."""
    return torch.where(_uge_p(a), a - _P, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    # a carry out of 2^64 means s = a + b - 2^64; adding EPSILON gives a + b - p
    s = torch.where(_ult(s, a), s + EPSILON, s)
    return canonicalize(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    # a borrow means d = a - b + 2^64; subtracting EPSILON gives a - b + p
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, _P - a)


def add_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b (mod p) for ANY u64 inputs, output any u64 (not canonical).

    Each carry out of 2^64 is worth EPSILON; the adjustment wraps at most
    twice (the JAX package's `add_lazy`, same bits)."""
    s = a + b
    wrapped = _ult(s, a)
    t = s + EPSILON
    wrapped2 = wrapped & _ult(t, s)
    s = torch.where(wrapped, t, s)
    return torch.where(wrapped2, s + EPSILON, s)


def _mul128(a: torch.Tensor, b: torch.Tensor):
    """full 64x64 -> 128 product as (lo, hi) u64 bit patterns."""
    a0, a1 = a & _M32, _shr(a, 32)
    b0, b1 = b & _M32, _shr(b, 32)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    # bits 32..95 of the product, three terms < 2^32 each: no int64 overflow
    mid = _shr(ll, 32) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | (mid << 32)
    hi = hh + _shr(lh, 32) + _shr(hl, 32) + _shr(mid, 32)
    return lo, hi


def _reduce128_lazy(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """n = lo + 2^64 hi == lo + (2^32 - 1) hi_lo - hi_hi (mod p), < 2^64."""
    hi_hi = _shr(hi, 32)
    hi_lo = hi & _M32
    t0 = lo - hi_hi
    t0 = torch.where(_ult(lo, hi_hi), t0 - EPSILON, t0)
    t1 = (hi_lo << 32) - hi_lo
    t2 = t0 + t1
    return torch.where(_ult(t2, t0), t2 + EPSILON, t2)


def mul_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b (mod p) for any u64 inputs, output any u64 (not canonical)."""
    return _reduce128_lazy(*_mul128(a, b))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return canonicalize(mul_lazy(a, b))


def double(a: torch.Tensor) -> torch.Tensor:
    return add(a, a)


def add_const(a: torch.Tensor, c: int) -> torch.Tensor:
    c = int(c) % MODULUS
    if c == 0:
        return a
    return add(a, constant(c, a.device))


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    c = int(c) % MODULUS
    if c == 0:
        return torch.zeros_like(a)
    if c == 1:
        return a
    return mul(a, constant(c, a.device))


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a python-int exponent (square and multiply)."""
    if e < 0:
        raise ValueError("negative exponent")
    result: Optional[torch.Tensor] = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return torch.ones_like(a) if result is None else result


def inv(a: torch.Tensor) -> torch.Tensor:
    """elementwise a^(p-2) (Fermat); inv(0) = 0 by convention."""
    return pow_const(a, MODULUS - 2)


def geometric(base: int, n: int, device=None) -> torch.Tensor:
    """[base^0 .. base^(n-1)] as an (n,) tensor, n a power of two
    (log n doubling steps: arr_{k+1} = [arr_k, arr_k * base^(2^k)]);
    `device` as torch reads it."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    arr = ones((1,), device)
    step = base % MODULUS
    while arr.shape[0] < n:
        arr = torch.cat([arr, mul(arr, constant(step, device))])
        step = step * step % MODULUS
    return arr


def sum_mod(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """modular sum along `dim` (log-depth pairwise tree)."""
    cur = a.movedim(dim, 0)
    while cur.shape[0] > 1:
        m = cur.shape[0]
        half = m // 2
        merged = add(cur[:half], cur[half : 2 * half])
        cur = torch.cat([merged, cur[2 * half :]]) if m % 2 else merged
    return cur[0]


def cumsum_mod(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """inclusive modular prefix sum along `dim` (log-depth Hillis-Steele scan)."""
    x = a.movedim(dim, 0)
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], add(x[d:], x[:-d])])
        d *= 2
    return x.movedim(0, dim)


def dot_mod(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return sum_mod(mul(a, b), dim)


def equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """elementwise equality of canonical elements."""
    return a == b


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """elementwise mask ? a : b (mask broadcastable)."""
    return torch.where(mask, a, b)
