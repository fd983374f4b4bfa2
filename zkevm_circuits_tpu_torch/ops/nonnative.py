"""Non-native 256-bit arithmetic checking, batched (the JAX package's
`ops/nonnative.py`).

Values are 16 x u16 limbs held in int64 tensors.  Nothing is computed mod p:
identities are CHECKED.  The witness supplies quotients (and any reduced
intermediate values), and the checker verifies integer identities of the form

    sum_i  a_i * b_i * m_i  +  sum_j x_j * m_j  + const
        ==  (same shape on the right-hand side)

limb-exactly: schoolbook coefficient sums of the u16 x u16 partial products,
then both sides are brought to base-2^16 digits and compared.

The JAX package carries each coefficient sum as an exact (lo, hi) u32 pair,
which is arithmetic modulo 2^64; here one int64 holds the same 64 bits and
its wrapping add is the same arithmetic.  With u16 limbs the widest sum the
callers build (34 coefficients of at most 16 products below 2^32, a few
terms) stays below 2^40, far from the wrap; the u16 x u16 products are masked
to 32 bits so that limbs out of range give the JAX package's answer too.

Grammar for a side: a list of terms
    ("prod", a_limbs, b_limbs, small_int_mult)
    ("lin",  x_limbs, small_int_mult)
    ("const", python_int)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NLIMBS = 16  # 256-bit values
_MASK16 = 0xFFFF
_MASK32 = 0xFFFFFFFF


def from_int(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    if x < 0 or x >> (16 * nlimbs):
        raise ValueError("value does not fit the limb count")
    return np.array([(x >> (16 * i)) & 0xFFFF for i in range(nlimbs)], dtype=np.uint32)


def from_ints(xs, nlimbs: int = NLIMBS) -> np.ndarray:
    return np.stack([from_int(int(x), nlimbs) for x in xs])


def to_int(limbs) -> int:
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    out = 0
    for i, limb in enumerate(np.asarray(limbs).reshape(-1).tolist()):
        out |= int(limb) << (16 * i)
    return out


def _coef_sums(a: torch.Tensor, b: torch.Tensor, mult: int, ncoef: int) -> torch.Tensor:
    """coefficient sums of mult * (a * b), (..., ncoef) u64 bit patterns.
    a (..., na), b (..., nb) u16 limbs; mult a small positive int."""
    na, nb = a.shape[-1], b.shape[-1]
    prods = (a.unsqueeze(-1) * b.unsqueeze(-2)) & _MASK32  # (..., na, nb)
    total = torch.zeros(a.shape[:-1] + (ncoef,), dtype=torch.int64, device=a.device)
    for i in range(na):
        total = total + F.pad(prods[..., i, :], (i, ncoef - nb - i))
    return total * mult


def _side_digits(terms, ncoef: int, batch_shape, device):
    """the ncoef + 2 base-2^16 digits of a term sum."""
    batch_shape = tuple(batch_shape)
    total = torch.zeros(batch_shape + (ncoef,), dtype=torch.int64, device=device)
    for t in terms:
        kind = t[0]
        if kind == "prod":
            _, a, b, mult = t
            total = total + _coef_sums(a, b, mult, ncoef)
        elif kind == "lin":
            _, x, mult = t
            total = total + F.pad(x, (0, ncoef - x.shape[-1])) * mult
        elif kind == "const":
            limbs = torch.from_numpy(from_int(int(t[1]), ncoef).astype(np.int64)).to(device)
            total = total + limbs
        else:
            raise ValueError(kind)
    # carry-propagate into digits; the carry is bits 16..47 of each sum
    carry = torch.zeros(batch_shape, dtype=torch.int64, device=device)
    digits = []
    for k in range(ncoef):
        s = total[..., k] + carry
        digits.append(s & _MASK16)
        carry = (s >> 16) & _MASK32
    digits.append(carry & _MASK16)
    digits.append(carry >> 16)
    return digits


def sides_equal(lhs, rhs, batch_shape, ncoef: int = 2 * NLIMBS + 2) -> torch.Tensor:
    """sum(lhs terms) == sum(rhs terms), exactly.  Returns bool (...,), on the
    device of the terms' tensors (at least one term must hold one)."""
    device = next(x.device for t in lhs + rhs for x in t[1:] if isinstance(x, torch.Tensor))
    dl = _side_digits(lhs, ncoef, batch_shape, device)
    dr = _side_digits(rhs, ncoef, batch_shape, device)
    ok = torch.ones(tuple(batch_shape), dtype=torch.bool, device=device)
    for a, b in zip(dl, dr):
        ok = ok & (a == b)
    return ok


def check_mulmod(a, b, q, r, modulus: int) -> torch.Tensor:
    """a * b == q * modulus + r over the integers.  a, b, r (..., 16); q (..., nq)."""
    m = torch.from_numpy(from_int(modulus).astype(np.int64)).to(q.device)
    m = m.expand(q.shape[:-1] + (NLIMBS,))
    return sides_equal([("prod", a, b, 1)], [("prod", q, m, 1), ("lin", r, 1)], a.shape[:-1])


def mulmod_witness(a: int, b: int, modulus: int):
    return divmod(a * b, modulus)


def check_range(x: torch.Tensor) -> torch.Tensor:
    return (x <= _MASK16).all(dim=-1)


def limbs_lt(a: torch.Tensor, b_int: int) -> torch.Tensor:
    """a < b (a constant), comparing 16-limb little-endian numbers."""
    b = from_int(b_int)
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for k in range(NLIMBS - 1, -1, -1):
        bk = int(b[k])
        lt = lt | (eq & (a[..., k] < bk))
        eq = eq & (a[..., k] == bk)
    return lt
