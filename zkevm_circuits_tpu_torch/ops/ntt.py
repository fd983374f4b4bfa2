"""Goldilocks radix-2 NTT and coset LDE on torch tensors.

One bit-reverse gather, then log2(n) Cooley-Tukey butterfly stages over the
trailing axis (any batch axes in front), natural order in and out.

  ntt(a)               coefficients -> evaluations on the size-n subgroup
  intt(e)              the inverse
  lde(e, rate, shift)  subgroup evaluations -> evaluations on the coset
                       shift * H' of the 2^rate times larger subgroup H'

`ntt_ref` / `intt_ref` are the python-int references (host use).
"""

from __future__ import annotations

import torch

from . import gf
from .gf import MODULUS, MULTIPLICATIVE_GENERATOR, TWO_ADICITY


def root_of_unity(log_n: int) -> int:
    """primitive 2^log_n-th root of unity."""
    if log_n > TWO_ADICITY:
        raise ValueError(f"no 2^{log_n}-th root of unity in Goldilocks")
    return pow(MULTIPLICATIVE_GENERATOR, (MODULUS - 1) >> log_n, MODULUS)


def _log2_exact(n: int) -> int:
    log_n = int(n).bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"length must be a power of two, got {n}")
    return log_n


def _bit_reverse_idx(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _transform(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    n = 1 << log_n
    batch = a.shape[:-1]
    dev = a.device
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, MODULUS - 2, MODULUS)
    # the twiddles of every stage are strided picks of one power table
    powers = gf.geometric(w, max(n // 2, 1), dev)
    x = a[..., _bit_reverse_idx(log_n, dev)]
    for s in range(log_n):
        half = 1 << s
        tw = powers[:: n // (2 * half)]  # w^(n / 2^(s+1) * j), j < half
        xr = x.reshape(batch + (n // (2 * half), 2, half))
        u = xr[..., 0, :]
        v = gf.mul(xr[..., 1, :], tw)
        x = torch.stack([gf.add(u, v), gf.sub(u, v)], dim=-2).reshape(batch + (n,))
    return x


def ntt(a: torch.Tensor) -> torch.Tensor:
    return _transform(a, _log2_exact(a.shape[-1]), inverse=False)


def intt(e: torch.Tensor) -> torch.Tensor:
    n = e.shape[-1]
    out = _transform(e, _log2_exact(n), inverse=True)
    return gf.mul_const(out, pow(n, MODULUS - 2, MODULUS))


def lde(evals: torch.Tensor, rate_log2: int,
        coset_shift: int = MULTIPLICATIVE_GENERATOR) -> torch.Tensor:
    """intt -> scale coefficient i by shift^i -> zero-pad -> ntt."""
    n = evals.shape[-1]
    _log2_exact(n)
    coeffs = intt(evals)
    shifted = gf.mul(coeffs, gf.geometric(coset_shift, n, evals.device))
    pad = gf.zeros(evals.shape[:-1] + (n * ((1 << rate_log2) - 1),), evals.device)
    return ntt(torch.cat([shifted, pad], dim=-1))


# ---------------------------------------------------------------------------
# host reference (python ints)
# ---------------------------------------------------------------------------


def ntt_ref(coeffs, inverse=False):
    n = len(coeffs)
    log_n = _log2_exact(n)
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, MODULUS - 2, MODULUS)
    if n == 1:
        return list(coeffs)
    even = ntt_ref(coeffs[0::2], inverse)
    odd = ntt_ref(coeffs[1::2], inverse)
    out = [0] * n
    for j in range(n // 2):
        t = odd[j] * pow(w, j, MODULUS) % MODULUS
        out[j] = (even[j] + t) % MODULUS
        out[j + n // 2] = (even[j] - t) % MODULUS
    return out


def intt_ref(evals):
    n = len(evals)
    n_inv = pow(n, MODULUS - 2, MODULUS)
    return [x * n_inv % MODULUS for x in ntt_ref(evals, inverse=True)]
