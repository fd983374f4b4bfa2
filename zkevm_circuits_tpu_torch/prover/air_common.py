"""What the circuit AIRs (demux, Horner, keccak, sha256, blake2s, ecrecover)
share, on torch tensors.

The JAX package keeps a copy of `_Reg`, `_grp`, `_gamma_powers` and
`_pow_static` in each AIR module; the port keeps one of each here, with the
same values:

  Reg                        named column ranges of one column group
  grp(v, lanes)              trailing lanes -> one leading group axis
  challenge(ch, j)           challenge j as a python int
  host(x)                    a witness column as numpy
  powers(x, k, device)       [x^0 .. x^(k-1)]  (`_gamma_powers`)
  linear_scan(mult, add)     x_{i+1} = mult_i x_i + add_i from x_0 = 0,
                             every x_{i+1}: the JAX `lax.scan` accumulators
                             as a log-depth scan of affine maps
  bits_rlc / horner_prefix   the plaintext bit-stream RLCs of the hash
                             AIRs, vectorised on the host's CPU
  byte_lookup_*              the logUp byte table (t_byte, m_byte; one
                             inverse a byte column) of the nonnative AIRs
  limbs_t / carries_t / carry_chain / conv
                             their byte-committed u16 limbs, biased carry
                             chains and limb products
  residuals(air, cols, public, ch)
                             every constraint family of an AIR on its own
                             trace domain (the tests' and the chip smoke's
                             check of a trace)

`pow(x, e, MODULUS)` stands for `_pow_static`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..ops import gf
from .stark import _alpha_powers as powers  # [x^0 .. x^(k-1)], (k,)

# elements of one block of the byte columns' inversion
_INV_ELEMS = 1 << 24


class Reg:
    """Named column ranges, in the order they are added."""

    def __init__(self):
        self.index = {}
        self.n = 0

    def add(self, name: str, k: int = 1):
        self.index[name] = (self.n, k)
        self.n += k

    def at(self, name: str, j: int = 0) -> int:
        return self.index[name][0] + j

    def sl(self, name: str) -> slice:
        s, k = self.index[name]
        return slice(s, s + k)


def grp(v: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """(batch, *lanes) -> (prod(lanes), batch): one constraint a lane."""
    if lanes > 1:
        v = v.reshape(tuple(v.shape[:-lanes]) + (-1,))
    return v.movedim(-1, 0)


def host(x) -> np.ndarray:
    """A witness column (a torch tensor on any device, or an array) as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def challenge(ch: torch.Tensor, j: int) -> int:
    return int(gf.to_u64(ch[j]))


def linear_scan(mult: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """x_{i+1} = mult_i x_i + add_i along dim 0 from x_0 = 0: returns
    (x_1 .. x_n).  The pairs (mult, add) are affine maps, composed in a
    log-depth Hillis-Steele scan."""
    a, b = mult, add
    d = 1
    while d < a.shape[0]:
        a, b = (torch.cat([a[:d], gf.mul(a[d:], a[:-d])]),
                torch.cat([b[:d], gf.add(gf.mul(a[d:], b[:-d]), b[d:])]))
        d *= 2
    return b


def masked_scan(sel: torch.Tensor, mult: int, add: torch.Tensor) -> torch.Tensor:
    """The accumulator BEFORE each row of acc' = sel ? acc * mult + add : acc
    (acc_0 = 0): (n,)."""
    on = sel != 0
    after = linear_scan(torch.where(on, gf.constant(mult, sel.device), torch.ones_like(sel)),
                        torch.where(on, gf.canonicalize(add), torch.zeros_like(add)))
    return torch.cat([torch.zeros_like(after[:1]), after[:-1]])


def bits_rlc(bits: np.ndarray, gamma: int) -> np.ndarray:
    """(B, K) bits -> (B,) u64: sum_k bits[b, k] gamma^k, on the CPU."""
    b = torch.as_tensor(np.ascontiguousarray(bits, np.int64))
    return gf.to_u64(gf.sum_mod(gf.mul(b, powers(gamma, b.shape[-1], "cpu")), dim=-1))


def horner_prefix(r: np.ndarray, G: int) -> np.ndarray:
    """a_0 = r_0, a_b = a_{b-1} G + r_b: every a_b, (B,) u64, on the CPU."""
    r = gf.from_u64(np.asarray(r, np.uint64), "cpu")
    return gf.to_u64(linear_scan(gf.constant(G, "cpu").expand(r.shape).clone(), r))


def byte_lookup_columns(qb: torch.Tensor, t_byte: torch.Tensor, m_byte: torch.Tensor,
                        X: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The byte lookup's phase-2 columns from the (NB, n) byte columns:
    (inv_qb (NB, n) = 1 / (X - b), inv_tb = m_byte / (X - t_byte), lacc =
    the running sum of sum(inv_qb) - inv_tb), a block of columns at a time.
    Where every cell holds a byte (an honest trace), the inverses are
    gathered from the 256 of 1 / (X - 0..255); else inverted cell by cell.
    The values are the same."""
    dev = qb.device
    xc = gf.constant(X, dev)
    table = gf.inv(gf.sub(xc, torch.arange(256, dtype=torch.int64, device=dev)))
    bytes_only = bool(((qb >= 0) & (qb < 256)).all())

    def inverse(b):
        return table[b] if bytes_only else gf.inv(gf.sub(xc, b))

    inv_qb = torch.empty_like(qb)
    total = torch.zeros_like(t_byte)
    step = max(_INV_ELEMS // max(qb.shape[1], 1), 1)
    for i in range(0, qb.shape[0], step):
        block = inverse(qb[i:i + step])
        inv_qb[i:i + step] = block
        total = gf.add(total, gf.sum_mod(block, dim=0))
    inv_tb = gf.mul(m_byte, gf.inv(gf.sub(xc, t_byte)))
    return inv_qb, inv_tb, gf.cumsum_mod(gf.sub(total, inv_tb))


def byte_lookup_rows(qb: torch.Tensor, invb: torch.Tensor, inv_tb: torch.Tensor,
                     t_byte: torch.Tensor, m_byte: torch.Tensor, X: torch.Tensor):
    """The two row constraints of the byte lookup over row views:
    [inv_qb (X - b) - 1 a byte column (group), inv_tb (X - t_byte) - m_byte]."""
    d = gf.sub(gf.mul(invb, gf.sub(X, qb)), torch.ones_like(qb))
    return [grp(d), gf.sub(gf.mul(inv_tb, gf.sub(X, t_byte)), m_byte)]


def lookup_diff(invb: torch.Tensor, inv_tb: torch.Tensor) -> torch.Tensor:
    """sum(inv_qb) - inv_tb over row views."""
    return gf.sub(gf.sum_mod(invb), inv_tb)


def limbs_t(row: torch.Tensor, base: int, count: int) -> torch.Tensor:
    """(batch, count) u16 limbs from interleaved lo/hi byte columns."""
    lo = row[..., base:base + 2 * count:2]
    hi = row[..., base + 1:base + 2 * count:2]
    return gf.add(lo, gf.mul_const(hi, 256))


def carries_t(row: torch.Tensor, base: int, npos: int) -> torch.Tensor:
    """(batch, npos) biased carry values from their 3-byte columns."""
    b0 = row[..., base:base + 3 * npos:3]
    b1 = row[..., base + 1:base + 3 * npos:3]
    b2 = row[..., base + 2:base + 3 * npos:3]
    return gf.add(b0, gf.add(gf.mul_const(b1, 1 << 8), gf.mul_const(b2, 1 << 16)))


def carry_chain(M: torch.Tensor, C: torch.Tensor, bias: int):
    """The biased carry chain over all positions: rel_pos = M_pos +
    (C_{pos-1} - BIAS) - (C_pos - BIAS) 2^16 with C_{-1} = BIAS, (batch,
    npos); and the final carry's C_last - BIAS."""
    b = gf.constant(bias, C.device)
    prev = torch.cat([torch.full_like(C[..., :1], bias), C[..., :-1]], dim=-1)
    rel = gf.sub(gf.add(M, gf.sub(prev, b)), gf.mul_const(gf.sub(C, b), 1 << 16))
    return rel, gf.sub(C[..., -1], b)


@functools.lru_cache(maxsize=8)
def _diagonals(la: int, lb: int, npos: int) -> np.ndarray:
    """(npos, min(la, lb)) flat indices a * lb + b of the products with
    a + b = pos, padded with la * lb (a zero column)."""
    width = min(la, lb)
    out = np.full((npos, width), la * lb, np.int64)
    for pos in range(npos):
        k = 0
        for a in range(la):
            b = pos - a
            if 0 <= b < lb:
                out[pos, k] = a * lb + b
                k += 1
    return out


def conv(A: torch.Tensor, B: torch.Tensor, npos: int) -> torch.Tensor:
    """Position sums of the limb product: (batch, npos), M_pos = sum over
    a + b = pos of A_a B_b; B (lb,) or (batch, lb)."""
    la, lb = A.shape[-1], B.shape[-1]
    prod = gf.mul(A.unsqueeze(-1), B.unsqueeze(-2))
    flat = prod.reshape(tuple(prod.shape[:-2]) + (la * lb,))
    flat = torch.cat([flat, torch.zeros_like(flat[..., :1])], dim=-1)
    idx = torch.as_tensor(_diagonals(la, lb, npos), device=A.device)
    return gf.sum_mod(flat[..., idx])


def residuals(air, cols: torch.Tensor, public: torch.Tensor, ch) -> dict:
    """Every constraint family of `air` over the (m, n) columns [fixed |
    phase1 | phase2] on the trace domain itself (no LDE): the transition
    ones on rows 0..n-2 against the next row, the row ones on every row, the
    boundary ones on the first and last rows.  Each entry is a (k, rows) u64
    array, zero where the constraint holds."""
    rows = cols.T
    ch_t = gf.from_u64(np.asarray(ch, np.uint64), cols.device)
    out = {}

    def flat(vals):
        parts = []
        for v in vals:
            v = gf.canonicalize(v)
            parts.append(v.reshape((-1,) + tuple(v.shape[-1:])) if v.dim() > 1 else v[None])
        return gf.to_u64(torch.cat(parts))

    cur, nxt = rows[:-1], rows[1:]
    if air.constraints_pub is not None:
        out["transition"] = flat(air.constraints_pub(cur, nxt, public, ch_t))
    else:
        out["transition"] = flat(air.constraints(cur, nxt, ch_t))
    if air.compose_row_pub is not None:
        # the folded row constraints vanish iff their alpha-sum does, for
        # two independent alphas
        out["row"] = np.stack([gf.to_u64(air.compose_row_pub(rows, public, ch_t, a, 1)[0])
                               for a in (3, 0x1234567)])
    elif air.row_constraints is not None:
        out["row"] = flat(air.row_constraints(rows, ch_t))
    if air.first_row is not None:
        out["first"] = flat(air.first_row(rows[:1], public, ch_t))
    if air.last_row is not None:
        out["last"] = flat(air.last_row(rows[-1:], public, ch_t))
    return out
