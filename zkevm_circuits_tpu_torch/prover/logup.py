"""Provable lookup argument, logUp (the JAX package's `prover/logup.py`, on
torch tensors).

Reference-parity role: boojum's lookup-table argument behind every
`cs.perform_lookup` (the VM opcode decode against `VMOpcodeDecodingTable`,
the bitshift and range tables).  Table membership becomes a STARK:

    sum_i  active_i / (X - key(q_i))  ==  sum_j  m_j / (X - key(t_j))

holds for a Fiat-Shamir X iff the active query tuples are a sub-multiset of
the table tuples with multiplicities m (logUp, Haboeck ePrint 2022/1530).
Tuples are compressed to one field key with a second challenge beta:
key(x) = x_0 + beta x_1 + beta^2 x_2 + ...

  fixed columns   (verifier-known; the verifier recomputes their cap):
                   t_0..t_{c-1}     the table tuples
  phase-1 columns: q_0..q_{c-1}     the queried tuples
                   active           1 on real queries, 0 on padding
                   m                multiplicity of table row j among queries
  challenges:      X = ch[0], beta = ch[1]
  phase-2 columns: inv_q = active / (X - key(q))
                   inv_t = m / (X - key(t))
                   acc   = running sum of (inv_q - inv_t)

  AIR (degree 2):
    row:        inv_q * (X - key(q)) - active  = 0
    row:        inv_t * (X - key(t)) - m       = 0
    row:        active * (active - 1)          = 0
    transition: acc' - acc - inv_q' + inv_t'   = 0
    first row:  acc - inv_q + inv_t            = 0   (affine)
    last row:   acc                            = 0   (affine)

The table occupies the first T rows (padded with multiplicity-0 rows to the
power-of-two trace length); queries are padded with active = 0 rows.  The
verifier supplies the PLAINTEXT table to `verify_lookup`, so a proof binds
the committed queries to THE agreed table.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import gf
from ..utils.device import resolve_device
from .stark import AirSpec, StarkParams, StarkProof, prove, verify


def _key(cols, beta: torch.Tensor) -> torch.Tensor:
    """Challenge-compressed tuple key: sum_k beta^k * cols[k] (Horner)."""
    acc = cols[-1]
    for k in range(len(cols) - 2, -1, -1):
        acc = gf.add(gf.mul(acc, beta), cols[k])
    return acc


@functools.lru_cache(maxsize=8)
def lookup_air(num_key_cols: int) -> AirSpec:
    """AIR for a `num_key_cols`-wide tuple lookup.  Row views are
    [fixed | phase1 | phase2]:
      [0 .. c) table tuple, [c .. 2c) query tuple, 2c active, 2c + 1 m,
      2c + 2 inv_q, 2c + 3 inv_t, 2c + 4 acc."""
    c = num_key_cols

    def split(row):
        t_cols = [row[..., k] for k in range(c)]
        q_cols = [row[..., c + k] for k in range(c)]
        active = row[..., 2 * c]
        m = row[..., 2 * c + 1]
        inv_q = row[..., 2 * c + 2]
        inv_t = row[..., 2 * c + 3]
        acc = row[..., 2 * c + 4]
        return t_cols, q_cols, active, m, inv_q, inv_t, acc

    def row_constraints(cur, ch):
        t_cols, q_cols, active, m, inv_q, inv_t, _ = split(cur)
        X, beta = ch[0], ch[1]
        kq = _key(q_cols, beta)
        kt = _key(t_cols, beta)
        return [
            gf.sub(gf.mul(inv_q, gf.sub(X, kq)), active),
            gf.sub(gf.mul(inv_t, gf.sub(X, kt)), m),
            gf.mul(active, gf.sub(active, torch.ones_like(active))),
        ]

    def constraints(cur, nxt, ch):
        _, _, _, _, inv_q_n, inv_t_n, acc_n = split(nxt)
        acc = split(cur)[6]
        return [gf.sub(gf.sub(acc_n, acc), gf.sub(inv_q_n, inv_t_n))]

    def first_row(row, public, ch):
        _, _, _, _, inv_q, inv_t, acc = split(row)
        return [gf.sub(acc, gf.sub(inv_q, inv_t))]

    def last_row(row, public, ch):
        return [split(row)[6]]

    return AirSpec(
        num_cols=c + 2,
        max_degree=2,
        constraints=constraints,
        row_constraints=row_constraints,
        first_row=first_row,
        last_row=last_row,
        num_fixed_cols=c,
        num_phase2_cols=3,
        num_challenges=2,
    )


def _pad_pow2(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((arr.shape[0], n), fill, dtype=np.uint64)
    out[:, : arr.shape[1]] = arr
    return out


def lookup_trace(table_cols: np.ndarray, query_cols: np.ndarray,
                 log_n: Optional[int] = None, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray, int]:
    """(fixed columns, phase-1 columns, multiplicities, log_n) for a lookup
    proof, the columns on `device` (None: the card).

    table_cols: (c, T) u64, the canonical table tuples (T >= 1).
    query_cols: (c, Q) u64, the queried tuples; EVERY one must be in the
    table, else ValueError (no valid multiplicities exist)."""
    table_cols = np.asarray(table_cols, np.uint64)
    query_cols = np.asarray(query_cols, np.uint64)
    c, T = table_cols.shape
    if query_cols.shape[0] != c:
        raise ValueError(f"queries are {query_cols.shape[0]} wide, the table {c}")
    Q = query_cols.shape[1]
    n = 1 << (log_n if log_n is not None else max(max(T, Q) - 1, 1).bit_length())
    if n < T or n < Q:
        raise ValueError(f"2^{log_n} rows hold neither {T} table rows nor {Q} queries")
    device = resolve_device(device)

    # multiplicities: each query counted against the first equal table row
    index = {}
    for j, tup in enumerate(map(tuple, table_cols.T.tolist())):
        index.setdefault(tup, j)
    m = np.zeros(n, dtype=np.uint64)
    for tup in map(tuple, query_cols.T.tolist()):
        j = index.get(tup)
        if j is None:
            raise ValueError(f"query tuple {tup} not in table")
        m[j] += 1

    fixed = gf.from_u64(_pad_pow2(table_cols, n), device)
    active = np.zeros(n, dtype=np.uint64)
    active[:Q] = 1
    phase1 = gf.from_u64(np.concatenate([_pad_pow2(query_cols, n), active[None], m[None]]),
                         device)
    return fixed, phase1, m, n.bit_length() - 1


def _build_phase2(c: int):
    """phase-2 builder: its input is [fixed | phase1] = (2c + 2, n)."""

    def build(trace: torch.Tensor, ch_ints) -> torch.Tensor:
        dev = trace.device
        X = gf.constant(ch_ints[0], dev)
        beta = gf.constant(ch_ints[1], dev)
        kq = _key([trace[c + k] for k in range(c)], beta)
        kt = _key([trace[k] for k in range(c)], beta)
        inv_q = gf.mul(trace[2 * c], gf.inv(gf.sub(X, kq)))
        inv_t = gf.mul(trace[2 * c + 1], gf.inv(gf.sub(X, kt)))
        acc = gf.cumsum_mod(gf.sub(inv_q, inv_t))
        return torch.stack([inv_q, inv_t, acc])

    return build


def prove_lookup(table_cols: np.ndarray, query_cols: np.ndarray,
                 params: Optional[StarkParams] = None, device=None
                 ) -> Tuple[StarkProof, StarkParams]:
    """STARK-prove that every query tuple appears in the table, on `device`
    (None: the card)."""
    c = int(np.asarray(table_cols).shape[0])
    fixed, phase1, _, log_n = lookup_trace(table_cols, query_cols, device=device)
    if params is None:
        params = StarkParams(log_n=log_n)
    proof = prove(phase1, lookup_air(c), params, build_phase2=_build_phase2(c),
                  fixed_cols=fixed)
    return proof, params


def verify_lookup(proof: StarkProof, table_cols: np.ndarray, params: StarkParams) -> bool:
    """Verifier side: the PLAINTEXT canonical table pins the fixed-column
    cap; everything else is the STARK."""
    table_cols = np.asarray(table_cols, np.uint64)
    c = table_cols.shape[0]
    n = 1 << params.log_n
    if table_cols.shape[1] > n:
        return False
    fixed = gf.from_u64(_pad_pow2(table_cols, n), proof.q_cap.device)
    return verify(proof, lookup_air(c), params, fixed_cols=fixed)
