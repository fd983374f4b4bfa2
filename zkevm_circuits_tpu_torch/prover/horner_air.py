"""eip_4844 Horner-evaluation AIR (the JAX package's `prover/horner_air.py`,
on torch tensors): a STARK of the blob polynomial's opening in the
BLS12-381 scalar field (ref `src/eip_4844/mod.rs:186-204`):

  acc_{i+1} = (acc_i + fe_i) * z  (mod r_BLS),   y = acc_E

Row i (one Horner step; E real rows, padded to 2^k):
  add:   acc_i + fe_i = t_i + k_i * r                (k_i < 2^16)
  mul:   t_i * z      = q_i * r + acc_{i+1}          (transition; skipped on
                                                      the last real row via
                                                      the fixed `lst` flag)
  last:  t_{E-1} = y                                 (the opening)

Every value is committed as bytes (u16 limbs = b0 + 256 b1), so every range
check is one logUp byte-table membership and every relation is affine in
trace cells: z and r enter as public scalars / constants, and the integer
identities are per-limb carry chains (biased carry bytes C_j = c_j + BIAS).

Publics: [z limbs (16) | y limbs (16) | fe-stream RLC (1)]; the verifier
recomputes z from the challenge digest's truncation, y from the opening
bytes and the RLC from the plaintext blob chunks.  Fixed columns: t_byte
(0..255 cyclic), act (1 on real rows), lst (1 on the last real row).

The constraints are the JAX module's in the same order; each carry chain
is one group over its positions, the limb products one gather of
anti-diagonals.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import gf
from ..ops.gf import MODULUS
from ..utils.device import resolve_device
from .air_common import (Reg, byte_lookup_columns, byte_lookup_rows, carries_t, carry_chain,
                         challenge, conv, grp, horner_prefix, host, limbs_t, lookup_diff,
                         masked_scan, powers)
from .stark import (AirSpec, StarkParams, StarkProof, _alpha_sum, _commit_columns,
                    challenges_from_cap, prove, verify)

BLS_FR = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
R_LIMBS = [(BLS_FR >> (16 * j)) & 0xFFFF for j in range(16)]

NFE = 16       # fe/acc/t limbs
NK = 1         # add carry-multiple limbs
NQ = 17        # mul quotient limbs
N_ADD_POS = 17   # carry positions for the add relation (limbs 0..16)
N_MUL_POS = 33   # carry positions for the mul relation (coef 0..32)
ADD_BIAS = 1 << 18
MUL_BIAS = 1 << 22


@functools.lru_cache(maxsize=1)
def layout() -> Tuple[Reg, Reg, Reg]:
    fx = Reg()
    fx.add("t_byte"); fx.add("act"); fx.add("lst")
    p1 = Reg()
    p1.add("fe_b", 2 * NFE)
    p1.add("acc_b", 2 * NFE)     # acc BEFORE this row's step
    p1.add("t_b", 2 * NFE)
    p1.add("k_b", 2 * NK)
    p1.add("q_b", 2 * NQ)
    p1.add("addc_b", 3 * N_ADD_POS)
    p1.add("mulc_b", 3 * N_MUL_POS)
    p1.add("m_byte")             # byte-table multiplicity
    p2 = Reg()
    p2.add("inv_qb", p1.index["m_byte"][0])  # one inverse per byte query col
    p2.add("inv_tb")
    p2.add("lacc")               # logUp accumulator
    p2.add("facc")               # fe-stream RLC accumulator (BEFORE row)
    return fx, p1, p2


_N_BYTE_Q = layout()[1].index["m_byte"][0]  # all p1 byte columns before m_byte


@functools.lru_cache(maxsize=1)
def horner_air() -> AirSpec:
    fx, p1, p2 = layout()
    F, P1 = fx.n, p1.n

    def fat(nm, j=0):
        return fx.at(nm, j)

    def at(nm, j=0):
        return F + p1.at(nm, j)

    def at2(nm, j=0):
        return F + P1 + p2.at(nm, j)

    def limbs(row, nm, count):
        return limbs_t(row, at(nm), count)

    def byte_terms(row):
        return (row[..., F:F + _N_BYTE_Q],
                row[..., at2("inv_qb"):at2("inv_qb") + _N_BYTE_Q], row[..., at2("inv_tb")])

    def compose_row_pub(cur, public, ch, alpha, a_pow):
        dev = cur.device
        act = cur[..., fat("act")]
        lst = cur[..., fat("lst")]
        fe, acc, t = limbs(cur, "fe_b", NFE), limbs(cur, "acc_b", NFE), limbs(cur, "t_b", NFE)
        k = limbs(cur, "k_b", NK)
        # add relation carry chain: (acc_j + fe_j - t_j - k r_j) + C_{j-1}
        #   - BIAS == (C_j - BIAS) 2^16, masked by act
        a = gf.sub(gf.add(acc, fe), gf.add(t, gf.mul(k, gf.from_u64(R_LIMBS, dev))))
        a = torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)
        rel, fin = carry_chain(a, carries_t(cur, at("addc_b"), N_ADD_POS), ADD_BIAS)
        out = [grp(gf.mul(act.unsqueeze(-1), rel)), gf.mul(act, fin)]
        # last real row: t == y (publics 16..31)
        out.append(grp(gf.mul(lst.unsqueeze(-1), gf.sub(t, public[NFE:2 * NFE]))))
        qb, invb, inv_tb = byte_terms(cur)
        out += byte_lookup_rows(qb, invb, inv_tb, cur[..., fat("t_byte")],
                                cur[..., at("m_byte")], ch[0])
        return _alpha_sum(out, alpha, a_pow)

    def constraints_pub(cur, nxt, public, ch):
        dev = cur.device
        act = cur[..., fat("act")]
        lst = cur[..., fat("lst")]
        one = torch.ones_like(act)
        t, q = limbs(cur, "t_b", NFE), limbs(cur, "q_b", NQ)
        acc_c, acc_n = limbs(cur, "acc_b", NFE), limbs(nxt, "acc_b", NFE)
        # mul relation: t z == q r + acc' (coefficient carry chain), masked
        # by act (1 - lst)
        M = gf.sub(conv(t, public[:NFE], N_MUL_POS),
                   conv(q, gf.from_u64(R_LIMBS, dev), N_MUL_POS))
        M = gf.sub(M, torch.cat([acc_n, torch.zeros_like(M[..., NFE:])], dim=-1))
        mask = gf.mul(act, gf.sub(one, lst))
        rel, fin = carry_chain(M, carries_t(cur, at("mulc_b"), N_MUL_POS), MUL_BIAS)
        out = [grp(gf.mul(mask.unsqueeze(-1), rel)), gf.mul(mask, fin)]
        # lst row: acc' = t (the no-multiply final step); pad rows hold acc
        # (so y stays readable on every pad row); limb-major pairs
        out.append(torch.stack([gf.mul(lst, grp(gf.sub(acc_n, t))),
                                gf.mul(gf.sub(one, act), grp(gf.sub(acc_n, acc_c)))], dim=1))
        # fe-stream RLC: facc' = facc delta^32 + row_rlc on act rows
        delta = challenge(ch, 1)
        fe_rlc = gf.dot_mod(cur[..., at("fe_b"):at("fe_b") + 2 * NFE],
                            powers(delta, 2 * NFE, dev))
        facc_c, facc_n = cur[..., at2("facc")], nxt[..., at2("facc")]
        pushed = gf.add(gf.mul_const(facc_c, pow(delta, 2 * NFE, MODULUS)), fe_rlc)
        out.append(gf.sub(facc_n, gf.add(gf.mul(act, pushed), gf.mul(gf.sub(one, act), facc_c))))
        # logUp accumulator transition
        _, invb, inv_tb = byte_terms(nxt)
        out.append(gf.sub(gf.sub(nxt[..., at2("lacc")], cur[..., at2("lacc")]),
                          lookup_diff(invb, inv_tb)))
        return out

    def first_row(row, public, ch):
        _, invb, inv_tb = byte_terms(row)
        return [grp(row[..., at("acc_b"):at("acc_b") + 2 * NFE]),
                gf.sub(row[..., at2("lacc")], lookup_diff(invb, inv_tb)),
                row[..., at2("facc")]]

    def last_row(row, public, ch):
        # the final pad row: facc carries the stream RLC (publics[32]);
        # the logUp accumulator closes at zero
        return [gf.sub(row[..., at2("facc")], public[2 * NFE]), row[..., at2("lacc")]]

    return AirSpec(
        num_cols=P1,
        max_degree=3,
        constraints=None,
        constraints_pub=constraints_pub,
        compose_row_pub=compose_row_pub,
        first_row=first_row,
        last_row=last_row,
        num_public=2 * NFE + 1,
        num_fixed_cols=F,
        num_phase2_cols=p2.n,
        num_challenges=2,
    )


# ---------------------------------------------------------------------------
# trace builder
# ---------------------------------------------------------------------------


def fixed_cols(n: int, E: int, device=None) -> torch.Tensor:
    """The fixed columns on `device` (None: the card)."""
    t_byte = np.arange(n, dtype=np.uint64) % 256
    act = (np.arange(n) < E).astype(np.uint64)
    lst = (np.arange(n) == E - 1).astype(np.uint64)
    return gf.from_u64(np.stack([t_byte, act, lst]), resolve_device(device))


def _bytes_of_limbs(limbs: np.ndarray, nl: int) -> np.ndarray:
    """(E, nl) u16 limbs -> (2*nl, E) byte rows [lo0, hi0, lo1, ...]."""
    out = np.zeros((2 * nl, limbs.shape[0]), np.uint64)
    out[0::2] = (limbs[:, :nl] & 0xFF).T
    out[1::2] = (limbs[:, :nl] >> 8).T
    return out


def _carry_bytes(vals: np.ndarray, bias: int, npos: int) -> np.ndarray:
    """(E, npos) signed carries -> (3*npos, E) biased byte rows."""
    b = vals + bias
    assert (b >= 0).all() and (b < (1 << 24)).all(), "carry out of range"
    out = np.zeros((3 * npos, vals.shape[0]), np.uint64)
    out[0::3] = (b & 0xFF).T
    out[1::3] = ((b >> 8) & 0xFF).T
    out[2::3] = (b >> 16).T
    return out


def _telescope(M: np.ndarray) -> np.ndarray:
    """Carries of the position sums M (E, npos), which must close at 0."""
    out = np.zeros_like(M)
    prev = np.zeros(M.shape[0], np.int64)
    for j in range(M.shape[1]):
        cur = M[:, j] + prev
        assert (cur % (1 << 16) == 0).all(), (j, cur[:4])
        cur >>= 16
        out[:, j] = cur
        prev = cur
    assert (prev == 0).all()
    return out


def horner_trace(w, E: int, device=None):
    """(fixed, phase1, publics-sans-RLC, log_n) from an EIP4844Witness, the
    columns on `device` (None: the card).  The fe-RLC public depends on a
    challenge and is appended by prove_horner after the challenge round."""
    device = resolve_device(device)
    fe = host(w.fe).astype(np.int64)          # (E, 16)
    acc = host(w.acc).astype(np.int64)        # (E+1, 16)
    t = host(w.t).astype(np.int64)            # (E, 16)
    k = host(w.add_k).astype(np.int64)        # (E, 1)
    q = host(w.mul_q).astype(np.int64)        # (E, 17)
    z = host(w.z).astype(np.int64)            # (16,)
    r = np.asarray(R_LIMBS, np.int64)
    n = 1 << max(8, max(E, 1).bit_length())  # >= 256 (byte table), > E

    # add carries: (acc + fe - t - k r) telescoping per limb
    A = np.zeros((E, N_ADD_POS), np.int64)
    A[:, :NFE] = acc[:-1] + fe - t - k * r[None, :]
    addc = _telescope(A)
    # mul carries: t z - q r - acc' per coefficient (zeroed on the last row)
    M = np.zeros((E, N_MUL_POS), np.int64)
    for a in range(NFE):
        M[:, a:a + NFE] += t[:, a:a + 1] * z[None, :]
    for a in range(NQ):
        M[:, a:a + NFE] -= q[:, a:a + 1] * r[None, :]
    M[:, :NFE] -= acc[1:]
    M[E - 1] = 0
    mulc = _telescope(M)

    fx, p1, p2 = layout()
    cols = np.zeros((p1.n, n), np.uint64)
    cols[p1.sl("fe_b"), :E] = _bytes_of_limbs(fe, NFE)
    # acc column = acc BEFORE the row; pad rows replicate acc_E (= y)
    acc_col = np.concatenate([acc[:E], np.repeat(acc[E][None], n - E, axis=0)], axis=0)
    cols[p1.sl("acc_b")] = _bytes_of_limbs(acc_col, NFE)
    cols[p1.sl("t_b"), :E] = _bytes_of_limbs(t, NFE)
    cols[p1.sl("k_b"), :E] = _bytes_of_limbs(k, NK)
    cols[p1.sl("q_b"), :E] = _bytes_of_limbs(q, NQ)
    # pad-row carries encode zero (biased)
    full_add = np.zeros((n, N_ADD_POS), np.int64)
    full_add[:E] = addc
    full_mul = np.zeros((n, N_MUL_POS), np.int64)
    full_mul[:E] = mulc
    cols[p1.sl("addc_b")] = _carry_bytes(full_add, ADD_BIAS, N_ADD_POS)
    cols[p1.sl("mulc_b")] = _carry_bytes(full_mul, MUL_BIAS, N_MUL_POS)
    # byte-table multiplicities over every byte query column
    counts = np.bincount(cols[:_N_BYTE_Q].reshape(-1).astype(np.int64), minlength=256)
    cols[p1.at("m_byte"), :256] = counts

    publics = np.zeros(2 * NFE + 1, np.uint64)
    publics[:NFE] = z.astype(np.uint64)
    publics[NFE:2 * NFE] = acc[E].astype(np.uint64)  # y
    return fixed_cols(n, E, device), gf.from_u64(cols, device), publics, n.bit_length() - 1


def _build_phase2(trace: torch.Tensor, ch_ints) -> torch.Tensor:
    """The phase-2 columns from [fixed | phase1] (m, n)."""
    fx, p1, _ = layout()
    F = fx.n
    X, delta = int(ch_ints[0]), int(ch_ints[1])
    inv_qb, inv_tb, lacc = byte_lookup_columns(trace[F:F + _N_BYTE_Q], trace[fx.at("t_byte")],
                                               trace[F + p1.at("m_byte")], X)
    s = F + p1.at("fe_b")
    rlc_rows = gf.dot_mod(trace[s:s + 2 * NFE].T, powers(delta, 2 * NFE, trace.device))
    facc = masked_scan(trace[fx.at("act")], pow(delta, 2 * NFE, MODULUS), rlc_rows)
    return torch.cat([inv_qb, torch.stack([inv_tb, lacc, facc])])


def stream_rlc_host(fe_limbs: np.ndarray, delta: int) -> int:
    """Verifier-side recomputation of the fe-stream RLC from plaintext
    limbs (derived from the public blob chunks)."""
    fe_limbs = np.asarray(fe_limbs, np.uint64)
    if fe_limbs.shape[0] == 0:
        return 0
    bs = np.zeros((fe_limbs.shape[0], 2 * NFE), np.uint64)
    bs[:, 0::2] = fe_limbs & np.uint64(0xFF)
    bs[:, 1::2] = fe_limbs >> np.uint64(8)
    rows = gf.to_u64(gf.dot_mod(torch.as_tensor(bs.astype(np.int64)),
                                powers(delta, 2 * NFE, "cpu")))
    return int(horner_prefix(rows, pow(delta, 2 * NFE, MODULUS))[-1])


def prove_horner(w, E: int, params: Optional[StarkParams] = None, device=None):
    """Prove the blob's Horner opening on `device` (None: the card).
    Returns (proof, publics, params)."""
    fixed, phase1, publics, log_n = horner_trace(w, E, device)
    if params is None:
        params = StarkParams(log_n=log_n)
    air = horner_air()
    # the fe-RLC public depends on the delta challenge drawn from the caps:
    # pre-commit to derive it exactly as the verifier will
    ftree = _commit_columns(fixed, params)
    ptree = _commit_columns(phase1, params)
    ch, _ = challenges_from_cap(ptree["cap"], air, ftree["cap"])
    publics = publics.copy()
    publics[2 * NFE] = stream_rlc_host(host(w.fe).astype(np.uint64)[:E], ch[1])
    proof = prove(phase1, air, params, gf.from_u64(publics, phase1.device),
                  build_phase2=_build_phase2, fixed_cols=fixed, phase1_tree=ptree)
    return proof, publics, params


def verify_horner(proof: StarkProof, w_public: dict, params: StarkParams) -> bool:
    """w_public: {chunks: (E, 31) bytes-as-ints, truncated: (16,) bytes,
    opening_be: (32,) bytes, E: int}, all public data; z, y and fe are
    recomputed from it, never taken from the prover.  The proof's own
    `params` are trusted, as in the JAX package (ROADMAP Queue 3)."""
    E = int(w_public["E"])
    chunks = np.asarray(w_public["chunks"], np.uint64)
    trunc = np.asarray(w_public["truncated"], np.uint64)
    opening = np.asarray(w_public["opening_be"], np.uint64)
    n = 1 << params.log_n
    air = horner_air()
    dev = proof.q_cap.device
    fixed = fixed_cols(n, E, dev)
    # z limbs from the BE truncated digest (models/eip_4844.py z_limbs rule)
    z = np.zeros(NFE, np.uint64)
    for i in range(16):
        z[(15 - i) // 2] += trunc[i] << np.uint64(8 * ((15 - i) % 2))
    # y limbs from the BE opening bytes
    y = np.zeros(NFE, np.uint64)
    for i in range(32):
        y[(31 - i) // 2] += opening[i] << np.uint64(8 * ((31 - i) % 2))
    # fe limbs from chunk bytes (31 LE bytes -> 16 limbs)
    fe = np.zeros((E, NFE), np.uint64)
    for j in range(NFE):
        lo = chunks[:, 2 * j]
        hi = chunks[:, 2 * j + 1] if 2 * j + 1 < 31 else np.zeros(E, np.uint64)
        fe[:, j] = lo | (hi << np.uint64(8))
    # replay the challenge round to derive delta for the fe-RLC public
    fcap = _commit_columns(fixed, params)["cap"]
    ch, _ = challenges_from_cap(proof.caps[1], air, fcap)
    publics = np.zeros(2 * NFE + 1, np.uint64)
    publics[:NFE] = z
    publics[NFE:2 * NFE] = y
    publics[2 * NFE] = stream_rlc_host(fe, ch[1])
    return verify(proof, air, params, gf.from_u64(publics, dev), fixed_cols=fixed)
