"""keccak-f[1600] sponge-chain AIR (the JAX package's `prover/keccak_air.py`,
on torch tensors): STARK proofs of keccak256 digests for the keccak
precompile (type 5, ref `src/keccak256_round_function/mod.rs:795+`), the
linear hasher (type 13, `src/linear_hasher/mod.rs`) and the eip_4844 chains.

Bit-column AIR, one row per round; every constraint is a gathered group
over static index maps:

  row r of block b (r = 0..23, the schedule pinned by fixed columns):
    pad | ab | cont | rcb[64] |
    A[1600]          state bits at round input
    c0,c1,c2[320]    theta column parity: sum_y A[x,y,z] = c0 + 2 c1 + 4 c2
    ap[1600]         post-theta bits: ap = XOR3(A, c0[x-1,z], c0[x+1,z-1])
    t[1600]          chi product bits: t = (1 - B[x+1]) B[x+2], B = the
                     rho/pi rewiring of ap
    O[1600]          round output: O = B + t - 2 B t, with iota on lane (0,0)
  transitions:
    cont' (A' - O)             round-to-round continuity
    ab'   (A'_cap - O_cap)     absorb rows keep the capacity lanes
    ab'   (acc' - acc g^1088 - sum_i g^i XOR2(A'_i, O_i))
                               message RLC over the absorbed rate bits
    pad'  (col' - col)         padding replicates the last live row

Publics: [digest as 8 u32 (lanes 0..3 of the final O), message-RLC acc];
the verifier recomputes the RLC from the plaintext padded message.  Fixed
columns: rcf[64] (the iota round-constant bits), ir0 (round-0 flag).

The constraints are the JAX module's in the same order.  The trace is built
as bytes, a row a round, and widened on the device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import gf
from ..ops.gf import MODULUS
from ..ops.keccak import KECCAK_RATE_BYTES, ROT, ROUND_CONSTANTS
from ..utils.device import resolve_device
from .air_common import bits_rlc, challenge, grp, horner_prefix, powers
from .stark import (AirSpec, StarkParams, StarkProof, _commit_columns, challenges_from_cap,
                    prove, verify)

LANES = 25
ZBITS = 64
NBITS = LANES * ZBITS          # 1600
RATE_BITS = (KECCAK_RATE_BYTES // 8) * ZBITS  # 1088
ROUNDS = 24


def _lane(x: int, y: int) -> int:
    return x + 5 * y


def _bit(x: int, y: int, z: int) -> int:
    return _lane(x, y) * ZBITS + z


@functools.lru_cache(maxsize=1)
def _index_maps():
    """Static gather maps shared by the AIR and the trace builder."""
    # theta parity groups: PAR[(x, z)] = 5 A-bit indices of column (x, z)
    PAR = np.zeros((5 * ZBITS, 5), np.int64)
    for x in range(5):
        for z in range(ZBITS):
            PAR[x * ZBITS + z] = [_bit(x, y, z) for y in range(5)]
    # ap[pos] = XOR3(A[pos], c0[XU[pos]], c0[XV[pos]])
    XU = np.zeros(NBITS, np.int64)
    XV = np.zeros(NBITS, np.int64)
    for x in range(5):
        for y in range(5):
            for z in range(ZBITS):
                i = _bit(x, y, z)
                XU[i] = ((x - 1) % 5) * ZBITS + z
                XV[i] = ((x + 1) % 5) * ZBITS + (z - 1) % ZBITS
    # B[x,y,z] = ap[BI[x,y,z]] (rho rotation + pi lane permutation)
    BI = np.zeros(NBITS, np.int64)
    for x in range(5):
        for y in range(5):
            p, q = y, (2 * x + 3 * y) % 5
            for z in range(ZBITS):
                BI[_bit(p, q, z)] = _bit(x, y, (z - ROT[x][y]) % ZBITS)
    B1I = np.zeros(NBITS, np.int64)
    B2I = np.zeros(NBITS, np.int64)
    for x in range(5):
        for y in range(5):
            for z in range(ZBITS):
                i = _bit(x, y, z)
                B1I[i] = BI[_bit((x + 1) % 5, y, z)]
                B2I[i] = BI[_bit((x + 2) % 5, y, z)]
    return PAR, XU, XV, BI, B1I, B2I


# round-constant bits, (ROUNDS, 64)
_RC_BITS = np.array([[(rc >> z) & 1 for z in range(ZBITS)] for rc in ROUND_CONSTANTS], np.uint64)


class _Cols:
    def __init__(self):
        i = 0
        self.pad = i; i += 1
        self.ab = i; i += 1
        self.cont = i; i += 1
        self.rcb = slice(i, i + ZBITS); i += ZBITS
        self.A = slice(i, i + NBITS); i += NBITS
        self.c0 = slice(i, i + 5 * ZBITS); i += 5 * ZBITS
        self.c1 = slice(i, i + 5 * ZBITS); i += 5 * ZBITS
        self.c2 = slice(i, i + 5 * ZBITS); i += 5 * ZBITS
        self.ap = slice(i, i + NBITS); i += NBITS
        self.t = slice(i, i + NBITS); i += NBITS
        self.O = slice(i, i + NBITS); i += NBITS
        self.num_phase1 = i
        self.acc = i  # phase-2 (index in the concatenated row)
        # fixed columns (own tree, indices 0.. in the fixed group)
        self.f_rcf = slice(0, ZBITS)
        self.f_ir0 = ZBITS
        self.num_fixed = ZBITS + 1


@functools.lru_cache(maxsize=1)
def _cols() -> _Cols:
    return _Cols()


NUM_PUBLIC = 9  # 8 u32 digest words + message RLC


def fixed_columns(n: int, device=None) -> torch.Tensor:
    """The fixed columns on `device` (None: the card)."""
    c = _cols()
    out = np.zeros((c.num_fixed, n), np.uint64)
    r = np.arange(n) % ROUNDS
    out[c.f_rcf] = _RC_BITS[r].T
    out[c.f_ir0] = (r == 0).astype(np.uint64)
    return gf.from_u64(out, resolve_device(device))


def _xor2(u, v):
    return gf.sub(gf.add(u, v), gf.double(gf.mul(u, v)))


@functools.lru_cache(maxsize=1)
def keccak_air() -> AirSpec:
    c = _cols()
    F = c.num_fixed
    PAR, XU, XV, BI, B1I, B2I = _index_maps()
    cap_ix = np.arange(RATE_BITS, NBITS)
    bool_slices = ["A", "c0", "c1", "c2", "ap", "t", "O", "rcb"]
    w32 = np.uint64(1) << np.arange(32, dtype=np.uint64)

    def sl(row, s):
        return row[..., F + s.start:F + s.stop] if isinstance(s, slice) else row[..., F + s]

    def row_constraints(cur, ch):
        one = torch.ones_like(cur[..., 0])
        pad, ab, cont = sl(cur, c.pad), sl(cur, c.ab), sl(cur, c.cont)
        live = gf.sub(one, pad)
        ir0 = cur[..., c.f_ir0]
        # booleanity
        out = [gf.mul(v, gf.sub(v, one)) for v in (pad, ab, cont)]
        for nm in bool_slices:
            v = sl(cur, getattr(c, nm))
            out.append(grp(gf.mul(v, gf.sub(v, torch.ones_like(v)))))
        # row-type bindings
        out.append(gf.sub(ab, gf.mul(live, ir0)))
        out.append(gf.sub(cont, gf.mul(live, gf.sub(one, ir0))))
        # rcb pins the fixed iota schedule on live rows (copied on pad)
        rcb = sl(cur, c.rcb)
        out.append(gf.mul(live, grp(gf.sub(rcb, cur[..., c.f_rcf]))))
        # theta parity
        A = sl(cur, c.A)
        c0, c1, c2 = sl(cur, c.c0), sl(cur, c.c1), sl(cur, c.c2)
        psum = gf.sum_mod(A[..., PAR])
        out.append(grp(gf.sub(psum, gf.add(c0, gf.add(gf.double(c1), gf.mul_const(c2, 4))))))
        # ap = XOR3(A, c0[XU], c0[XV])
        ap = sl(cur, c.ap)
        u, v, w = A, c0[..., XU], c0[..., XV]
        uv, uw, vw = gf.mul(u, v), gf.mul(u, w), gf.mul(v, w)
        x3 = gf.sub(gf.add(gf.add(u, v), w), gf.double(gf.add(gf.add(uv, uw), vw)))
        x3 = gf.add(x3, gf.mul_const(gf.mul(uv, w), 4))
        out.append(grp(gf.sub(ap, x3)))
        # t = (1 - B1) B2
        t = sl(cur, c.t)
        B1, B2 = ap[..., B1I], ap[..., B2I]
        out.append(grp(gf.sub(t, gf.sub(B2, gf.mul(B1, B2)))))
        # O = chi (+ iota on lane 00): X = B + t - 2 B t
        O = sl(cur, c.O)
        X = _xor2(ap[..., BI], t)
        out.append(grp(gf.sub(O[..., ZBITS:], X[..., ZBITS:])))
        out.append(grp(gf.sub(O[..., :ZBITS], _xor2(X[..., :ZBITS], rcb))))
        return out

    def constraints(cur, nxt, ch):
        one = torch.ones_like(cur[..., 0])
        pad_c, pad_n = sl(cur, c.pad), sl(nxt, c.pad)
        ab_n, cont_n = sl(nxt, c.ab), sl(nxt, c.cont)
        # pad monotone + block-aligned start
        out = [gf.mul(pad_c, gf.sub(one, pad_n)),
               gf.mul(gf.sub(pad_n, pad_c), gf.sub(one, nxt[..., c.f_ir0]))]
        # pad rows replicate the previous row (all committed phase-1 bits)
        copy = slice(F + c.rcb.start, F + c.num_phase1)
        out.append(gf.mul(pad_n, grp(gf.sub(nxt[..., copy], cur[..., copy]))))
        # continuity: next round input = this round output
        A_n, O_c = sl(nxt, c.A), sl(cur, c.O)
        d = gf.sub(A_n, O_c)
        out.append(gf.mul(cont_n, grp(d)))
        out.append(gf.mul(ab_n, grp(d[..., cap_ix])))
        # message RLC: absorbed block = A_next XOR O_prev on the rate bits
        gamma = challenge(ch, 0)
        m = _xor2(A_n[..., :RATE_BITS], O_c[..., :RATE_BITS])
        rlc = gf.dot_mod(m, powers(gamma, RATE_BITS, cur.device))
        acc_c, acc_n = cur[..., F + c.acc], nxt[..., F + c.acc]
        G = pow(gamma, RATE_BITS, MODULUS)
        out.append(gf.mul(ab_n, gf.sub(acc_n, gf.add(gf.mul_const(acc_c, G), rlc))))
        out.append(gf.mul(gf.sub(one, ab_n), gf.sub(acc_n, acc_c)))
        return out

    def first_row(row, public, ch):
        A = sl(row, c.A)
        gamma = challenge(ch, 0)
        return [sl(row, c.pad), grp(A[..., cap_ix]),
                gf.sub(row[..., F + c.acc],
                       gf.dot_mod(A[..., :RATE_BITS], powers(gamma, RATE_BITS, row.device)))]

    def last_row(row, public, ch):
        O = sl(row, c.O)[..., :256].reshape(tuple(row.shape[:-1]) + (8, 32))
        words = gf.sum_mod(gf.mul(O, gf.from_u64(w32, row.device)))
        return [grp(gf.sub(words, public[:8])), gf.sub(row[..., F + c.acc], public[8])]

    return AirSpec(
        num_cols=c.num_phase1,
        max_degree=3,
        constraints=constraints,
        row_constraints=row_constraints,
        first_row=first_row,
        last_row=last_row,
        num_public=NUM_PUBLIC,
        num_fixed_cols=c.num_fixed,
        num_phase2_cols=1,
        num_challenges=1,
    )


# ---------------------------------------------------------------------------
# trace builder (numpy bit vectors; mirrors ops/keccak.py semantics)
# ---------------------------------------------------------------------------


def pad_message(message: bytes) -> np.ndarray:
    """keccak256 0x01..0x80 padding -> (B, RATE_BITS) bit blocks."""
    rate = KECCAK_RATE_BYTES
    padded = bytearray(message)
    pad_len = rate - (len(padded) % rate)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    data = np.frombuffer(bytes(padded), np.uint8)
    bits = np.unpackbits(data, bitorder="little").astype(np.uint64)
    return bits.reshape(-1, RATE_BITS)


def _trace_rows(blocks: np.ndarray):
    """(n, num_phase1) u8 rows of the sponge over the bit blocks, the
    digest words, n."""
    c = _cols()
    PAR, XU, XV, BI, B1I, B2I = _index_maps()
    B = blocks.shape[0]
    live = ROUNDS * B
    n = 1 << max(5, live.bit_length())  # 24 B is never a power of two
    R = np.zeros((n, c.num_phase1), np.uint8)
    rc = _RC_BITS.astype(np.uint8)
    state = np.zeros(NBITS, np.uint8)
    row = 0
    for b in range(B):
        A = state.copy()
        A[:RATE_BITS] ^= blocks[b].astype(np.uint8)
        for rnd in range(ROUNDS):
            r = R[row]
            csum = A[PAR].sum(axis=1, dtype=np.uint8)
            c0 = csum & 1
            ap = A ^ c0[XU] ^ c0[XV]
            Bv = ap[BI]
            t = (1 - ap[B1I]) * ap[B2I]
            O = Bv ^ t
            O[:ZBITS] ^= rc[rnd]
            r[c.rcb] = rc[rnd]
            r[c.A] = A
            r[c.c0] = c0
            r[c.c1] = (csum >> 1) & 1
            r[c.c2] = csum >> 2
            r[c.ap] = ap
            r[c.t] = t
            r[c.O] = O
            r[c.ab] = rnd == 0
            r[c.cont] = rnd != 0
            A = O
            row += 1
        state = A
    # pad: replicate the last live row; pad/ab/cont flags
    R[live:, c.rcb.start:] = R[live - 1, c.rcb.start:]
    R[live:, c.pad] = 1
    digest_bits = state[:8 * 32].reshape(8, 32).astype(np.uint64)
    digest_words = (digest_bits << np.arange(32, dtype=np.uint64)).sum(1)
    return R, digest_words, n


def build_keccak_trace(message: bytes, device=None):
    """(phase1, fixed, digest_words(8,) u32, build_phase2, log_n), the
    columns on `device` (None: the card)."""
    device = resolve_device(device)
    blocks = pad_message(message)
    R, digest_words, n = _trace_rows(blocks)
    phase1 = torch.from_numpy(R).to(device).to(torch.int64).T.contiguous()
    del R
    B = blocks.shape[0]

    def build_phase2(_trace, ch):
        acc = np.zeros(n, np.uint64)
        a = horner_prefix(bits_rlc(blocks, int(ch[0])), pow(int(ch[0]), RATE_BITS, MODULUS))
        acc[:ROUNDS * B] = np.repeat(a, ROUNDS)
        acc[ROUNDS * B:] = a[-1]
        return gf.from_u64(acc[None, :], device)

    return (phase1, fixed_columns(n, device), digest_words.astype(np.uint32), build_phase2,
            n.bit_length() - 1)


def message_rlc(message: bytes, gamma: int) -> int:
    """Verifier-side RLC over the padded message bit blocks."""
    blocks = pad_message(message)
    return int(horner_prefix(bits_rlc(blocks, gamma), pow(gamma, RATE_BITS, MODULUS))[-1])


def _publics(digest_words: np.ndarray, acc: int, device) -> torch.Tensor:
    return gf.from_u64(np.concatenate([np.asarray(digest_words, np.uint64), [np.uint64(acc)]]),
                       device)


def prove_keccak256(message: bytes, params: Optional[StarkParams] = None, device=None
                    ) -> Tuple[StarkProof, bytes, StarkParams]:
    """STARK-prove digest = keccak256(message) on `device` (None: the card);
    returns (proof, digest, params).  The digest and the message RLC are the
    proof's publics."""
    phase1, fixed, digest_words, build_phase2, log_n = build_keccak_trace(message, device)
    air = keccak_air()
    if params is None:
        params = StarkParams(log_n=log_n)
    cap_f = _commit_columns(fixed, params)["cap"]
    tree = _commit_columns(phase1, params)
    (gamma,), _ = challenges_from_cap(tree["cap"], air, cap_f)
    public = _publics(digest_words, message_rlc(message, gamma), phase1.device)
    proof = prove(phase1, air, params, public, build_phase2=build_phase2, fixed_cols=fixed,
                  phase1_tree=tree)
    digest = b"".join(int(w).to_bytes(4, "little") for w in digest_words)
    return proof, digest, params


def verify_keccak256(proof: StarkProof, message: bytes, digest: bytes,
                     params: StarkParams) -> bool:
    """Verifier: recompute the fixed columns (VK), re-derive gamma, rebuild
    the publics from the plaintext message + claimed digest, verify.  The
    proof's own `params` are trusted, as in the JAX package (ROADMAP Queue
    3)."""
    air = keccak_air()
    n = 1 << params.log_n
    if ROUNDS * pad_message(message).shape[0] > n:
        return False
    if len(proof.caps) != 3 or len(digest) != 32:
        return False
    dev = proof.q_cap.device
    fixed = fixed_columns(n, dev)
    (gamma,), _ = challenges_from_cap(proof.caps[1], air, proof.caps[0])
    words = np.frombuffer(digest, np.uint32).astype(np.uint64)
    public = _publics(words, message_rlc(message, gamma), dev)
    return verify(proof, air, params, public, fixed_cols=fixed)
