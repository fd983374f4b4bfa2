"""blake2s single-block batch AIR (the JAX package's `prover/blake2s_air.py`,
on torch tensors): one STARK of every blake2s digest the storage paths of
circuit type 10 consume (ref `src/storage_application/mod.rs:390-400`,
derived key mod.rs:433-439, leaf mod.rs:523-570).

Every blake2s call of storage application is single-block (node 64 B,
derived key 64 B, leaf 40 B), so the AIR proves a batch of independent
single-block compressions, 10 rows a call, one row a round:

  phase 1:
    pad first lst          row-type flags (first / lst live-bound to the
                           fixed schedule; pads copy the row)
    t8[8]                  message byte-count bits (t <= 64)
    v[16 x 32]             working-state bits at round input
    m[16 x 32]             message-block bits (held across the call)
    xv[16]                 the SIGMA-selected message values, bound to m
                           via the fixed one-hot selector columns
    A1 C1 A2 C2 D2 B2      [8 G-slots x 32] intermediate bits of each G
    ca1[16] cc1[8] ca2[16] cc2[8]   addition carries
    dg[8]                  digest words, bound on last-round rows to
                           IVP ^ v_out ^ v_out[8..]
  phase 2:
    acc                    record RLC: per call acc' = acc g^521 +
                           RLC_g([t] ++ mbits[512] ++ dg[8]); the verifier
                           recomputes it from the plaintext records

Publics: [final acc].  Fixed columns: f_r0 (round-0 flag), f_lst (round-9
flag), fsel[16x16] (per-row one-hot SIGMA message selectors).

The constraints are the JAX module's in the same order.  The trace is built
row-major as u32 on the host and widened on the device.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import gf
from ..ops.blake2s import IV, SIGMA
from ..ops.gf import MODULUS
from ..utils.device import resolve_device
from .air_common import bits_rlc, challenge, grp, horner_prefix, powers
from .stark import (AirSpec, StarkParams, StarkProof, _commit_columns, challenges_from_cap,
                    prove, verify)

ROUNDS = 10
WBITS = 32
_M32 = (1 << 32) - 1

# parameter-block-mixed initial state (digest_size=32, no key, fanout=1,
# depth=1): every storage_application call hashes < 2^32 bytes in one block
IVP = [IV[0] ^ 0x01010020] + list(IV[1:])

# record = [t] ++ m bits (512) ++ dg words (8)
RECORD_LEN = 1 + 16 * WBITS + 8
NUM_PUBLIC = 1


class _Cols:
    def __init__(self):
        i = 0
        self.pad = i; i += 1
        self.first = i; i += 1
        self.lst = i; i += 1
        self.t8 = slice(i, i + 8); i += 8
        self.v = slice(i, i + 16 * WBITS); i += 16 * WBITS
        self.m = slice(i, i + 16 * WBITS); i += 16 * WBITS
        self.xv = slice(i, i + 16); i += 16
        self.A1 = slice(i, i + 8 * WBITS); i += 8 * WBITS
        self.C1 = slice(i, i + 8 * WBITS); i += 8 * WBITS
        self.A2 = slice(i, i + 8 * WBITS); i += 8 * WBITS
        self.C2 = slice(i, i + 8 * WBITS); i += 8 * WBITS
        self.D2 = slice(i, i + 8 * WBITS); i += 8 * WBITS
        self.B2 = slice(i, i + 8 * WBITS); i += 8 * WBITS
        self.ca1 = slice(i, i + 16); i += 16
        self.cc1 = slice(i, i + 8); i += 8
        self.ca2 = slice(i, i + 16); i += 16
        self.cc2 = slice(i, i + 8); i += 8
        self.dg = slice(i, i + 8); i += 8
        self.num_phase1 = i
        self.acc = i
        # fixed
        self.f_r0 = 0
        self.f_lst = 1
        self.fsel = slice(2, 2 + 16 * 16)
        self.num_fixed = 2 + 16 * 16


@functools.lru_cache(maxsize=1)
def _cols() -> _Cols:
    return _Cols()


def fixed_columns(n: int, device=None) -> torch.Tensor:
    """The fixed columns on `device` (None: the card)."""
    c = _cols()
    out = np.zeros((c.num_fixed, n), np.uint64)
    r = np.arange(n) % ROUNDS
    out[c.f_r0] = (r == 0).astype(np.uint64)
    out[c.f_lst] = (r == ROUNDS - 1).astype(np.uint64)
    sig = np.asarray(SIGMA)  # (10, 16)
    out[c.fsel] = (sig[r][:, :, None] == np.arange(16)).reshape(n, 256).T
    return gf.from_u64(out, resolve_device(device))


_W32 = np.uint64(1) << np.arange(WBITS, dtype=np.uint64)


def _bit_rows(words) -> np.ndarray:
    """(k,) u32 words -> (k, 32) bits."""
    return (np.asarray(words, np.uint64)[:, None] >> np.arange(WBITS, dtype=np.uint64)) & 1


def _vinit_consts() -> Tuple[np.ndarray, np.ndarray]:
    vinit = IVP[:8] + [IV[0], IV[1], IV[2], IV[3], IV[4], IV[5], IV[6] ^ _M32, IV[7]]
    fix_mask = np.ones((16, WBITS), np.uint64)
    fix_mask[12, :8] = 0  # t-dependent bits, bound apart
    return _bit_rows(vinit), fix_mask


def _xor2(u, v):
    return gf.sub(gf.add(u, v), gf.double(gf.mul(u, v)))


def _ror(x, r: int):
    """bit i of ror(x, r) = x bit (i + r) % 32."""
    return torch.roll(x, -r, dims=-1)


@functools.lru_cache(maxsize=1)
def blake2s_air() -> AirSpec:
    c = _cols()
    F = c.num_fixed
    vinit_bits, fix_mask = _vinit_consts()
    iv4 = [(IV[4] >> k) & 1 for k in range(8)]
    ivp_bits = _bit_rows(IVP)

    def sl(row, s):
        return row[..., F + s.start:F + s.stop] if isinstance(s, slice) else row[..., F + s]

    def blk4(row, s, g0, perm=None):
        """(batch, 4, 32) view of G-slot blocks g0..g0+3 of column group s,
        re-ordered by `perm`."""
        v = row[..., F + s.start + g0 * WBITS:F + s.start + (g0 + 4) * WBITS]
        v = v.reshape(tuple(v.shape[:-1]) + (4, WBITS))
        return v if perm is None else v[..., list(perm), :]

    def words(row, s, k):
        return sl(row, s).reshape(tuple(row.shape[:-1]) + (k, WBITS))

    def val(bits):  # (..., 32) -> (...)
        return gf.sum_mod(gf.mul(bits, gf.from_u64(_W32, bits.device)))

    def vout(row):
        """The round's output state v2 as (batch, 16, 32): the diagonal
        step's blocks in word order."""
        return torch.cat([blk4(row, c.A2, 4), blk4(row, c.B2, 4, (3, 0, 1, 2)),
                          blk4(row, c.C2, 4, (2, 3, 0, 1)), blk4(row, c.D2, 4, (1, 2, 3, 0))],
                         dim=-2)

    def record_rlc(row, gamma):
        """RLC_gamma([t] ++ mbits ++ dg), affine in the trace cells."""
        gp = powers(gamma, RECORD_LEN, row.device)
        t_val = gf.dot_mod(sl(row, c.t8), gf.from_u64(_W32[:8], row.device))
        r = gf.mul(t_val, gp[0])
        r = gf.add(r, gf.dot_mod(sl(row, c.m), gp[1:1 + 16 * WBITS]))
        return gf.add(r, gf.dot_mod(sl(row, c.dg), gp[1 + 16 * WBITS:]))

    def row_constraints(cur, ch):
        dev = cur.device
        one = torch.ones_like(cur[..., 0])
        pad, first, lst = sl(cur, c.pad), sl(cur, c.first), sl(cur, c.lst)
        live = gf.sub(one, pad)
        out = []
        # booleanity: flags + every bit column (contiguous slices)
        for s0, s1 in ((c.pad, c.lst + 1), (c.t8.start, c.m.stop), (c.A1.start, c.B2.stop),
                       (c.ca1.start, c.cc2.stop)):
            b = cur[..., F + s0:F + s1]
            out.append(grp(gf.mul(b, gf.sub(b, torch.ones_like(b)))))
        # row-type bindings: first = live f_r0; lst live-bound only (pads
        # copy lst = 1 so the digest binding and last_row stay valid)
        out.append(gf.sub(first, gf.mul(live, cur[..., c.f_r0])))
        out.append(gf.mul(live, gf.sub(lst, cur[..., c.f_lst])))
        # xv binding: xv_s = sum_k fsel[s,k] val(m_k) (live rows)
        mvals = val(words(cur, c.m, 16))  # (batch, 16)
        fsel = cur[..., c.fsel].reshape(tuple(cur.shape[:-1]) + (16, 16))
        selv = gf.sum_mod(gf.mul(fsel, mvals.unsqueeze(-2)))
        out.append(grp(gf.mul(live.unsqueeze(-1), gf.sub(sl(cur, c.xv), selv))))
        # v-init binding on first rows; only word 12's low 8 bits depend on
        # the witness (t), bound next: v_bit = IV4_bit XOR t_bit
        vbits = words(cur, c.v, 16)
        d_const = gf.mul(gf.sub(vbits, gf.from_u64(vinit_bits, dev)), gf.from_u64(fix_mask, dev))
        out.append(grp(gf.mul(first[..., None, None], d_const), lanes=2))
        t8 = sl(cur, c.t8)
        want = torch.stack([gf.sub(torch.ones_like(t8[..., k]), t8[..., k]) if iv4[k]
                            else t8[..., k] for k in range(8)], dim=-1)
        out.append(grp(gf.mul(first.unsqueeze(-1), gf.sub(vbits[..., 12, :8], want))))
        # ---- the 8 G applications (row-local, fixed-free) ----
        A1, C1, A2 = words(cur, c.A1, 8), words(cur, c.C1, 8), words(cur, c.A2, 8)
        C2, D2, B2 = words(cur, c.C2, 8), words(cur, c.D2, 8), words(cur, c.B2, 8)
        ain = torch.cat([blk4(cur, c.v, 0), blk4(cur, c.A2, 0)], dim=-2)
        bin_ = torch.cat([blk4(cur, c.v, 4), blk4(cur, c.B2, 0, (1, 2, 3, 0))], dim=-2)
        cin = torch.cat([blk4(cur, c.v, 8), blk4(cur, c.C2, 0, (2, 3, 0, 1))], dim=-2)
        din = torch.cat([blk4(cur, c.v, 12), blk4(cur, c.D2, 0, (3, 0, 1, 2))], dim=-2)
        xv = sl(cur, c.xv)
        x, y = xv[..., 0::2], xv[..., 1::2]
        ca1 = sl(cur, c.ca1)
        ca1v = gf.add(ca1[..., 0::2], gf.double(ca1[..., 1::2]))
        ca2 = sl(cur, c.ca2)
        ca2v = gf.add(ca2[..., 0::2], gf.double(ca2[..., 1::2]))
        P32 = 1 << 32
        # a1 = a + b + x (mod 2^32, carry <= 2)
        out.append(grp(gf.sub(gf.add(val(A1), gf.mul_const(ca1v, P32)),
                              gf.add(gf.add(val(ain), val(bin_)), x))))
        # c1 = c + d1, d1 = ror16(d ^ a1)
        d1 = _xor2(_ror(din, 16), _ror(A1, 16))
        out.append(grp(gf.sub(gf.add(val(C1), gf.mul_const(sl(cur, c.cc1), P32)),
                              gf.add(val(cin), val(d1)))))
        # a2 = a1 + b1 + y, b1 = ror12(b ^ c1)
        b1 = _xor2(_ror(bin_, 12), _ror(C1, 12))
        out.append(grp(gf.sub(gf.add(val(A2), gf.mul_const(ca2v, P32)),
                              gf.add(gf.add(val(A1), val(b1)), y))))
        # d2 = ror8(d1 ^ a2), d1 rotated once more (degree 3)
        d1s = _xor2(_ror(din, 24), _ror(A1, 24))
        out.append(grp(gf.sub(D2, _xor2(d1s, _ror(A2, 8))), lanes=2))
        # c2 = c1 + d2
        out.append(grp(gf.sub(gf.add(val(C2), gf.mul_const(sl(cur, c.cc2), P32)),
                              gf.add(val(C1), val(D2)))))
        # b2 = ror7(b1 ^ c2)
        b1s = _xor2(_ror(bin_, 19), _ror(C1, 19))
        out.append(grp(gf.sub(B2, _xor2(b1s, _ror(C2, 7))), lanes=2))
        # ---- digest binding on last-round rows ----
        # dg_j = sum_i 2^i (IVP_j[i] ^ v2[j][i] ^ v2[j+8][i]); c ^ e = c + (1-2c) e
        v2 = vout(cur)
        x2 = _xor2(v2[..., :8, :], v2[..., 8:, :])
        cb = gf.from_u64(ivp_bits, dev)
        mixed = gf.add(cb, gf.mul(gf.sub(torch.ones_like(cb), gf.double(cb)), x2))
        out.append(grp(gf.mul(lst.unsqueeze(-1), gf.sub(sl(cur, c.dg), val(mixed)))))
        return out

    def constraints(cur, nxt, ch):
        one = torch.ones_like(cur[..., 0])
        pad_c, pad_n = sl(cur, c.pad), sl(nxt, c.pad)
        first_n = sl(nxt, c.first)
        # pads are monotone and may only start at a block boundary
        out = [gf.mul(pad_c, gf.sub(one, pad_n)),
               gf.mul(gf.sub(pad_n, pad_c), gf.sub(one, nxt[..., c.f_r0]))]
        # pad rows copy the row (everything from lst on)
        span = slice(F + c.lst, F + c.num_phase1)
        out.append(grp(gf.mul(pad_n.unsqueeze(-1), gf.sub(nxt[..., span], cur[..., span]))))
        # within-block transitions (next is live and not a block start)
        cn = gf.mul(gf.sub(one, pad_n), gf.sub(one, first_n)).unsqueeze(-1)
        v2 = vout(cur).reshape(tuple(cur.shape[:-1]) + (16 * WBITS,))
        out.append(grp(gf.mul(cn, gf.sub(sl(nxt, c.v), v2))))
        for hs in (c.t8, c.m):
            out.append(grp(gf.mul(cn, gf.sub(sl(nxt, hs), sl(cur, hs)))))
        # record absorption at block starts; copy elsewhere
        gamma = challenge(ch, 0)
        acc_c, acc_n = cur[..., F + c.acc], nxt[..., F + c.acc]
        G = pow(gamma, RECORD_LEN, MODULUS)
        pushed = gf.add(gf.mul_const(acc_c, G), record_rlc(cur, gamma))
        out.append(gf.mul(first_n, gf.sub(acc_n, pushed)))
        out.append(gf.mul(gf.sub(one, first_n), gf.sub(acc_n, acc_c)))
        return out

    def first_row(row, public, ch):
        return [sl(row, c.pad), row[..., F + c.acc]]

    def last_row(row, public, ch):
        gamma = challenge(ch, 0)
        final = gf.add(gf.mul_const(row[..., F + c.acc], pow(gamma, RECORD_LEN, MODULUS)),
                       record_rlc(row, gamma))
        return [gf.sub(final, public[0])]

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
# trace builder (vectorized over the batch of calls)
# ---------------------------------------------------------------------------


def _pad_message(message: bytes) -> np.ndarray:
    assert len(message) <= 64, "single-block AIR: message must be <= 64 bytes"
    data = message + b"\x00" * (64 - len(message))
    return np.frombuffer(data, "<u4").astype(np.uint64)


def _ror_np(x: np.ndarray, r: int) -> np.ndarray:
    x = x & _M32
    return ((x >> np.uint64(r)) | (x << np.uint64(32 - r))) & _M32


def _bits_of(vals: np.ndarray) -> np.ndarray:
    """(B, k) u32 -> (B, k * 32) bits, word-major, LSB first."""
    b = (vals[..., None] >> np.arange(WBITS, dtype=np.uint64)) & np.uint64(1)
    return b.reshape(vals.shape[0], -1)


def _records(t: np.ndarray, m_words: np.ndarray, dg: np.ndarray) -> np.ndarray:
    """(B, RECORD_LEN) record vectors [t, m bits, dg words]."""
    return np.concatenate([t[:, None], _bits_of(m_words), dg], axis=1)


def _trace_rows(messages: Sequence[bytes]):
    """(n, num_phase1) u32 rows, the (t, m, dg) of every call, n."""
    c = _cols()
    B = len(messages)
    assert B >= 1
    t = np.array([len(m) for m in messages], np.uint64)
    m_words = np.stack([_pad_message(m) for m in messages])  # (B, 16)
    live = ROUNDS * B
    n = 1 << max(6, (live - 1).bit_length())
    R = np.zeros((n, c.num_phase1), np.uint32)
    rows = np.arange(B) * ROUNDS

    v = np.zeros((B, 16), np.uint64)
    v[:, :8] = IVP
    v[:, 8:12] = np.asarray(IV[:4], np.uint64)
    v[:, 12] = np.uint64(IV[4]) ^ t
    v[:, 13] = IV[5]
    v[:, 14] = np.uint64(IV[6]) ^ np.uint64(_M32)
    v[:, 15] = IV[7]
    m_bits = _bits_of(m_words)
    t_bits = (t[:, None] >> np.arange(8, dtype=np.uint64)) & 1
    sig = np.asarray(SIGMA)
    for r in range(ROUNDS):
        rws = rows + r
        R[rws, c.v] = _bits_of(v)
        R[rws, c.m] = m_bits
        R[rws, c.t8] = t_bits
        R[rws, c.xv] = m_words[:, sig[r]]
        out = {k: np.zeros((B, 8), np.uint64) for k in ("A1", "C1", "A2", "C2", "D2", "B2",
                                                          "CA1", "CC1", "CA2", "CC2")}

        def run_g(slot, a, b_, cc, d, x, y):
            a1f = a + b_ + x
            a1 = a1f & _M32
            d1 = _ror_np(d ^ a1, 16)
            c1f = cc + d1
            c1 = c1f & _M32
            b1 = _ror_np(b_ ^ c1, 12)
            a2f = a1 + b1 + y
            a2 = a2f & _M32
            d2 = _ror_np(d1 ^ a2, 8)
            c2f = c1 + d2
            c2 = c2f & _M32
            b2 = _ror_np(b1 ^ c2, 7)
            for k, val in (("A1", a1), ("C1", c1), ("A2", a2), ("C2", c2), ("D2", d2),
                           ("B2", b2), ("CA1", a1f >> 32), ("CC1", c1f >> 32),
                           ("CA2", a2f >> 32), ("CC2", c2f >> 32)):
                out[k][:, slot] = val

        for g in range(4):
            run_g(g, v[:, g], v[:, 4 + g], v[:, 8 + g], v[:, 12 + g],
                  m_words[:, sig[r, 2 * g]], m_words[:, sig[r, 2 * g + 1]])
        for gg in range(4):
            run_g(4 + gg, out["A2"][:, gg], out["B2"][:, (gg + 1) % 4],
                  out["C2"][:, (gg + 2) % 4], out["D2"][:, (gg + 3) % 4],
                  m_words[:, sig[r, 8 + 2 * gg]], m_words[:, sig[r, 9 + 2 * gg]])
        for k in ("A1", "C1", "A2", "C2", "D2", "B2"):
            R[rws, getattr(c, k)] = _bits_of(out[k])
        for k, ks in (("CA1", c.ca1), ("CA2", c.ca2)):
            R[rws, ks.start:ks.stop:2] = out[k] & 1
            R[rws, ks.start + 1:ks.stop:2] = out[k] >> 1
        R[rws, c.cc1] = out["CC1"]
        R[rws, c.cc2] = out["CC2"]
        # next-round state
        v = np.concatenate([out["A2"][:, 4:], out["B2"][:, [7, 4, 5, 6]],
                            out["C2"][:, [6, 7, 4, 5]], out["D2"][:, [5, 6, 7, 4]]], axis=1)

    dg = np.asarray(IVP, np.uint64)[None, :] ^ v[:, :8] ^ v[:, 8:]
    lst_rows = rows + ROUNDS - 1
    R[lst_rows, c.dg] = dg
    R[rows, c.first] = 1
    R[lst_rows, c.lst] = 1
    # pad tail: copy the final live row
    if live < n:
        R[live:] = R[live - 1]
        R[live:, c.pad] = 1
        R[live:, c.first] = 0
    return R, t, m_words, dg, n


def build_blake2s_trace(messages: Sequence[bytes], device=None):
    """(phase1, fixed, digests list[bytes], build_phase2, log_n), the
    columns on `device` (None: the card)."""
    device = resolve_device(device)
    R, t, m_words, dg, n = _trace_rows(messages)
    phase1 = (torch.from_numpy(R.view(np.int32)).to(device).to(torch.int64) & _M32).T.contiguous()
    del R
    B = len(messages)
    live = ROUNDS * B
    digests = [dg[i].astype("<u4").tobytes() for i in range(B)]
    records = _records(t, m_words, dg)

    def build_phase2(_trace, ch):
        gamma = int(ch[0])
        after = horner_prefix(bits_rlc(records, gamma), pow(gamma, RECORD_LEN, MODULUS))
        before = np.concatenate([np.zeros(1, np.uint64), after[:-1]])
        acc_col = np.zeros(n, np.uint64)
        acc_col[:live] = np.repeat(before, ROUNDS)
        # pads copy the in-row acc of the final live row
        acc_col[live:] = before[-1]
        return gf.from_u64(acc_col[None, :], device)

    return phase1, fixed_columns(n, device), digests, build_phase2, n.bit_length() - 1


def batch_rlc(records: Sequence[Tuple[int, np.ndarray, np.ndarray]], gamma: int) -> int:
    """records: [(t, m_words (16,), dg_words (8,)), ...] (plaintext)."""
    if not records:
        return 0
    t = np.array([int(r[0]) for r in records], np.uint64)
    m = np.stack([np.asarray(r[1], np.uint64) for r in records])
    dg = np.stack([np.asarray(r[2], np.uint64) for r in records])
    return int(horner_prefix(bits_rlc(_records(t, m, dg), gamma),
                             pow(gamma, RECORD_LEN, MODULUS))[-1])


def records_from_calls(messages: Sequence[bytes], digests: Sequence[bytes]) -> List[Tuple]:
    out = []
    for msg, d in zip(messages, digests):
        out.append((len(msg), _pad_message(msg), np.frombuffer(d, "<u4").astype(np.uint64)))
    return out


# ---------------------------------------------------------------------------
# prove / verify
# ---------------------------------------------------------------------------


def prove_blake2s_batch(messages: Sequence[bytes], params: Optional[StarkParams] = None,
                        device=None) -> Tuple[StarkProof, List[bytes], StarkParams]:
    """One STARK proving digest_i = blake2s(messages_i) for the whole batch,
    on `device` (None: the card).  Returns (proof, digests, params)."""
    phase1, fixed, digests, build_phase2, log_n = build_blake2s_trace(messages, device)
    air = blake2s_air()
    if params is None:
        params = StarkParams(log_n=log_n)
    cap_f = _commit_columns(fixed, params)["cap"]
    tree = _commit_columns(phase1, params)
    (gamma,), _ = challenges_from_cap(tree["cap"], air, cap_f)
    acc = batch_rlc(records_from_calls(messages, digests), gamma)
    public = gf.from_u64(np.array([acc], np.uint64), phase1.device)
    proof = prove(phase1, air, params, public, build_phase2=build_phase2, fixed_cols=fixed,
                  phase1_tree=tree)
    return proof, digests, params


def verify_blake2s_batch(proof: StarkProof, messages: Sequence[bytes],
                         digests: Sequence[bytes], params: StarkParams) -> bool:
    """messages / digests: the plaintext call list (public data: the path
    structure consuming these digests is checked by the evaluator and the
    compact form).  The proof's own `params` are trusted, as in the JAX
    package (ROADMAP Queue 3)."""
    air = blake2s_air()
    n = 1 << params.log_n
    if len(messages) != len(digests) or not messages:
        return False
    if ROUNDS * len(messages) > n:
        return False
    if any(len(m) > 64 for m in messages):
        return False
    if any(len(d) != 32 for d in digests):
        return False
    dev = proof.q_cap.device
    fixed = fixed_columns(n, dev)
    cap_f = _commit_columns(fixed, params)["cap"]
    if len(proof.caps) != 3:
        return False
    (gamma,), _ = challenges_from_cap(proof.caps[1], air, cap_f)
    acc = batch_rlc(records_from_calls(messages, digests), gamma)
    public = gf.from_u64(np.array([acc], np.uint64), dev)
    return verify(proof, air, params, public, fixed_cols=fixed)
