"""sha256 compression-chain AIR (the JAX package's `prover/sha256_air.py`, on
torch tensors): STARK proofs of sha256 digests for the sha256 precompile
(type 6, ref `src/sha256_round_function/mod.rs:271`) and the code
unpacker's code hashes (type 3, `src/code_unpacker_sha256/mod.rs:364-414`).

One row per ROUND (64 rows per 512-bit block), bit-column state with a
future message-schedule window (every reference is row-local or
cur->next):

  pad | ab | cont | lst | kc |
  a..h bits [8 x 32]        working state at round input
  W[16 x 32] bits           w_t .. w_{t+15} (at a block start the window IS
                            the message block: the RLC binds it)
  s1v chv s0v mjv sg0 sg1   committed u32 values of Sigma1(e), Ch(e,f,g),
                            Sigma0(a), Maj(a,b,c), sigma0(W[1]),
                            sigma1(W[14]), each bound to its bit expression
  ce[3] ca[3] sc[2]         round / schedule addition carries
  ia..ih [8]                the block's initial state values (feed-forward)
  dg[8] + dgc[12]           digest words of this block and their carries

  transitions: the state and window shifts, the two round additions, the
  schedule, the ia hold; at a block start the feed-forward and the message
  RLC acc' = acc g^512 + sum_i g^i W'bits[i]; pads copy the row.

Publics: [digest as 8 u32 big-endian words, message-RLC acc]; the verifier
recomputes the RLC from the plaintext padded message.  Fixed columns: kf
(round constant K_t), ir0f (block-start flag), lstf (last-round flag).

The constraints are the JAX module's in the same order; the trace builder
runs the rounds on python ints and expands every bit column at once.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import gf
from ..ops.gf import MODULUS
from ..ops.sha256 import H0, K
from ..utils.device import resolve_device
from .air_common import bits_rlc, challenge, grp, horner_prefix, powers
from .stark import (AirSpec, StarkParams, StarkProof, _commit_columns, challenges_from_cap,
                    prove, verify)

ROUNDS = 64
WBITS = 32
BLOCK_BITS = 16 * WBITS  # 512


class _Cols:
    def __init__(self):
        i = 0
        self.pad = i; i += 1
        self.ab = i; i += 1
        self.cont = i; i += 1
        self.lst = i; i += 1
        self.kc = i; i += 1
        self.st = {}
        for nm in "abcdefgh":
            self.st[nm] = slice(i, i + WBITS); i += WBITS
        self.W = slice(i, i + 16 * WBITS); i += 16 * WBITS
        self.s1v = i; i += 1
        self.chv = i; i += 1
        self.s0v = i; i += 1
        self.mjv = i; i += 1
        self.sg0 = i; i += 1
        self.sg1 = i; i += 1
        self.ce = slice(i, i + 3); i += 3
        self.ca = slice(i, i + 3); i += 3
        self.sc = slice(i, i + 2); i += 2
        self.ia = slice(i, i + 8); i += 8
        self.dg = slice(i, i + 8); i += 8
        # dgc: 3 bits for a, 3 for e, 1 each for b,c,d,f,g,h
        self.dgc = slice(i, i + 12); i += 12
        self.num_phase1 = i
        self.acc = i
        self.f_kf = 0
        self.f_ir0 = 1
        self.f_lst = 2
        self.num_fixed = 3


@functools.lru_cache(maxsize=1)
def _cols() -> _Cols:
    return _Cols()


NUM_PUBLIC = 9
_M32 = (1 << 32) - 1
_W32 = np.uint64(1) << np.arange(WBITS, dtype=np.uint64)


def fixed_columns(n: int, device=None) -> torch.Tensor:
    """The fixed columns on `device` (None: the card)."""
    c = _cols()
    out = np.zeros((c.num_fixed, n), np.uint64)
    r = np.arange(n) % ROUNDS
    out[c.f_kf] = np.asarray(K, np.uint64)[r]
    out[c.f_ir0] = (r == 0).astype(np.uint64)
    out[c.f_lst] = (r == ROUNDS - 1).astype(np.uint64)
    return gf.from_u64(out, resolve_device(device))


def _rot_ix(r: int) -> np.ndarray:
    """bit i of ROTR(x, r) = x bit (i + r) % 32."""
    return (np.arange(WBITS) + r) % WBITS


def _xor3(u, v, w):
    uv, uw, vw = gf.mul(u, v), gf.mul(u, w), gf.mul(v, w)
    x = gf.sub(gf.add(gf.add(u, v), w), gf.double(gf.add(gf.add(uv, uw), vw)))
    return gf.add(x, gf.mul_const(gf.mul(uv, w), 4))


def _span(s: slice, F: int) -> slice:
    return slice(F + s.start, F + s.stop)


@functools.lru_cache(maxsize=1)
def sha256_air() -> AirSpec:
    c = _cols()
    F = c.num_fixed
    st_ix = np.concatenate([np.arange(c.st[nm].start, c.st[nm].stop) for nm in "abcdefgh"])
    bit_ix = np.concatenate([st_ix, np.arange(c.W.start, c.W.stop),
                             np.arange(c.ce.start, c.ce.stop), np.arange(c.ca.start, c.ca.stop),
                             np.arange(c.sc.start, c.sc.stop), np.arange(c.dgc.start, c.dgc.stop)])
    shift_dst = np.concatenate([np.arange(c.st[d].start, c.st[d].stop) for d in "bcdfgh"])
    shift_src = np.concatenate([np.arange(c.st[s].start, c.st[s].stop) for s in "abcefg"])
    shr_mask = {r: (np.arange(WBITS) < WBITS - r).astype(np.uint64) for r in (3, 10)}

    def sl(row, s):
        return row[..., _span(s, F)] if isinstance(s, slice) else row[..., F + s]

    def val(bits):  # (..., 32) -> (...)
        return gf.sum_mod(gf.mul(bits, gf.from_u64(_W32, bits.device)))

    def states(row):  # (batch, 8, 32) a..h bits
        return row[..., F + st_ix].reshape(tuple(row.shape[:-1]) + (8, WBITS))

    def window(row):  # (batch, 16, 32)
        return sl(row, c.W).reshape(tuple(row.shape[:-1]) + (16, WBITS))

    def carry3(v):
        return gf.add(gf.add(v[..., 0], gf.double(v[..., 1])), gf.mul_const(v[..., 2], 4))

    def t1_expr(cur, st_vals):
        return gf.add(gf.add(st_vals[..., 7], sl(cur, c.s1v)),
                      gf.add(gf.add(sl(cur, c.chv), sl(cur, c.kc)), val(window(cur)[..., 0, :])))

    def shr_bits(x, r):
        # bit i of SHR(x, r) = x bit (i + r) if i < 32 - r else 0
        return gf.mul(x[..., _rot_ix(r)], gf.from_u64(shr_mask[r], x.device))

    def row_constraints(cur, ch):
        one = torch.ones_like(cur[..., 0])
        pad, ab, cont, lst = (sl(cur, s) for s in (c.pad, c.ab, c.cont, c.lst))
        live = gf.sub(one, pad)
        ir0 = cur[..., c.f_ir0]
        # booleanity: flags + all bit columns + carries
        out = [gf.mul(v, gf.sub(v, one)) for v in (pad, ab, cont, lst)]
        b = cur[..., F + bit_ix]
        out.append(grp(gf.mul(b, gf.sub(b, torch.ones_like(b)))))
        # row-type bindings to the fixed schedule
        out.append(gf.sub(ab, gf.mul(live, ir0)))
        out.append(gf.sub(cont, gf.mul(live, gf.sub(one, ir0))))
        out.append(gf.mul(live, gf.sub(lst, cur[..., c.f_lst])))
        out.append(gf.mul(live, gf.sub(sl(cur, c.kc), cur[..., c.f_kf])))
        # committed round-function values
        S = states(cur)
        a, bb_, cc_, e, f_, g = (S[..., j, :] for j in (0, 1, 2, 4, 5, 6))
        out.append(gf.sub(sl(cur, c.s1v),
                          val(_xor3(e[..., _rot_ix(6)], e[..., _rot_ix(11)], e[..., _rot_ix(25)]))))
        out.append(gf.sub(sl(cur, c.chv),
                          val(gf.add(gf.mul(e, f_), gf.mul(gf.sub(torch.ones_like(e), e), g)))))
        out.append(gf.sub(sl(cur, c.s0v),
                          val(_xor3(a[..., _rot_ix(2)], a[..., _rot_ix(13)], a[..., _rot_ix(22)]))))
        ab_, ac_, bc_ = gf.mul(a, bb_), gf.mul(a, cc_), gf.mul(bb_, cc_)
        mj = gf.sub(gf.add(gf.add(ab_, ac_), bc_), gf.double(gf.mul(ab_, cc_)))
        out.append(gf.sub(sl(cur, c.mjv), val(mj)))
        # sigma0(W[1]) = ROTR7 ^ ROTR18 ^ SHR3; sigma1(W[14]) = R17^R19^SHR10
        Wc = window(cur)
        w1, w14 = Wc[..., 1, :], Wc[..., 14, :]
        out.append(gf.sub(sl(cur, c.sg0),
                          val(_xor3(w1[..., _rot_ix(7)], w1[..., _rot_ix(18)], shr_bits(w1, 3)))))
        out.append(gf.sub(sl(cur, c.sg1),
                          val(_xor3(w14[..., _rot_ix(17)], w14[..., _rot_ix(19)],
                                    shr_bits(w14, 10)))))
        # ia binding at block-start rows
        ia = sl(cur, c.ia)
        st_vals = val(S)  # (batch, 8)
        out.append(gf.mul(ab, grp(gf.sub(ia, st_vals))))
        # digest words on last-round rows: dg_x = x_64 + i_x mod 2^32 (the
        # a / e carries absorb the round carry too)
        dgc = sl(cur, c.dgc)
        T1 = t1_expr(cur, st_vals)
        T2 = gf.add(sl(cur, c.s0v), sl(cur, c.mjv))
        x64 = torch.stack([gf.add(T1, T2), st_vals[..., 0], st_vals[..., 1], st_vals[..., 2],
                           gf.add(st_vals[..., 3], T1), st_vals[..., 4], st_vals[..., 5],
                           st_vals[..., 6]], dim=-1)
        carry = torch.stack([carry3(dgc[..., 0:3]), dgc[..., 6], dgc[..., 7], dgc[..., 8],
                             carry3(dgc[..., 3:6]), dgc[..., 9], dgc[..., 10], dgc[..., 11]],
                            dim=-1)
        d = gf.sub(gf.add(sl(cur, c.dg), gf.mul_const(carry, 1 << 32)), gf.add(x64, ia))
        out.append(gf.mul(lst, grp(d)))
        return out

    def constraints(cur, nxt, ch):
        one = torch.ones_like(cur[..., 0])
        pad_c, pad_n = sl(cur, c.pad), sl(nxt, c.pad)
        ab_n, cont_n = sl(nxt, c.ab), sl(nxt, c.cont)
        out = [gf.mul(pad_c, gf.sub(one, pad_n)),
               gf.mul(gf.sub(pad_n, pad_c), gf.sub(one, nxt[..., c.f_ir0]))]
        copy = slice(F + c.lst, F + c.num_phase1)
        out.append(gf.mul(pad_n, grp(gf.sub(nxt[..., copy], cur[..., copy]))))
        # state shifts on cont' rows (b<-a, c<-b, d<-c, f<-e, g<-f, h<-g)
        out.append(gf.mul(cont_n, grp(gf.sub(nxt[..., F + shift_dst], cur[..., F + shift_src]))))
        # round additions
        st_c = val(states(cur))
        T1 = t1_expr(cur, st_c)
        T2 = gf.add(sl(cur, c.s0v), sl(cur, c.mjv))
        st_n = val(states(nxt))
        out.append(gf.mul(cont_n, gf.sub(
            gf.add(st_n[..., 4], gf.mul_const(carry3(sl(cur, c.ce)), 1 << 32)),
            gf.add(st_c[..., 3], T1))))
        out.append(gf.mul(cont_n, gf.sub(
            gf.add(st_n[..., 0], gf.mul_const(carry3(sl(cur, c.ca)), 1 << 32)),
            gf.add(T1, T2))))
        # window shift + schedule
        Wc, Wn = window(cur), window(nxt)
        shift_d = gf.sub(Wn[..., :15, :], Wc[..., 1:, :])
        out.append(gf.mul(cont_n, grp(shift_d, lanes=2)))
        sc = sl(cur, c.sc)
        sc_v = gf.add(sc[..., 0], gf.double(sc[..., 1]))
        out.append(gf.mul(cont_n, gf.sub(
            gf.add(val(Wn[..., 15, :]), gf.mul_const(sc_v, 1 << 32)),
            gf.add(gf.add(sl(cur, c.sg1), val(Wc[..., 9, :])),
                   gf.add(sl(cur, c.sg0), val(Wc[..., 0, :]))))))
        # ia hold within a block
        out.append(gf.mul(cont_n, grp(gf.sub(sl(nxt, c.ia), sl(cur, c.ia)))))
        # feed-forward into the next block
        out.append(gf.mul(ab_n, grp(gf.sub(st_n, sl(cur, c.dg)))))
        # message RLC over the next block's window bits
        gamma = challenge(ch, 0)
        acc_c, acc_n = cur[..., F + c.acc], nxt[..., F + c.acc]
        rlc = gf.dot_mod(sl(nxt, c.W), powers(gamma, BLOCK_BITS, cur.device))
        G = pow(gamma, BLOCK_BITS, MODULUS)
        out.append(gf.mul(ab_n, gf.sub(acc_n, gf.add(gf.mul_const(acc_c, G), rlc))))
        out.append(gf.mul(gf.sub(one, ab_n), gf.sub(acc_n, acc_c)))
        return out

    def first_row(row, public, ch):
        h0 = gf.from_u64(np.asarray(H0, np.uint64), row.device)
        gamma = challenge(ch, 0)
        return [sl(row, c.pad), grp(gf.sub(val(states(row)), h0)),
                gf.sub(row[..., F + c.acc],
                       gf.dot_mod(sl(row, c.W), powers(gamma, BLOCK_BITS, row.device)))]

    def last_row(row, public, ch):
        return [grp(gf.sub(sl(row, c.dg), public[:8])), gf.sub(row[..., F + c.acc], public[8])]

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
# trace builder
# ---------------------------------------------------------------------------


def pad_message(message: bytes) -> np.ndarray:
    """sha256 padding -> (B, 16) u32 big-endian words."""
    bitlen = 8 * len(message)
    padded = bytearray(message) + b"\x80"
    padded += b"\x00" * ((56 - len(padded)) % 64)
    padded += bitlen.to_bytes(8, "big")
    return np.frombuffer(bytes(padded), ">u4").astype(np.uint64).reshape(-1, 16)


def _rotr(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & _M32


def _bits(vals: np.ndarray) -> np.ndarray:
    """(..., k) u32 values -> (..., k * 32) bits, LSB first."""
    v = np.asarray(vals, np.uint64)
    b = (v[..., None] >> np.arange(WBITS, dtype=np.uint64)) & np.uint64(1)
    return b.reshape(v.shape[:-1] + (v.shape[-1] * WBITS,))


def _schedule(block) -> list:
    """w_0 .. w_79: the schedule extended far enough for the future window."""
    w = [int(x) for x in block]
    for t in range(16, ROUNDS + 16):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    return w


def _round_values(blocks: np.ndarray):
    """Every round's python-int values: state (rows, 8), schedule windows
    (rows, 16), the six committed values (rows, 6), the three carries
    (rows, 3), the initial state (rows, 8), and per block its digest words
    with their carries; and the final chain state."""
    B = blocks.shape[0]
    rows = ROUNDS * B
    state_v = np.zeros((rows, 8), np.uint64)
    win = np.zeros((rows, 16), np.uint64)
    vals6 = np.zeros((rows, 6), np.uint64)
    carries = np.zeros((rows, 3), np.uint64)
    ia_v = np.zeros((rows, 8), np.uint64)
    dg = np.zeros((B, 8), np.uint64)
    dgc = np.zeros((B, 12), np.uint64)
    state = list(H0)
    for b in range(B):
        w = _schedule(blocks[b])
        w_np = np.asarray(w, np.uint64)
        r0 = ROUNDS * b
        win[r0:r0 + ROUNDS] = w_np[np.arange(ROUNDS)[:, None] + np.arange(16)[None, :]]
        a, bb_, cc_, d, e, f, g, h = state
        ia = list(state)
        ia_v[r0:r0 + ROUNDS] = ia
        for t in range(ROUNDS):
            row = r0 + t
            state_v[row] = (a, bb_, cc_, d, e, f, g, h)
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g & _M32)
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            mj = (a & bb_) ^ (a & cc_) ^ (bb_ & cc_)
            w1, w14 = w[t + 1], w[t + 14]
            sg0 = _rotr(w1, 7) ^ _rotr(w1, 18) ^ (w1 >> 3)
            sg1 = _rotr(w14, 17) ^ _rotr(w14, 19) ^ (w14 >> 10)
            vals6[row] = (s1, ch, s0, mj, sg0, sg1)
            T1 = h + s1 + ch + K[t] + w[t]
            new_e_full = d + T1
            new_a_full = T1 + s0 + mj
            # w[t] + sigma0(w[t+1]) + w[t+9] + sigma1(w[t+14]) = w[t+16]
            carries[row] = (new_e_full >> 32, new_a_full >> 32,
                            (w[t] + sg0 + w[t + 9] + sg1) >> 32)
            if t == ROUNDS - 1:
                # dg_x = x_64 + i_x; the AIR's dg constraints use the
                # un-reduced new_a / new_e, so their carries take 3 bits
                fin = [new_a_full, a, bb_, cc_, new_e_full, e, f, g]
                sums = [x + y for x, y in zip(fin, ia)]
                dg[b] = [s & _M32 for s in sums]
                ca, ce = sums[0] >> 32, sums[4] >> 32
                dgc[b] = ([(ca >> k) & 1 for k in range(3)] + [(ce >> k) & 1 for k in range(3)]
                          + [sums[j] >> 32 for j in (1, 2, 3, 5, 6, 7)])
            h, g, f = g, f, e
            e = new_e_full & _M32
            d, cc_, bb_ = cc_, bb_, a
            a = new_a_full & _M32
        state = [(x + y) & _M32 for x, y in zip((a, bb_, cc_, d, e, f, g, h), ia)]
    return state_v, win, vals6, carries, ia_v, dg, dgc, state


def _trace_rows(blocks: np.ndarray):
    """(n, num_phase1) u64 rows, digest words, n."""
    c = _cols()
    B = blocks.shape[0]
    live = ROUNDS * B
    n = 1 << max(6, (live - 1).bit_length())  # live == n is fine (no pads)
    state_v, win, vals6, carries, ia_v, dg, dgc, state = _round_values(blocks)
    R = np.zeros((n, c.num_phase1), np.uint64)
    t = np.arange(live) % ROUNDS
    R[:live, c.ab] = t == 0
    R[:live, c.cont] = t != 0
    R[:live, c.lst] = t == ROUNDS - 1
    R[:live, c.kc] = np.asarray(K, np.uint64)[t]
    R[:live, c.st["a"].start:c.st["h"].stop] = _bits(state_v)
    R[:live, c.W] = _bits(win)
    R[:live, c.s1v:c.sg1 + 1] = vals6
    cbits = (carries[:, :, None] >> np.arange(3, dtype=np.uint64)) & np.uint64(1)
    R[:live, c.ce] = cbits[:, 0]
    R[:live, c.ca] = cbits[:, 1]
    R[:live, c.sc] = cbits[:, 2, :2]
    R[:live, c.ia] = ia_v
    last = np.arange(B) * ROUNDS + ROUNDS - 1
    R[last, c.dg] = dg
    R[last, c.dgc] = dgc
    # padding rows replicate the last live row
    R[live:, c.lst:] = R[live - 1, c.lst:]
    R[live:, c.pad] = 1
    return R, np.asarray(state, np.uint64), n


def build_sha256_trace(message: bytes, device=None):
    """(phase1, fixed, digest_words(8,) u32 BE, build_phase2, log_n)."""
    return build_sha256_trace_blocks(pad_message(message), device)


def build_sha256_trace_blocks(blocks: np.ndarray, device=None):
    """Raw caller-padded block chain (the sha256_round_function precompile
    and code_unpacker forms, ref sha256_round_function/mod.rs:86): blocks
    (B, 16) u32 BE words, digest = the final chain state.  The columns go to
    `device` (None: the card)."""
    device = resolve_device(device)
    blocks = np.asarray(blocks, np.uint64)
    B = blocks.shape[0]
    R, digest_words, n = _trace_rows(blocks)
    phase1 = gf.from_u64(R, device).T.contiguous()

    def build_phase2(_trace, ch):
        acc = np.zeros(n, np.uint64)
        a = horner_prefix(bits_rlc(_bits(blocks), int(ch[0])),
                          pow(int(ch[0]), BLOCK_BITS, MODULUS))
        acc[:ROUNDS * B] = np.repeat(a, ROUNDS)
        acc[ROUNDS * B:] = a[-1]
        return gf.from_u64(acc[None, :], device)

    return (phase1, fixed_columns(n, device), digest_words.astype(np.uint32), build_phase2,
            n.bit_length() - 1)


def message_rlc(message: bytes, gamma: int) -> int:
    return blocks_rlc(pad_message(message), gamma)


def blocks_rlc(blocks: np.ndarray, gamma: int) -> int:
    blocks = np.asarray(blocks, np.uint64)
    if blocks.shape[0] == 0:
        return 0
    return int(horner_prefix(bits_rlc(_bits(blocks), gamma),
                             pow(gamma, BLOCK_BITS, MODULUS))[-1])


def _publics(digest_words: np.ndarray, acc: int, device) -> torch.Tensor:
    return gf.from_u64(np.concatenate([np.asarray(digest_words, np.uint64), [np.uint64(acc)]]),
                       device)


def _prove_blocks(blocks: np.ndarray, params: Optional[StarkParams], device):
    phase1, fixed, digest_words, build_phase2, log_n = build_sha256_trace_blocks(blocks, device)
    air = sha256_air()
    if params is None:
        params = StarkParams(log_n=log_n)
    cap_f = _commit_columns(fixed, params)["cap"]
    tree = _commit_columns(phase1, params)
    (gamma,), _ = challenges_from_cap(tree["cap"], air, cap_f)
    public = _publics(digest_words, blocks_rlc(blocks, gamma), phase1.device)
    proof = prove(phase1, air, params, public, build_phase2=build_phase2, fixed_cols=fixed,
                  phase1_tree=tree)
    return proof, digest_words, params


def prove_sha256(message: bytes, params: Optional[StarkParams] = None, device=None
                 ) -> Tuple[StarkProof, bytes, StarkParams]:
    """STARK-prove digest = sha256(message) on `device` (None: the card)."""
    proof, digest_words, params = _prove_blocks(pad_message(message), params, device)
    digest = b"".join(int(w).to_bytes(4, "big") for w in digest_words)
    return proof, digest, params


def verify_sha256(proof: StarkProof, message: bytes, digest: bytes,
                  params: StarkParams) -> bool:
    if len(digest) != 32:
        return False
    words = np.frombuffer(digest, ">u4").astype(np.uint64)
    return verify_sha256_blocks(proof, pad_message(message), words, params)


def prove_sha256_blocks(blocks: np.ndarray, params: Optional[StarkParams] = None, device=None
                        ) -> Tuple[StarkProof, np.ndarray, StarkParams]:
    """Prove the raw caller-padded chain: digest = compress*(H0, blocks), on
    `device` (None: the card).  Returns (proof, digest_words (8,) u32,
    params)."""
    return _prove_blocks(np.asarray(blocks, np.uint64), params, device)


def verify_sha256_blocks(proof: StarkProof, blocks: np.ndarray, digest_words: np.ndarray,
                         params: StarkParams) -> bool:
    """The proof's own `params` are trusted, as in the JAX package (ROADMAP
    Queue 3)."""
    air = sha256_air()
    n = 1 << params.log_n
    blocks = np.asarray(blocks, np.uint64)
    if blocks.ndim != 2 or blocks.shape[1] != 16:
        return False
    if ROUNDS * blocks.shape[0] > n:
        return False
    if len(proof.caps) != 3:
        return False
    digest_words = np.asarray(digest_words, np.uint64)
    if digest_words.shape != (8,):
        return False
    dev = proof.q_cap.device
    fixed = fixed_columns(n, dev)
    (gamma,), _ = challenges_from_cap(proof.caps[1], air, proof.caps[0])
    public = _publics(digest_words, blocks_rlc(blocks, gamma), dev)
    return verify(proof, air, params, public, fixed_cols=fixed)
