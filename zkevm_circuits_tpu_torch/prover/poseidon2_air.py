"""Poseidon2 sponge-chain AIR: STARK proofs of queue-tail commitments (the
JAX package's `prover/poseidon2_air.py`, on torch tensors).

A two-phase STARK (`prover/stark.py`) whose trace is the full round
trajectory of a chain of width-12 permutations and whose public values are

    [tail_init | tail_final | message_rlc]

where `message_rlc` accumulates every absorbed rate chunk under a challenge
gamma drawn AFTER the trace commitment (the phase-2 column).  A verifier who
recomputes the RLC from the plaintext encodings binds the proof to the exact
message stream: a real proof of `tail_final = sponge_chain(tail_init, encodings)`.

AIR layout (one row per absorbed rate chunk / permutation):

    pad | b_0..b_{M-1} | chunk[8] | carry[4] |
        (s3[12], y[12]) x 4 full rounds |
        (s3, y) x 22 partial rounds |
        (s3[12], y[12]) x 4 full rounds | O[12]          (phase 1)
    acc                                                   (phase 2)

Each S-box cell carries s3 = x^3 and y = s3^2 x (= x^7), so every
constraint has degree <= 3; the states between rounds are linear in the
committed y columns and are rebuilt by the constraint evaluator with the
runtime permutation's own `_ext_matrix` / `_int_matrix` (`ops/poseidon2.py`).

Chaining: narrow queues (4-lane tail) absorb M = 3 chunks a push and re-seed
lanes 8:12 from the previous push's out[:4]; full-state queues absorb one
chunk a push and carry lanes 8:12.  Rows past the chain hold one valid
zero block (chunk = 0, carry = 0) and a monotone `pad` flag switches the
output columns to passthrough, so the real tail reaches the last row.

The trace builder knows every row's permutation input before it starts:
the sponge chain itself comes from the native C++ runtime (or, for a
full-state chain, from the caller's witness, which already holds every
state), and then all rounds of all rows are captured in one row-parallel
pass on the device.  The RLC column is a prefix sum on the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import gf
from ..ops.gf import MODULUS
from ..ops.poseidon2 import (
    EXT_RC,
    INT_RC,
    MU_MINUS_1,
    R_FULL,
    R_PARTIAL,
    RATE,
    WIDTH,
    _ext_matrix,
    _int_matrix,
    _ladd,
    _lmul,
)
from ..runtime import native
from ..utils.device import resolve_device
from .stark import (
    AirSpec,
    StarkParams,
    StarkProof,
    _alpha_powers,
    _alpha_sum,
    _commit_columns,
    challenges_from_cap,
    prove,
    verify,
)

HALF_FULL = R_FULL // 2  # 4


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """blocks_per_push M; narrow chains restart each push from the running
    4-lane tail, full-state chains carry capacity lanes throughout."""

    blocks_per_push: int
    restart_from_tail: bool
    out_width: int  # 4 (narrow tail) or 12 (full queue state)

    @property
    def cols(self):
        return _ColMap(self.blocks_per_push)

    @property
    def num_public(self) -> int:
        return 4 + self.out_width + 1


NARROW = ChainSpec(blocks_per_push=3, restart_from_tail=True, out_width=4)
FULL = ChainSpec(blocks_per_push=1, restart_from_tail=False, out_width=12)


class PermCols:
    """Column layout of ONE permutation block starting at index `start`:
    chunk[8] | carry[4] | (s3[12], y[12]) x 4 | (s3, y) x 22 |
    (s3[12], y[12]) x 4 | out[12]."""

    def __init__(self, start: int = 0):
        i = start
        self.chunk = slice(i, i + RATE); i += RATE
        self.carry = slice(i, i + 4); i += 4
        self.full1_s3, self.full1_y = [], []
        for _ in range(HALF_FULL):
            self.full1_s3.append(slice(i, i + WIDTH)); i += WIDTH
            self.full1_y.append(slice(i, i + WIDTH)); i += WIDTH
        self.part_s3 = slice(i, i + R_PARTIAL); i += R_PARTIAL
        self.part_y = slice(i, i + R_PARTIAL); i += R_PARTIAL
        self.full2_s3, self.full2_y = [], []
        for _ in range(HALF_FULL):
            self.full2_s3.append(slice(i, i + WIDTH)); i += WIDTH
            self.full2_y.append(slice(i, i + WIDTH)); i += WIDTH
        self.out = slice(i, i + WIDTH); i += WIDTH
        self.end = i

    @property
    def width(self) -> int:
        return self.end - self.chunk.start


class _ColMap:
    """Phase-1 column index layout of the chain AIR."""

    def __init__(self, m: int):
        self.m = m
        i = 0
        self.pad = i; i += 1
        self.b = slice(i, i + m); i += m
        perm = PermCols(i)
        self.chunk = perm.chunk
        self.carry = perm.carry
        self.full1_s3, self.full1_y = perm.full1_s3, perm.full1_y
        self.part_s3, self.part_y = perm.part_s3, perm.part_y
        self.full2_s3, self.full2_y = perm.full2_s3, perm.full2_y
        self.out = perm.out
        self.perm = perm
        i = perm.end
        self.num_phase1 = i
        self.acc = i  # phase-2 column (index in the concatenated row)
        self.total = i + 1


_c = gf.canonicalize


def _cube(x: torch.Tensor) -> torch.Tensor:
    return _lmul(_lmul(x, x), x)


def _sbox_out(s3: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _lmul(_lmul(s3, s3), x)


def _round_consts(device):
    """(8, 12) external, (22,) internal round constants, (12,) mu - 1."""
    return (gf.from_u64(EXT_RC, device), gf.from_u64(INT_RC, device),
            gf.from_u64(MU_MINUS_1, device))


def _one_minus(x: torch.Tensor) -> torch.Tensor:
    return gf.sub(torch.ones_like(x), x)


def _rlc(chunk: torch.Tensor, gamma: int) -> torch.Tensor:
    """sum_j chunk[..., j] gamma^j."""
    return gf.dot_mod(_c(chunk), _alpha_powers(gamma, RATE, chunk.device))


def _gamma(ch: torch.Tensor) -> int:
    return int(gf.to_u64(ch[0]))


def _weighted_sum(vals: torch.Tensor, weights) -> torch.Tensor:
    """sum over the leading axes of vals (..., batch) times int weights of
    the same leading shape."""
    w = gf.from_u64(np.asarray(weights, np.uint64), vals.device)
    batch = tuple(vals.shape[w.dim():])
    w = w.reshape(tuple(w.shape) + (1,) * len(batch))
    return gf.sum_mod(gf.mul(_c(vals), w).reshape((-1,) + batch), dim=0)


def fold_perm_constraints(cur: torch.Tensor, pcols: PermCols, alpha: int, a_pow: int):
    """Alpha-fold the S-box constraints of one permutation block (s3 = x^3
    and y = s3^2 x per round cell, the round inputs rebuilt from committed y
    columns).  Round r of a full half takes the weights a_pow alpha^(24 r + k)
    over its 24 constraints [c1 | c2]; a partial round the weights
    a_pow' (1, alpha).  The four rounds of a full half are folded in one
    batched pass, since each one's input is linear in committed columns.

    Returns (acc, a_pow', final) where final is the permutation output as
    an expression in committed cells: the caller constrains it against the
    committed out columns."""
    ext_rc, int_rc, mu = _round_consts(cur.device)
    a24 = pow(alpha, 2 * WIDTH, MODULUS)
    a2 = pow(alpha, 2, MODULUS)
    w24 = [pow(alpha, k, MODULUS) for k in range(2 * WIDTH)]

    def full_half(first_state, s3_slices, y_slices, rc, a_pow):
        s3 = torch.stack([cur[..., s] for s in s3_slices])   # (4, batch, 12)
        y = torch.stack([cur[..., s] for s in y_slices])
        st = torch.cat([first_state.unsqueeze(0), _ext_matrix(y[:-1])])
        x = _ladd(st, rc.unsqueeze(1))
        c1 = gf.sub(_c(_cube(x)), s3)
        c2 = gf.sub(_c(_sbox_out(s3, x)), y)
        vals = torch.cat([c1, c2], dim=-1).movedim(-1, 1)    # (4, 24, batch)
        weights = [[a_pow * pow(a24, r, MODULUS) * w % MODULUS for w in w24]
                    for r in range(HALF_FULL)]
        return _weighted_sum(vals, weights), _ext_matrix(y[-1]), \
            a_pow * pow(a24, HALF_FULL, MODULUS) % MODULUS

    s_pre = torch.cat([cur[..., pcols.chunk], cur[..., pcols.carry]], dim=-1)
    acc, st, a_pow = full_half(_ext_matrix(s_pre), pcols.full1_s3, pcols.full1_y,
                               ext_rc[:HALF_FULL], a_pow)
    part_s3, part_y = cur[..., pcols.part_s3], cur[..., pcols.part_y]
    for r in range(R_PARTIAL):
        x0 = _ladd(st[..., 0], int_rc[r])
        s3, y = part_s3[..., r], part_y[..., r]
        c1 = gf.sub(_c(_cube(x0)), s3)
        c2 = gf.sub(_c(_sbox_out(s3, x0)), y)
        acc = gf.add(acc, _weighted_sum(torch.stack([c1, c2]),
                                        [a_pow, a_pow * alpha % MODULUS]))
        st = _int_matrix(torch.cat([y.unsqueeze(-1), st[..., 1:]], dim=-1), mu)
        a_pow = a_pow * a2 % MODULUS
    acc2, final, a_pow = full_half(st, pcols.full2_s3, pcols.full2_y, ext_rc[HALF_FULL:], a_pow)
    return gf.add(acc, acc2), a_pow, _c(final)


@functools.lru_cache(maxsize=8)
def chain_air(spec: ChainSpec) -> AirSpec:
    cols = spec.cols
    M = spec.blocks_per_push

    def compose_row(cur, ch, alpha, a_pow):
        """Alpha-weighted sum of all per-row constraints."""
        vals = []
        pad = cur[..., cols.pad]
        live = _one_minus(pad)
        vals.append(gf.mul(pad, gf.sub(pad, torch.ones_like(pad))))  # booleanity
        b = cur[..., cols.b]
        for i in range(M):
            bi = b[..., i]
            vals.append(gf.mul(bi, gf.sub(bi, torch.ones_like(bi))))
            vals.append(gf.mul(pad, bi))          # pad rows: counter zeroed
        tot = b[..., 0]
        for i in range(1, M):
            tot = gf.add(tot, b[..., i])
        vals.append(gf.mul(live, gf.sub(tot, torch.ones_like(tot))))  # one-hot on live rows
        # pad rows hold the canonical zero block (chunk = 0, carry = 0)
        vals.append(gf.mul(pad.unsqueeze(-1), cur[..., cols.chunk]).movedim(-1, 0))
        vals.append(gf.mul(pad.unsqueeze(-1), cur[..., cols.carry]).movedim(-1, 0))
        acc, a_pow = _alpha_sum(vals, alpha, a_pow)

        perm_acc, a_pow, final = fold_perm_constraints(cur, cols.perm, alpha, a_pow)
        acc = gf.add(acc, perm_acc)

        # O = permutation output on live rows (pad rows: passthrough, in the transitions)
        out = gf.mul(live.unsqueeze(-1), gf.sub(cur[..., cols.out], final))
        tail_acc, a_pow = _alpha_sum([out.movedim(-1, 0)], alpha, a_pow)
        return gf.add(acc, tail_acc), a_pow

    def constraints(cur, nxt, ch):
        vals = []
        pad_n = nxt[..., cols.pad]
        live_n = _one_minus(pad_n)
        vals.append(gf.mul(cur[..., cols.pad], live_n))  # pad is monotone
        # the one-hot counter rotates on live rows
        b_c, b_n = cur[..., cols.b], nxt[..., cols.b]
        for i in range(M):
            vals.append(gf.mul(live_n, gf.sub(b_n[..., i], b_c[..., (i - 1) % M])))
        # carry chaining: push-start rows re-seed from the tail (narrow) or
        # continue from the capacity lanes
        O_c = cur[..., cols.out]
        carry_n = nxt[..., cols.carry]
        for k in range(4):
            if spec.restart_from_tail:
                b0 = b_n[..., 0]
                src = gf.add(gf.mul(b0, O_c[..., k]), gf.mul(_one_minus(b0), O_c[..., 8 + k]))
            else:
                src = O_c[..., 8 + k]
            vals.append(gf.mul(live_n, gf.sub(carry_n[..., k], src)))
        # pad rows pass the output through unchanged
        vals.append(gf.mul(pad_n.unsqueeze(-1), gf.sub(nxt[..., cols.out], O_c)).movedim(-1, 0))
        # the phase-2 RLC accumulator
        gamma = _gamma(ch)
        acc_c, acc_n = cur[..., cols.acc], nxt[..., cols.acc]
        live_val = gf.add(gf.mul_const(acc_c, pow(gamma, RATE, MODULUS)),
                          _rlc(nxt[..., cols.chunk], gamma))
        sel = gf.add(gf.mul(pad_n, acc_c), gf.mul(live_n, live_val))
        vals.append(gf.sub(acc_n, sel))
        return vals

    def first_row(row, public, ch):
        vals = [row[..., cols.pad], gf.sub(row[..., cols.b][..., 0], torch.ones_like(row[..., 0]))]
        for k in range(4):
            vals.append(gf.sub(row[..., cols.carry][..., k], public[k]))
        vals.append(gf.sub(row[..., cols.acc], _rlc(row[..., cols.chunk], _gamma(ch))))
        return vals

    def last_row(row, public, ch):
        O = row[..., cols.out]
        vals = [gf.sub(O[..., k], public[4 + k]) for k in range(spec.out_width)]
        vals.append(gf.sub(row[..., cols.acc], public[4 + spec.out_width]))
        return vals

    return AirSpec(
        num_cols=cols.num_phase1,
        max_degree=3,
        constraints=constraints,
        compose_row=compose_row,
        first_row=first_row,
        last_row=last_row,
        num_public=spec.num_public,
        num_phase2_cols=1,
        num_challenges=1,
    )


# ---------------------------------------------------------------------------
# trace builder: the chain on the host, every round of every row at once on
# the device
# ---------------------------------------------------------------------------


def _block_capture(s_pre: torch.Tensor):
    """Permutations of a batch of inputs (..., 12) with every round's
    (s3, y): returns (out, (f1_s3, f1_y, p_s3, p_y, f2_s3, f2_y)), the full
    rounds' as (..., 4, 12), the partial rounds' as (..., 22)."""
    ext_rc, int_rc, mu = _round_consts(s_pre.device)

    def full_rounds(st, rcs):
        s3s, ys = [], []
        for rc in rcs:
            x = _ladd(st, rc)
            s3 = _c(_cube(x))
            y = _c(_sbox_out(s3, x))
            st = _ext_matrix(y)
            s3s.append(s3)
            ys.append(y)
        return st, torch.stack(s3s, dim=-2), torch.stack(ys, dim=-2)

    st, f1_s3, f1_y = full_rounds(_ext_matrix(s_pre), ext_rc[:HALF_FULL])
    p_s3, p_y = [], []
    for r in range(R_PARTIAL):
        x0 = _ladd(st[..., 0], int_rc[r])
        s3 = _c(_cube(x0))
        y = _c(_sbox_out(s3, x0))
        st = _int_matrix(torch.cat([y.unsqueeze(-1), st[..., 1:]], dim=-1), mu)
        p_s3.append(s3)
        p_y.append(y)
    st, f2_s3, f2_y = full_rounds(st, ext_rc[HALF_FULL:])
    return _c(st), (f1_s3, f1_y, torch.stack(p_s3, -1), torch.stack(p_y, -1), f2_s3, f2_y)


def _perm_rows(s_pre: torch.Tensor) -> torch.Tensor:
    """(B, 12) permutation inputs -> (B, 260) PermCols rows."""
    out, (f1_s3, f1_y, p_s3, p_y, f2_s3, f2_y) = _block_capture(s_pre)
    B = s_pre.shape[0]
    return torch.cat([
        s_pre,
        torch.stack([f1_s3, f1_y], dim=-2).reshape(B, 2 * HALF_FULL * WIDTH),
        p_s3, p_y,
        torch.stack([f2_s3, f2_y], dim=-2).reshape(B, 2 * HALF_FULL * WIDTH),
        out,
    ], dim=-1)


def _chain_carries(chunks: np.ndarray, init_state: np.ndarray, spec: ChainSpec) -> np.ndarray:
    """(B, 4) carry lanes of every row, by the native C++ permutation: a
    full-state chain in one call, a narrow one by a step a block."""
    B = chunks.shape[0]
    init = np.asarray(init_state, np.uint64)
    if not spec.restart_from_tail:
        init12 = np.zeros(WIDTH, np.uint64)
        init12[8:12] = init
        return native.full_state_chain(chunks, None, init12)[:B, 8:12]
    prev = np.zeros(WIDTH, np.uint64)
    prev[0:4] = init  # a push-start row re-seeds from lanes 0:4
    prev[8:12] = init
    carries = np.empty((B, 4), np.uint64)
    for i in range(B):
        carries[i] = prev[0:4] if i % spec.blocks_per_push == 0 else prev[8:12]
        prev = native.poseidon2_permute(np.concatenate([chunks[i], carries[i]]))
    return carries


def _acc_column(chunks: torch.Tensor, gamma: int, n: int) -> torch.Tensor:
    """The RLC accumulator over B chunks, padded to n with its last value:
    acc_i = acc_{i-1} gamma^8 + r_i, r_i = sum_j chunk_ij gamma^j, so
    acc_i = gamma^(8i) sum_{j<=i} r_j gamma^(-8j), a prefix sum."""
    B = chunks.shape[0]
    dev = chunks.device
    r = _rlc(chunks, gamma)
    if gamma % MODULUS == 0:
        acc = r
    else:
        g8 = pow(gamma, RATE, MODULUS)
        size = 1 << (B - 1).bit_length()
        down = gf.geometric(pow(g8, MODULUS - 2, MODULUS), size, dev)[:B]
        up = gf.geometric(g8, size, dev)[:B]
        acc = gf.mul(gf.cumsum_mod(gf.mul(r, down)), up)
    return torch.cat([acc, acc[-1:].expand(n - B)])


def build_chain_trace(
    chunks: np.ndarray, init_state: np.ndarray, spec: ChainSpec,
    log_n: Optional[int] = None, device=None,
    states: Optional[torch.Tensor] = None,
):
    """chunks: (B, 8) u64 rate blocks; init_state: (4,) u64, the initial
    tail (narrow) or capacity lanes state[8:12] (full).  `states` (B + 1, 12),
    a full-state chain's every state when the caller has them (a witness's
    per-row chain), spares the host chain.  Returns (phase-1 trace
    (num_phase1, n) on `device` (None: the card), publics without acc (numpy),
    build_phase2, n)."""
    chunks = np.asarray(chunks, np.uint64)
    B = chunks.shape[0]
    if B < 1 or chunks.shape != (B, RATE):
        raise ValueError(f"chunks must be (B >= 1, {RATE}), got {chunks.shape}")
    M = spec.blocks_per_push
    if B % M:
        raise ValueError("chain length must be whole pushes")
    need = max(1 << 3, 1 << (B - 1).bit_length())
    n = need if log_n is None else (1 << log_n)
    if n < B:
        raise ValueError(f"{B} chunks do not fit 2^{log_n} rows")
    dev = resolve_device(device)
    chunks_t = gf.from_u64(chunks, dev)

    if states is not None:
        if spec.restart_from_tail or tuple(states.shape) != (B + 1, WIDTH):
            raise ValueError(f"states must be a full-state chain's (B + 1, 12), "
                             f"got {tuple(states.shape)}")
        carries = states[:B, 8:12].to(dev)
    else:
        carries = gf.from_u64(_chain_carries(chunks, init_state, spec), dev)
    rows = _perm_rows(torch.cat([chunks_t, carries], dim=-1))   # (B, 260)
    out_final = rows[-1, -WIDTH:]
    pad_row = _perm_rows(gf.zeros((1, WIDTH), dev))
    pad_row[:, -WIDTH:] = out_final  # pad rows pass the tail through
    body = torch.cat([rows, pad_row.expand(n - B, -1)])
    flags = gf.zeros((n, 1 + M), dev)
    flags[B:, 0] = 1
    j = torch.arange(B, device=dev)
    flags[j, 1 + j % M] = 1
    trace = torch.cat([flags, body], dim=-1).T.contiguous()    # (num_phase1, n)

    def build_phase2(_cols, ch):
        return _acc_column(chunks_t, ch[0], n).unsqueeze(0)

    out_pub = gf.to_u64(out_final)[: spec.out_width]
    publics_head = np.concatenate([np.asarray(init_state, np.uint64), out_pub])
    return trace, publics_head, build_phase2, n


def message_rlc(chunks, gamma: int, device=None) -> int:
    """The public RLC binding, recomputed by the verifier from plaintext
    chunks (B, 8): a tensor stays on its device, numpy goes to `device`
    (None: the card)."""
    if not isinstance(chunks, torch.Tensor):
        chunks = gf.from_u64(np.asarray(chunks, np.uint64), resolve_device(device))
    return int(gf.to_u64(_acc_column(chunks, gamma, chunks.shape[0])[-1]))


def encodings_to_chunks(encodings: np.ndarray) -> np.ndarray:
    """(L, E) narrow-queue encodings -> (L*ceil(E/8), 8) zero-padded chunks
    (the blocking of `ops/queues.narrow_state_transition`)."""
    L, E = encodings.shape
    padded = E + (-E) % RATE
    buf = np.zeros((L, padded), dtype=np.uint64)
    buf[:, :E] = encodings
    return buf.reshape(L * (padded // RATE), RATE)


def _chunks_of(encodings: np.ndarray, spec: ChainSpec) -> np.ndarray:
    enc = np.asarray(encodings, np.uint64)
    return encodings_to_chunks(enc) if spec.blocks_per_push > 1 else enc


# ---------------------------------------------------------------------------
# queue-chain proof API
# ---------------------------------------------------------------------------


def prove_queue_chain(
    encodings: np.ndarray,
    init_state: np.ndarray,
    spec: ChainSpec = NARROW,
    params: Optional[StarkParams] = None,
    device=None,
    states: Optional[torch.Tensor] = None,
) -> Tuple[StarkProof, torch.Tensor, StarkParams]:
    """Prove tail_final = sponge_chain(init, encodings), on `device` (None:
    the card).

    narrow: encodings (L, 20) u64, init_state = the (4,) tail;
    full:   encodings (L, 8) u64, init_state = state[8:12] (lanes 0:8 are
            replaced by the first absorption and cannot affect the chain);
            `states` as in `build_chain_trace`.
    Returns (proof, publics, params); publics[4:4+out_width] is the proven
    final tail/state."""
    chunks = _chunks_of(encodings, spec)
    trace, pub_head, build_phase2, n = build_chain_trace(
        chunks, init_state, spec, device=device, states=states)
    if params is None:
        params = StarkParams(log_n=int(n).bit_length() - 1, log_blowup=2)
    air = chain_air(spec)
    # the acc public depends on gamma = FS(cap_1), drawn before the publics
    # are absorbed: commit phase 1 here to learn gamma and hand the tree on
    tree = _commit_columns(trace, params)
    (gamma,), _ = challenges_from_cap(tree["cap"], air)
    acc = int(gf.to_u64(build_phase2(trace, (gamma,))[0, -1]))
    public = gf.from_u64(np.concatenate([pub_head, np.array([acc], np.uint64)]), trace.device)
    proof = prove(trace, air, params, public, build_phase2, phase1_tree=tree)
    return proof, public, params


def verify_queue_chain(
    proof: StarkProof,
    encodings: np.ndarray,
    init_state: np.ndarray,
    final_state: np.ndarray,
    spec: ChainSpec = NARROW,
    params: Optional[StarkParams] = None,
) -> bool:
    """Check a queue-chain proof against PLAINTEXT encodings and claimed
    init/final states: recompute the RLC public under the transcript-bound
    gamma, then run the STARK verifier (on the proof's device)."""
    chunks = _chunks_of(encodings, spec)
    B = chunks.shape[0]
    if params is None:
        n = max(8, 1 << (B - 1).bit_length())
        params = StarkParams(log_n=int(n).bit_length() - 1, log_blowup=2)
    air = chain_air(spec)
    pub_head = np.concatenate(
        [np.asarray(init_state, np.uint64), np.asarray(final_state, np.uint64)])
    if pub_head.shape != (4 + spec.out_width,):
        return False
    dev = proof.q_cap.device
    (gamma,), _ = challenges_from_cap(proof.caps[0], air)
    acc = message_rlc(chunks, gamma, dev)
    publics = gf.from_u64(np.concatenate([pub_head, np.array([acc], np.uint64)]), dev)
    return verify(proof, air, params, publics)
