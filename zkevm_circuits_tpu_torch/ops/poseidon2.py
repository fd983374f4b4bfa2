"""Poseidon2 permutation over Goldilocks, width 12, and its sponge conventions.

The same instance as the JAX package's `ops/poseidon2.py`: alpha = 7,
R_F = 8 (4 + 4), R_P = 22, Grain-LFSR constants from `utils/grain.py`.

  * pre-round:       state = M_E @ state
  * external round:  state += rc;  state = state^7;  state = M_E @ state
  * internal round:  state[0] += rc;  state[0] ^= 7;  state = M_I @ state
  * M_E = (J_{3x3} + I) (x) M4 through the 8-addition M4 chain;
    M_I = J + diag(mu - 1).

A batch of states is an int64 tensor of shape (..., 12).  `permutation`
sends a CUDA tensor to the hand-written kernels (`ops/poseidon2_cuda.py`:
the lane-parallel one for small batches, the thread-per-state one for large)
and a CPU tensor to `permutation_plain`, the torch version here; there is no
third case and no fallback between the two.
"""

from __future__ import annotations

import hashlib

import torch

from ..utils.device import resolve_device
from ..utils.grain import poseidon2_goldilocks_constants
from . import gf

WIDTH = 12
RATE = 8
COMMITMENT_WIDTH = 4
R_FULL = 8
# absorbs from which `hash_padded` over fewer than SMALL_BATCH states on the
# card runs as one fused chain launch: the crossover of the sponge table of
# scripts/bench_poseidon2_kernels.py (on an H100 the chain is 1.04-1.31 times
# as fast at 2 absorbs, 1.5-3 times from 4, and slower at 1, at 1-2^13 states)
CHAIN_SPONGE_ROUNDS = 2
R_PARTIAL = 22

EXT_RC, INT_RC, MU = poseidon2_goldilocks_constants(gf.MODULUS, WIDTH, R_FULL, R_PARTIAL)
MU_MINUS_1 = [(m - 1) % gf.MODULUS for m in MU]

# Identifies the round-constant instance every sponge-derived value depends
# on; equal to the JAX package's INSTANCE_ID (pinned by the tests).
INSTANCE_ID = int.from_bytes(
    hashlib.sha256(
        repr(("poseidon2-goldilocks-grain-v1", EXT_RC, INT_RC, MU)).encode()
    ).digest()[:8],
    "little",
)

_ladd = gf.add_lazy
_lmul = gf.mul_lazy


def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = _lmul(x, x)
    x3 = _lmul(x2, x)
    x4 = _lmul(x2, x2)
    return _lmul(x3, x4)


def _ext_matrix(state: torch.Tensor) -> torch.Tensor:
    """M_E @ state on the trailing axis of 12, across the three 4-blocks."""
    b = state.reshape(state.shape[:-1] + (3, 4))
    x0, x1, x2, x3 = b.unbind(-1)
    t0 = _ladd(x0, x1)
    t1 = _ladd(x2, x3)
    t2 = _ladd(_ladd(x1, x1), t1)
    t3 = _ladd(_ladd(x3, x3), t0)
    t1_2 = _ladd(t1, t1)
    t0_2 = _ladd(t0, t0)
    t4 = _ladd(_ladd(t1_2, t1_2), t3)
    t5 = _ladd(_ladd(t0_2, t0_2), t2)
    t6 = _ladd(t3, t5)
    t7 = _ladd(t2, t4)
    w = torch.stack([t6, t5, t7, t4], dim=-1)  # (..., 3, 4)
    s = _ladd(_ladd(w[..., 0, :], w[..., 1, :]), w[..., 2, :])
    return _ladd(w, s.unsqueeze(-2)).reshape(state.shape)


def _int_matrix(state: torch.Tensor, mu_m1: torch.Tensor) -> torch.Tensor:
    total = state[..., 0]
    for i in range(1, WIDTH):
        total = _ladd(total, state[..., i])
    return _ladd(_lmul(state, mu_m1), total.unsqueeze(-1))


def permutation_plain(state: torch.Tensor) -> torch.Tensor:
    """The permutation in plain torch ops; canonical output, (..., 12)."""
    dev = state.device
    ext_rc = gf.from_u64(EXT_RC, dev)  # (8, 12)
    int_rc = gf.from_u64(INT_RC, dev)  # (22,)
    mu_m1 = gf.from_u64(MU_MINUS_1, dev)  # (12,)
    half = R_FULL // 2

    def full_round(st, r):
        return _ext_matrix(_sbox(_ladd(st, ext_rc[r])))

    st = _ext_matrix(state)
    for r in range(half):
        st = full_round(st, r)
    for r in range(R_PARTIAL):
        lane0 = _sbox(_ladd(st[..., 0], int_rc[r]))
        st = _int_matrix(torch.cat([lane0.unsqueeze(-1), st[..., 1:]], dim=-1), mu_m1)
    for r in range(half, R_FULL):
        st = full_round(st, r)
    return gf.canonicalize(st)


def permutation(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of a (..., 12) int64 tensor of states."""
    if state.device.type == "cuda":
        from .poseidon2_cuda import permutation_cuda

        return permutation_cuda(state)
    if state.device.type == "cpu":
        return permutation_plain(state)
    raise ValueError(f"no Poseidon2 permutation for device {state.device}")


# ---------------------------------------------------------------------------
# sponge conventions
# ---------------------------------------------------------------------------


def empty_state(batch_shape=(), device=None) -> torch.Tensor:
    """The all-zero sponge state; `device=None` is the card, or an error
    without one."""
    return gf.zeros(tuple(batch_shape) + (WIDTH,), resolve_device(device))


def apply_length_specialization(state: torch.Tensor, length: int) -> torch.Tensor:
    """Add the input length to the last capacity lane (domain separation)."""
    last = gf.add(state[..., WIDTH - 1], gf.constant(length, state.device))
    return torch.cat([state[..., : WIDTH - 1], last.unsqueeze(-1)], dim=-1)


def absorb_with_replacement(chunk: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    return torch.cat([chunk, state[..., RATE:]], dim=-1)


def absorb_round(chunk: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    return permutation(absorb_with_replacement(chunk, state))


def state_into_commitment(state: torch.Tensor) -> torch.Tensor:
    return state[..., :COMMITMENT_WIDTH]


def absorb_loop(inputs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Replacement-absorb the trailing axis of `inputs` into `state`, a
    permutation a chunk of RATE, the last chunk zero-padded: the state after."""
    n = inputs.shape[-1]
    for i in range(0, n, RATE):
        chunk = inputs[..., i : i + RATE]
        if chunk.shape[-1] < RATE:
            pad = gf.zeros(tuple(chunk.shape[:-1]) + (RATE - chunk.shape[-1],), inputs.device)
            chunk = torch.cat([chunk, pad], dim=-1)
        state = absorb_round(chunk, state)
    return state


def absorb_chained(inputs: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """`absorb_loop` on the card as one launch of the fused chain kernel,
    each state a segment of its own: the same bits."""
    from .poseidon2_cuda import chain_segmented_cuda

    n = inputs.shape[-1]
    rounds = -(-n // RATE)
    states = state.reshape(-1, WIDTH)
    rows = inputs.reshape(-1, n)
    if rounds * RATE != n:
        rows = torch.cat([rows, gf.zeros((rows.shape[0], rounds * RATE - n), inputs.device)],
                         dim=-1)
    encodings = rows.reshape(-1, RATE).contiguous()
    boundaries = torch.cat([states, states[:1]]).contiguous()
    execute = torch.ones((encodings.shape[0],), dtype=torch.bool, device=inputs.device)
    landing = chain_segmented_cuda([(boundaries, encodings, execute)])[0]
    return landing.reshape(state.shape)


def hash_padded(inputs: torch.Tensor, length_specialize: bool = True) -> torch.Tensor:
    """Sponge-hash the trailing axis of field elements to 4 lanes: zero-pad
    to a multiple of the rate, optionally length-specialize, replacement-absorb.
    On the card, a sponge of CHAIN_SPONGE_ROUNDS absorbs or more over fewer
    than SMALL_BATCH states (a transcript absorb, the leaves of a short
    trace) runs through `absorb_chained`."""
    n = inputs.shape[-1]
    batch = inputs.shape[:-1]
    state = empty_state(batch, inputs.device)
    if length_specialize:
        state = apply_length_specialization(state, n)
    if inputs.device.type == "cuda" and -(-n // RATE) >= CHAIN_SPONGE_ROUNDS:
        from .poseidon2_cuda import SMALL_BATCH

        if 0 < state.numel() // WIDTH < SMALL_BATCH:
            return state_into_commitment(absorb_chained(inputs, state))
    return state_into_commitment(absorb_loop(inputs, state))
