"""keccak-f[1600] and keccak256 (original 0x01 padding): a batched torch
form and the host reference on python ints (the JAX package's
`ops/keccak.py`).

Batched form: a batch of states is a pair of int64 tensors (lo, hi) of shape
(..., 25), each holding the low or high 32 bits of a 64-bit lane, as the JAX
package lays it out.  Every left shift is cut back to 32 bits (`& M32`); a
right shift acts on a value already in [0, 2^32), so the arithmetic shift of
int64 is the logical one; a NOT is always ANDed with an in-range value, which
clears its upper bits.  The 24 rounds are a Python loop over the batch (the
JAX package scans them); the linear hasher checks its keccak chain with
`absorb_block` on the card.

Host reference (`keccak_f1600_ref`, `keccak256_ref`, `bytes_to_lanes`): copied so that the port
needs nothing of the JAX package; the recursion layer's interblock aggregator
(`models/recursion.py`) and the linear hasher's witness chain use it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

KECCAK_RATE_BYTES = 136
KECCAK_ROUNDS = 24

ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets indexed [x][y]
ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _idx(x: int, y: int) -> int:
    return x + 5 * y


# ---------------------------------------------------------------------------
# Batched (lo, hi) u32-pair form on torch tensors
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _rotl64(lo: torch.Tensor, hi: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    r %= 64
    if r == 0:
        return lo, hi
    if r == 32:
        return hi, lo
    if r < 32:
        t = 32 - r
        return ((lo << r) & M32) | (hi >> t), ((hi << r) & M32) | (lo >> t)
    s, t = r - 32, 64 - r
    return ((hi << s) & M32) | (lo >> t), ((lo << s) & M32) | (hi >> t)


def _round(lo: torch.Tensor, hi: torch.Tensor, rc_lo: int, rc_hi: int):
    """One keccak round on (..., 25) u32 pairs (static lane shuffles)."""
    L = [lo[..., i] for i in range(25)]
    H = [hi[..., i] for i in range(25)]
    # theta
    CL = [L[_idx(x, 0)] ^ L[_idx(x, 1)] ^ L[_idx(x, 2)] ^ L[_idx(x, 3)] ^ L[_idx(x, 4)]
          for x in range(5)]
    CH = [H[_idx(x, 0)] ^ H[_idx(x, 1)] ^ H[_idx(x, 2)] ^ H[_idx(x, 3)] ^ H[_idx(x, 4)]
          for x in range(5)]
    for x in range(5):
        rl, rh = _rotl64(CL[(x + 1) % 5], CH[(x + 1) % 5], 1)
        dl = CL[(x - 1) % 5] ^ rl
        dh = CH[(x - 1) % 5] ^ rh
        for y in range(5):
            L[_idx(x, y)] = L[_idx(x, y)] ^ dl
            H[_idx(x, y)] = H[_idx(x, y)] ^ dh
    # rho + pi
    BL = [None] * 25
    BH = [None] * 25
    for x in range(5):
        for y in range(5):
            rl, rh = _rotl64(L[_idx(x, y)], H[_idx(x, y)], ROT[x][y])
            BL[_idx(y, (2 * x + 3 * y) % 5)] = rl
            BH[_idx(y, (2 * x + 3 * y) % 5)] = rh
    # chi (the NOT of an in-range value ANDed with an in-range value stays in range)
    for x in range(5):
        for y in range(5):
            L[_idx(x, y)] = BL[_idx(x, y)] ^ (~BL[_idx((x + 1) % 5, y)] & BL[_idx((x + 2) % 5, y)])
            H[_idx(x, y)] = BH[_idx(x, y)] ^ (~BH[_idx((x + 1) % 5, y)] & BH[_idx((x + 2) % 5, y)])
    # iota
    L[0] = L[0] ^ rc_lo
    H[0] = H[0] ^ rc_hi
    return torch.stack(L, dim=-1), torch.stack(H, dim=-1)


def keccak_f1600(lo: torch.Tensor, hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One permutation over a batch; lo/hi (..., 25) int64 holding u32 halves."""
    for rc in ROUND_CONSTANTS:
        lo, hi = _round(lo, hi, rc & M32, rc >> 32)
    return lo, hi


def absorb_block(lo, hi, block_lo, block_hi):
    """XOR a 17-lane (136-byte) block into the state and permute.

    block_*: (..., 17) int64 holding u32 halves."""
    pad = tuple(lo.shape[:-1]) + (25 - 17,)
    z = torch.zeros(pad, dtype=lo.dtype, device=lo.device)
    return keccak_f1600(lo ^ torch.cat([block_lo, z], dim=-1), hi ^ torch.cat([block_hi, z], dim=-1))


def lane_halves(block_bytes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 8k) byte values -> the (..., k) lo / hi u32 halves of the
    little-endian 64-bit lanes."""
    by = block_bytes.reshape(tuple(block_bytes.shape[:-1]) + (block_bytes.shape[-1] // 8, 8))
    lo = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16) | (by[..., 3] << 24)
    hi = by[..., 4] | (by[..., 5] << 8) | (by[..., 6] << 16) | (by[..., 7] << 24)
    return lo, hi


def digest_bytes(state_lo: torch.Tensor, state_hi: torch.Tensor) -> torch.Tensor:
    """(..., 25) state -> (..., 32) keccak256 digest bytes (the first 4 lanes, LE)."""
    outs = []
    for lane in range(4):
        for part in (state_lo, state_hi):
            outs += [(part[..., lane] >> (8 * j)) & 0xFF for j in range(4)]
    return torch.stack(outs, dim=-1)


# ---------------------------------------------------------------------------
# Host reference (python ints)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


# theta's column per lane and rho-pi's (source, column, destination,
# rotation, 64 - rotation) per lane; chi's two neighbours of each lane
_RHO_PI = [(x + 5 * y, x, y + 5 * ((2 * x + 3 * y) % 5), ROT[x][y], 64 - ROT[x][y])
           for x in range(5) for y in range(5)]
_CHI = [(i, (i + 1) % 5 + i - i % 5, (i + 2) % 5 + i - i % 5) for i in range(25)]


def keccak_f1600_ref(state: Sequence[int]) -> List[int]:
    A = [v & _M64 for v in state]
    if len(A) != 25:
        raise ValueError(f"a keccak state has 25 lanes, got {len(A)}")
    B = [0] * 25
    for rc in ROUND_CONSTANTS:
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20] for x in range(5)]
        D = [C[x - 1] ^ (((C[x - 4] << 1) | (C[x - 4] >> 63)) & _M64) for x in range(5)]
        for src, x, dst, r, left in _RHO_PI:
            v = A[src] ^ D[x]
            B[dst] = ((v << r) | (v >> left)) & _M64
        A = [B[i] ^ (~B[j] & B[k]) for i, j, k in _CHI]
        A[0] ^= rc
    return A


def keccak256_ref(data: bytes) -> bytes:
    """keccak256 (original 0x01 padding, NOT NIST sha3's 0x06)."""
    state = [0] * 25
    rate = KECCAK_RATE_BYTES
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            state[i] ^= lane
        state = keccak_f1600_ref(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


def bytes_to_lanes(block: bytes) -> List[int]:
    """little-endian 64-bit lanes of a byte string whose length is a multiple of 8."""
    if len(block) % 8:
        raise ValueError(f"{len(block)} bytes are not whole 64-bit lanes")
    return [int.from_bytes(block[8 * i : 8 * i + 8], "little") for i in range(len(block) // 8)]
