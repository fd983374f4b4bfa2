"""keccak-f[1600] and keccak256 (original 0x01 padding) on python ints.

The host reference of the JAX package's `ops/keccak.py`, copied so that the
port needs nothing of that package: the recursion layer's interblock
aggregator (`models/recursion.py`) hashes with it.  The batched keccak of
the precompile circuits is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

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


_M64 = (1 << 64) - 1


def _rotl_ref(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & _M64


def keccak_f1600_ref(state: Sequence[int]) -> List[int]:
    A = [v & _M64 for v in state]
    if len(A) != 25:
        raise ValueError(f"a keccak state has 25 lanes, got {len(A)}")
    for rc in ROUND_CONSTANTS:
        C = [A[_idx(x, 0)] ^ A[_idx(x, 1)] ^ A[_idx(x, 2)] ^ A[_idx(x, 3)] ^ A[_idx(x, 4)] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl_ref(C[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                A[_idx(x, y)] ^= D[x]
        B = [0] * 25
        for x in range(5):
            for y in range(5):
                B[_idx(y, (2 * x + 3 * y) % 5)] = _rotl_ref(A[_idx(x, y)], ROT[x][y])
        for x in range(5):
            for y in range(5):
                A[_idx(x, y)] = B[_idx(x, y)] ^ ((~B[_idx((x + 1) % 5, y)] & _M64) & B[_idx((x + 2) % 5, y)])
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
