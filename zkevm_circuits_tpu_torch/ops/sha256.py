"""sha256 compression: a batched torch form and the host reference on python
ints (the JAX package's `ops/sha256.py`).

Batched form (`compress`, `initial_state`): a batch of states is an int64
tensor (..., 8), a block (..., 16) big-endian u32 words, each value in
[0, 2^32).  Every add and left shift is cut back to 32 bits (`& M32`); a
right shift acts on a value already in range, so the arithmetic shift of
int64 is the logical one; a NOT is always ANDed with an in-range value.  The
48 schedule steps and the 64 rounds are Python loops over the batch (the JAX
package scans them).  The code unpacker and the sha256 precompile circuit
check every compression of their witness with one call.

Host reference (`compress_ref`, `sha256_ref`): copied so that the port needs
nothing of the JAX package; the witnesses and the Python EraVM's precompile
host execution use it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..utils.device import resolve_device

H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

_M32 = 0xFFFFFFFF
M32 = _M32


# ---------------------------------------------------------------------------
# Batched form on torch tensors
# ---------------------------------------------------------------------------


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) | ((x << (32 - r)) & M32)


def compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One sha256 compression over a batch; state (..., 8), block (..., 16)
    int64 holding u32 big-endian words.  Returns (..., 8)."""
    w = [block[..., i] for i in range(16)]
    for t in range(16, 64):
        wm15, wm2 = w[t - 15], w[t - 2]
        s0 = _rotr(wm15, 7) ^ _rotr(wm15, 18) ^ (wm15 >> 3)
        s1 = _rotr(wm2, 17) ^ _rotr(wm2, 19) ^ (wm2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = (state[..., i] for i in range(8))
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + K[t] + w[t]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + S0 + maj) & M32
    return torch.stack([(o + state[..., i]) & M32 for i, o in enumerate((a, b, c, d, e, f, g, h))],
                       dim=-1)


def initial_state(batch_shape=(), device=None) -> torch.Tensor:
    """H0 broadcast to (..., 8); `device=None` is the card, or an error without one."""
    h0 = torch.tensor(H0, dtype=torch.int64, device=resolve_device(device))
    return h0.expand(tuple(batch_shape) + (8,))


# ---------------------------------------------------------------------------
# Host reference
# ---------------------------------------------------------------------------


def _rotr_ref(x, r):
    return ((x >> r) | (x << (32 - r))) & _M32


def compress_ref(state: Sequence[int], block_words: Sequence[int]) -> List[int]:
    w = list(block_words)
    for t in range(16, 64):
        s0 = _rotr_ref(w[t - 15], 7) ^ _rotr_ref(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr_ref(w[t - 2], 17) ^ _rotr_ref(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _rotr_ref(e, 6) ^ _rotr_ref(e, 11) ^ _rotr_ref(e, 25)
        ch = (e & f) ^ (~e & g & _M32)
        t1 = (h + S1 + ch + K[t] + w[t]) & _M32
        S0 = _rotr_ref(a, 2) ^ _rotr_ref(a, 13) ^ _rotr_ref(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return [(x + y) & _M32 for x, y in zip([a, b, c, d, e, f, g, h], state)]


def sha256_ref(data: bytes) -> bytes:
    padded = bytearray(data)
    bitlen = len(data) * 8
    padded += b"\x80"
    while len(padded) % 64 != 56:
        padded += b"\x00"
    padded += bitlen.to_bytes(8, "big")
    state = list(H0)
    for off in range(0, len(padded), 64):
        words = [int.from_bytes(padded[off + 4 * i : off + 4 * i + 4], "big") for i in range(16)]
        state = compress_ref(state, words)
    return b"".join(x.to_bytes(4, "big") for x in state)
