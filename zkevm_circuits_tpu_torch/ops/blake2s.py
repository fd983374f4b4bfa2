"""blake2s compression: a batched torch form and the host reference on python
ints (the JAX package's `ops/blake2s.py`).

Reference-parity role: boojum's blake2s gadget, used by storage_application
for the depth-256 Merkle tree (derived key = blake2s(address||key), node
hashes — ref `src/storage_application/mod.rs:14,437-439`).

Batched form: a batch of states is an int64 tensor (..., 8), a message
(..., 16) little-endian u32 words, each value in [0, 2^32); every add and
left shift is cut back to 32 bits (`& M32`), a right shift acts on an
in-range value.  The 10 rounds are a Python loop over the batch (the JAX
package scans them); the message words are read as views, round by round,
so a batch of millions of compressions holds no gathered copy of its
messages.  Host reference cross-checked against hashlib.blake2s
(digest_size=32, no key).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..utils.device import resolve_device

IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

M32 = 0xFFFFFFFF
_M32 = M32

# the G mixes of one round: (a, b, c, d) state indices, then the message slots
_MIX = [((0, 4, 8, 12), 0), ((1, 5, 9, 13), 2), ((2, 6, 10, 14), 4), ((3, 7, 11, 15), 6),
        ((0, 5, 10, 15), 8), ((1, 6, 11, 12), 10), ((2, 7, 8, 13), 12), ((3, 4, 9, 14), 14)]


# ---------------------------------------------------------------------------
# Batched form on torch tensors
# ---------------------------------------------------------------------------


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) | ((x << (32 - r)) & M32)


def _G(a, b, c, d, x, y):
    a = (a + b + x) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def compress(h: torch.Tensor, m: torch.Tensor, t: int, last: bool) -> torch.Tensor:
    """blake2s F over a batch: h (..., 8), m (..., 16) int64 holding u32 LE
    words, t = the byte counter.  Returns (..., 8)."""
    batch = tuple(torch.broadcast_shapes(h.shape[:-1], m.shape[:-1]))
    hv = [h[..., i].expand(batch) for i in range(8)]
    v = hv + [torch.full(batch, IV[i], dtype=torch.int64, device=h.device) for i in range(8)]
    v[12] = v[12] ^ (t & M32)
    v[13] = v[13] ^ ((t >> 32) & M32)
    if last:
        v[14] = v[14] ^ M32
    ms = [m[..., i] for i in range(16)]
    for sigma in SIGMA:
        for (ia, ib, ic, id_), k in _MIX:
            v[ia], v[ib], v[ic], v[id_] = _G(v[ia], v[ib], v[ic], v[id_],
                                             ms[sigma[k]], ms[sigma[k + 1]])
    return torch.stack([hv[i] ^ v[i] ^ v[i + 8] for i in range(8)], dim=-1)


def initial_state(batch_shape=(), digest_size: int = 32, device=None) -> torch.Tensor:
    """The parameter-block state (digest_size, no key, fanout 1, depth 1)
    broadcast to (..., 8); `device=None` is the card, or an error without one."""
    h = list(IV)
    h[0] ^= 0x01010000 ^ digest_size
    h0 = torch.tensor(h, dtype=torch.int64, device=resolve_device(device))
    return h0.expand(tuple(batch_shape) + (8,))


# ---------------------------------------------------------------------------
# Host reference
# ---------------------------------------------------------------------------


def _rotr_ref(x, r):
    return ((x >> r) | (x << (32 - r))) & _M32


def compress_ref(h: Sequence[int], m: Sequence[int], t: int, last: bool) -> List[int]:
    v = list(h) + list(IV)
    v[12] ^= t & _M32
    v[13] ^= (t >> 32) & _M32
    if last:
        v[14] ^= _M32

    def G(a, b, c, d, x, y):
        a = (a + b + x) & _M32
        d = _rotr_ref(d ^ a, 16)
        c = (c + d) & _M32
        b = _rotr_ref(b ^ c, 12)
        a = (a + b + y) & _M32
        d = _rotr_ref(d ^ a, 8)
        c = (c + d) & _M32
        b = _rotr_ref(b ^ c, 7)
        return a, b, c, d

    for s in SIGMA:
        for (ia, ib, ic, id_), k in _MIX:
            v[ia], v[ib], v[ic], v[id_] = G(v[ia], v[ib], v[ic], v[id_], m[s[k]], m[s[k + 1]])
    return [(h[i] ^ v[i] ^ v[i + 8]) & _M32 for i in range(8)]


def blake2s_ref(data: bytes, digest_size: int = 32) -> bytes:
    h = list(IV)
    h[0] ^= 0x01010000 ^ digest_size
    msg = bytearray(data)
    if len(msg) == 0:
        msg = bytearray(64)
        blocks = [msg]
        t_final = 0
    else:
        pad = (-len(msg)) % 64
        total = len(data)
        msg += b"\x00" * pad
        blocks = [msg[i : i + 64] for i in range(0, len(msg), 64)]
        t_final = total
    for i, block in enumerate(blocks[:-1]):
        words = [int.from_bytes(block[4 * j : 4 * j + 4], "little") for j in range(16)]
        h = compress_ref(h, words, (i + 1) * 64, False)
    words = [int.from_bytes(blocks[-1][4 * j : 4 * j + 4], "little") for j in range(16)]
    h = compress_ref(h, words, t_final, True)
    return b"".join(x.to_bytes(4, "little") for x in h)[:digest_size]
