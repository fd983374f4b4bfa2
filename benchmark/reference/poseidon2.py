"""Poseidon2 over Goldilocks, width 12, in plain torch: the benchmark's own
frozen copy of the instance the program uses (alpha 7, 4 + 4 full rounds,
22 partial rounds, Grain-LFSR constants), for its references.

  pre-round:       state = M_E @ state
  external round:  state += rc; state = state^7; state = M_E @ state
  internal round:  state[0] += rc; state[0] ^= 7; state = M_I @ state
  M_E = (J_3 + I) (x) M4, M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]]
  M_I = J + diag(mu - 1)

Sponge: the rate is lanes 0..7, absorbed by replacement; lanes 0..3 of a
state are its commitment.
"""

from __future__ import annotations

import functools

import torch

from . import goldilocks as gl

WIDTH = 12
RATE = 8
R_FULL = 8
R_PARTIAL = 22


def _grain_bits(field_bits: int, t: int, r_f: int, r_p: int):
    """The Grain LFSR of the Poseidon reference, after its 160 discarded
    bits; yields the shrinking generator's output bits."""
    state = []
    for value, width in ((1, 2), (0, 4), (field_bits, 12), (t, 12), (r_f, 10), (r_p, 10)):
        state.extend(int(b) for b in format(value, f"0{width}b"))
    state.extend([1] * 30)

    def raw():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        raw()
    while True:
        gate, payload = raw(), raw()
        if gate:
            yield payload


@functools.lru_cache(maxsize=1)
def constants():
    """(external round constants [8][12], internal [22], mu [12]) as ints."""
    bits = _grain_bits(64, WIDTH, R_FULL, R_PARTIAL)

    def element():
        while True:
            v = 0
            for _ in range(64):
                v = (v << 1) | next(bits)
            if v < gl.P:
                return v

    ext = [[element() for _ in range(WIDTH)] for _ in range(R_FULL)]
    internal = [element() for _ in range(R_PARTIAL)]
    mu = []
    while len(mu) < WIDTH:
        v = element()
        if v not in (0, 1):
            mu.append(v)
    return ext, internal, mu


@functools.lru_cache(maxsize=4)
def _device_constants(device: torch.device):
    ext, internal, mu = constants()
    return (gl.tensor(ext, device), gl.tensor(internal, device),
            gl.tensor([(m - 1) % gl.P for m in mu], device))


def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = gl.mul(x, x)
    return gl.mul(gl.mul(x2, x), gl.mul(x2, x2))


def _m4(b: torch.Tensor) -> torch.Tensor:
    """M4 on the trailing axis of 4, by its addition chain."""
    x0, x1, x2, x3 = b.unbind(-1)
    t0 = gl.add(x0, x1)
    t1 = gl.add(x2, x3)
    t2 = gl.add(gl.add(x1, x1), t1)
    t3 = gl.add(gl.add(x3, x3), t0)
    t1x4 = gl.add(gl.add(t1, t1), gl.add(t1, t1))
    t0x4 = gl.add(gl.add(t0, t0), gl.add(t0, t0))
    t4 = gl.add(t1x4, t3)
    t5 = gl.add(t0x4, t2)
    return torch.stack([gl.add(t3, t5), t5, gl.add(t2, t4), t4], dim=-1)


def _external(state: torch.Tensor) -> torch.Tensor:
    blocks = _m4(state.reshape(state.shape[:-1] + (3, 4)))
    total = gl.add(gl.add(blocks[..., 0, :], blocks[..., 1, :]), blocks[..., 2, :])
    return gl.add(blocks, total.unsqueeze(-2)).reshape(state.shape)


def _internal(state: torch.Tensor, mu_m1: torch.Tensor) -> torch.Tensor:
    half = gl.add(state[..., :6], state[..., 6:])
    third = gl.add(half[..., :3], half[..., 3:])
    total = gl.add(gl.add(third[..., 0], third[..., 1]), third[..., 2])
    return gl.add(gl.mul(state, mu_m1), total.unsqueeze(-1))


def permute(state: torch.Tensor) -> torch.Tensor:
    """the permutation of a (..., 12) int64 tensor of canonical states."""
    ext, internal, mu_m1 = _device_constants(state.device)
    st = _external(state)
    for r in range(R_FULL // 2):
        st = _external(_sbox(gl.add(st, ext[r])))
    for r in range(R_PARTIAL):
        lane0 = _sbox(gl.add(st[..., 0], internal[r]))
        st = _internal(torch.cat([lane0.unsqueeze(-1), st[..., 1:]], dim=-1), mu_m1)
    for r in range(R_FULL // 2, R_FULL):
        st = _external(_sbox(gl.add(st, ext[r])))
    return st


def absorb(state: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """replace the rate lanes by `chunk` (..., 8), then permute."""
    return permute(torch.cat([chunk, state[..., RATE:]], dim=-1))


def hash_elements(values: torch.Tensor) -> torch.Tensor:
    """the length-specialised sponge of a 1-D element vector: the state after
    its zero-padded chunks (all 12 lanes)."""
    n = values.shape[0]
    state = torch.zeros(WIDTH, dtype=torch.int64, device=values.device)
    state[WIDTH - 1] = n
    pad = (-n) % RATE
    if pad:
        values = torch.cat([values, torch.zeros(pad, dtype=torch.int64, device=values.device)])
    for i in range(0, values.shape[0], RATE):
        state = absorb(state, values[i:i + RATE])
    return state
