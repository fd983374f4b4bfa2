"""secp256k1 host-side arithmetic (witness generation + table oracle): a copy
of the JAX package's `ops/secp256k1.py`, which the port may not import (the
Python EraVM's ecrecover host execution needs it).

Reference parity: the out-of-circuit curve implementation bundled with the
reference's ecrecover circuit (`src/ecrecover/secp256k1/mod.rs` — used there
for test-signature generation and fixed-base table construction).  Pure
python ints; the in-circuit counterpart is the non-native limb arithmetic in
ops/nonnative.py + models/ecrecover.py.
"""

from __future__ import annotations

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
A = 0
B = 7

INF = None


def is_on_curve(pt) -> bool:
    if pt is INF:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def add(p1, p2):
    if p1 is INF:
        return p2
    if p2 is INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return INF
        return double(p1)
    lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def double(pt):
    if pt is INF:
        return INF
    x, y = pt
    if y == 0:
        return INF
    lam = 3 * x * x * pow(2 * y, P - 2, P) % P
    x3 = (lam * lam - 2 * x) % P
    y3 = (lam * (x - x3) - y) % P
    return (x3, y3)


def mul(k: int, pt):
    k %= N
    acc = INF
    base = pt
    while k:
        if k & 1:
            acc = add(acc, base)
        base = double(base)
        k >>= 1
    return acc


def lift_x(x: int, odd: bool):
    """recover y with the requested parity; None if x not on curve."""
    y2 = (x * x * x + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != int(odd):
        y = P - y
    return (x, y)


def recover(digest: int, r: int, s: int, recid: int):
    """ECDSA public-key recovery; returns the affine point or None."""
    if not (1 <= r < N and 1 <= s < N):
        return None
    x = r + (recid >> 1) * N
    if x >= P:
        return None
    R = lift_x(x, odd=bool(recid & 1))
    if R is None:
        return None
    r_inv = pow(r, N - 2, N)
    u1 = (-digest * r_inv) % N
    u2 = (s * r_inv) % N
    Q = add(mul(u1, (GX, GY)), mul(u2, R))
    if Q is INF:
        return None
    return Q


def sign(digest: int, priv: int, k: int):
    """Deterministic-k test signing; returns (r, s, recid).

    s is normalized to the low-s convention the circuit enforces
    (s < (n-1)/2 — ref new_optimized.rs:927-932); the parity bit of recid
    flips with the negation."""
    R = mul(k, (GX, GY))
    r = R[0] % N
    assert r != 0
    s = pow(k, N - 2, N) * (digest + r * priv) % N
    assert s != 0
    recid = (R[1] & 1) | (2 if R[0] >= N else 0)
    if s >= (N - 1) // 2:
        s = N - s
        recid ^= 1
    return r, s, recid


def eth_address(Q) -> int:
    from .keccak import keccak256_ref

    x, y = Q
    h = keccak256_ref(x.to_bytes(32, "big") + y.to_bytes(32, "big"))
    return int.from_bytes(h[12:], "big")
