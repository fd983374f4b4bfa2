"""Non-native 256-bit identity checking: the torch port against the JAX
package on the same seeded limbs, exactly (bool arrays, digit by digit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.ops import nonnative as jnn

from zkevm_circuits_tpu_torch.ops import nonnative as nn
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

SECP_P = (1 << 256) - (1 << 32) - 977


def _ints(seed, n, bits=256):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]


def t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_limb_conversions_agree():
    xs = _ints(1, 5) + [0, 1, (1 << 256) - 1]
    assert np.array_equal(nn.from_ints(xs), jnn.from_ints(xs))
    assert np.array_equal(nn.from_int(xs[0], 17), jnn.from_int(xs[0], 17))
    assert [nn.to_int(t(nn.from_int(x))) for x in xs] == xs
    with pytest.raises(ValueError):
        nn.from_int(1 << 256)
    assert nn.mulmod_witness(xs[0], xs[1], SECP_P) == jnn.mulmod_witness(xs[0], xs[1], SECP_P)


@pytest.mark.parametrize("modulus", [SECP_P, (1 << 255) - 19])
def test_check_mulmod_matches_jax(modulus):
    a, b = _ints(2, 6), _ints(3, 6)
    qr = [divmod(x * y, modulus) for x, y in zip(a, b)]
    r = [v[1] for v in qr]
    r[1] = (r[1] + 1) % modulus  # wrong remainder
    q = [v[0] for v in qr]
    q[4] ^= 1 << 200  # wrong quotient
    args = (nn.from_ints(a), nn.from_ints(b), nn.from_ints(q, 17), nn.from_ints(r))
    want = np.asarray(jnn.check_mulmod(*[jnp.asarray(x) for x in args], modulus))
    got = nn.check_mulmod(*[t(x) for x in args], modulus).numpy()
    assert np.array_equal(got, want)
    assert got.tolist() == [True, False, True, True, False, True]


def test_sides_equal_and_digits_match_jax():
    """The three term kinds, multipliers, and limbs above the u16 range (the
    u32 wrap of the JAX package's partial products is reproduced)."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 16, size=(4, 16), dtype=np.uint32)
    b = rng.integers(0, 1 << 16, size=(4, 16), dtype=np.uint32)
    x = rng.integers(0, 1 << 32, size=(4, 16), dtype=np.uint32)
    a[3, 5] = 0xFFFFFFFF  # out of range on purpose
    b[3, 7] = 0xFFFF0001
    const = (1 << 300) + 12345

    def terms(conv):
        return ([("prod", conv(a), conv(b), 3), ("lin", conv(x), 2), ("const", const)],
                [("prod", conv(b), conv(a), 3), ("const", const), ("lin", conv(x), 2)])

    jl, jr = terms(jnp.asarray)
    tl, tr = terms(t)
    want = [np.asarray(d) for d in jnn._side_digits(jl, 34, (4,))]
    got = [d.numpy() for d in nn._side_digits(tl, 34, (4,), torch.device("cpu"))]
    assert len(got) == len(want) == 36
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    assert nn.sides_equal(tl, tr, (4,), ncoef=34).all()
    assert np.asarray(jnn.sides_equal(jl, jr, (4,), ncoef=34)).all()
    tl[1] = ("lin", t(x), 1)
    jl[1] = ("lin", jnp.asarray(x), 1)
    assert np.array_equal(nn.sides_equal(tl, tr, (4,), ncoef=34).numpy(),
                          np.asarray(jnn.sides_equal(jl, jr, (4,), ncoef=34)))


def test_range_and_compare_match_jax():
    rng = np.random.default_rng(5)
    limbs = rng.integers(0, 1 << 16, size=(6, 16), dtype=np.uint32)
    limbs[2, 9] = 1 << 16
    assert np.array_equal(nn.check_range(t(limbs)).numpy(),
                          np.asarray(jnn.check_range(jnp.asarray(limbs))))
    vals = _ints(6, 4) + [SECP_P, SECP_P - 1]
    arr = nn.from_ints(vals)
    got = nn.limbs_lt(t(arr), SECP_P).numpy()
    assert np.array_equal(got, np.asarray(jnn.limbs_lt(jnp.asarray(arr), SECP_P)))
    assert got.tolist() == [v < SECP_P for v in vals]
