"""The torch Goldilocks field (zkevm_circuits_tpu_torch/ops/gf.py) against the
JAX package's `ops/gf.py` and `gf.gf_ref`, on the same numpy inputs.

Tolerance: exact.  Both sides are integer field arithmetic, so every
comparison is equality of u64 bit patterns, including the non-canonical
outputs of the lazy forms.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops.gf import gf_ref
from zkevm_circuits_tpu_torch.ops import gf
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


P = gf.MODULUS
EDGES = [0, 1, 2, P - 1, P - 2, 0xFFFFFFFF, 0x100000000, P >> 1, 1 << 63, 0xFFFFFFFE00000002]


def _canonical(seed, n=512):
    vals = np.random.default_rng(seed).integers(0, P, size=n, dtype=np.uint64)
    vals[: len(EDGES)] = np.array(EDGES, dtype=np.uint64)
    return vals


def _any_u64(seed, n=512):
    """full-range u64 inputs (the lazy forms take any bit pattern)."""
    vals = np.random.default_rng(seed).integers(0, 1 << 64, size=n, dtype=np.uint64)
    vals[: len(EDGES) + 3] = np.array(
        EDGES + [P, P + 1, (1 << 64) - 1], dtype=np.uint64)
    return vals


def _jgf_raw(u64):
    """JAX GF holding the exact bits (no reduction mod p)."""
    return jgf.GF(jnp.asarray((u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                  jnp.asarray((u64 >> np.uint64(32)).astype(np.uint32)))


def _t(u64):
    return torch.from_numpy(np.ascontiguousarray(u64).view(np.int64))


def _jax_u64(x):
    return np.asarray(x.astype_u64(), np.uint64)


BINARY = {
    "add": (gf.add, jgf.add, gf_ref.add),
    "sub": (gf.sub, jgf.sub, gf_ref.sub),
    "mul": (gf.mul, jgf.mul, gf_ref.mul),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_match_jax_and_ref(name):
    ours, theirs, ref = BINARY[name]
    a = _canonical(1)
    b = np.random.default_rng(2).permutation(_canonical(3))
    got = gf.to_u64(ours(gf.from_u64(a), gf.from_u64(b)))
    np.testing.assert_array_equal(got, _jax_u64(theirs(jgf.from_u64(a), jgf.from_u64(b))))
    assert [int(v) for v in got] == [ref(int(x), int(y)) for x, y in zip(a, b)]


def test_mul_edge_grid():
    a = np.array([x for x in EDGES for _ in EDGES], dtype=np.uint64)
    b = np.array(EDGES * len(EDGES), dtype=np.uint64)
    got = gf.to_u64(gf.mul(gf.from_u64(a), gf.from_u64(b)))
    assert [int(v) for v in got] == [gf_ref.mul(int(x), int(y)) for x, y in zip(a, b)]


UNARY = {
    "neg": (gf.neg, jgf.neg, gf_ref.neg),
    "square": (gf.square, jgf.square, lambda x: x * x % P),
    "inv": (gf.inv, jgf.inv, gf_ref.inv),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_ops_match_jax_and_ref(name):
    ours, theirs, ref = UNARY[name]
    a = _canonical(4, n=256 if name == "inv" else 512)
    got = gf.to_u64(ours(gf.from_u64(a)))
    np.testing.assert_array_equal(got, _jax_u64(theirs(jgf.from_u64(a))))
    assert [int(v) for v in got] == [ref(int(x)) for x in a]


@pytest.mark.parametrize("name", ["add_lazy", "mul_lazy"])
def test_lazy_forms_bit_identical_on_any_u64(name):
    a, b = _any_u64(5), np.random.default_rng(6).permutation(_any_u64(7))
    got = gf.to_u64(getattr(gf, name)(_t(a), _t(b)))
    np.testing.assert_array_equal(got, _jax_u64(getattr(jgf, name)(_jgf_raw(a), _jgf_raw(b))))
    op = (lambda x, y: x + y) if name == "add_lazy" else (lambda x, y: x * y)
    assert [int(v) % P for v in got] == [op(int(x), int(y)) % P for x, y in zip(a, b)]


def test_canonicalize_any_u64():
    a = _any_u64(8)
    got = gf.to_u64(gf.canonicalize(_t(a)))
    np.testing.assert_array_equal(got, _jax_u64(jgf.canonicalize(_jgf_raw(a))))
    assert [int(v) for v in got] == [int(x) % P for x in a]


@pytest.mark.parametrize("c", [0, 1, 7, P - 1, 1 << 40])
def test_mul_const(c):
    a = _canonical(9, n=64)
    got = gf.to_u64(gf.mul_const(gf.from_u64(a), c))
    np.testing.assert_array_equal(got, _jax_u64(jgf.mul_const(jgf.from_u64(a), c)))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 12345, P - 2])
def test_pow_const(e):
    a = _canonical(10, n=64)
    got = gf.to_u64(gf.pow_const(gf.from_u64(a), e))
    assert [int(v) for v in got] == [pow(int(x), e, P) for x in a]
    if e <= 7:
        np.testing.assert_array_equal(got, _jax_u64(jgf.pow_const(jgf.from_u64(a), e)))


@pytest.mark.parametrize("base,n", [(7, 1), (7, 64), (P - 1, 16), (0x12345678ABCDEF, 256)])
def test_geometric(base, n):
    got = gf.to_u64(gf.geometric(base, n))
    np.testing.assert_array_equal(got, _jax_u64(jgf.geometric(base, n)))


@pytest.mark.parametrize("shape,axis", [((37,), -1), ((5, 12), -1), ((9, 4), 0)])
def test_sum_mod(shape, axis):
    a = _canonical(11, n=int(np.prod(shape))).reshape(shape)
    got = gf.to_u64(gf.sum_mod(gf.from_u64(a), dim=axis))
    np.testing.assert_array_equal(got, _jax_u64(jgf.sum_mod(jgf.from_u64(a), axis=axis)))


def test_select():
    a, b = _canonical(12, n=64), _canonical(13, n=64)
    mask = np.random.default_rng(14).integers(0, 2, size=64).astype(bool)
    got = gf.to_u64(gf.select(torch.from_numpy(mask), gf.from_u64(a), gf.from_u64(b)))
    np.testing.assert_array_equal(
        got, _jax_u64(jgf.select(jnp.asarray(mask), jgf.from_u64(a), jgf.from_u64(b))))


def test_from_u64_reduces_and_round_trips():
    a = _any_u64(15)
    t = gf.from_u64(a)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(gf.to_u64(t), _jax_u64(jgf.from_u64(a)))
    np.testing.assert_array_equal(gf.to_u64(gf.from_u64(gf.to_u64(t))), gf.to_u64(t))


def test_constants():
    assert (gf.MODULUS, gf.MULTIPLICATIVE_GENERATOR, gf.TWO_ADICITY) == (
        jgf.MODULUS, jgf.MULTIPLICATIVE_GENERATOR, jgf.TWO_ADICITY)
