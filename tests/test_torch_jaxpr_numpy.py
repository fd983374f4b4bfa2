"""The numpy evaluator of JAX programs (tests/torch_jaxpr_numpy.py), which
the circuit-AIR parity tests run the JAX package's wide compositions and
provers through, against XLA on JAX functions that XLA:CPU compiles in
seconds: the same bits."""

import numpy as np
import pytest

import jax
from torch_jaxpr_numpy import NumpyJit, numpy_jit
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops import merkle as jmerkle
from zkevm_circuits_tpu.ops import ntt as jntt
from zkevm_circuits_tpu.ops import poseidon2 as jp2
from zkevm_circuits_tpu.prover import stark as jstark
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

P = (1 << 64) - (1 << 32) + 1


def _gf(rng, *shape):
    # canonical values and the non-canonical top of the u64 range
    x = rng.integers(0, P, size=shape, dtype=np.uint64)
    x.reshape(-1)[:3] = [P - 1, P, (1 << 64) - 1][: x.size]
    return jgf.from_u64(x)


CASES = {
    "gf arithmetic": lambda r: (lambda a, b: [jgf.mul(a, b), jgf.add(a, b), jgf.sub(a, b),
                                              jgf.inv(a), jgf.pow_const(b, 0x12345)],
                                (_gf(r, 64), _gf(r, 64))),
    "poseidon2 permutation": lambda r: (jp2.permutation, (_gf(r, 37, 12),)),
    "hash_padded": lambda r: (lambda x: jp2.hash_padded(x), (_gf(r, 5, 19),)),
    "ntt and lde": lambda r: (lambda x: [jntt.ntt(x), jntt.lde(x, 2)], (_gf(r, 3, 16),)),
    "merkle leaves": lambda r: (jmerkle.hash_leaves, (_gf(r, 9, 16),)),
    "alpha powers": lambda r: (lambda a: jstark._alpha_powers(a, 9), (_gf(r),)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_evaluation_equals_xla(case):
    fn, args = CASES[case](np.random.default_rng(len(case)))
    want = jax.tree_util.tree_leaves(jax.jit(fn)(*args))
    got = jax.tree_util.tree_leaves(NumpyJit(jax.jit(fn))(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_numpy_jit_puts_everything_back():
    real = jax.jit, jstark._compose_rows
    with numpy_jit():
        assert isinstance(jstark._compose_rows, NumpyJit) and jax.jit is not real[0]
    assert (jax.jit, jstark._compose_rows) == real
    with numpy_jit(("_compose_rows",)):
        assert isinstance(jstark._compose_rows, NumpyJit) and jax.jit is real[0]
    assert jstark._compose_rows is real[1]
