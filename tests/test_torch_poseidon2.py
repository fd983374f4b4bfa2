"""The torch Poseidon2 (zkevm_circuits_tpu_torch/ops/poseidon2.py) against the
JAX package's permutation and sponge and `utils/poseidon2_ref`.

On the CPU the JAX `permutation` takes its `lax.scan` path, its plain
reference (the Pallas kernel in interpret mode hangs XLA:CPU, see
tests/test_poseidon2_pallas.py).  Tolerance: exact (u64 equality).

The CUDA kernel's own tests are in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest

from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops import poseidon2 as jp2
from zkevm_circuits_tpu.utils import poseidon2_ref
from zkevm_circuits_tpu_torch.ops import gf, poseidon2
from zkevm_circuits_tpu_torch.runtime import native
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


P = gf.MODULUS


def _states(seed, n):
    st = np.random.default_rng(seed).integers(0, P, size=(n, 12), dtype=np.uint64)
    edge = np.array([0, P - 1, (1 << 32) - 1, 1 << 32], dtype=np.uint64)
    st[: len(edge)] = edge[:, None]
    return st


def test_instance_id_pinned():
    assert poseidon2.INSTANCE_ID == jp2.INSTANCE_ID == 0x6354F5E6501D2929
    assert (poseidon2.EXT_RC, poseidon2.INT_RC, poseidon2.MU) == (jp2.EXT_RC, jp2.INT_RC, jp2.MU)


def test_plain_permutation_matches_jax_and_ref():
    st = _states(1, 64)
    got = gf.to_u64(poseidon2.permutation(gf.from_u64(st)))
    np.testing.assert_array_equal(
        got, np.asarray(jp2.permutation(jgf.from_u64(st)).astype_u64(), np.uint64))
    for b in range(8):
        assert [int(x) for x in got[b]] == poseidon2_ref.permutation([int(x) for x in st[b]])


def test_golden_pin():
    got = gf.to_u64(poseidon2.permutation(gf.from_u64(np.arange(12, dtype=np.uint64))))
    assert [int(x) for x in got[:4]] == [
        8375451536246023917, 1236755478162261938,
        1674308928158675145, 8949911864487308360,
    ]


def test_batch_shapes_and_cpu_dispatch():
    st = gf.from_u64(_states(2, 24).reshape(2, 3, 4, 12))
    out = poseidon2.permutation(st)
    assert out.shape == st.shape
    np.testing.assert_array_equal(
        gf.to_u64(out).reshape(24, 12),
        gf.to_u64(poseidon2.permutation_plain(st.reshape(24, 12))))


@pytest.mark.parametrize("n", [1, 4, 8, 9, 13, 16, 21])
@pytest.mark.parametrize("length_specialize", [True, False])
def test_hash_padded_matches_jax(n, length_specialize):
    vals = np.random.default_rng(n).integers(0, P, size=(3, n), dtype=np.uint64)
    got = gf.to_u64(poseidon2.hash_padded(gf.from_u64(vals), length_specialize))
    exp = jp2.hash_padded(jgf.from_u64(vals), length_specialize)
    np.testing.assert_array_equal(got, np.asarray(exp.astype_u64(), np.uint64))
    if length_specialize:
        assert [int(x) for x in got[0]] == poseidon2_ref.hash_padded([int(v) for v in vals[0]])


def test_native_runtime_matches_plain():
    st = _states(3, 32)
    np.testing.assert_array_equal(
        native.poseidon2_permute_batch(st),
        gf.to_u64(poseidon2.permutation(gf.from_u64(st))))


def test_native_strided_chains_are_boundaries_of_full_chains():
    rng = np.random.default_rng(4)
    enc = rng.integers(0, 1 << 56, size=(2, 32, 8), dtype=np.uint64)
    ex = np.ones((2, 32), np.uint8)
    ex[:, 29:] = 0
    init = np.zeros((2, 12), np.uint64)
    full = native.full_state_chains(enc, ex, init)
    strided = native.full_state_chains_strided(enc, ex, init, 8)
    np.testing.assert_array_equal(strided, full[:, ::8])
    # one step of the chain is an absorb with replacement
    step = poseidon2.absorb_round(gf.from_u64(enc[0, 0]), gf.from_u64(full[0, 0]))
    np.testing.assert_array_equal(gf.to_u64(step), full[0, 1])
