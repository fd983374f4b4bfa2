"""The port's logUp lookup STARK (prover/logup.py), the package's one AIR with
fixed (verifier-known) columns, against the JAX package.

Exact u64 equality with the JAX package for the trace (`lookup_trace`: the
fixed table columns, the queries, the active flags, the multiplicities) on
a small 3-wide table, on the VM's 2^11-row opcode decode table and on a
16-bit range table, and for the phase-2 columns (inv_q, inv_t, acc) under
given challenges.  The port's own proofs on the CPU with the JAX package's
tamper cases (tests/test_logup.py): a forged query and a changed table are
rejected, a query outside the table makes the prover raise ValueError.
"""

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.prover import logup as jlogup
from zkevm_circuits_tpu_torch.isa import opcodes as isa
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import logup
from zkevm_circuits_tpu_torch.prover.stark import StarkParams, prove
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CHALLENGES = [(0x1234567, 0x89ABCDEF), (5, 0), (gf.MODULUS - 1, gf.MODULUS - 2)]


def _u64(x):
    return np.asarray(x.astype_u64(), np.uint64)


def small_table():
    """3-wide tuples, 8 rows (tests/test_logup.py)"""
    return np.array([[i, (i * 7 + 1) % 97, (i * i) % 61] for i in range(8)], np.uint64).T


def decode_table():
    idx = np.arange(1 << isa.OPCODES_TABLE_WIDTH, dtype=np.uint64)
    return np.stack([idx, isa.OPCODES_PRICES.astype(np.uint64),
                     isa.OPCODES_PROPS_INTEGER_BITMASKS.astype(np.uint64)])


def range_table():
    return np.arange(1 << 16, dtype=np.uint64)[None]


def _case(name):
    rng = np.random.default_rng(len(name))
    table = {"small": small_table, "decode": decode_table, "range16": range_table}[name]()
    count = {"small": 13, "decode": 40, "range16": 1 << 12}[name]
    return table, table[:, rng.integers(0, table.shape[1], size=count)]


CASES = ["small", "decode", "range16"]


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for name in CASES:
        table, queries = _case(name)
        fixed, phase1, m, log_n = jlogup.lookup_trace(table, queries)
        trace = jgf.concat([fixed, phase1], axis=0)
        build = jlogup._build_phase2(table.shape[0])
        out[name] = dict(fixed=_u64(fixed), phase1=_u64(phase1), m=m, log_n=log_n,
                         phase2=[_u64(build(trace, ch)) for ch in CHALLENGES])
    return out


@pytest.mark.parametrize("name", CASES)
def test_lookup_trace_matches_jax(jax_side, name):
    fixed, phase1, m, log_n = logup.lookup_trace(*_case(name), device="cpu")
    j = jax_side[name]
    assert log_n == j["log_n"]
    np.testing.assert_array_equal(gf.to_u64(fixed), j["fixed"])
    np.testing.assert_array_equal(gf.to_u64(phase1), j["phase1"])
    np.testing.assert_array_equal(m, j["m"])


@pytest.mark.parametrize("ch", range(len(CHALLENGES)))
@pytest.mark.parametrize("name", CASES)
def test_phase2_columns_match_jax(jax_side, name, ch):
    table, queries = _case(name)
    fixed, phase1, _, _ = logup.lookup_trace(table, queries, device="cpu")
    cols = logup._build_phase2(table.shape[0])(torch.cat([fixed, phase1]), CHALLENGES[ch])
    np.testing.assert_array_equal(gf.to_u64(cols), jax_side[name]["phase2"][ch])


def test_lookup_air_matches_jax():
    for c in (1, 3):
        air, jair = logup.lookup_air(c), jlogup.lookup_air(c)
        assert (air.num_cols, air.num_fixed_cols, air.num_phase2_cols, air.num_challenges,
                air.max_degree) == (jair.num_cols, jair.num_fixed_cols, jair.num_phase2_cols,
                                    jair.num_challenges, jair.max_degree)


@pytest.fixture(scope="module")
def proven():
    table, queries = _case("small")
    proof, params = logup.prove_lookup(table, queries, device="cpu")
    return table, proof, params


def test_lookup_accepts(proven):
    table, proof, params = proven
    assert len(proof.caps) == 3  # fixed, phase 1, phase 2
    assert logup.verify_lookup(proof, table, params)


def test_lookup_rejects_wrong_table(proven):
    """the proof is bound to THE table: the fixed cap is recomputed"""
    table, proof, params = proven
    other = table.copy()
    other[2, 7] ^= np.uint64(1)
    assert not logup.verify_lookup(proof, other, params)
    assert not logup.verify_lookup(proof, np.concatenate([table, table], axis=1), params)


def test_lookup_rejects_forged_query():
    """an off-table query with forged multiplicities: the composition is no
    polynomial, so the prover's FRI refuses it, and a proof made anyway must
    not verify"""
    table = small_table()
    queries = table[:, [0, 1, 2, 3]].copy()
    queries[1, 2] = 9999
    c, n = table.shape[0], 8
    m = np.zeros(n, np.uint64)
    m[[0, 1, 2, 3]] = 1
    active = np.zeros(n, np.uint64)
    active[:4] = 1
    phase1 = gf.from_u64(np.concatenate([logup._pad_pow2(queries, n), active[None], m[None]]))
    params = StarkParams(log_n=3)
    try:
        proof = prove(phase1, logup.lookup_air(c), params, build_phase2=logup._build_phase2(c),
                      fixed_cols=gf.from_u64(logup._pad_pow2(table, n)))
    except ValueError:
        return
    assert not logup.verify_lookup(proof, table, params)


def test_lookup_query_not_in_table_raises():
    table = small_table()
    queries = table[:, [0]].copy()
    queries[0, 0] = 77777
    with pytest.raises(ValueError):
        logup.lookup_trace(table, queries, device="cpu")
