"""ecrecover (circuit type 7) in the torch port against the JAX package on
the CPU: one witness over six seeded calls that take every path of the
circuit — a valid signature, a zero message hash (u1 = 0, Q = u2 R), a high
s, r = 0, an x off the curve (the non-residue certificate) and an x overflow
past 2^256 — continuing a memory chain from a seeded state.

Exact equality: the witness (scalar, point and ladder columns), the
residual dict, the compact form, the port's evaluation of the JAX package's
witness, the recovered addresses against the host's `recover`;
chip_smoke.py's negative probe (a changed limb of one ladder row) fails the
same residuals at the same rows under both packages' evaluations.
"""

import numpy as np
import pytest

import chip_smoke
from torch_log_helpers import assert_same_residuals, failing_rows, jax_to_numpy
from torch_precompile_helpers import (
    assert_same_forms, assert_same_witness, call_row, init_state, key, to_jax,
)
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.base_structures.memory_query import MemoryQueries as JMemoryQueries
from zkevm_circuits_tpu.isa import system_params as jsp
from zkevm_circuits_tpu.models import ecrecover as jec

from zkevm_circuits_tpu_torch.models import ecrecover as ecr
from zkevm_circuits_tpu_torch.ops import secp256k1 as ec
from zkevm_circuits_tpu_torch.utils.convert import (
    ecrecover_witness_from_numpy, residuals_to_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
FIELDS = ("call_chain", "mem_chain")
QUERIES = dict(calls=JLogQueries, reads=JMemoryQueries, writes=JMemoryQueries)


def _signatures(rng):
    h = int.from_bytes(rng.bytes(32), "big")
    r, s, recid = ec.sign(h, 0xC0FFEE, 0x12345)
    off = r
    while ec.lift_x(off, False) is not None:
        off += 1
    return [
        (h, recid, r, s),                         # valid
        (0, recid, r, s),                         # zero hash: Q = u2 R
        (h, recid ^ 1, r, ec.N - s),              # high s
        (h, recid, 0, s),                         # r = 0
        (h, recid & 1, off, s),                   # x off the curve
        (h, recid | 2, (1 << 256) - ec.N + 5, s),  # r + n overflows 256 bits
    ]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    memory, calls, sigs = {}, [], _signatures(rng)
    for ci, sig in enumerate(sigs):
        for j, value in enumerate(sig):
            memory[(3, 4 * ci + j)] = value.to_bytes(32, "big")
        calls.append(call_row(jsp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS,
                              key([4 * ci, 0, 50 + 2 * ci, 0, 3, 4, 0, 0]), 100 + 4 * ci))
    init = init_state(7)
    cfg, jcfg = ecr.EcrecoverConfig(len(calls)), jec.EcrecoverConfig(len(calls))
    jw = jec.generate_witness(calls, memory, jcfg, mem_init_state=init)
    w = ecr.generate_witness(calls, memory, cfg, mem_init_state=init, device=CPU)
    want = {k: np.asarray(v) for k, v in jec.eval_constraints(jw, jcfg).items()}
    return sigs, jw, w, want


def test_witness_residuals_and_form_equal_jax(case):
    sigs, jw, w, want = case
    cfg, jcfg = ecr.EcrecoverConfig(len(sigs)), jec.EcrecoverConfig(len(sigs))
    assert_same_witness(w, jw, FIELDS)
    assert not failing_rows(want)
    assert_same_residuals(residuals_to_numpy(ecr.eval_constraints(w, cfg)), want)
    carried = ecrecover_witness_from_numpy(jax_to_numpy(jw), device=CPU)
    assert_same_residuals(residuals_to_numpy(ecr.eval_constraints_jit(carried, cfg)), want)
    assert_same_forms(ecr.instance_compact_form(w, cfg), jec.instance_compact_form(jw, jcfg))
    # the two valid calls recover the signer; every exception masks both words
    valid = w.scalars["call_valid"].tolist()
    assert valid == [1, 1, 0, 0, 0, 0]
    for ci, (h, v, r, s) in enumerate(sigs[:2]):
        addr = sum(int(x) << (32 * k) for k, x in enumerate(w.addresses[ci].tolist()))
        assert addr == ec.eth_address(ec.recover(h, r, s, v))
    assert int(w.writes.value[4:].abs().sum()) == 0
    assert int(w.scalars["nonres"][4]) == 1


def test_analyze_call_is_the_jax_oracle(case):
    for sig in case[0]:
        assert ecr._analyze_call(*sig) == jec._analyze_call(*sig)


def test_changed_ladder_limb_fails_as_in_jax(case):
    sigs, _, w, _ = case
    forged, want = chip_smoke.probe_ecrecover_ladder(w)
    cfg = ecr.EcrecoverConfig(len(sigs))
    assert failing_rows(residuals_to_numpy(ecr.eval_constraints(forged, cfg))) == want
    jforged = to_jax(jec.EcrecoverWitness, witness_to_numpy(forged, FIELDS), FIELDS, QUERIES)
    assert failing_rows(jec.eval_constraints(jforged, jec.EcrecoverConfig(len(sigs)))) == want
