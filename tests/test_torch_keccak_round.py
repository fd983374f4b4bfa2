"""The keccak precompile (circuit type 5) in the torch port against the JAX
package on the CPU, on seeded calls whose payloads start unaligned, cross
a rate block, fill one exactly (the full padding block), take 135 bytes
(the fused 0x81 pad) and none, continuing a memory chain from a seeded state.

Exact equality: the witness, the residual dict, the multi-instance compact
forms (instances of 4 blocks, boundaries mid-call and at call starts) and
the single-instance one, the port's evaluation of the JAX package's
witness, the call payloads; chip_smoke.py's negative probes (a changed
digest byte, a changed hidden-FSM boundary) fail where the JAX package's
evaluation and chaining fail.
"""

import numpy as np
import pytest

import chip_smoke
from torch_log_helpers import assert_same_residuals, failing, failing_rows, jax_to_numpy
from torch_precompile_helpers import (
    assert_same_forms, assert_same_witness, call_row, init_state, key, to_jax,
)
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.base_structures.memory_query import MemoryQueries as JMemoryQueries
from zkevm_circuits_tpu.isa import system_params as jsp
from zkevm_circuits_tpu.models import keccak256_round_function as jkc
from zkevm_circuits_tpu.utils import protocol as jprotocol

from zkevm_circuits_tpu_torch.models import keccak256_round_function as kc
from zkevm_circuits_tpu_torch.utils.convert import (
    keccak_round_witness_from_numpy, residuals_to_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
BLOCKS, READS = 16, 48
LIMIT = 4
FIELDS = ("call_chain", "mem_chain", "mem_order_encodings")
QUERIES = dict(calls=JLogQueries, reads=JMemoryQueries, writes=JMemoryQueries)
SPANS = [(5, 64), (0, 136), (33, 300), (0, 0), (7, 135), (100, 544)]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    memory, calls = {}, []
    for ci, (off, length) in enumerate(SPANS):
        base = 40 * ci * 32
        for wi in range((base + off) // 32, (base + off + length) // 32 + 1):
            memory[(9, wi)] = rng.bytes(32)
        calls.append(call_row(jsp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS,
                              key([base + off, length, 200 + ci, 0, 9, 11, 0, 0]), 30 + 4 * ci))
    init = init_state(5)
    cfg, jcfg = kc.KeccakRoundFunctionConfig(BLOCKS, READS), jkc.KeccakRoundFunctionConfig(BLOCKS, READS)
    jw = jkc.generate_witness(calls, memory, jcfg, mem_init_state=init)
    w = kc.generate_witness(calls, memory, cfg, mem_init_state=init, device=CPU)
    want = {k: np.asarray(v) for k, v in jkc.eval_constraints(jw, jcfg).items()}
    return calls, memory, jw, w, want


def test_witness_residuals_and_forms_equal_jax(case):
    calls, memory, jw, w, want = case
    cfg, jcfg = kc.KeccakRoundFunctionConfig(BLOCKS, READS), jkc.KeccakRoundFunctionConfig(BLOCKS, READS)
    assert_same_witness(w, jw, FIELDS)
    assert not failing(want)
    assert int(w.block_execute.sum()) == 13
    assert_same_residuals(residuals_to_numpy(kc.eval_constraints(w, cfg)), want)
    carried = keccak_round_witness_from_numpy(jax_to_numpy(jw), device=CPU)
    assert_same_residuals(residuals_to_numpy(kc.eval_constraints_jit(carried, cfg)), want)
    assert_same_forms(kc.instance_compact_forms(w, cfg, LIMIT),
                      jkc.instance_compact_forms(jw, jcfg, LIMIT))
    assert_same_forms(kc.instance_compact_form(w, cfg), jkc.instance_compact_form(jw, jcfg))
    assert kc.call_payloads(calls, memory) == jkc.call_payloads(calls, memory)


def test_changed_digest_byte_fails_as_in_jax(case):
    *_, w, _ = case
    forged, want = chip_smoke.probe_keccak_digest(w)
    cfg = kc.KeccakRoundFunctionConfig(BLOCKS, READS)
    assert failing_rows(residuals_to_numpy(kc.eval_constraints(forged, cfg))) == want
    jforged = to_jax(jkc.KeccakRoundWitness, witness_to_numpy(forged, FIELDS), FIELDS, QUERIES)
    assert failing_rows(jkc.eval_constraints(
        jforged, jkc.KeccakRoundFunctionConfig(BLOCKS, READS))) == want


def test_changed_fsm_boundary_fails_the_chaining_as_in_jax(case):
    """the hidden FSM input of instance 2 from a witness whose state at that
    boundary changed: the port's chaining and the JAX package's (on the JAX
    package's forms of the same two witnesses) fail between instances 1 and 2"""
    *_, jw, w, _ = case
    cfg = kc.KeccakRoundFunctionConfig(BLOCKS, READS)
    chain, want = chip_smoke.probe_keccak_boundary(w, cfg, LIMIT)
    assert failing_rows(residuals_to_numpy(chain)) == want
    jcfg = jkc.KeccakRoundFunctionConfig(BLOCKS, READS)
    forms = jkc.instance_compact_forms(jw, jcfg, LIMIT)
    fields = witness_to_numpy(w, FIELDS)
    fields["state_lo"] = fields["state_lo"].copy()
    fields["state_lo"][2 * LIMIT, 0] ^= 1
    forged = jkc.instance_compact_forms(to_jax(jkc.KeccakRoundWitness, fields, FIELDS, QUERIES),
                                        jcfg, LIMIT)
    fsm_in = forms.hidden_fsm_input_commitment
    fsm_in = type(fsm_in)(fsm_in.lo.at[2].set(forged.hidden_fsm_input_commitment.lo[2]),
                          fsm_in.hi.at[2].set(forged.hidden_fsm_input_commitment.hi[2]))
    jchain = jprotocol.check_instance_chaining(forms.start_flag, forms.completion_flag, fsm_in,
                                               forms.hidden_fsm_output_commitment)
    assert failing_rows(jchain) == want
