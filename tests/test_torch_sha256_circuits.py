"""The sha256 precompile (circuit type 6) and the code unpacker (type 3) in
the torch port against the JAX package on the CPU, on seeded calls and
bytecodes, each continuing a memory chain from a seeded state.

Exact equality: the witness, the residual dict, the multi-instance compact
forms (instances of 4 rounds, so that boundaries fall mid-call) and the
single-instance one, the port's evaluation of the JAX package's witness;
chip_smoke.py's negative probes (a changed round state word, a changed
unpacked code word) fail the same residuals at the same rows under both
packages' evaluations.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from torch_log_helpers import assert_same_residuals, failing, failing_rows, jax_to_numpy
from torch_precompile_helpers import (
    assert_same_forms, assert_same_witness, call_row, init_state, key, to_jax,
)
from zkevm_circuits_tpu.base_structures.decommit_query import DecommitQueries as JDecommitQueries
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.base_structures.memory_query import MemoryQueries as JMemoryQueries
from zkevm_circuits_tpu.isa import system_params as jsp
from zkevm_circuits_tpu.models import code_unpacker_sha256 as jcu
from zkevm_circuits_tpu.models import sha256_round_function as jsh

from zkevm_circuits_tpu_torch.models import code_unpacker_sha256 as cu
from zkevm_circuits_tpu_torch.models import sha256_round_function as sh
from zkevm_circuits_tpu_torch.utils.convert import (
    code_unpacker_witness_from_numpy, residuals_to_numpy, sha256_round_witness_from_numpy,
    witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
ROUNDS = 12
LIMIT = 4
SHA_FIELDS = ("call_chain", "mem_chain", "mem_order_encodings")
SHA_QUERIES = dict(calls=JLogQueries, reads=JMemoryQueries, writes=JMemoryQueries)
CU_FIELDS = ("request_chain", "mem_chain")
CU_QUERIES = dict(requests=JDecommitQueries, writes=JMemoryQueries)


@pytest.fixture(scope="module")
def sha():
    """three calls of 1, 4 and 3 rounds (pre-padded input words at arbitrary
    word offsets of page 5, digests to page 6), from a seeded memory state"""
    rng = np.random.default_rng(6)
    memory, calls = {}, []
    for ci, nr in enumerate((1, 4, 3)):
        base = 20 * ci + 3
        for j in range(2 * nr):
            memory[(5, base + j)] = rng.bytes(32)
        calls.append(call_row(jsp.SHA256_PRECOMPILE_FORMAL_ADDRESS,
                              key([base, 0, 100 + ci, 0, 5, 6, nr, 0]), 10 + 4 * ci))
    init = init_state(6)
    cfg, jcfg = sh.Sha256RoundFunctionConfig(ROUNDS), jsh.Sha256RoundFunctionConfig(ROUNDS)
    jw = jsh.generate_witness(calls, memory, jcfg, mem_init_state=init)
    w = sh.generate_witness(calls, memory, cfg, mem_init_state=init, device=CPU)
    want = {k: np.asarray(v) for k, v in jsh.eval_constraints(jw, jcfg).items()}
    return calls, memory, init, jw, w, want


def test_sha256_witness_residuals_and_forms_equal_jax(sha):
    calls, memory, init, jw, w, want = sha
    cfg, jcfg = sh.Sha256RoundFunctionConfig(ROUNDS), jsh.Sha256RoundFunctionConfig(ROUNDS)
    assert_same_witness(w, jw, SHA_FIELDS)
    assert not failing(want)
    assert_same_residuals(residuals_to_numpy(sh.eval_constraints(w, cfg)), want)
    carried = sha256_round_witness_from_numpy(jax_to_numpy(jw), device=CPU)
    assert_same_residuals(residuals_to_numpy(sh.eval_constraints_jit(carried, cfg)), want)
    assert_same_forms(sh.instance_compact_forms(w, cfg, LIMIT),
                      jsh.instance_compact_forms(jw, jcfg, LIMIT))
    assert_same_forms(sh.instance_compact_form(w, cfg), jsh.instance_compact_form(jw, jcfg))
    # the step loop builds the same chains as the native runtime
    stepped = sh.generate_witness(calls, memory, cfg, mem_init_state=init, backend="device",
                                  device=CPU)
    assert torch.equal(stepped.mem_chain, w.mem_chain)
    assert torch.equal(stepped.call_chain, w.call_chain)


def test_sha256_changed_state_word_fails_as_in_jax(sha):
    *_, w, _ = sha
    forged, want = chip_smoke.probe_sha256_state(w)
    cfg = sh.Sha256RoundFunctionConfig(ROUNDS)
    assert failing_rows(residuals_to_numpy(sh.eval_constraints(forged, cfg))) == want
    jforged = to_jax(jsh.Sha256RoundWitness, witness_to_numpy(forged, SHA_FIELDS), SHA_FIELDS,
                     SHA_QUERIES)
    jcfg = jsh.Sha256RoundFunctionConfig(ROUNDS)
    assert failing_rows(jsh.eval_constraints(jforged, jcfg)) == want


def test_sha256_rounds_that_do_not_fit_raise(sha):
    calls, memory, *_ = sha
    with pytest.raises(ValueError):
        sh.generate_witness(calls, memory, sh.Sha256RoundFunctionConfig(4), device=CPU)


@pytest.fixture(scope="module")
def unpacker():
    """three bytecodes of 5, 9 and 3 words (10 rounds), continuing a memory chain"""
    rng = np.random.default_rng(3)
    store, requests = {}, []
    for q, n_words in enumerate((5, 9, 3)):
        code = [int.from_bytes(rng.bytes(32), "big") for _ in range(n_words)]
        req = cu.make_request(code, 100 + q, 7 + q)
        assert req == jcu.make_request(code, 100 + q, 7 + q)
        store[req["code_hash"]] = code
        requests.append(req)
    init = init_state(3)
    cfg, jcfg = cu.CodeUnpackerConfig(ROUNDS), jcu.CodeUnpackerConfig(ROUNDS)
    jw = jcu.generate_witness(requests, store, jcfg, mem_init_state=init)
    w = cu.generate_witness(requests, store, cfg, mem_init_state=init, device=CPU)
    want = {k: np.asarray(v) for k, v in jcu.eval_constraints(jw, jcfg).items()}
    return jw, w, want


def test_unpacker_witness_residuals_and_forms_equal_jax(unpacker):
    jw, w, want = unpacker
    cfg, jcfg = cu.CodeUnpackerConfig(ROUNDS), jcu.CodeUnpackerConfig(ROUNDS)
    assert_same_witness(w, jw, CU_FIELDS)
    assert not failing(want)
    assert_same_residuals(residuals_to_numpy(cu.eval_constraints(w, cfg)), want)
    carried = code_unpacker_witness_from_numpy(jax_to_numpy(jw), device=CPU)
    assert_same_residuals(residuals_to_numpy(cu.eval_constraints_jit(carried, cfg)), want)
    assert_same_forms(cu.instance_compact_forms(w, cfg, LIMIT),
                      jcu.instance_compact_forms(jw, jcfg, LIMIT))
    assert_same_forms(cu.instance_compact_form(w, cfg), jcu.instance_compact_form(jw, jcfg))


def test_unpacker_changed_code_word_fails_as_in_jax(unpacker):
    _, w, _ = unpacker
    forged, want = chip_smoke.probe_code_word(w)
    cfg = cu.CodeUnpackerConfig(ROUNDS)
    assert failing_rows(residuals_to_numpy(cu.eval_constraints(forged, cfg))) == want
    jforged = to_jax(jcu.CodeUnpackerWitness, witness_to_numpy(forged, CU_FIELDS), CU_FIELDS,
                     CU_QUERIES)
    assert failing_rows(jcu.eval_constraints(jforged, jcu.CodeUnpackerConfig(ROUNDS))) == want


def test_unpacker_rejects_an_even_bytecode():
    with pytest.raises(ValueError):
        cu.make_request([1, 2], 0, 0)
