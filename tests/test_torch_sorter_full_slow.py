"""Whole proofs of the port against the JAX package's, as nested ints: the
queue-chain STARK (FULL and NARROW, 8 rows), the compact-commitment STARK,
the fully proof-backed sorter argument on the 16-row fixture of
tests/test_prover_pipeline.py and the logUp proof.  Each must be identical,
the port's verifiers must accept the JAX package's proofs (carried across
with `convert.proof_from_ints`), and each tamper must get the same verdict
from both packages.

`slow`, as the JAX package's own chain and pipeline tests are: a cold JAX
chain proof costs minutes of XLA:CPU compiles.  Run it with
`python -m pytest tests/test_torch_sorter_full_slow.py -m slow`.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_ram_prover import _jax_proof_to_ints
from zkevm_circuits_tpu.base_structures.memory_query import MemoryQueries as JMemoryQueries
from zkevm_circuits_tpu.models import ram_permutation as jram
from zkevm_circuits_tpu.prover import logup as jlogup
from zkevm_circuits_tpu.prover import pipeline as jpipeline
from zkevm_circuits_tpu.prover import poseidon2_air as jpa
from zkevm_circuits_tpu.prover.stark import StarkParams as JStarkParams
from zkevm_circuits_tpu_torch.base_structures.memory_query import MemoryQueries
from zkevm_circuits_tpu_torch.models import ram_permutation as ram
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import logup, pipeline
from zkevm_circuits_tpu_torch.prover import poseidon2_air as pa
from zkevm_circuits_tpu_torch.prover.stark import StarkParams
from zkevm_circuits_tpu_torch.utils.convert import proof_from_ints, proof_to_ints
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

pytestmark = pytest.mark.slow

CHAIN_PARAMS = dict(log_n=3, log_blowup=2, num_queries=8, cap_log2=1)
GP_PARAMS = dict(log_n=4, log_blowup=2, num_queries=12, cap_log2=1)


def _u64(x):
    return np.asarray(x.astype_u64(), np.uint64)


def _chain_inputs(name):
    rng = np.random.default_rng(5)
    if name == "narrow":
        return (pa.NARROW, jpa.NARROW, rng.integers(0, gf.MODULUS, size=(2, 20), dtype=np.uint64),
                np.zeros(4, np.uint64))
    return (pa.FULL, jpa.FULL, rng.integers(0, gf.MODULUS, size=(8, 8), dtype=np.uint64),
            rng.integers(0, gf.MODULUS, size=4, dtype=np.uint64))


@pytest.fixture(scope="module", params=["full", "narrow"])
def chain(request):
    spec, jspec, enc, init = _chain_inputs(request.param)
    jproof, jpub, jparams = jpa.prove_queue_chain(enc, init, jspec, JStarkParams(**CHAIN_PARAMS))
    proof, pub, params = pa.prove_queue_chain(enc, init, spec, StarkParams(**CHAIN_PARAMS), "cpu")
    return dict(spec=spec, jspec=jspec, enc=enc, init=init, proof=proof, pub=gf.to_u64(pub),
                params=params, jproof=jproof, jpub=_u64(jpub), jparams=jparams)


def test_chain_proof_identical_to_jax(chain):
    np.testing.assert_array_equal(chain["pub"], chain["jpub"])
    assert proof_to_ints(chain["proof"]) == _jax_proof_to_ints(chain["jproof"])


def test_port_verifier_accepts_jax_chain_proof(chain):
    c = chain
    w = c["spec"].out_width
    jproof = proof_from_ints(_jax_proof_to_ints(c["jproof"]), "cpu")
    assert pa.verify_queue_chain(jproof, c["enc"], c["init"], c["jpub"][4:4 + w], c["spec"],
                                 c["params"])


@pytest.mark.parametrize("tamper", ["final", "message", "init"])
def test_chain_tamper_verdicts_match_jax(chain, tamper):
    c = chain
    w = c["spec"].out_width
    enc, init, final = c["enc"].copy(), c["init"].copy(), c["pub"][4:4 + w].copy()
    {"final": final, "message": enc[1], "init": init}[tamper][0] ^= np.uint64(1)
    verdict = pa.verify_queue_chain(c["proof"], enc, init, final, c["spec"], c["params"])
    assert verdict == jpa.verify_queue_chain(c["jproof"], enc, init, final, c["jspec"],
                                             c["jparams"])
    assert not verdict


def test_compact_commitment_proof_identical_to_jax():
    enc = np.random.default_rng(0xC0DE).integers(0, gf.MODULUS, size=18, dtype=np.uint64)
    proof, c, fs, params = pipeline.prove_compact_commitment(enc, device="cpu")
    jproof, jc, jfs, jparams = jpipeline.prove_compact_commitment(enc)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(fs, jfs)
    assert params == StarkParams(**vars(jparams))
    assert proof_to_ints(proof) == _jax_proof_to_ints(jproof)
    assert pipeline.verify_compact_commitment(
        proof_from_ints(_jax_proof_to_ints(jproof), "cpu"), enc, jc, jfs, params)


def _fixture_rows():
    unsorted = [
        dict(timestamp=1025, memory_page=30, index=0, rw_flag=True, is_ptr=False, value=123),
        dict(timestamp=2052, memory_page=30, index=0, rw_flag=False, is_ptr=False, value=123),
        dict(timestamp=0, memory_page=8, index=2, rw_flag=True, is_ptr=False, value=12345678),
    ]
    return unsorted, [unsorted[2], unsorted[0], unsorted[1]]


@pytest.fixture(scope="module")
def sorter():
    unsorted, sorted_q = _fixture_rows()
    jw = jram.generate_witness(JMemoryQueries.from_lists(unsorted),
                               JMemoryQueries.from_lists(sorted_q),
                               jram.RamPermutationConfig(limit=16))
    jok, jfull = jpipeline.prove_sorter_full(jw, gp_params=JStarkParams(**GP_PARAMS))
    w = ram.generate_witness(MemoryQueries.from_lists(unsorted, "cpu"),
                             MemoryQueries.from_lists(sorted_q, "cpu"),
                             ram.RamPermutationConfig(limit=16))
    ok, full = pipeline.prove_sorter_full(w, gp_params=StarkParams(**GP_PARAMS))
    return w, ok, full, jw, jok, jfull


def test_sorter_full_proof_identical_to_jax(sorter):
    w, ok, full, jw, jok, jfull = sorter
    assert ok and jok
    assert full.n_real == jfull.n_real
    np.testing.assert_array_equal(full.tail_u, jfull.tail_u)
    np.testing.assert_array_equal(full.tail_s, jfull.tail_s)
    np.testing.assert_array_equal(gf.to_u64(full.gp_public), _u64(jfull.gp_public))
    assert proof_to_ints(full.gp_proof) == _jax_proof_to_ints(jfull.gp_proof)
    for side, jside in ((full.chain_u, jfull.chain_u), (full.chain_s, jfull.chain_s)):
        assert proof_to_ints(side[0]) == _jax_proof_to_ints(jside[0])
        assert side[1] == StarkParams(**vars(jside[1]))


def test_port_verifier_accepts_jax_sorter_full_proof(sorter):
    w, _, full, _, _, jfull = sorter

    def carried(p):
        return proof_from_ints(_jax_proof_to_ints(p), "cpu")

    from_jax = pipeline.SorterFullProof(
        gp_proof=carried(jfull.gp_proof), gp_public=gf.from_u64(_u64(jfull.gp_public)),
        gp_params=full.gp_params,
        chain_u=(carried(jfull.chain_u[0]), full.chain_u[1]),
        chain_s=(carried(jfull.chain_s[0]), full.chain_s[1]),
        tail_u=np.asarray(jfull.tail_u, np.uint64), tail_s=np.asarray(jfull.tail_s, np.uint64),
        n_real=int(jfull.n_real))
    assert pipeline.verify_sorter_full(w, from_jax)


def test_sorter_full_tail_tamper_verdict_matches_jax(sorter):
    w, _, full, jw, _, jfull = sorter
    p = np.uint64(gf.MODULUS)
    bad = dataclasses.replace(full, tail_u=(full.tail_u + np.uint64(1)) % p)
    jbad = dataclasses.replace(jfull, tail_u=(jfull.tail_u + np.uint64(1)) % p)
    verdict = pipeline.verify_sorter_full(w, bad)
    assert verdict == jpipeline.verify_sorter_full(jw, jbad)
    assert not verdict


def test_lookup_proof_identical_to_jax():
    table = np.array([[i, (i * 7 + 1) % 97, (i * i) % 61] for i in range(8)], np.uint64).T
    queries = table[:, np.random.default_rng(3).integers(0, 8, size=13)]
    proof, params = logup.prove_lookup(table, queries, device="cpu")
    jproof, jparams = jlogup.prove_lookup(table, queries)
    assert params == StarkParams(**vars(jparams))
    assert proof_to_ints(proof) == _jax_proof_to_ints(jproof)
    assert logup.verify_lookup(proof_from_ints(_jax_proof_to_ints(jproof), "cpu"), table, params)
    other = table.copy()
    other[2, 7] ^= np.uint64(1)
    verdict = logup.verify_lookup(proof, other, params)
    assert verdict == jlogup.verify_lookup(jproof, other, jparams)
    assert not verdict
