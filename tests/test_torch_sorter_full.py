"""The port's fully proof-backed sorter argument (prover/pipeline.py:
prove_sorter_full / verify_sorter_full) and the protocol pieces it shares
with the JAX package.

Held against the JAX package, exactly as u64: the challenge round
(`stark.challenges_from_cap`, with and without a fixed cap), the verifying-key
commitment (`pipeline.stark_vk_commitment`) and the commitment sponge's
chunks (`pipeline._commitment_chunks`).  The port's own round trip on the
16-row fixture of tests/test_prover_pipeline.py, on the CPU: the argument
verifies, its proven tails are the witness's, and a changed tail is rejected
as the JAX test rejects it.  The whole proofs are compared with the JAX
package's in test_torch_sorter_full_slow.py.
"""

import dataclasses

import numpy as np
import pytest

from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.prover import logup as jlogup
from zkevm_circuits_tpu.prover import pipeline as jpipeline
from zkevm_circuits_tpu.prover import poseidon2_air as jpa
from zkevm_circuits_tpu.prover import stark as jstark
from zkevm_circuits_tpu_torch.base_structures.memory_query import MemoryQueries
from zkevm_circuits_tpu_torch.models import ram_permutation as ram
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import logup, pipeline
from zkevm_circuits_tpu_torch.prover import poseidon2_air as pa
from zkevm_circuits_tpu_torch.prover import stark
from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

GP_PARAMS = stark.StarkParams(log_n=4, log_blowup=2, num_queries=12, cap_log2=1)
VK_PARAMS = [dict(log_n=3), dict(log_n=16), dict(log_n=4, num_queries=12),
             dict(log_n=4, num_queries=13)]
CHUNK_LENGTHS = [1, 7, 8, 9, 18, 20, 69]


def _u64(x):
    return np.asarray(x.astype_u64(), np.uint64)


def _airs():
    """(port AIR, JAX AIR) pairs: no fixed columns, and fixed ones"""
    return {"chain_full": (pa.chain_air(pa.FULL), jpa.chain_air(jpa.FULL)),
            "chain_narrow": (pa.chain_air(pa.NARROW), jpa.chain_air(jpa.NARROW)),
            "permutation": (pipeline.permutation_air(), jpipeline.permutation_air()),
            "lookup3": (logup.lookup_air(3), jlogup.lookup_air(3))}


@pytest.fixture(scope="module")
def jax_side():
    rng = np.random.default_rng(77)
    caps = rng.integers(0, gf.MODULUS, size=(2, 2, 4), dtype=np.uint64)
    out = dict(caps=caps, challenges={}, vk={})
    for name, (_, jair) in _airs().items():
        fixed = jgf.from_u64(caps[1]) if jair.num_fixed_cols else None
        out["challenges"][name] = jstark.challenges_from_cap(jgf.from_u64(caps[0]), jair, fixed)[0]
        for i, p in enumerate(VK_PARAMS):
            out["vk"][name, i] = _u64(jpipeline.stark_vk_commitment(jair, jstark.StarkParams(**p)))
    return out


@pytest.mark.parametrize("name", list(_airs()))
def test_challenges_from_cap_match_jax(jax_side, name):
    air = _airs()[name][0]
    caps = jax_side["caps"]
    fixed = gf.from_u64(caps[1]) if air.num_fixed_cols else None
    ch, _ = stark.challenges_from_cap(gf.from_u64(caps[0]), air, fixed)
    assert ch == jax_side["challenges"][name]
    assert len(ch) == air.num_challenges


@pytest.mark.parametrize("params", range(len(VK_PARAMS)))
@pytest.mark.parametrize("name", list(_airs()))
def test_stark_vk_commitment_matches_jax(jax_side, name, params):
    vk = pipeline.stark_vk_commitment(_airs()[name][0], stark.StarkParams(**VK_PARAMS[params]),
                                      "cpu")
    np.testing.assert_array_equal(gf.to_u64(vk), jax_side["vk"][name, params])


@pytest.mark.parametrize("length", CHUNK_LENGTHS)
def test_commitment_chunks_match_jax(length):
    enc = np.random.default_rng(length).integers(0, gf.MODULUS, size=length, dtype=np.uint64)
    chunks, init = pipeline._commitment_chunks(enc)
    jchunks, jinit = jpipeline._commitment_chunks(enc)
    np.testing.assert_array_equal(chunks, jchunks)
    np.testing.assert_array_equal(init, jinit)


def test_commitment_chunks_refuse_an_empty_encoding():
    with pytest.raises(ValueError):
        pipeline._commitment_chunks(np.zeros(0, np.uint64))


def _fixture_witness():
    """the 16-row, 3-query fixture of tests/test_prover_pipeline.py"""
    unsorted = [
        dict(timestamp=1025, memory_page=30, index=0, rw_flag=True, is_ptr=False, value=123),
        dict(timestamp=2052, memory_page=30, index=0, rw_flag=False, is_ptr=False, value=123),
        dict(timestamp=0, memory_page=8, index=2, rw_flag=True, is_ptr=False, value=12345678),
    ]
    sorted_q = [unsorted[2], unsorted[0], unsorted[1]]
    cfg = ram.RamPermutationConfig(limit=16)
    return ram.generate_witness(MemoryQueries.from_lists(unsorted, "cpu"),
                                MemoryQueries.from_lists(sorted_q, "cpu"), cfg)


@pytest.fixture(scope="module")
def proven():
    w = _fixture_witness()
    ok, full = pipeline.prove_sorter_full(w, gp_params=GP_PARAMS)
    return w, ok, full


def test_full_sorter_proof_verifies(proven):
    """the verdict prove_sorter_full returns is verify_sorter_full's"""
    _, ok, full = proven
    assert ok
    assert full.n_real == 3 and full.chain_u is not None and full.chain_s is not None


def test_full_sorter_proof_tails_are_the_witness_chains(proven):
    w, _, full = proven
    np.testing.assert_array_equal(full.tail_u, gf.to_u64(w.chain_unsorted[3]))
    np.testing.assert_array_equal(full.tail_s, gf.to_u64(w.chain_sorted[3]))
    np.testing.assert_array_equal(gf.to_u64(full.gp_public), gf.to_u64(w.lhs[-1]))


@pytest.mark.parametrize("tamper", ["tail_u", "no_chain_proof"])
def test_full_sorter_proof_tamper_rejected(proven, tamper):
    w, _, full = proven
    if tamper == "tail_u":
        bad = dataclasses.replace(full, tail_u=(full.tail_u + np.uint64(1)) % np.uint64(gf.MODULUS))
    else:
        bad = dataclasses.replace(full, chain_s=None)
    assert not pipeline.verify_sorter_full(w, bad)


def test_full_sorter_proof_needs_per_row_chains():
    """a witness that keeps every 8th state only is refused, not indexed"""
    tapes = build_tapes_np(16)
    cfg = ram.RamPermutationConfig(limit=16, chain_stride=8)
    w = ram.generate_witness_host_tapes(*tapes, cfg, device="cpu")
    with pytest.raises(ValueError, match="chain_stride"):
        pipeline.prove_sorter_full(w)
