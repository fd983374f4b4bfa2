"""The port's main path as a whole against the JAX package: the ram_permutation
witness from host tapes, then the grand-product STARK prove + verify
(`prove_sorter_argument`), at the smallest size the JAX tests use
(2^4 rows, StarkParams(log_n=4, log_blowup=2, num_queries=12, cap_log2=1)).

The same numpy tapes (bench.build_tapes_np) go to both packages.  Tolerance
exact: witness fields equal as u64, proofs equal as nested python ints, and
every tampered proof gets the same verdict on both sides.  The JAX side
proves exactly once (module fixture), its jaxprs evaluated with numpy: a cold
JAX proof costs minutes of XLA:CPU compiles.
"""

import copy

import numpy as np
import pytest

from bench import build_tapes_np
from zkevm_circuits_tpu.models import ram_permutation as jram
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.prover import pipeline as jpipeline
from zkevm_circuits_tpu.prover.stark import StarkParams as JStarkParams
from zkevm_circuits_tpu_torch.models import ram_permutation as ram
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import pipeline
from zkevm_circuits_tpu_torch.prover.stark import StarkParams
from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints, witness_from_numpy
from torch_jaxpr_numpy import numpy_jit
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _jax_side_on_numpy():
    """The JAX side runs as its jaxprs evaluated with numpy
    (tests/torch_jaxpr_numpy.py): the file takes a quarter less than on
    XLA:CPU."""
    with numpy_jit():
        yield


N_ROWS = 16
STRIDE = 8
PARAMS = dict(log_n=4, log_blowup=2, num_queries=12, cap_log2=1)


def _u64(x):
    return np.asarray(x.astype_u64(), np.uint64)


def _jax_proof_to_ints(proof):
    """Mirror of convert.proof_to_ints for the JAX StarkProof, whose openings
    hold (2, m) u32 [lo, hi] rows."""

    def row(r):
        r = np.asarray(r, np.uint64)
        return (r[0] | (r[1] << np.uint64(32))).tolist()

    def ints(a):
        return np.asarray(a, np.uint64).tolist()

    f = proof.fri_proof
    return dict(
        caps=[_u64(c).tolist() for c in proof.caps],
        q_cap=_u64(proof.q_cap).tolist(),
        ood=dict(trace_z=ints(proof.ood["trace_z"]), trace_wz=ints(proof.ood["trace_wz"]),
                 q_z=int(proof.ood["q_z"])),
        fri=dict(
            caps=[_u64(c).tolist() for c in f.caps],
            final_poly=ints(f.final_poly),
            query_indices=[int(i) for i in f.query_indices],
            openings=[[dict(pair=ints(op["pair"]), path=ints(op["path"])) for op in q]
                      for q in f.openings],
        ),
        trace_openings=[
            {tag: dict(rows=[row(r) for r in op["rows"]], paths=[ints(p) for p in op["paths"]],
                       q_row=row(op["q_row"]), q_path=ints(op["q_path"]), index=int(op["index"]))
             for tag, op in entry.items()}
            for entry in proof.trace_openings
        ],
    )


def _jax_witness_fields(w):
    def mq(q):
        return dict(timestamp=np.asarray(q.timestamp), memory_page=np.asarray(q.memory_page),
                    index=np.asarray(q.index), rw_flag=np.asarray(q.rw_flag),
                    is_ptr=np.asarray(q.is_ptr), value=np.asarray(q.value))

    return dict(
        n=int(w.n), execute=np.asarray(w.execute), unsorted=mq(w.unsorted), sorted=mq(w.sorted),
        enc_unsorted=_u64(w.enc_unsorted), enc_sorted=_u64(w.enc_sorted),
        chain_unsorted=_u64(w.chain_unsorted), chain_sorted=_u64(w.chain_sorted),
        challenges=_u64(w.challenges), lhs=_u64(w.lhs), rhs=_u64(w.rhs),
        nondet_count=np.asarray(w.nondet_count), snapshot_length=int(w.snapshot_length),
    )


@pytest.fixture(scope="module")
def tapes():
    return build_tapes_np(N_ROWS)


@pytest.fixture(scope="module")
def jax_side(tapes):
    cfg = jram.RamPermutationConfig(limit=N_ROWS, chain_stride=STRIDE)
    w = jram.generate_witness_host_tapes(*tapes, cfg)
    ok, proof, public, params = jpipeline.prove_sorter_argument(w, JStarkParams(**PARAMS))
    assert ok
    return w, proof, public, params


@pytest.fixture(scope="module")
def torch_side(tapes):
    cfg = ram.RamPermutationConfig(limit=N_ROWS, chain_stride=STRIDE)
    w = ram.generate_witness_host_tapes(*tapes, cfg, device="cpu")
    ok, proof, public, params = pipeline.prove_sorter_argument(w, StarkParams(**PARAMS))
    assert ok
    return w, proof, public, params


WITNESS_FIELDS = ["enc_unsorted", "enc_sorted", "chain_unsorted", "chain_sorted",
                  "challenges", "lhs", "rhs"]


@pytest.mark.parametrize("name", WITNESS_FIELDS)
def test_witness_field_matches_jax(torch_side, jax_side, name):
    np.testing.assert_array_equal(
        gf.to_u64(getattr(torch_side[0], name)), _u64(getattr(jax_side[0], name)))


def test_witness_counts_match_jax(torch_side, jax_side):
    w, jw = torch_side[0], jax_side[0]
    assert w.n == int(jw.n) == N_ROWS
    np.testing.assert_array_equal(w.execute.numpy(), np.asarray(jw.execute))
    np.testing.assert_array_equal(w.nondet_count.numpy(), np.asarray(jw.nondet_count, np.int64))
    assert w.snapshot_length == int(jw.snapshot_length)


def test_grand_product_trace_matches_jax(torch_side, jax_side):
    trace, public = pipeline.permutation_trace(torch_side[0])
    jtrace, jpublic = jpipeline.permutation_trace(jax_side[0])
    np.testing.assert_array_equal(gf.to_u64(trace), _u64(jtrace))
    np.testing.assert_array_equal(gf.to_u64(public), _u64(jpublic))


def test_proof_byte_identical_to_jax(torch_side, jax_side):
    assert proof_to_ints(torch_side[1]) == _jax_proof_to_ints(jax_side[1])
    np.testing.assert_array_equal(gf.to_u64(torch_side[2]), _u64(jax_side[2]))


def test_proof_from_jax_witness_identical(jax_side):
    w = witness_from_numpy(_jax_witness_fields(jax_side[0]), device="cpu")
    ok, proof, _, _ = pipeline.prove_sorter_argument(w, StarkParams(**PARAMS))
    assert ok
    assert proof_to_ints(proof) == _jax_proof_to_ints(jax_side[1])


def _wrong_public(proof, public, is_jax):
    if is_jax:
        return proof, jgf.add(public, jgf.ones(public.shape))
    return proof, gf.add(public, gf.ones(public.shape))


def _swapped_cap(proof, public, is_jax):
    proof = copy.deepcopy(proof)
    cap = proof.caps[0]
    proof.caps = [cap[::-1] if is_jax else cap.flip(0)]
    return proof, public


def _altered_ood(proof, public, is_jax):
    proof = copy.deepcopy(proof)
    tz = np.array(proof.ood["trace_z"], copy=True)
    tz[0] ^= np.uint64(1)
    proof.ood = dict(proof.ood, trace_z=tz)
    return proof, public


def _altered_opening(proof, public, is_jax):
    proof = copy.deepcopy(proof)
    op = proof.trace_openings[0]["cur"]
    op["rows"][0] = np.array(op["rows"][0], copy=True)
    if is_jax:
        op["rows"][0][0, 0] ^= np.uint32(1)
    else:
        op["rows"][0][0] ^= np.uint64(1)
    return proof, public


@pytest.mark.parametrize("tamper", [None, _wrong_public, _swapped_cap, _altered_ood,
                                    _altered_opening],
                         ids=["honest", "wrong_public", "swapped_cap", "altered_ood",
                              "altered_opening"])
def test_tamper_verdicts_match_jax(torch_side, jax_side, tamper):
    _, proof, public, params = torch_side
    _, jproof, jpublic, jparams = jax_side
    if tamper is not None:
        proof, public = tamper(proof, public, False)
        jproof, jpublic = tamper(jproof, jpublic, True)
    verdict = pipeline.verify_permutation_argument(proof, public, params)
    assert verdict == jpipeline.verify_permutation_argument(jproof, jpublic, jparams)
    assert verdict == (tamper is None)
