"""The port's FRI-verifier AIR (prover/verifier_air.py) against the JAX
package, on the two FRI children of tests/test_verifier_air.py.

The JAX children, pulled to nested ints and rebuilt as the port's FriProofs
(`utils/convert.py:fri_proof_from_ints`), give the same schedule (rows,
public offsets, trace length, public count), the same fixed columns, phase-1
trace and publics as u64; the alpha-composed constraints equal the JAX
prover's `_compose_rows` on random rows (its jaxpr evaluated with numpy:
tests/torch_jaxpr_numpy.py); a child with a changed Merkle path cannot be
traced (AssertionError, as in the JAX package).  The port's own proofs at
this size are in tests/test_torch_verifier_air_proof.py, the node over
compact-form children in tests/test_torch_node_in_field.py, whole proofs
against the JAX proofs in tests/test_torch_vm_verifier_airs_slow.py.
"""

import dataclasses

import numpy as np
import pytest

from torch_air_helpers import composition_pair, jax_fri_to_ints, u64
from zkevm_circuits_tpu.ops import fri as jfri
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops import ntt as jntt
from zkevm_circuits_tpu.prover import verifier_air as jva
from zkevm_circuits_tpu_torch.ops import fri, gf
from zkevm_circuits_tpu_torch.prover import verifier_air as va
from zkevm_circuits_tpu_torch.utils.convert import fri_proof_from_ints
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


def _jax_child(seed, log_n=3, log_blowup=2, q=4):
    """tests/test_verifier_air.py's `_child`."""
    r = np.random.default_rng(seed)
    evals = jgf.from_u64(r.integers(0, gf.MODULUS, size=(1, 1 << log_n), dtype=np.uint64))
    code = jntt.lde(evals, log_blowup, jgf.MULTIPLICATIVE_GENERATOR)[0]
    p = jfri.FriParams(log_domain=log_n + log_blowup, log_blowup=log_blowup, num_queries=q,
                       cap_log2=1)
    return jfri.prove(code, p), p


def port_params(p) -> fri.FriParams:
    return fri.FriParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


@pytest.fixture(scope="module")
def jax_side():
    children = [_jax_child(1), _jax_child(2)]
    proofs, params = [c[0] for c in children], [c[1] for c in children]
    phase1, fixed = jva.build_verifier_trace(proofs, params)
    return dict(proofs=proofs, params=params, sched=jva.build_schedule(tuple(params)),
                phase1=u64(phase1), fixed=u64(fixed),
                publics=u64(jva.build_publics(proofs, params)))


@pytest.fixture(scope="module")
def port_children(jax_side):
    return ([fri_proof_from_ints(jax_fri_to_ints(p), "cpu") for p in jax_side["proofs"]],
            [port_params(p) for p in jax_side["params"]])


def test_children_convert_and_verify(port_children):
    proofs, params = port_children
    assert all(fri.verify(p, prm) for p, prm in zip(proofs, params))


def test_schedule_matches_jax(jax_side, port_children):
    want = jax_side["sched"]
    got = va.build_schedule(tuple(port_children[1]))
    assert (got.n, got.num_public) == (want.n, want.num_public) == (128, 108)
    for name in ("off_caps", "off_beta", "off_idx", "off_leaf0", "off_final"):
        assert getattr(got, name) == getattr(want, name)
    strip = [{k: v for k, v in dict(r).items() if k != "lay"} for r in want.rows]
    assert [{k: v for k, v in dict(r).items() if k != "lay"} for r in got.rows] == strip
    assert [dict(r).get("lay") for r in got.rows] == [dict(r).get("lay") for r in want.rows]


def test_fixed_columns_and_trace_match_jax(jax_side, port_children):
    phase1, fixed = va.build_verifier_trace(*port_children, device="cpu")
    np.testing.assert_array_equal(gf.to_u64(fixed), jax_side["fixed"])
    np.testing.assert_array_equal(gf.to_u64(phase1), jax_side["phase1"])
    np.testing.assert_array_equal(
        gf.to_u64(va.fixed_columns(va.build_schedule(tuple(port_children[1])), "cpu")),
        jax_side["fixed"])


def test_publics_match_jax(jax_side, port_children):
    np.testing.assert_array_equal(gf.to_u64(va.build_publics(*port_children)),
                                  jax_side["publics"])
    for proof, prm, jproof, jprm in zip(*port_children, jax_side["proofs"], jax_side["params"]):
        betas, indices = jva.fri_transcript_scalars(jproof, jprm)
        assert va.fri_transcript_scalars(proof, prm) == (list(betas), list(indices))


def test_composition_matches_jax(jax_side, port_children):
    """The constraints of the AIR, alpha-composed by the JAX prover's
    `_compose_rows` and by the port's, agree on random rows (random publics
    of the schedule's count)."""
    want, got = composition_pair(jva.verifier_air(jax_side["sched"]),
                                 va.verifier_air(va.build_schedule(tuple(port_children[1]))),
                                 seed=3)
    np.testing.assert_array_equal(got, want)


def test_bad_path_is_refused(port_children):
    """An invalid child cannot be traced, so not proven verified: the trace
    builder's Merkle-cap check raises AssertionError, as the JAX one does."""
    proofs, params = port_children
    ops = [[dict(o) for o in q] for q in proofs[0].openings]
    path = np.asarray(ops[0][0]["path"], np.uint64).copy()
    path[0, 0] ^= np.uint64(1)
    ops[0][0]["path"] = path
    bad = dataclasses.replace(proofs[0], openings=ops)
    with pytest.raises(AssertionError):
        va.prove_fri_verification([bad, proofs[1]], params)
