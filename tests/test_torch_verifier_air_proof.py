"""The port's FRI-verifier STARK (prover/verifier_air.py) proven and
verified on the CPU over the two FRI children of tests/test_verifier_air.py,
made by the port's own FRI (the same bytes as the JAX package's children:
tests/test_torch_verifier_air.py holds the trace made from those to JAX's).

The proof is accepted; it is rejected against a child with one opened pair
value changed, a child with its cap list reversed, and a public vector with
one beta changed (the squeeze row's binding): the verdicts of
tests/test_verifier_air.py.
"""

import dataclasses

import numpy as np
import pytest

from zkevm_circuits_tpu_torch.ops import fri, gf, ntt
from zkevm_circuits_tpu_torch.prover import verifier_air as va
from zkevm_circuits_tpu_torch.prover.stark import verify
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


def child(seed, log_n=3, log_blowup=2, q=4):
    """tests/test_verifier_air.py's `_child`, made by the port."""
    r = np.random.default_rng(seed)
    evals = gf.from_u64(r.integers(0, gf.MODULUS, size=(1, 1 << log_n), dtype=np.uint64), "cpu")
    code = ntt.lde(evals, log_blowup, gf.MULTIPLICATIVE_GENERATOR)[0]
    p = fri.FriParams(log_domain=log_n + log_blowup, log_blowup=log_blowup, num_queries=q,
                      cap_log2=1)
    return fri.prove(code, p), p


@pytest.fixture(scope="module")
def node_proof():
    (fp1, p1), (fp2, p2) = child(1), child(2)
    proofs, params = [fp1, fp2], [p1, p2]
    vproof, publics, vparams = va.prove_fri_verification(proofs, params)
    return proofs, params, vproof, publics, vparams


def test_node_stark_verifies_two_children(node_proof):
    proofs, params, vproof, _, vparams = node_proof
    assert vproof.q_cap.device.type == "cpu"
    assert va.verify_fri_verification(vproof, proofs, params, vparams)


def test_tampered_child_value_rejected(node_proof):
    proofs, params, vproof, _, vparams = node_proof
    ops = [[dict(o) for o in q] for q in proofs[0].openings]
    pair = np.asarray(ops[0][0]["pair"], np.uint64).copy()
    pair[0, 0] ^= np.uint64(1)
    ops[0][0]["pair"] = pair
    bad = dataclasses.replace(proofs[0], openings=ops)
    assert not va.verify_fri_verification(vproof, [bad, proofs[1]], params, vparams)


def test_reversed_caps_rejected(node_proof):
    proofs, params, vproof, _, vparams = node_proof
    bad = dataclasses.replace(proofs[0], caps=list(reversed(proofs[0].caps)))
    assert va.build_publics([bad, proofs[1]], params) is None
    assert not va.verify_fri_verification(vproof, [bad, proofs[1]], params, vparams)


def test_forged_beta_public_rejected_by_stark(node_proof):
    proofs, params, vproof, publics, vparams = node_proof
    sched = va.build_schedule(tuple(params))
    fixed = va.fixed_columns(sched, "cpu")
    bad = gf.to_u64(publics).copy()
    bad[sched.off_beta[0][0]] ^= np.uint64(1)  # child 0, layer 0, beta c0
    assert not verify(vproof, va.verifier_air(sched), vparams, gf.from_u64(bad, "cpu"),
                      fixed_cols=fixed)
