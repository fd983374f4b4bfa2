"""Whole main_vm and FRI-verifier proofs of the port against the JAX
package, on the CPU.  Marked `slow`:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vm_verifier_airs_slow.py -m slow

The JAX side runs under `numpy_jit()` (tests/torch_jaxpr_numpy.py): its
jitted functions traced to their jaxprs and evaluated with numpy.

main_vm at the two witnesses of tests/test_vm_air.py, each package's own
EraVM making its witness: the port's proof equals the JAX proof as nested
ints (caps, OOD values, query indices, openings), with the same boundary
states and code-read stream; the port's verifier accepts the JAX proof and
rejects it for a forged final register and a forged code-read word, as the
JAX tests do.  The JAX `debug_residuals` on the near-call panic program
gives the value the tier-1 test pins for the port.  The FRI-verifier STARK
over the two children of tests/test_verifier_air.py: the port's proof made
from the JAX children equals the JAX proof, and each verifier accepts the
other's.
"""

import numpy as np
import pytest

from torch_air_helpers import jax_fri_to_ints, jax_proof_to_ints
from torch_jaxpr_numpy import numpy_jit
from torch_vm_programs import PROGRAMS, VM_AIR_PROGRAMS, run_vm
from zkevm_circuits_tpu.models import vm as jvm
from zkevm_circuits_tpu.prover import verifier_air as jva
from zkevm_circuits_tpu.prover import vm_air as jair
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.prover import verifier_air as va
from zkevm_circuits_tpu_torch.prover import vm_air
from zkevm_circuits_tpu_torch.utils.convert import (fri_proof_from_ints, proof_from_ints,
                                                    proof_to_ints)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module", params=list(VM_AIR_PROGRAMS))
def vm_proofs(request):
    entry = VM_AIR_PROGRAMS[request.param]
    _, jw = run_vm(jvm.EraVM, entry)
    _, pw = run_vm(vm.EraVM, entry)
    with numpy_jit():
        jout = jair.prove_vm_core(jw, entry["limit"])
    pout = vm_air.prove_vm_core(pw, entry["limit"], device="cpu")
    return jout, pout


def test_vm_proof_identical_to_jax(vm_proofs):
    (jproof, js_in, js_out, jreads, jparams), (proof, s_in, s_out, reads, params) = vm_proofs
    assert params.log_n == jparams.log_n == 11 and params.num_queries == jparams.num_queries
    np.testing.assert_array_equal(s_in, js_in)
    np.testing.assert_array_equal(s_out, js_out)
    np.testing.assert_array_equal(reads, jreads)
    assert proof_to_ints(proof) == jax_proof_to_ints(jproof)


def test_vm_port_verifier_on_jax_proof(vm_proofs):
    (jproof, s_in, s_out, reads, _), (_, _, _, _, params) = vm_proofs
    proof = proof_from_ints(jax_proof_to_ints(jproof), "cpu")
    assert vm_air.verify_vm_core(proof, s_in, s_out, reads, params)
    forged = np.asarray(s_out, np.uint64).copy()
    forged[-1] ^= np.uint64(1)
    assert not vm_air.verify_vm_core(proof, s_in, forged, reads, params)
    forged = np.asarray(reads, np.uint64).copy()
    forged[0, 3] ^= np.uint64(1)
    assert not vm_air.verify_vm_core(proof, s_in, s_out, forged, params)


def test_jax_near_call_panic_fault():
    """The JAX AIR's pc transition fails the honest near-call panic witness
    on one row: the value the tier-1 test pins for the port."""
    entry = PROGRAMS["near_call_ergs_split_and_panic_return"]
    _, jw = run_vm(jvm.EraVM, entry)
    _, pw = run_vm(vm.EraVM, entry)
    want = {"transition": [(2, 1)]}
    assert jair.debug_residuals(jw, entry["limit"]) == want
    assert vm_air.debug_residuals(pw, entry["limit"], device="cpu") == want


def test_verifier_air_proof_identical_to_jax():
    from test_torch_verifier_air import _jax_child, port_params

    children = [_jax_child(1), _jax_child(2)]
    jproofs, jparams = [c[0] for c in children], [c[1] for c in children]
    with numpy_jit():
        jvp, _, jvparams = jva.prove_fri_verification(jproofs, jparams)
    proofs = [fri_proof_from_ints(jax_fri_to_ints(p), "cpu") for p in jproofs]
    params = [port_params(p) for p in jparams]
    vp, _, vparams = va.prove_fri_verification(proofs, params)
    assert vparams.log_n == jvparams.log_n
    assert proof_to_ints(vp) == jax_proof_to_ints(jvp)
    assert va.verify_fri_verification(proof_from_ints(jax_proof_to_ints(jvp), "cpu"), proofs,
                                      params, vparams)
    with numpy_jit():
        assert jva.verify_fri_verification(jvp, jproofs, jparams, jvparams)
