"""main_vm constraint evaluation: the torch port against the JAX package.

One parametrised test over the programs of tests/test_vm2.py (honest and
tampered, `torch_vm_programs.PROGRAMS`): the witness dict comes from the JAX
package's Python oracle `vm.EraVM(...).run()`, goes through both
`prepare_device_witness`, and the two residual dicts must be equal key by key
and element by element (bool arrays, no tolerance), including which keys fail.
The JAX side runs eagerly on the CPU, as tests/test_vm2.py runs it.
"""

import numpy as np
import pytest

from zkevm_circuits_tpu.models import vm as jvm

from torch_vm_programs import PROGRAMS, run_vm
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.utils.convert import residuals_to_numpy, vm_witness_from_numpy
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_residuals_equal_jax(name):
    entry = PROGRAMS[name]
    limit = entry["limit"]
    _, w = run_vm(jvm.EraVM, entry)
    want = {k: np.asarray(v)
            for k, v in jvm.eval_constraints(jvm.prepare_device_witness(w), limit).items()}
    dw = vm_witness_from_numpy(w, device="cpu")
    got = residuals_to_numpy(vm.eval_constraints(dw, limit))
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape == (limit,), key
        assert np.array_equal(got[key], want[key]), key
    bad = [k for k, v in got.items() if not v.all()]
    if entry["tamper"]:
        assert bad and not vm.all_ok(vm.eval_constraints_jit(dw, limit))
    else:
        assert not bad, bad


def test_witness_tensors_are_not_written():
    """Evaluation leaves every witness tensor as it was."""
    _, w = run_vm(vm.NativeEraVM, PROGRAMS["far_call_roundtrip_and_page_reuse"])
    dw = vm.prepare_device_witness(w, device="cpu")
    before = {k: v.clone() for k, v in dw.items()}
    assert vm.all_ok(vm.eval_constraints(dw, 32))
    for k, v in dw.items():
        assert (v == before[k]).all(), k
