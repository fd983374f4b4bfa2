"""main_vm instance slicing (`models/vm/compact.py`) and the port's
`entry()`, against the JAX package on the CPU.

The compact forms of a run cut into instances, the boot/exit residuals, the
local-state encoding and the per-instance windows equal the JAX package's bit
for bit; a changed hidden FSM commitment of one instance fails the chaining on
both sides at the same place; `entry(device="cpu")` gives the same verdicts as
`__graft_entry__.entry()`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__
from zkevm_circuits_tpu.models import vm as jvm
from zkevm_circuits_tpu.models.vm import compact as jcompact
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.utils import protocol as jprotocol

from torch_log_helpers import FIELDS, assert_same, assert_same_residuals, jax_to_numpy
from torch_vm_programs import PROGRAMS, run_vm
from zkevm_circuits_tpu_torch import entry as port_entry
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.models.vm import circuit, compact
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.utils import protocol
from zkevm_circuits_tpu_torch.utils.convert import witness_to_numpy
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

# (program, instance limit): 2 and 4 instances, a far call, a revert with
# rollbacks; the programs preset registers, which the boot pins reject (as the
# JAX package does), but for the NOP program, which boots clean
CASES = [("far_call_roundtrip_and_page_reuse", 16), ("log_revert_appends_rollback", 8),
         ("log_storage_and_events", 8), ("tamper_ergs", 8)]
PRESET = {"boot_r1", "boot_regs_clear"}


def _witnesses(name):
    _, w = run_vm(vm.EraVM, dict(PROGRAMS[name], tamper=None))
    return vm.prepare_device_witness(w, device="cpu"), jvm.prepare_device_witness(w)


def _residuals_np(res):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in res.items()}


@pytest.mark.parametrize("name,limit", CASES)
def test_compact_forms_and_boot_residuals_equal_jax(name, limit):
    dw, jdw = _witnesses(name)
    forms, res = vm.vm_instance_compact_forms(dw, limit)
    jforms, jres = jvm.vm_instance_compact_forms(jdw, limit)
    assert_same(witness_to_numpy(forms, FIELDS["forms"]), jax_to_numpy(jforms))
    assert_same_residuals(_residuals_np(res), _residuals_np(jres))
    bad = {k for k, v in res.items() if not bool(v.all())}
    assert bad <= PRESET and bool(PROGRAMS[name]["regs"]) == bool(bad)
    assert forms.start_flag.shape == (dw["ts"].shape[0] // limit,)
    bounds = np.arange(0, dw["ts"].shape[0], limit)
    assert np.array_equal(gf.to_u64(compact.encode_local_state(dw, bounds)),
                          jcompact.encode_local_state(jdw, bounds).astype_u64())
    assert np.array_equal(gf.to_u64(compact.observable_output_encoding(dw)),
                          jcompact.observable_output_encoding(jdw).astype_u64())
    assert np.array_equal(gf.to_u64(compact._boot_sponge(dw["block_rollback_tail"])),
                          jcompact._boot_sponge(jdw["block_rollback_tail"]).astype_u64())


def test_windows_equal_jax():
    dw, jdw = _witnesses("log_revert_appends_rollback")
    windows, axes, n = vm.vm_instance_windows(dw, 8)
    jwindows, jaxes, jn = jvm.vm_instance_windows(jdw, 8)
    assert n == jn == 4 and axes == jaxes
    got = {k: gf.to_u64(v) if k in circuit._GF_KEYS else v.numpy() for k, v in windows.items()}
    assert_same(got, jax_to_numpy(jwindows))
    with pytest.raises(ValueError):
        vm.vm_instance_windows(dw, 7)


@pytest.mark.parametrize("instance", [0, 2])
def test_changed_fsm_boundary_fails_chaining_as_jax(instance):
    """negative probe: the hidden FSM input of instance k + 1 no longer
    commits to the state instance k ended in (one lane of its encoding
    changed), so the chaining fails between k and k + 1 and nowhere else."""
    dw, jdw = _witnesses("log_revert_appends_rollback")
    limit = 8
    forms, _ = vm.vm_instance_compact_forms(dw, limit)
    jforms, _ = jvm.vm_instance_compact_forms(jdw, limit)
    row = (instance + 1) * limit
    lane = 124  # the timestamp: after 120 register limbs, the pointer bits and 3 flags
    assert compact.VM_LOCAL_STATE_LAYOUT[5][0] == "ts"
    enc = compact.encode_local_state(dw, [row])
    enc[0, lane] = gf.add(enc[0, lane], gf.ones((), enc.device))
    forged = forms.hidden_fsm_input_commitment.clone()
    forged[instance + 1] = protocol.commit_encoding(enc)[0]
    chain = protocol.check_instance_chaining(
        forms.start_flag, forms.completion_flag, forged, forms.hidden_fsm_output_commitment)
    jenc = jcompact.encode_local_state(jdw, [row])
    jenc = jgf.GF(jenc.lo.at[0, lane].add(1), jenc.hi)  # a small u32: no carry
    jforged = jforms.hidden_fsm_input_commitment
    jc = jprotocol.commit_encoding(jenc)
    jforged = jgf.GF(jforged.lo.at[instance + 1].set(jc.lo[0]),
                     jforged.hi.at[instance + 1].set(jc.hi[0]))
    jchain = jprotocol.check_instance_chaining(
        jforms.start_flag, jforms.completion_flag, jforged, jforms.hidden_fsm_output_commitment)
    got, want = _residuals_np(chain), _residuals_np(jchain)
    assert_same_residuals(got, want)
    assert np.flatnonzero(~got["fsm_handoff"]).tolist() == [instance]


def test_entry_on_the_cpu_equals_graft_entry():
    fn, (dw,) = port_entry.entry(device="cpu")
    assert dw["regs"].device.type == "cpu"
    got = fn(dw)
    jfn, (jdw,) = __graft_entry__.entry()
    want = np.asarray(jfn(jdw))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert bool(got.all())
    # the same witness through the JAX package's oracle
    jdw_np = {k: (v.astype_u64() if hasattr(v, "astype_u64") else np.asarray(v))
              for k, v in jdw.items()}
    for k, v in dw.items():
        ref = jdw_np[k]
        mine = gf.to_u64(v) if k in circuit._GF_KEYS else v.numpy()
        assert np.array_equal(mine.astype(np.int64) if mine.dtype != np.uint64 else mine,
                              ref.astype(np.int64) if ref.dtype != np.uint64 else ref), k


def test_entry_defaults_to_the_card():
    """Without a card, entry() refuses rather than running on the CPU."""
    if torch.cuda.is_available():
        fn, (dw,) = port_entry.entry()
        assert dw["regs"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()


def test_compact_forms_refuse_a_partial_instance():
    dw, _ = _witnesses("arith_families")
    with pytest.raises(ValueError):
        vm.vm_instance_compact_forms(dw, 5)
    assert dataclasses.is_dataclass(vm.vm_instance_compact_forms(dw, 16)[0])
