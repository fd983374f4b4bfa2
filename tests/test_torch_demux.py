"""demux_log_queue (circuit type 4) in the torch port against the JAX package
on the CPU, on the log tape of a program whose near call reverts; and
chip_smoke.py's log path rehearsed on the CPU on a short run of its
log-heavy program, with its five negative probes.

Exact equality: the witness (u64 field elements, u32 and bool columns by
value), the residual dict, the output queue states and the compact form;
chip_smoke.py's demux out-flag probe fails the same residuals at the same
rows on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.models import demux_log_queue as jdm

from torch_log_helpers import (
    FIELDS, assert_same, assert_same_residuals, failing, failing_rows, jax_to_numpy,
)
from torch_vm_programs import PROGRAMS, run_vm
from zkevm_circuits_tpu_torch.base_structures.log_query import LogQueries
from zkevm_circuits_tpu_torch.models import demux_log_queue as dm
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.runtime import block
from zkevm_circuits_tpu_torch.utils.convert import (
    demux_witness_from_numpy, residuals_to_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"


@pytest.fixture(scope="module")
def revert_tape():
    """the log tape of the program whose near call reverts (a storage write,
    reads, an event and their rollbacks)"""
    v, _ = run_vm(vm.EraVM, dict(PROGRAMS["log_revert_appends_rollback"], tamper=None))
    return [dict(q) for q in v.log_tape]


@pytest.fixture(scope="module")
def demux_pair(revert_tape):
    cfg = dm.DemuxConfig(limit=8)
    jw = jdm.generate_witness(JLogQueries.from_lists(revert_tape), jdm.DemuxConfig(limit=8))
    return cfg, jw, dm.generate_witness(LogQueries.from_lists(revert_tape, CPU), cfg)


def test_demux_witness_and_residuals_equal_jax(demux_pair, revert_tape):
    cfg, jw, w = demux_pair
    jnp_w = jax_to_numpy(jw)
    assert_same(witness_to_numpy(w, FIELDS["demux"]), jnp_w)
    want = {k: np.asarray(v) for k, v in jdm.eval_constraints(jw, jdm.DemuxConfig(limit=8)).items()}
    assert_same_residuals(residuals_to_numpy(dm.eval_constraints(w, cfg)), want)
    assert not failing(want)
    # the port's evaluation of the JAX package's witness
    carried = demux_witness_from_numpy(jnp_w, device=CPU)
    assert_same_residuals(residuals_to_numpy(dm.eval_constraints_jit(carried, cfg)), want)
    # output queue states and the compact form
    states, jstates = dm.output_queue_states(w), jdm.output_queue_states(jw)
    for name in dm.QUEUE_NAMES:
        assert np.array_equal(states[name].tail.numpy().astype(np.uint64),
                              jstates[name].tail.astype_u64())
        assert int(states[name].length) == int(jstates[name].length)
    assert_same(witness_to_numpy(dm.instance_compact_form(w, cfg), FIELDS["forms"]),
                jax_to_numpy(jdm.instance_compact_form(jw, jdm.DemuxConfig(limit=8))))
    # the step loop gives the same chains as the native runtime
    plain = dm.generate_witness(LogQueries.from_lists(revert_tape, CPU), cfg, backend="device")
    assert_same(witness_to_numpy(plain, FIELDS["demux"]), jnp_w)


def test_demux_flag_probe_fails_as_jax(demux_pair):
    cfg, jw, w = demux_pair
    forged, want = chip_smoke.probe_demux_flag(w)
    row = want["flags_events"][0]
    flags = dict(jw.out_flags)
    flags["events"] = flags["events"].at[row].set(False)
    jres = jdm.eval_constraints(dataclasses.replace(jw, out_flags=flags), jdm.DemuxConfig(limit=8))
    assert failing_rows(jres) == want
    assert failing_rows(residuals_to_numpy(dm.eval_constraints(forged, cfg))) == want


def test_chip_smoke_log_program_on_the_cpu():
    """chip_smoke.py's log path, rehearsed on the CPU at a short run: all
    residuals and handoffs true, and the five negative probes fail as pinned"""
    words, kw = chip_smoke.log_program(18)
    v = vm.NativeEraVM(words, 1024, **kw)
    w = v.run()
    out, handoffs, digest, want, counts = block.log_path(v, w, (256, 16), torch.device(CPU))
    assert not {n: chip_smoke._bad(r) for n, (_, r, _) in out.items() if chip_smoke._bad(r)}
    assert all(handoffs.values()) and digest == want
    assert counts["l1_messages"] == 10 and counts["rollbacks"] == 7 and counts["decommits"] == 19
    chip_smoke.log_probes(out, (256, 16))
