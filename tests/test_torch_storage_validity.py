"""storage_validity (circuit type 9) in the torch port against the JAX
package on the CPU, on the storage log of a short run of chip_smoke.py's
log-heavy program (a loop counter written every iteration, repeated cell
writes, code-hash reads, a reverted call's writes and their rollbacks) in
three instances.

Exact equality: the witness (the host-run cell state machine included),
the residual dict, the compact forms; the port's evaluation of the JAX
package's witness; chip_smoke.py's written_value probe fails the same
residuals at the same rows under both packages' evaluations.  A known fault
of the EraVM oracle (a reverted storage write is not undone, so a later read
reports the reverted value) is rejected by both packages alike.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.models import storage_validity as jsv

from torch_log_helpers import (
    FIELDS, assert_same, assert_same_residuals, failing, failing_rows,
    jax_to_numpy, numpy_to_jax,
)
from torch_vm_programs import PROGRAMS, run_vm
from zkevm_circuits_tpu_torch.base_structures.log_query import LogQueries
from zkevm_circuits_tpu_torch.models import storage_validity as sv
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.runtime import block
from zkevm_circuits_tpu_torch.utils.convert import (
    residuals_to_numpy, storage_validity_witness_from_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
LIMIT = 32


def _inputs(v, device=CPU):
    b = block.block_rows(v)
    return (LogQueries.from_lists(b["storage"], device),
            LogQueries.from_lists(b["storage_sorted"], device), b["storage_ts"], b)


@pytest.fixture(scope="module")
def pair():
    words, kw = chip_smoke.log_program(8)
    v = vm.NativeEraVM(words, 512, **kw)
    v.run()
    unsorted, sorted_q, ts, b = _inputs(v)
    assert any(r["rollback"] for r in b["storage"]) and 2 * LIMIT < len(ts) <= 3 * LIMIT
    jw = jsv.generate_witness(JLogQueries.from_lists(b["storage"]),
                              JLogQueries.from_lists(b["storage_sorted"]),
                              np.asarray(ts, np.uint32), jsv.StorageValidityConfig(LIMIT))
    w = sv.generate_witness(unsorted, sorted_q, ts, sv.StorageValidityConfig(LIMIT))
    return jw, w, jax_to_numpy(jw)


def _jax_verdict(w):
    jw = numpy_to_jax(jsv.StorageValidityWitness, witness_to_numpy(w, FIELDS["storage"]),
                      FIELDS["storage"], JLogQueries)
    return failing_rows(jsv.eval_constraints(jw, jsv.StorageValidityConfig(LIMIT)))


def test_witness_residuals_and_forms_equal_jax(pair):
    jw, w, jnp_w = pair
    cfg, jcfg = sv.StorageValidityConfig(LIMIT), jsv.StorageValidityConfig(LIMIT)
    assert_same(witness_to_numpy(w, FIELDS["storage"]), jnp_w)
    want = {k: np.asarray(v) for k, v in jsv.eval_constraints(jw, jcfg).items()}
    assert not failing(want)
    assert_same_residuals(residuals_to_numpy(sv.eval_constraints(w, cfg)), want)
    carried = storage_validity_witness_from_numpy(jnp_w, device=CPU)
    assert_same_residuals(residuals_to_numpy(sv.eval_constraints_jit(carried, cfg)), want)
    forms = sv.instance_compact_forms(w, cfg)
    assert forms.start_flag.shape == (3,)
    assert_same(witness_to_numpy(forms, FIELDS["forms"]),
                jax_to_numpy(jsv.instance_compact_forms(jw, jcfg)))
    assert np.array_equal(
        sv.extend_encoding_with_timestamp(w.enc_sorted_ext, w.sorted_ts).numpy().view(np.uint64),
        jsv.extend_encoding_with_timestamp(jw.enc_sorted_ext, jw.sorted_ts).astype_u64())


def test_written_value_probe_fails_as_jax(pair):
    _, w, _ = pair
    forged, want = chip_smoke.probe_storage_written_value(w)
    got = failing_rows(residuals_to_numpy(
        sv.eval_constraints(forged, sv.StorageValidityConfig(LIMIT))))
    assert _jax_verdict(forged) == got == want


@pytest.mark.parametrize("field", ["depth", "base_value", "explicit_read"])
def test_changed_cell_state_fails_as_jax(pair, field):
    """one cell-state column changed at an inner row: the transitions into and
    out of it fail on both sides"""
    import dataclasses

    _, w, _ = pair
    states = dict(w.cell_states)
    col = states[field].clone()
    col[5] = ~col[5] if col.dtype == torch.bool else col[5] ^ 1
    states[field] = col
    forged = dataclasses.replace(w, cell_states=states)
    got = failing_rows(residuals_to_numpy(
        sv.eval_constraints(forged, sv.StorageValidityConfig(LIMIT))))
    assert got and _jax_verdict(forged) == got
    assert 4 in got["cell_state_transitions"]


def test_step_loop_chains_equal_the_native_ones(pair):
    _, w, _ = pair
    n = 6
    cut = [LogQueries(*[getattr(q, f)[:n] for f in LogQueries.__dataclass_fields__])
           for q in (w.unsorted, w.sorted)]
    ts = w.sorted_ts[:n]
    cfg = sv.StorageValidityConfig(8)
    a = sv.generate_witness(*cut, ts, cfg, backend="device")
    b = sv.generate_witness(*cut, ts, cfg, backend="host")
    assert_same(witness_to_numpy(a, FIELDS["storage"]), witness_to_numpy(b, FIELDS["storage"]))


def test_unreverted_storage_is_rejected_as_by_jax():
    """the EraVM oracle keeps a reverted write's value, so the read after the
    revert reports it: both packages reject the storage log at that read"""
    v, _ = run_vm(vm.EraVM, dict(PROGRAMS["log_revert_appends_rollback"], tamper=None))
    unsorted, sorted_q, ts, b = _inputs(v)
    w = sv.generate_witness(unsorted, sorted_q, ts, sv.StorageValidityConfig(LIMIT))
    got = failing_rows(residuals_to_numpy(sv.eval_constraints(w, sv.StorageValidityConfig(LIMIT))))
    last_read = max(i for i, r in enumerate(b["storage_sorted"]) if not r["rw_flag"])
    assert got == {"read_consistency": [last_read]}
    assert _jax_verdict(w) == got
