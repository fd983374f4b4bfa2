"""log_sorter (circuit types 11 and 12) in the torch port against the JAX
package on the CPU: seeded event tapes with rollbacks (chip_smoke.py's
`event_tapes`) in two instances, through `generate_witness` and through the
host pipeline `generate_witness_host_tapes`.

Exact equality: the witness (u64 field elements, u32 and bool columns by
value), the residual dict, the compact forms; the port's evaluation of the
JAX package's witness; chip_smoke.py's swapped-events probe fails the same
residuals at the same rows under both packages' evaluations.
"""

import numpy as np
import pytest

import chip_smoke
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.models import log_sorter as jls

from torch_log_helpers import (
    FIELDS, assert_same, assert_same_residuals, failing, failing_rows, jax_queries,
    jax_to_numpy, numpy_to_jax,
)
from zkevm_circuits_tpu_torch.base_structures.log_query import LogQueries
from zkevm_circuits_tpu_torch.models import log_sorter as ls
from zkevm_circuits_tpu_torch.utils.convert import (
    log_sorter_witness_from_numpy, residuals_to_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
LIMIT = 8


@pytest.fixture(scope="module")
def tapes():
    unsorted, sorted_t = chip_smoke.event_tapes(14, 5)
    assert unsorted["rollback"].any() and unsorted["timestamp"].shape[0] <= 14
    return unsorted, sorted_t


@pytest.fixture(scope="module")
def pair(tapes):
    unsorted, sorted_t = tapes
    jw = jls.generate_witness(jax_queries(JLogQueries, unsorted),
                              jax_queries(JLogQueries, sorted_t), jls.LogSorterConfig(LIMIT))
    w = ls.generate_witness(LogQueries.from_numpy(unsorted, CPU),
                            LogQueries.from_numpy(sorted_t, CPU), ls.LogSorterConfig(LIMIT))
    return jw, w, jax_to_numpy(jw)


def test_witness_residuals_and_forms_equal_jax(pair):
    jw, w, jnp_w = pair
    cfg, jcfg = ls.LogSorterConfig(LIMIT), jls.LogSorterConfig(LIMIT)
    assert_same(witness_to_numpy(w, FIELDS["log_sorter"]), jnp_w)
    want = {k: np.asarray(v) for k, v in jls.eval_constraints(jw, jcfg).items()}
    assert not failing(want)
    assert_same_residuals(residuals_to_numpy(ls.eval_constraints(w, cfg)), want)
    carried = log_sorter_witness_from_numpy(jnp_w, device=CPU)
    assert_same_residuals(residuals_to_numpy(ls.eval_constraints_jit(carried, cfg)), want)
    forms = ls.instance_compact_forms(w, cfg)
    assert forms.start_flag.shape == (2,)
    assert_same(witness_to_numpy(forms, FIELDS["forms"]),
                jax_to_numpy(jls.instance_compact_forms(jw, jcfg)))


def test_host_tapes_equal_jax_witness(tapes, pair):
    """the host pipeline makes the witness `generate_witness` makes, field by
    field (the JAX package's host pipeline makes the same one)"""
    _, _, jnp_w = pair
    w = ls.generate_witness_host_tapes(*tapes, ls.LogSorterConfig(LIMIT), device=CPU)
    assert_same(witness_to_numpy(w, FIELDS["log_sorter"]), jnp_w)
    jhost = jls.generate_witness_host_tapes(*tapes, jls.LogSorterConfig(LIMIT))
    assert_same(jax_to_numpy(jhost), jnp_w)


def test_step_loop_chains_equal_the_native_ones(tapes, pair):
    unsorted, sorted_t = tapes
    w = ls.generate_witness(LogQueries.from_numpy(unsorted, CPU),
                            LogQueries.from_numpy(sorted_t, CPU), ls.LogSorterConfig(LIMIT),
                            backend="device")
    assert_same(witness_to_numpy(w, FIELDS["log_sorter"]), pair[2])


def test_swapped_events_probe_fails_as_jax(pair):
    _, w, _ = pair
    forged, want = chip_smoke.probe_swapped_events(w, LIMIT)
    got = failing_rows(residuals_to_numpy(ls.eval_constraints(forged, ls.LogSorterConfig(LIMIT))))
    jforged = numpy_to_jax(jls.LogSorterWitness, witness_to_numpy(forged, FIELDS["log_sorter"]),
                           FIELDS["log_sorter"], JLogQueries)
    assert failing_rows(jls.eval_constraints(jforged, jls.LogSorterConfig(LIMIT))) == got == want


@pytest.mark.parametrize("field,row,expect", [
    ("rw_flag", 3, "writes_only"),
    ("rollback", 0, "new_log_not_rollback"),
])
def test_tampered_sorted_row_fails_as_jax(pair, field, row, expect):
    """a changed flag of one sorted row: the same residuals fail on both sides"""
    import dataclasses

    _, w, _ = pair
    col = getattr(w.sorted, field).clone()
    col[row] = ~col[row]
    forged = dataclasses.replace(w, sorted=dataclasses.replace(w.sorted, **{field: col}))
    got = failing_rows(residuals_to_numpy(ls.eval_constraints(forged, ls.LogSorterConfig(LIMIT))))
    jforged = numpy_to_jax(jls.LogSorterWitness, witness_to_numpy(forged, FIELDS["log_sorter"]),
                           FIELDS["log_sorter"], JLogQueries)
    assert failing_rows(jls.eval_constraints(jforged, jls.LogSorterConfig(LIMIT))) == got
    assert expect in got
