"""sort_decommittment_requests (circuit type 2) in the torch port against the
JAX package on the CPU, on the decommit requests of a short run of
chip_smoke.py's log-heavy program (the bootloader's own request, then one a
far call into four callees, so that hashes repeat with their first page) in
two instances.

Exact equality: the witness, the residual dict, the compact forms, the
port's evaluation of the JAX package's witness; a changed request fails the
same residuals at the same rows under both packages' evaluations.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from zkevm_circuits_tpu.base_structures.decommit_query import DecommitQueries as JDecommitQueries
from zkevm_circuits_tpu.models import sort_decommittment_requests as jsd

from torch_log_helpers import (
    FIELDS, assert_same, assert_same_residuals, failing, failing_rows,
    jax_to_numpy, numpy_to_jax,
)
from zkevm_circuits_tpu_torch.base_structures.decommit_query import DecommitQueries
from zkevm_circuits_tpu_torch.models import sort_decommittment_requests as sd
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.runtime import block
from zkevm_circuits_tpu_torch.utils.convert import (
    decommit_sorter_witness_from_numpy, residuals_to_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
LIMIT = 8


@pytest.fixture(scope="module")
def requests():
    words, kw = chip_smoke.log_program(10)
    v = vm.NativeEraVM(words, 512, **kw)
    v.run()
    b = block.block_rows(v)
    assert len(b["dec"]) == 11 and sum(r["is_first"] for r in b["dec"]) == 5
    return b["dec"], b["dec_sorted"]


@pytest.fixture(scope="module")
def pair(requests):
    dec, dec_sorted = requests
    jw = jsd.generate_witness(JDecommitQueries.from_lists(dec),
                              JDecommitQueries.from_lists(dec_sorted),
                              jsd.DecommitSorterConfig(LIMIT))
    w = sd.generate_witness(DecommitQueries.from_lists(dec, CPU),
                            DecommitQueries.from_lists(dec_sorted, CPU),
                            sd.DecommitSorterConfig(LIMIT))
    return jw, w, jax_to_numpy(jw)


def _jax_verdict(w):
    jw = numpy_to_jax(jsd.DecommitSorterWitness, witness_to_numpy(w, FIELDS["decommit"]),
                      FIELDS["decommit"], JDecommitQueries)
    return failing_rows(jsd.eval_constraints(jw, jsd.DecommitSorterConfig(LIMIT)))


def test_witness_residuals_and_forms_equal_jax(pair):
    jw, w, jnp_w = pair
    cfg, jcfg = sd.DecommitSorterConfig(LIMIT), jsd.DecommitSorterConfig(LIMIT)
    assert_same(witness_to_numpy(w, FIELDS["decommit"]), jnp_w)
    want = {k: np.asarray(v) for k, v in jsd.eval_constraints(jw, jcfg).items()}
    assert not failing(want)
    assert_same_residuals(residuals_to_numpy(sd.eval_constraints(w, cfg)), want)
    carried = decommit_sorter_witness_from_numpy(jnp_w, device=CPU)
    assert_same_residuals(residuals_to_numpy(sd.eval_constraints_jit(carried, cfg)), want)
    forms = sd.instance_compact_forms(w, cfg)
    assert forms.start_flag.shape == (2,)
    assert_same(witness_to_numpy(forms, FIELDS["forms"]),
                jax_to_numpy(jsd.instance_compact_forms(jw, jcfg)))
    assert int(w.result_count[-1]) == 5  # one record a distinct hash


@pytest.mark.parametrize("field,row", [("page", 2), ("is_first", 1), ("timestamp", 3)])
def test_changed_request_fails_as_jax(pair, field, row):
    _, w, _ = pair
    col = getattr(w.sorted, field).clone()
    col[row] = ~col[row] if field == "is_first" else col[row] + 1
    forged = dataclasses.replace(w, sorted=dataclasses.replace(w.sorted, **{field: col}))
    got = failing_rows(residuals_to_numpy(
        sd.eval_constraints(forged, sd.DecommitSorterConfig(LIMIT))))
    assert got and _jax_verdict(forged) == got


def test_step_loop_chains_equal_the_native_ones(requests, pair):
    dec, dec_sorted = requests
    w = sd.generate_witness(DecommitQueries.from_lists(dec, CPU),
                            DecommitQueries.from_lists(dec_sorted, CPU),
                            sd.DecommitSorterConfig(LIMIT), backend="device")
    assert_same(witness_to_numpy(w, FIELDS["decommit"]), pair[2])
