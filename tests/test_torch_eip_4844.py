"""eip_4844 and the VM lookup tables in the torch port against the JAX
package on the CPU.

The seven table builders equal, `lookup_row_ids` equal, `lookup_check`
true on the found rows and false where a row id or a query changes.  The
blob circuit on seeded chunks (a partial blob padded with zero chunks): the
witness, the residual dict, the compact form, the port's evaluation of the
JAX package's witness, the hashes against chip_smoke.py's host
recomputation, and its negative probe (a changed coefficient) under both
packages' evaluations.  Exact equality.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from torch_log_helpers import assert_same_residuals, failing_rows, jax_to_numpy
from torch_precompile_helpers import assert_same_forms, assert_same_witness, to_jax
from zkevm_circuits_tpu import tables as jtables
from zkevm_circuits_tpu.models import eip_4844 as je

from zkevm_circuits_tpu_torch import tables
from zkevm_circuits_tpu_torch.models import eip_4844 as e44
from zkevm_circuits_tpu_torch.utils.convert import (
    eip_4844_witness_from_numpy, residuals_to_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
ELEMENTS = 16


@pytest.mark.parametrize("name", sorted(jtables.ALL_TABLES))
def test_tables_equal_jax_and_lookups_hold(name):
    table = tables.ALL_TABLES[name]()
    assert np.array_equal(table, jtables.ALL_TABLES[name]())
    rng = np.random.default_rng(len(name))
    queries = table[rng.integers(0, table.shape[0], size=9)]
    ids = tables.lookup_row_ids(table, queries)
    assert np.array_equal(ids, jtables.lookup_row_ids(table, queries))
    ok = tables.lookup_check(table, queries, torch.from_numpy(ids.astype(np.int64)))
    assert ok.dtype == torch.bool and bool(ok.all())
    assert np.array_equal(ok.numpy(), np.asarray(jtables.lookup_check(table, queries, ids)))
    bad = queries.copy()
    bad[0, -1] += np.uint64(1 << 40)  # beyond 32 bits: the u64 compare sees it
    got = tables.lookup_check(table, bad, torch.from_numpy(ids.astype(np.int64)))
    assert got.tolist() == np.asarray(jtables.lookup_check(table, bad, ids)).tolist()
    assert not bool(got[0]) and bool(got[1:].all())


@pytest.fixture(scope="module")
def case():
    chunks, vh = chip_smoke.blob_inputs(ELEMENTS - 3, 44)
    cfg, jcfg = e44.EIP4844Config(ELEMENTS), je.EIP4844Config(ELEMENTS)
    jw = je.generate_witness(chunks, vh, jcfg)
    w = e44.generate_witness(chunks, vh, cfg, device=CPU)
    want = {k: np.asarray(v) for k, v in je.eval_constraints(jw, jcfg).items()}
    return chunks, vh, jw, w, want


def test_witness_residuals_and_form_equal_jax(case):
    chunks, vh, jw, w, want = case
    cfg, jcfg = e44.EIP4844Config(ELEMENTS), je.EIP4844Config(ELEMENTS)
    assert_same_witness(w, jw, ())
    assert not failing_rows(want)
    assert_same_residuals(residuals_to_numpy(e44.eval_constraints(w, cfg)), want)
    carried = eip_4844_witness_from_numpy(jax_to_numpy(jw), device=CPU)
    assert_same_residuals(residuals_to_numpy(e44.eval_constraints_jit(carried, cfg)), want)
    assert_same_forms(e44.instance_compact_form(w, cfg), je.instance_compact_form(jw, jcfg))
    padded = list(chunks) + [bytes(31)] * 3
    assert (bytes(w.linear_hash.tolist()), bytes(w.output_hash.tolist())) == \
        chip_smoke.blob_host(padded, vh)
    assert e44.ELEMENTS_PER_4844_BLOCK == je.ELEMENTS_PER_4844_BLOCK == 4096


def test_changed_coefficient_fails_as_in_jax(case):
    *_, w, _ = case
    forged, want = chip_smoke.probe_blob_coefficient(w)
    cfg = e44.EIP4844Config(ELEMENTS)
    assert failing_rows(residuals_to_numpy(e44.eval_constraints(forged, cfg))) == want
    jforged = to_jax(je.EIP4844Witness, witness_to_numpy(forged, ()), (), {})
    assert failing_rows(je.eval_constraints(jforged, je.EIP4844Config(ELEMENTS))) == want
