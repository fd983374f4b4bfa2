"""ram_permutation constraint evaluation and compact forms: the torch port
against the JAX package on the same tapes, residual by residual.

The cases are those of tests/test_ram_permutation.py (the reference fixture,
then one tamper per check group) plus a strided-chain run of two instances
from seeded tapes.  Everything is integer arithmetic: the residual dicts must
be equal key by key and element by element, and the compact forms field by
field as u64, with no tolerance.
"""

import dataclasses

import numpy as np
import pytest

from zkevm_circuits_tpu.base_structures.memory_query import MemoryQueries as JMemoryQueries
from zkevm_circuits_tpu.models import ram_permutation as jram

from zkevm_circuits_tpu_torch.base_structures.memory_query import MemoryQueries
from zkevm_circuits_tpu_torch.isa.system_params import BOOTLOADER_HEAP_PAGE
from zkevm_circuits_tpu_torch.models import ram_permutation as ram
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.utils.convert import residuals_to_numpy
from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"


def _q(ts, page, index, rw, value, is_ptr=False):
    return dict(timestamp=ts, memory_page=page, index=index, rw_flag=rw, is_ptr=is_ptr,
                value=value)


def _reference_fixture():
    unsorted = [
        _q(1025, 30, 0, False, 1125899906842626),
        _q(1024, 30, 0, True, 1125899906842626),
        _q(0, BOOTLOADER_HEAP_PAGE, 695, True, 12345678),
    ]
    return unsorted, [unsorted[2], unsorted[1], unsorted[0]]


def _cases():
    """name -> (unsorted rows, sorted rows, limit, the residual that must fail or None)."""
    unsorted, sorted_q = _reference_fixture()
    bad_value = [dict(r) for r in sorted_q]
    bad_value[1]["value"] += 1
    rw = [_q(10, 5, 0, True, 42), _q(11, 5, 0, False, 43)]
    uninit = [_q(1, 4, 0, True, 1), _q(10, 5, 3, False, 7)]
    multi = [_q(100 + i, 7, i, True, 1000 + i) for i in range(6)]
    return {
        "honest": (unsorted, sorted_q, 4, None),
        "permuted_multiset": (unsorted, bad_value, 4, "grand_product_final"),
        "sort_order": (unsorted, [sorted_q[1], sorted_q[0], sorted_q[2]], 4, "sort_order"),
        "read_consistency": (rw, rw, 4, "read_consistency"),
        "uninit_read": (uninit, uninit, 4, "uninit_read_zero"),
        "multi_instance": (multi, multi, 2, None),
    }


CASES = _cases()


def _jax_compact_np(cf):
    return {
        f.name: (np.asarray(getattr(cf, f.name)) if f.name.endswith("_flag")
                 else np.asarray(getattr(cf, f.name).astype_u64()))
        for f in dataclasses.fields(cf)
    }


def _torch_compact_np(cf):
    return {
        f.name: (getattr(cf, f.name).numpy() if f.name.endswith("_flag")
                 else gf.to_u64(getattr(cf, f.name)))
        for f in dataclasses.fields(cf)
    }


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's residuals and compact forms, once per case."""
    out = {}
    for name, (unsorted, sorted_q, limit, _) in CASES.items():
        cfg = jram.RamPermutationConfig(limit=limit)
        w = jram.generate_witness(
            JMemoryQueries.from_lists(unsorted), JMemoryQueries.from_lists(sorted_q), cfg,
            backend="host",
        )
        res = {k: np.asarray(v) for k, v in jram.eval_constraints(w, cfg).items()}
        out[name] = (res, _jax_compact_np(jram.instance_compact_forms(w, cfg)))
    return out


def _torch_witness(name, backend):
    unsorted, sorted_q, limit, _ = CASES[name]
    cfg = ram.RamPermutationConfig(limit=limit)
    w = ram.generate_witness(
        MemoryQueries.from_lists(unsorted, CPU), MemoryQueries.from_lists(sorted_q, CPU), cfg,
        backend=backend,
    )
    return w, cfg


@pytest.mark.parametrize("name", list(CASES))
def test_residuals_equal_jax(jax_results, name):
    w, cfg = _torch_witness(name, "host")
    got = residuals_to_numpy(ram.eval_constraints(w, cfg))
    want, _ = jax_results[name]
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key
    failing = CASES[name][3]
    bad = [k for k, v in got.items() if not v.all()]
    if failing is None:
        assert not bad and ram.all_ok(ram.eval_constraints_jit(w, cfg))
    else:
        assert failing in bad


@pytest.mark.parametrize("name", list(CASES))
def test_compact_forms_equal_jax(jax_results, name):
    w, cfg = _torch_witness(name, "host")
    got = _torch_compact_np(ram.instance_compact_forms(w, cfg))
    _, want = jax_results[name]
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_device_backend_equals_host_backend():
    """The torch chain (`queues.simulate_chain`) gives the native chain's witness."""
    w_dev, cfg = _torch_witness("multi_instance", "device")
    w_host, _ = _torch_witness("multi_instance", "host")
    for name in ("chain_unsorted", "chain_sorted", "challenges", "lhs", "rhs", "nondet_count"):
        assert np.array_equal(getattr(w_dev, name).numpy(), getattr(w_host, name).numpy()), name
    assert ram.all_ok(ram.eval_constraints(w_dev, cfg))


@pytest.fixture(scope="module")
def strided():
    """Two instances of 2^6 rows from the seeded tapes, chain stride 16, on both sides."""
    tapes = build_tapes_np(100)
    jcfg = jram.RamPermutationConfig(limit=64, chain_stride=16)
    jw = jram.generate_witness_host_tapes(*tapes, jcfg)
    cfg = ram.RamPermutationConfig(limit=64, chain_stride=16)
    w = ram.generate_witness_host_tapes(*tapes, cfg, device=CPU)
    return jw, jcfg, w, cfg


def test_strided_residuals_and_compact_forms_equal_jax(strided):
    jw, jcfg, w, cfg = strided
    want = {k: np.asarray(v) for k, v in jram.eval_constraints(jw, jcfg).items()}
    got = residuals_to_numpy(ram.eval_constraints(w, cfg))
    assert list(got) == list(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert all(v.all() for v in got.values())
    assert got["chain_unsorted"].shape == (128 // 16,)
    jcf = _jax_compact_np(jram.instance_compact_forms(jw, jcfg))
    tcf = _torch_compact_np(ram.instance_compact_forms(w, cfg))
    assert tcf["start_flag"].tolist() == [True, False]
    assert tcf["completion_flag"].tolist() == [False, True]
    for key in jcf:
        assert np.array_equal(tcf[key], jcf[key]), key


def test_strided_tampered_value_fails_encoding_only(strided):
    """One limb of sorted.value changed after witness generation: the stored
    encoding no longer matches the fields at that row, and nothing else fails
    (the tapes hold only writes to distinct cells)."""
    _, _, w, cfg = strided
    value = w.sorted.value.clone()
    value[37, 2] ^= 1
    bad = dataclasses.replace(w, sorted=dataclasses.replace(w.sorted, value=value))
    res = residuals_to_numpy(ram.eval_constraints(bad, cfg))
    assert [k for k, v in res.items() if not v.all()] == ["encoding_sorted"]
    assert np.flatnonzero(~res["encoding_sorted"]).tolist() == [37]


def test_tampered_chain_boundary_fails_segment(strided):
    _, _, w, cfg = strided
    chain = w.chain_sorted.clone()
    chain[3, 9] ^= 1  # a capacity lane: a push replaces the rate lanes
    res = residuals_to_numpy(ram.eval_constraints(dataclasses.replace(w, chain_sorted=chain), cfg))
    assert np.flatnonzero(~res["chain_sorted"]).tolist() == [2, 3]
    assert res["chain_unsorted"].all()
