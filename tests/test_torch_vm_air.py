"""The port's main_vm committed-trace AIR (prover/vm_air.py) against the JAX
package, on six EraVM programs: the two of tests/test_vm_air.py and four of
tests/torch_vm_programs.py that the JAX AIR accepts.

Exact u64 equality with the JAX package for the column layout, the fixed
tables, the phase-1 trace, the phase-2 columns under two challenge sets, the
boundary state vectors, the code-read stream, its RLC and the publics; each
package's own EraVM makes its witness.  The port's constraints vanish on
every honest trace, and the reference's near-call panic fault is pinned.
The constraints themselves are held to the JAX AIR's in
tests/test_torch_vm_air_constraints.py, whole proofs in
tests/test_torch_vm_verifier_airs_slow.py.
"""

import numpy as np
import pytest
import torch

import jax

from torch_air_helpers import u64
from torch_vm_programs import PROGRAMS, VM_AIR_PROGRAMS, run_vm
from zkevm_circuits_tpu.base_structures.memory_query import encode_memory_query_ref
from zkevm_circuits_tpu.models import vm as jvm
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.prover import vm_air as jair
from zkevm_circuits_tpu_torch.base_structures.memory_query import encode_memory_queries_np
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import vm_air
from zkevm_circuits_tpu_torch.prover.stark import StarkParams
from zkevm_circuits_tpu_torch.runtime.block import memory_tapes
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

ACCEPTED = ["arith_families", "context_family", "log_storage_and_events",
            "far_call_roundtrip_and_page_reuse"]
NAMES = list(VM_AIR_PROGRAMS) + ACCEPTED
CHALLENGES = [jair._DEBUG_CH,
              tuple(int(x) for x in np.random.default_rng(11).integers(
                  1 << 40, gf.MODULUS, size=7, dtype=np.uint64))]


def _program(name):
    return VM_AIR_PROGRAMS[name] if name in VM_AIR_PROGRAMS else PROGRAMS[name]


@pytest.fixture(scope="module")
def witnesses():
    """name -> (the JAX EraVM's witness, the port's EraVM and witness)."""
    out = {}
    for name in NAMES:
        _, jw = run_vm(jvm.EraVM, _program(name))
        v, pw = run_vm(vm.EraVM, _program(name))
        out[name] = (jw, v, pw)
    return out


def _jax_phase2(cols, ch):
    """The JAX `_build_phase2`, compiled once per challenge set by XLA."""
    return jax.jit(jair._build_phase2, static_argnums=1)(cols, ch)


def _jax_publics(phase1, w, limit, ch):
    s_in, s_out = jair.boundary_state_vectors(phase1)
    macc = jair.stream_rlc(jair.code_read_queries(w, limit), ch[jair._MQ])
    return jair._boundary_publics(s_in, s_out, ch[jair._RLC], macc)


@pytest.fixture(scope="module")
def jax_side(witnesses):
    """Everything the JAX package computes, for every program."""
    out = {}
    for name in NAMES:
        w, limit = witnesses[name][0], _program(name)["limit"]
        phase1, fixed, log_n = jair.vm_core_trace(w, limit)
        cols = jgf.concat([fixed, phase1], axis=0)
        s_in, s_out = jair.boundary_state_vectors(phase1)
        reads = np.asarray(jair.code_read_queries(w, limit), np.uint64)
        out[name] = dict(
            phase1=u64(phase1), fixed=u64(fixed), log_n=log_n,
            phase2=[u64(_jax_phase2(cols, ch)) for ch in CHALLENGES],
            state=(s_in, s_out), reads=reads,
            rlc=[jair.stream_rlc(reads, ch[jair._MQ]) for ch in CHALLENGES],
            publics=[u64(_jax_publics(phase1, w, limit, ch)) for ch in CHALLENGES])
    return out


@pytest.fixture(scope="module")
def port_side(witnesses):
    out = {}
    for name in NAMES:
        w, limit = witnesses[name][2], _program(name)["limit"]
        phase1, fixed, log_n = vm_air.vm_core_trace(w, limit, "cpu")
        out[name] = dict(phase1=phase1, fixed=fixed, log_n=log_n, w=w, limit=limit)
    return out


def test_layout_matches_jax():
    for reg, jreg in zip(vm_air.layout()[:3], jair.layout()[:3]):
        assert list(reg.index.items()) == [(nm, jreg.index[nm]) for nm, _ in jreg.names]
        assert reg.n == jreg.n
    assert vm_air.layout()[3] == jair.layout()[3]
    assert vm_air._byte_query_names() == jair._byte_query_names()
    assert (vm_air._BOOL_COLS, vm_air._BOOL_SPANS) == (jair._BOOL_COLS, jair._BOOL_SPANS)
    fx, p1, p2, _ = vm_air.layout()
    air = vm_air.vm_core_air()
    assert (fx.n, p1.n, p2.n) == (7, 1469, 446)
    assert (air.total_cols, air.num_challenges, air.num_public, air.max_degree) == (1922, 7, 3, 3)


def test_fixed_tables_match_jax():
    np.testing.assert_array_equal(gf.to_u64(vm_air.fixed_tables(1 << 11, "cpu")),
                                  u64(jair.fixed_tables(1 << 11)))


@pytest.mark.parametrize("name", NAMES)
def test_trace_matches_jax(jax_side, port_side, name):
    want, got = jax_side[name], port_side[name]
    assert got["log_n"] == want["log_n"] == 11
    np.testing.assert_array_equal(gf.to_u64(got["fixed"]), want["fixed"])
    np.testing.assert_array_equal(gf.to_u64(got["phase1"]), want["phase1"])


@pytest.mark.parametrize("k", range(len(CHALLENGES)))
@pytest.mark.parametrize("name", NAMES)
def test_phase2_matches_jax(jax_side, port_side, name, k):
    got = port_side[name]
    p2 = vm_air._build_phase2(torch.cat([got["fixed"], got["phase1"]]), CHALLENGES[k])
    np.testing.assert_array_equal(gf.to_u64(p2), jax_side[name]["phase2"][k])


@pytest.mark.parametrize("name", NAMES)
def test_boundary_code_reads_and_publics_match_jax(jax_side, port_side, name):
    want, got = jax_side[name], port_side[name]
    s_in, s_out = vm_air.boundary_state_vectors(got["phase1"])
    np.testing.assert_array_equal(s_in, want["state"][0])
    np.testing.assert_array_equal(s_out, want["state"][1])
    reads = vm_air.code_read_queries(got["w"], got["limit"])
    np.testing.assert_array_equal(reads, want["reads"])
    assert reads.shape[0] > 0
    for k, ch in enumerate(CHALLENGES):
        rlc = vm_air.stream_rlc(reads, ch[vm_air._MQ])
        assert rlc == want["rlc"][k]
        pub = vm_air._boundary_publics(s_in, s_out, ch[vm_air._RLC], rlc, "cpu")
        np.testing.assert_array_equal(gf.to_u64(pub), want["publics"][k])


@pytest.mark.parametrize("name", NAMES)
def test_residuals_vanish(witnesses, name):
    assert vm_air.debug_residuals(witnesses[name][2], _program(name)["limit"], device="cpu") == {}


def test_near_call_panic_fault_matches_reference():
    """The reference's fault (ROADMAP Queue 3): the pc transition has no term
    for a near call's panic to its exception handler, so this honest witness
    fails it on one row, as the JAX `debug_residuals` does (the slow file
    runs the JAX function itself)."""
    entry = PROGRAMS["near_call_ergs_split_and_panic_return"]
    _, w = run_vm(vm.EraVM, entry)
    assert vm_air.debug_residuals(w, entry["limit"], device="cpu") == {"transition": [(2, 1)]}


@pytest.mark.parametrize("name", ["log_storage_and_events", "vm_air_base"])
def test_memory_tape_encoding_matches_jax_row_encoder(witnesses, name):
    """The type-1 writer encodes the VM's memory tape with the port's
    `encode_memory_queries_np`; row by row it equals the JAX package's
    `encode_memory_query_ref` (which the JAX block runtime uses)."""
    rows = witnesses[name][1].memory_tape
    assert rows
    t = memory_tapes([rows])
    got = encode_memory_queries_np(t["timestamp"], t["memory_page"], t["index"], t["rw_flag"],
                                   t["is_ptr"], t["value"])
    want = np.array([encode_memory_query_ref(r) for r in rows], np.uint64)
    np.testing.assert_array_equal(got, want)


def test_verifier_early_returns(port_side):
    """Wrong state-vector or code-read shapes are refused before any proof
    is read."""
    got = port_side["vm_air_base"]
    s_in, s_out = vm_air.boundary_state_vectors(got["phase1"])
    reads = vm_air.code_read_queries(got["w"], got["limit"])
    params = StarkParams(log_n=11)
    assert not vm_air.verify_vm_core(None, s_in[:-1], s_out, reads, params)
    assert not vm_air.verify_vm_core(None, s_in, s_out, reads[:, :7], params)
