"""The block's log path in the torch port against the JAX package on the CPU:
the batched keccak ops and the linear hasher (type 13), then demux ->
storage / events / L1 sorters -> hasher as the block runtime wires them
(`runtime.block.log_path`) on the two log programs of
tests/torch_vm_programs.py.  Demux itself and a short run of chip_smoke.py's
log-heavy program are in tests/test_torch_demux.py.

Exact equality throughout: keccak lanes, witnesses (u64 field elements, u32
and bool columns by value), residual dicts and compact forms; chip_smoke.py's
keccak-lane probe fails the same residuals at the same rows on both sides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.models import linear_hasher as jlh
from zkevm_circuits_tpu.ops import keccak as jkeccak

from torch_log_helpers import (
    FIELDS, assert_same, assert_same_residuals, failing, failing_rows, jax_to_numpy,
)
from torch_vm_programs import PROGRAMS, run_vm
from zkevm_circuits_tpu_torch.base_structures.log_query import LogQueries
from zkevm_circuits_tpu_torch.isa import system_params as sp
from zkevm_circuits_tpu_torch.models import linear_hasher as lh
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.ops import keccak
from zkevm_circuits_tpu_torch.runtime import block
from zkevm_circuits_tpu_torch.utils.convert import (
    linear_hasher_witness_from_numpy, residuals_to_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# keccak ops
# ---------------------------------------------------------------------------


def _random_states(seed, batch):
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 1 << 64, size=(batch, 25), dtype=np.uint64)
    lanes[0] = M64  # every lane with its top bit set
    lanes[1] = 1 << 63
    lanes[2] = 0
    return lanes


def _halves(lanes):
    return ((lanes & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (lanes >> np.uint64(32)).astype(np.uint32))


def _join(lo, hi):
    return np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64) << np.uint64(32))


def test_keccak_f1600_equals_jax_and_the_host_reference():
    lanes = _random_states(7, 6)
    lo, hi = _halves(lanes)
    tlo, thi = keccak.keccak_f1600(torch.from_numpy(lo.astype(np.int64)),
                                   torch.from_numpy(hi.astype(np.int64)))
    assert tlo.dtype == torch.int64 and int(tlo.min()) >= 0 and int(tlo.max()) < 1 << 32
    got = _join(tlo.numpy(), thi.numpy())
    jlo, jhi = jkeccak.keccak_f1600(jnp.asarray(lo), jnp.asarray(hi))
    assert np.array_equal(got, _join(jlo, jhi))
    for row, state in zip(got, lanes):
        assert row.tolist() == keccak.keccak_f1600_ref([int(x) for x in state])


@pytest.mark.parametrize("r", [0, 1, 31, 32, 33, 63])
def test_rotl64_equals_jax(r):
    lo, hi = _halves(_random_states(r, 4))
    a = keccak._rotl64(torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64)), r)
    b = jkeccak._rotl64(jnp.asarray(lo), jnp.asarray(hi), r)
    assert np.array_equal(_join(a[0].numpy(), a[1].numpy()), _join(*b))


def test_absorb_block_equals_jax():
    lanes = _random_states(3, 4)
    block = np.random.default_rng(4).integers(0, 1 << 64, size=(4, 17), dtype=np.uint64)
    lo, hi = _halves(lanes)
    blo, bhi = _halves(block)
    t = [torch.from_numpy(x.astype(np.int64)) for x in (lo, hi, blo, bhi)]
    got = keccak.absorb_block(*t)
    want = jkeccak.absorb_block(*(jnp.asarray(x) for x in (lo, hi, blo, bhi)))
    assert np.array_equal(_join(got[0].numpy(), got[1].numpy()), _join(*want))
    assert keccak.keccak256_ref(b"") == jkeccak.keccak256_ref(b"")


# ---------------------------------------------------------------------------
# the linear hasher against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hasher_pair():
    """the L1 message of log_storage_and_events, in a hasher of 4 messages
    (3 keccak blocks, 1 executed)"""
    v, _ = run_vm(vm.EraVM, dict(PROGRAMS["log_storage_and_events"], tamper=None))
    rows = [dict(q) for q in v.log_tape if q["aux_byte"] == sp.L1_MESSAGE_AUX_BYTE]
    assert len(rows) == 1
    cfg = lh.LinearHasherConfig(limit=4)
    jw = jlh.generate_witness(JLogQueries.from_lists(rows), jlh.LinearHasherConfig(limit=4))
    return rows, cfg, jw, lh.generate_witness(LogQueries.from_lists(rows, CPU), cfg)


def test_linear_hasher_equals_jax(hasher_pair):
    rows, cfg, jw, w = hasher_pair
    jnp_w = jax_to_numpy(jw)
    assert_same(witness_to_numpy(w, FIELDS["hasher"]), jnp_w)
    jcfg = jlh.LinearHasherConfig(limit=4)
    want = {k: np.asarray(v) for k, v in jlh.eval_constraints(jw, jcfg).items()}
    assert_same_residuals(residuals_to_numpy(lh.eval_constraints(w, cfg)), want)
    assert not failing(want)
    carried = linear_hasher_witness_from_numpy(jnp_w, device=CPU)
    assert_same_residuals(residuals_to_numpy(lh.eval_constraints_jit(carried, cfg)), want)
    digest = bytes(w.digest.tolist())
    assert digest == keccak.keccak256_ref(lh.serialize_l2_l1_ref(rows[0]))
    assert lh.serialize_l2_l1_ref(rows[0]) == jlh.serialize_l2_l1_ref(rows[0])
    assert np.array_equal(lh.serialize_l2_l1_bytes(w.queries).numpy(),
                          np.asarray(jlh.serialize_l2_l1_bytes(jw.queries)))
    assert_same(witness_to_numpy(lh.instance_compact_form(w, cfg), FIELDS["forms"]),
                jax_to_numpy(jlh.instance_compact_form(jw, jcfg)))


def test_keccak_lane_probe_fails_as_jax(hasher_pair):
    _, cfg, jw, w = hasher_pair
    forged, want = chip_smoke.probe_keccak_lane(w)
    assert want == {"keccak_chain": [0, 1], "digest": [0]}
    jforged = dataclasses.replace(jw, state_lo=jw.state_lo.at[1, 3].set(jw.state_lo[1, 3] ^ 1))
    assert failing_rows(jlh.eval_constraints(jforged, jlh.LinearHasherConfig(limit=4))) == want
    assert failing_rows(residuals_to_numpy(lh.eval_constraints(forged, cfg))) == want


# ---------------------------------------------------------------------------
# the path: demux -> sorters -> hasher, with the handoffs and the digest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["log_storage_and_events", "log_revert_appends_rollback"])
def test_block_log_path_on_a_program(name):
    """every circuit satisfied, every handoff true, the L1 digest equal to
    the host keccak of the survivors (keccak256("") when none survives)"""
    entry = dict(PROGRAMS[name], tamper=None)
    v, w = run_vm(vm.EraVM, entry)
    out, handoffs, digest, want, counts = block.log_path(v, w, (8, 8), torch.device(CPU))
    bad = {n: chip_smoke._bad(r) for n, (_, r, _) in out.items() if chip_smoke._bad(r)}
    # the programs preset registers, which main_vm's boot pins reject; and the
    # EraVM oracle does not undo the reverted storage write, so the read after
    # the revert sees the reverted value and storage_validity rejects it, as
    # the JAX package's does (tests/test_torch_storage_validity.py; ROADMAP
    # Queue 3)
    assert set(bad.pop("main_vm")) == {"protocol_boot_r1", "protocol_boot_regs_clear"}
    if name == "log_revert_appends_rollback":
        assert bad == {"storage_validity": ["read_consistency"]}
    else:
        assert not bad
    assert all(handoffs.values()) and len(handoffs) == 6
    assert digest == want
    if name == "log_storage_and_events":
        assert counts["l1_survivors"] == 1 and counts["storage"] >= 2
    else:
        assert counts["rollbacks"] >= 2 and counts["l1_survivors"] == 0
        assert digest == keccak.keccak256_ref(b"")
    # the survivors the hasher took are the L1 sorter's result queue
    lw, hw = out["log_sorter_12"][0], out["linear_hasher"][0]
    survivors = block.soa_rows(lw.result_items, lw.result_add)
    assert len(survivors) == counts["l1_survivors"] == hw.n
    assert block.soa_rows(hw.queries, hw.execute) == survivors
