"""The port's Python EraVM (`models/vm/sim.py`) against the JAX package's
`EraVM` and the port's `NativeEraVM`: the same program gives the same witness
columns (dtype, shape and value), the same memory, log and decommit tapes,
the same precompile calls and snapshots, and the same boot rows and hashes.

Programs: every entry of tests/torch_vm_programs.py (run without its tamper)
and the block bootloader of tests/test_block2.py, whose three far calls run
the keccak, sha256 and ecrecover precompiles on the host (through the port's
own copies of the sha256 and secp256k1 host math).
"""

import numpy as np
import pytest

from zkevm_circuits_tpu.models import ecrecover as jecrecover
from zkevm_circuits_tpu.models import sha256_round_function as jsha_rf
from zkevm_circuits_tpu.models import vm as jvm
from zkevm_circuits_tpu.ops import secp256k1 as jsecp
from zkevm_circuits_tpu.ops import sha256 as jsha

from torch_vm_programs import PROGRAMS, run_vm
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.models import ecrecover, sha256_round_function as sha_rf
from zkevm_circuits_tpu_torch.models.vm import sim
from zkevm_circuits_tpu_torch.ops import secp256k1, sha256
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

TAPES = ("memory_tape", "log_tape", "decommit_tape", "precompile_calls", "precompile_memory",
         "initial_mem_rows", "initial_dec_rows", "boot_code_hash")


def _assert_same_run(a, wa, b, wb, same_dtype=True):
    assert list(wa) == list(wb) if same_dtype else sorted(wa) == sorted(wb)
    for k in wa:
        x, y = np.asarray(wa[k]), np.asarray(wb[k])
        assert x.shape == y.shape, k
        if same_dtype:
            assert x.dtype == y.dtype, k
        assert np.array_equal(x.astype(np.uint64), y.astype(np.uint64)), k
    for name in TAPES:
        assert getattr(a, name) == getattr(b, name), name
    assert np.array_equal(np.asarray(a.block_rollback_tail, np.uint64),
                          np.asarray(b.block_rollback_tail, np.uint64))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_sim_equals_jax_sim_and_native(name):
    entry = dict(PROGRAMS[name], tamper=None)
    vt, wt = run_vm(vm.EraVM, entry)
    vj, wj = run_vm(jvm.EraVM, entry)
    _assert_same_run(vt, wt, vj, wj)
    vn, wn = run_vm(vm.NativeEraVM, entry)
    _assert_same_run(vt, wt, vn, wn, same_dtype=False)


def _block_program():
    """the bootloader of tests/test_block2.py with its three precompile
    contracts, as tests/test_vm_native.py builds it"""
    import test_block2 as tb

    from zkevm_circuits_tpu.isa import system_params as jsp
    from zkevm_circuits_tpu.models import code_unpacker_sha256 as cu
    from zkevm_circuits_tpu.ops.keccak import keccak256_ref

    codes = {jsp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS: tb._ecrecover_contract(),
             jsp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS: tb._keccak_contract(),
             jsp.SHA256_PRECOMPILE_FORMAL_ADDRESS: tb._sha256_contract()}
    hashes = {a: cu.make_request(c, 0, 0)["code_hash"] for a, c in codes.items()}
    storage = {(0, jsp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, a): h for a, h in hashes.items()}
    code_store = {hashes[a]: c for a, c in codes.items()}
    h = int.from_bytes(keccak256_ref(b"zk block"), "big")
    r, s, recid = jsecp.sign(h, 0xC0FFEE, 0x12345)
    prog = tb._bootloader(len(tb._bootloader(None)) - 1)
    return dict(prog=prog, limit=128, regs={}, tamper=None,
                kw=dict(storage=storage, code_store=code_store,
                        bootloader_heap={0: h, 1: recid, 2: r, 3: s}))


def test_sim_runs_the_precompiles_as_jax_sim_and_native():
    entry = _block_program()
    vt, wt = run_vm(vm.EraVM, entry)
    vj, wj = run_vm(jvm.EraVM, entry)
    _assert_same_run(vt, wt, vj, wj)
    assert [len(vt.precompile_calls[k]) for k in ("keccak", "sha256", "ecrecover")] == [1, 1, 1]
    vn, wn = run_vm(vm.NativeEraVM, entry)
    _assert_same_run(vt, wt, vn, wn, same_dtype=False)


def test_simulate_and_config():
    words = vm.assemble_code_words(PROGRAMS["arith_families"]["prog"])
    w = vm.simulate(words, 16)
    assert np.array_equal(w["ts"], jvm.simulate(words, 16)["ts"])
    assert vm.VmConfig() == vm.VmConfig(limit=jvm.VmConfig().limit)
    assert sim.assemble_code_words is vm.assemble_code_words


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_host_copies_equal_the_jax_package(seed):
    """The sha256 and secp256k1 host math and the two precompile helpers the
    Python EraVM takes from the port's circuits equal their originals."""
    rng = np.random.default_rng(seed)
    data = rng.bytes(int(rng.integers(0, 300)))
    assert sha256.sha256_ref(data) == jsha.sha256_ref(data)
    block = [int(x) for x in rng.integers(0, 1 << 32, size=16, dtype=np.uint64)]
    assert sha256.compress_ref(sha256.H0, block) == jsha.compress_ref(jsha.H0, block)
    assert sim._digest_value_limbs is sha_rf._digest_value_limbs
    assert sim._analyze_ecrecover_call is ecrecover._analyze_call
    assert sim._digest_value_limbs(block[:8]) == jsha_rf._digest_value_limbs(block[:8])
    h = int.from_bytes(rng.bytes(32), "big")
    priv, k = int(rng.integers(1, 1 << 62)), int(rng.integers(1, 1 << 62))
    r, s, recid = secp256k1.sign(h, priv, k)
    assert (r, s, recid) == jsecp.sign(h, priv, k)
    for v, rr, ss in ((recid, r, s), (recid ^ 1, r, s), (recid | 2, r, s), (0, 0, s),
                      (recid, r, secp256k1.N - 1), (recid, secp256k1.P - 1, s)):
        assert sim._analyze_ecrecover_call(h, v, rr, ss) == jecrecover._analyze_call(h, v, rr, ss)
