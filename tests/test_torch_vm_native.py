"""The port's native EraVM front end against the JAX package's: the same
C++ oracle through two ctypes front ends must give the same witness, key by
key, the same tapes and the same boot code hash, on the programs of
tests/test_vm2.py and on the benchmark loop.
"""

import numpy as np
import pytest

from zkevm_circuits_tpu.models import vm as jvm
from zkevm_circuits_tpu.models.vm import native_sim as jnative_sim

from torch_vm_programs import PROGRAMS, SET_FLAGS, SWAP, enc, isa, run_vm
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.models.vm import native_sim, state
from zkevm_circuits_tpu_torch.runtime import native
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

BENCH_PROGRAM = [
    enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=0xFFFF, src1=0, dst0=1),
    enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=1, flags=SET_FLAGS | SWAP),
    enc(isa.MUL, src0=1, src1=1, dst0=2, dst1=3),
    enc(isa.BINOP, isa.BINOP_XOR, src0=2, src1=1, dst0=4),
    enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=1, condition=isa.COND_NE),
    enc(isa.RET, isa.RET_OK),
]
HONEST = [name for name, e in PROGRAMS.items() if not e["tamper"]]


@pytest.mark.parametrize("name", HONEST)
def test_native_witness_equals_jax_package(name):
    vj, wj = run_vm(jvm.NativeEraVM, PROGRAMS[name])
    vt, wt = run_vm(vm.NativeEraVM, PROGRAMS[name])
    assert list(wt) == list(wj)
    for k in wj:
        a, b = np.asarray(wt[k]), np.asarray(wj[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert vt.memory_tape == vj.memory_tape
    assert vt.log_tape == vj.log_tape
    assert vt.decommit_tape == vj.decommit_tape
    assert vt.precompile_calls == vj.precompile_calls
    assert vt.precompile_memory == vj.precompile_memory
    assert vt.initial_mem_rows == vj.initial_mem_rows
    assert vt.initial_dec_rows == vj.initial_dec_rows
    assert vt.boot_code_hash == vj.boot_code_hash


def test_bench_program_assembly_and_boot_hash():
    words = vm.assemble_code_words(BENCH_PROGRAM)
    assert words == jvm.assemble_code_words(BENCH_PROGRAM)
    assert native_sim.compute_boot_code_hash(words) == jnative_sim.compute_boot_code_hash(words)


def test_bench_loop_satisfies_the_circuit():
    limit = 64
    w = vm.NativeEraVM(vm.assemble_code_words(BENCH_PROGRAM), limit).run()
    assert w["regs"].shape == (limit + 1, 15, 8) and w["src0_val"].shape == (limit, 8)
    res = vm.eval_constraints(vm.prepare_device_witness(w, device="cpu"), limit)
    assert vm.all_ok(res), [k for k, v in res.items() if not v.all()]


def test_context_record_encoding_and_sponge():
    boot = state.initial_bootloader_state()
    enc32 = state.encode_context_record(boot["ctx"])
    cols = dict(
        rq_head=np.zeros((1, 4), np.uint64), rq_tail=np.zeros((1, 4), np.uint64),
        code_address=np.array([state._addr_limbs(boot["ctx"].code_address)], np.uint32),
        this=np.array([state._addr_limbs(boot["ctx"].this)], np.uint32),
        caller=np.zeros((1, 5), np.uint32), ctx_u128=np.zeros((1, 4), np.uint32),
        code_page=np.array([boot["ctx"].code_page], np.uint32),
        base_page=np.array([boot["ctx"].base_page], np.uint32),
        heap_bound=np.array([boot["ctx"].heap_upper_bound], np.uint32),
        aux_heap_bound=np.array([boot["ctx"].aux_heap_upper_bound], np.uint32),
        pc=np.zeros(1, np.uint32), sp=np.zeros(1, np.uint32),
        eh=np.array([boot["ctx"].exception_handler_loc], np.uint32),
        ergs=np.array([boot["ctx"].ergs_remaining], np.uint32),
        rq_len=np.zeros(1, np.uint32), is_static=np.zeros(1, bool),
        is_kernel=np.ones(1, bool), is_local=np.zeros(1, bool),
        shard_this=np.zeros(1, np.uint32), shard_caller=np.zeros(1, np.uint32),
        shard_code=np.zeros(1, np.uint32),
    )
    assert state.encode_context_records_np(cols)[0].tolist() == enc32
    st = state.callstack_sponge_absorb(np.zeros(12, np.uint64), enc32)
    want = np.zeros(12, np.uint64)
    for r in range(4):
        want[:8] = enc32[8 * r : 8 * r + 8]
        want = native.poseidon2_permute_batch(want[None])[0]
    assert np.array_equal(st, want)
