"""EraVM programs shared by the torch port's main_vm tests: the programs of
tests/test_vm2.py, as data.

Each entry of PROGRAMS (and of VM_AIR_PROGRAMS, the two witnesses of
tests/test_vm_air.py) is name -> dict(prog, limit, regs, kw, tamper):
the limits are 16, 24 or 32 only (two trace shapes keep the JAX side's eager
compiles few); `regs` maps a register number to a value or (value, is_ptr); `kw` holds the
VM's storage and code store; `tamper`, where present, is (column, index, kind)
applied to the witness after the run ("xor1" flips the low bit, "add1" adds 1)
and must make at least one residual fail.
"""

from zkevm_circuits_tpu_torch.isa import opcodes as isa
from zkevm_circuits_tpu_torch.isa import system_params as sp
from zkevm_circuits_tpu_torch.models.vm import assemble_code_words

enc = isa.encode_instruction
SET_FLAGS = 1 << isa.SET_FLAGS_FLAG_IDX
SWAP = 1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES
BIG = (1 << 256) - 1


def _callee(instructions, tag, dest):
    words = assemble_code_words(instructions)
    code_hash = (sp.CODE_HASH_VERSION_BYTE << 248) | (len(words) << 224) | tag
    storage = {(0, sp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, dest): code_hash}
    return dict(storage=storage, code_store={code_hash: words})


def _entry(prog, limit=16, regs=None, kw=None, tamper=None):
    return dict(prog=prog, limit=limit, regs=regs or {}, kw=kw or {}, tamper=tamper)


PROGRAMS = {
    "arith_families": _entry([
        enc(isa.ADD, src0=1, src1=2, dst0=3, flags=SET_FLAGS),
        enc(isa.SUB, src0=1, src1=2, dst0=4),
        enc(isa.MUL, src0=1, src1=2, dst0=5, dst1=6),
        enc(isa.DIV, src0=1, src1=2, dst0=7, dst1=8),
        enc(isa.BINOP, isa.BINOP_XOR, src0=1, src1=2, dst0=9),
        enc(isa.SHIFT, isa.SHIFT_SHL, src0=1, src_mode=isa.SRC_REG, src1=10, dst0=11),
        enc(isa.SHIFT, isa.SHIFT_SHR, src0=1, src1=10, dst0=12),
        enc(isa.SHIFT, isa.SHIFT_ROL, src0=1, src1=10, dst0=13),
        enc(isa.SHIFT, isa.SHIFT_ROR, src0=1, src1=10, dst0=14),
        enc(isa.RET, isa.RET_OK),
    ], regs={1: BIG - 12345, 2: 0xFEDCBA9876543210, 10: 37}),
    "conditional_jump_loop": _entry([
        enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=1, flags=SET_FLAGS | SWAP),
        enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=0, condition=isa.COND_NE),
        enc(isa.RET, isa.RET_OK),
    ], regs={1: 3}),
    "stack_addressing": _entry([
        enc(isa.ADD, src0=1, src1=0, dst_mode=isa.DST_STACK_PUSH_POP, imm1=1),
        enc(isa.ADD, src0=2, src1=0, dst_mode=isa.DST_STACK_PUSH_POP, imm1=1),
        enc(isa.ADD, src_mode=isa.SRC_STACK_OFFSET, imm0=1, src1=0, dst0=5),
        enc(isa.ADD, src_mode=isa.SRC_STACK_OFFSET, imm0=2, src1=0, dst0=6),
        enc(isa.ADD, src_mode=isa.SRC_STACK_PUSH_POP, imm0=1, src1=0, dst0=7),
        enc(isa.RET, isa.RET_OK),
    ], regs={1: 111, 2: 222}),
    "context_family": _entry([
        enc(isa.CONTEXT, isa.CTX_THIS, dst0=3),
        enc(isa.CONTEXT, isa.CTX_ERGS_LEFT, dst0=4),
        enc(isa.CONTEXT, isa.CTX_SET_CONTEXT_U128, src0=1),
        enc(isa.CONTEXT, isa.CTX_INCREMENT_TX_NUMBER),
        enc(isa.CONTEXT, isa.CTX_META, dst0=5),
        enc(isa.RET, isa.RET_OK),
    ], regs={1: 0xABCDEF}),
    "uma_unaligned_roundtrip": _entry([
        enc(isa.UMA, isa.UMA_HEAP_WRITE, src0=1, src1=2),
        enc(isa.UMA, isa.UMA_HEAP_READ, src0=1, dst0=3),
        enc(isa.UMA, isa.UMA_HEAP_READ, src0=4, dst0=5,
            flags=1 << isa.UMA_INCREMENT_FLAG_IDX, dst1=6),
        enc(isa.RET, isa.RET_OK),
    ], regs={1: 13, 2: (0x11223344556677 << 200) | 0xDEADBEEF, 4: 32}),
    "uma_fat_ptr_read_with_cleanup": _entry([
        enc(isa.UMA, isa.UMA_HEAP_WRITE, src0=1, src1=2),
        enc(isa.UMA, isa.UMA_FAT_PTR_READ, src0=3, dst0=4),
        enc(isa.RET, isa.RET_OK),
    ], regs={1: 0, 2: int.from_bytes(bytes(range(1, 33)), "big"),
             3: (16 | ((sp.BOOTLOADER_BASE_PAGE + 2) << 32) | (40 << 96), True)}),
    "log_storage_and_events": _entry([
        enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=1, src1=2),
        enc(isa.LOG, isa.LOG_STORAGE_READ, src0=1, dst0=3),
        enc(isa.LOG, isa.LOG_EVENT, src0=1, src1=2, flags=1 << isa.FIRST_MESSAGE_FLAG_IDX),
        enc(isa.LOG, isa.LOG_TO_L1_MESSAGE, src0=1, src1=2),
        enc(isa.RET, isa.RET_OK),
    ], regs={1: 0x55, 2: 777}),
    "log_revert_appends_rollback": _entry([
        enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=1, src1=2),
        enc(isa.NEAR_CALL, imm0=6, imm1=4),
        enc(isa.LOG, isa.LOG_STORAGE_READ, src0=1, dst0=3),
        enc(isa.RET, isa.RET_OK),
        enc(isa.LOG, isa.LOG_STORAGE_READ, src0=1, dst0=3),  # exception handler
        enc(isa.RET, isa.RET_OK),
        enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=1, src1=4),  # callee at 6
        enc(isa.LOG, isa.LOG_EVENT, src0=1, src1=4),
        enc(isa.RET, isa.RET_REVERT),
    ], limit=32, regs={1: 0x99, 2: 111, 4: 999}),
    "far_call_roundtrip_and_page_reuse": _entry([
        enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=2, imm0=7),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=0x4242, src1=0, dst0=4),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=1000, src1=0, dst0=5),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=192, src1=0, dst0=6),
        enc(isa.SHIFT, isa.SHIFT_SHL, src0=5, src1=6, dst0=3),  # ergs << 192
        enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=3, src1=4, imm0=7),
        enc(isa.RET, isa.RET_OK),
        enc(isa.RET, isa.RET_PANIC),  # exception handler
    ], limit=32, regs={1: (2 ** 30) << 192, 2: 0x4242},
        kw=_callee([enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=42, src1=0, dst0=1),
                    enc(isa.RET, isa.RET_OK)], 0x77, 0x4242)),
    "near_call_ergs_split_and_panic_return": _entry([
        enc(isa.NEAR_CALL, src0=1, imm0=4, imm1=3),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=1, src1=0, dst0=5),
        enc(isa.RET, isa.RET_OK),
        enc(isa.RET, isa.RET_OK),  # exception handler: recover
        enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=4),  # callee at 4: burns its ergs
    ], limit=32, regs={1: 40}),
    "tamper_register_value": _entry([
        enc(isa.ADD, src0=1, src1=2, dst0=3),
        enc(isa.RET, isa.RET_OK),
    ], limit=16, regs={1: 5, 2: 6}, tamper=("regs", (1, 2, 0), "xor1")),
    "tamper_ergs": _entry(
        [enc(isa.NOP), enc(isa.RET, isa.RET_OK)],
        limit=16, tamper=("ctx_ergs", (1,), "add1")),
    "tamper_storage_read": _entry([
        enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=1, src1=2),
        enc(isa.LOG, isa.LOG_STORAGE_READ, src0=1, dst0=3),
        enc(isa.RET, isa.RET_OK),
    ], limit=16, regs={1: 7, 2: 123}, tamper=("storage_read_val", (1, 0), "xor1")),
    "tamper_rollback_head": _entry([
        enc(isa.NEAR_CALL, imm0=3, imm1=2),
        enc(isa.RET, isa.RET_OK),
        enc(isa.RET, isa.RET_OK),
        enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=1, src1=2),  # callee at 3
        enc(isa.RET, isa.RET_REVERT),
    ], regs={1: 1, 2: 2}, tamper=("rb_prev_head", (1, 0), "xor1")),
    "out_of_ergs_masks_into_panic": _entry([
        enc(isa.NEAR_CALL, src0=1, imm0=3, imm1=2),
        enc(isa.RET, isa.RET_OK),
        enc(isa.RET, isa.RET_OK),  # exception handler
        enc(isa.MUL, src0=2, src1=2, dst0=3, dst1=4),  # callee: cannot afford it
        enc(isa.RET, isa.RET_OK),
    ], regs={1: 2, 2: 9}),
    "static_context_forbids_writes": _entry([
        enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL,
            flags=1 << isa.FAR_CALL_STATIC_FLAG_IDX, src0=1, src1=2, imm0=2),
        enc(isa.RET, isa.RET_OK),
        enc(isa.RET, isa.RET_OK),  # exception handler
    ], limit=32, regs={1: (2 ** 28) << 192, 2: 0x20202},
        kw=_callee([enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=1, src1=1),
                    enc(isa.RET, isa.RET_OK)], 0x88, 0x20202)),
}


VM_AIR_PROGRAMS = {
    "vm_air_base": _entry([
        enc(isa.ADD, src0=1, src1=2, dst0=3, flags=SET_FLAGS),
        enc(isa.SUB, src0=1, src1=2, dst0=4),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=7, src1=3, dst0=5),
        enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=5, dst0=5, flags=SET_FLAGS | SWAP),
        enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=6),
        enc(isa.NOP),  # skipped over by the jump
        enc(isa.SUB, src0=1, src1=1, dst0=6, flags=SET_FLAGS),
        enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=9, condition=isa.COND_EQ),
        enc(isa.NOP),
        enc(isa.RET, isa.RET_OK),
    ], limit=16, regs={1: BIG - 12345, 2: 0xFEDCBA9876543210}),
    "vm_air_alu": _entry([
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=0xBEEF, src1=0, dst0=1),
        enc(isa.MUL, src0=1, src1=1, dst0=2, dst1=3, flags=SET_FLAGS),
        enc(isa.MUL, src0=7, src1=7, dst0=4, dst1=5, flags=SET_FLAGS),
        enc(isa.DIV, src0=7, src1=1, dst0=6, dst1=8, flags=SET_FLAGS),
        enc(isa.DIV, src0=1, src1=9, dst0=10, dst1=11, flags=SET_FLAGS),
        enc(isa.SHIFT, isa.SHIFT_SHL, src0=7, src1=1, dst0=12),
        enc(isa.SHIFT, isa.SHIFT_SHR, src0=7, src1=1, dst0=13, flags=SET_FLAGS),
        enc(isa.SHIFT, isa.SHIFT_ROL, src0=7, src1=1, dst0=14),
        enc(isa.SHIFT, isa.SHIFT_ROR, src0=7, src1=9, dst0=12),
        enc(isa.SHIFT, isa.SHIFT_ROR, src0=7, src1=1, dst0=12),
        enc(isa.BINOP, isa.BINOP_AND, src0=7, src1=2, dst0=12, flags=SET_FLAGS),
        enc(isa.BINOP, isa.BINOP_OR, src0=7, src1=2, dst0=12),
        enc(isa.BINOP, isa.BINOP_XOR, src0=7, src1=7, dst0=12, flags=SET_FLAGS),
        enc(isa.RET, isa.RET_OK),
    ], limit=24, regs={1: 0xBEEF, 7: BIG - 0x1234567890}),
}


def run_vm(vm_class, entry):
    """Run one entry on `vm_class` (an EraVM with the JAX package's
    constructor); returns (vm, witness dict) with the tamper applied."""
    v = vm_class(assemble_code_words(entry["prog"]), entry["limit"], **entry["kw"])
    for idx, val in entry["regs"].items():
        ptr = False
        if isinstance(val, tuple):
            val, ptr = val
        v.registers[idx - 1] = [val, ptr]
    w = v.run()
    if entry["tamper"]:
        col, index, kind = entry["tamper"]
        if kind == "xor1":
            w[col][index] ^= 1
        else:
            w[col][index] += 1
    return v, w
