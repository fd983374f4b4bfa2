"""EraVM host simulator + witness tracer (the witness-oracle role): the JAX
package's `models/vm/sim.py`, with the port's imports.

Executes the real zkEVM ISA (isa/opcodes.py, 2^11 decode table) with the
reference's semantics, producing dense per-cycle witness columns that
`circuit.py` re-checks row-parallel on device.

Reference parity (cited per stage):
  * prestate / pc / code read     src/main_vm/pre_state.rs:71-519
  * decode + fast exceptions      src/main_vm/decoded_opcode.rs:42-220
  * operand resolution            src/main_vm/utils.rs:237-384
  * add/sub/mul/div/binop/shift   src/main_vm/opcodes/{add_sub,mul_div,binop,shifts}.rs
  * jump/nop/context/ptr          src/main_vm/opcodes/{jump,nop,context,ptr}.rs
  * uma (unaligned 2-word)        src/main_vm/opcodes/uma.rs:18-1103
  * log (two-sided queues)        src/main_vm/opcodes/log.rs:16-463
  * near_call/far_call/ret        src/main_vm/opcodes/call_ret_impl/*.rs
  * callstack sponge              src/main_vm/opcodes/call_ret.rs:167-274
  * rollback-queue join protocol  src/base_structures/vm_state/saved_context.rs:16-31

Two-phase design: the rollback-queue head/tail values and (through the
saved-context encodings) the callstack sponge states depend on FUTURE
forward-queue tails, so phase A executes forward recording symbolic refs,
phase B resolves the backward hash chain (reverts anchor at the forward
tail of the revert point; surviving segments anchor at the final forward
tail — the exit invariant `forward_tail == root head`, mod.rs:167-175,
makes the block rollback tail the chain's far end) and then replays the
callstack sponge with resolved encodings.

The port's own copies stand in for what this module took from the JAX
package: `hashlib` for the bootloader code hash, `ops/sha256.py` and
`ops/secp256k1.py` (host math); the sha256 and ecrecover circuits' host
helpers (`_digest_value_limbs`, `_analyze_call`) come from the port's
circuits, as the JAX oracle takes them from its own.  `assemble_code_words`
lives in `native_sim.py`, the front end of the same C++ oracle, and is
imported from there.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ...isa import opcodes as isa
from ...isa import system_params as sp
from ...ops import secp256k1 as ec
from ...ops import sha256 as sha_ops
from ...ops.keccak import keccak256_ref
from ..ecrecover import _analyze_call as _analyze_ecrecover_call
from ..sha256_round_function import _digest_value_limbs
from .native_sim import assemble_code_words  # noqa: F401  (re-exported)
from .state import (
    ExecutionContextRecord,
    callstack_sponge_absorb,
    encode_context_record,
    initial_bootloader_state,
)

U32 = 0xFFFFFFFF
U16 = 0xFFFF
U256 = (1 << 256) - 1


# --------------------------------------------------------------------------
# code assembly helpers
# --------------------------------------------------------------------------


def _limbs8(v: int) -> list:
    return [(v >> (32 * k)) & U32 for k in range(8)]


@dataclasses.dataclass(frozen=True)
class VmConfig:
    limit: int = 64


# --------------------------------------------------------------------------
# symbolic refs for backward-resolved rollback values
# --------------------------------------------------------------------------
# A "ref" is ("push", slot) — a rollback push's head-after value — or
# ("tail", slot) — a frame's claimed rollback tail.  Slots resolve in phase
# B: reverts pin tails forward (the tail is the forward-chain value of the
# appended segment); ok-rets alias the child tail to the parent's saved
# head (the constraint of ret.rs:368-374); segments alive at the end
# resolve against the final forward tail.


class EraVM:
    """Host EraVM with dense witness tracing."""

    def __init__(
        self,
        code_words,
        limit: int,
        storage=None,
        code_store=None,
        calldata=None,
        bootloader_heap=None,
        default_aa_code_hash: int = 0,
        zkporter_available: bool = False,
    ):
        boot = initial_bootloader_state()
        self.limit = limit
        self.default_aa_code_hash = default_aa_code_hash
        self.zkporter_available = zkporter_available

        self.memory = {sp.BOOTLOADER_CODE_PAGE: {i: (w, False) for i, w in enumerate(code_words)}}
        if calldata:
            self.memory[sp.BOOTLOADER_CALLDATA_PAGE] = {
                i: (v, False) for i, v in enumerate(calldata)
            }
        # nondeterministic initial bootloader heap content (the ram_permutation
        # timestamp-0 write convention, ref ram mod.rs:259-290)
        self.bootloader_heap_init = dict(bootloader_heap or {})
        if self.bootloader_heap_init:
            self.memory[sp.BOOTLOADER_BASE_PAGE + 2] = {
                i: (v & U256, False) for i, v in self.bootloader_heap_init.items()
            }
        self.storage = dict(storage or {})
        self.code_store = dict(code_store or {})
        self.decommitted = {}  # masked code hash -> first page

        # current frame + callstack; the block-level rollback tail slot is
        # shared by the root frame and the boot empty entry
        self._block_slot = {}
        self.ctx = boot["ctx"]
        self.ctx._tail_slot = self._block_slot
        self.ctx._segment = []  # [(enc_rb (20,), slot, query_dict)]
        boot["empty_entry"]._tail_slot = self._block_slot
        boot["empty_entry"]._head_ref = ("tail", self._block_slot)
        boot["empty_entry"]._segment = []
        self.frames = [boot["empty_entry"]]  # saved records (deepest first)
        self.cs_depth = 1

        self.registers = [[0, False] for _ in range(15)]
        self.registers[0] = [boot["r1_value"], True]
        self.flags = dict(of=False, eq=False, gt=False)
        self.timestamp = sp.STARTING_TIMESTAMP
        self.page_counter = sp.STARTING_BASE_PAGE
        self.tx_number = 0
        self.prev_code_page = 0
        self.prev_super_pc = 0
        self.prev_code_word = 0
        self.pending_exception = False
        self.ergs_per_pubdata = 0
        self.context_u128 = [0, 0, 0, 0]

        self.mem_q_state = np.zeros(12, np.uint64)
        self.mem_q_len = 0
        self.dec_q_state = np.zeros(12, np.uint64)
        self.dec_q_len = 0
        self.log_fwd_tail = np.zeros(4, np.uint64)
        self.log_fwd_len = 0

        # callstack sponge events for phase-B replay:
        #   ("push", record) | ("pop",) per cycle (at most one)
        self.cs_events = []  # list aligned with cycles: None or event

        self.memory_tape = []
        self.decommit_tape = []
        self.log_tape = []  # forward queue elements (incl. appended rollbacks)
        # precompile-call side channel for the block runtime: the host
        # executes each call at log time (the zk_evm host role) and records
        # the call + a {(page, word): bytes32} snapshot of every word the
        # precompile circuit will read, so its generate_witness can replay.
        self.precompile_calls = {"keccak": [], "sha256": [], "ecrecover": []}
        self.precompile_memory = {}

        self._trace = []
        self._state_rows = []

        # absorb the ts=0 bootloader-heap writes into the memory queue BEFORE
        # cycle 0 — the VM's memory_queue_initial_state observable input (ref
        # main_vm/input.rs + ram mod.rs:259-290); the rows live on a separate
        # tape (the scheduler/harness pushes them, not the VM)
        self.initial_mem_rows = []
        if self.bootloader_heap_init:
            from ...base_structures.memory_query import encode_memory_queries_np

            hp = sp.BOOTLOADER_BASE_PAGE + 2
            for i, val in sorted(self.bootloader_heap_init.items()):
                row = dict(timestamp=0, memory_page=hp, index=i,
                           rw_flag=True, is_ptr=False, value=val & U256)
                self.initial_mem_rows.append(row)
                enc = encode_memory_queries_np(
                    np.array([0], np.uint32), np.array([hp], np.uint32),
                    np.array([i], np.uint32), np.array([True], bool),
                    np.array([False], bool),
                    np.array([_limbs8(val)], np.uint32),
                )[0]
                self.mem_q_state = self._full_absorb(self.mem_q_state, enc)
                self.mem_q_len += 1

        # boot decommittment push (scheduler mod.rs:152-172): the bootloader's
        # own code decommit request enters the queue BEFORE cycle 0; the
        # resulting state is the VM's decommittment_queue_initial_state
        # observable input (ref main_vm/input.rs)
        from ...base_structures.decommit_query import encode_decommit_query_ref

        data = b"".join(int(x).to_bytes(32, "big") for x in code_words)
        boot_hash = int.from_bytes(hashlib.sha256(data).digest(), "big") & ((1 << 224) - 1)
        boot_hash |= ((sp.CODE_HASH_VERSION_BYTE << 8) << 16 | len(code_words)) << 224
        self.boot_code_hash = boot_hash
        boot_row = dict(
            code_hash=boot_hash, page=sp.BOOTLOADER_CODE_PAGE,
            is_first=True, timestamp=1,
        )
        self.initial_dec_rows = [boot_row]
        enc = np.array(encode_decommit_query_ref(boot_row), np.uint64)
        self.dec_q_state = self._full_absorb(self.dec_q_state, enc)
        self.dec_q_len += 1

    # -------------------- primitives --------------------

    def _mem_read(self, page, index):
        return self.memory.get(page, {}).get(index, (0, False))

    def _mem_write(self, page, index, value, is_ptr=False):
        self.memory.setdefault(page, {})[index] = (value & U256, bool(is_ptr))

    def _narrow_hash(self, tail4, enc20) -> np.ndarray:
        """3-round narrow queue push, framework-standard convention
        (ops/queues.narrow_state_transition: tail in the capacity lanes,
        encoding zero-padded to 24 absorbed by rate replacement) — so the
        VM's log-queue tail chains bit-identically with the demux input
        queue the scheduler derives."""
        from ...runtime import native

        st = np.zeros(12, np.uint64)
        st[8:12] = np.asarray(tail4, np.uint64)
        enc = np.asarray(enc20, np.uint64)
        st[:8] = enc[0:8]
        st = native.poseidon2_permute(st)
        st[:8] = enc[8:16]
        st = native.poseidon2_permute(st)
        st[:4] = enc[16:20]
        st[4:8] = 0
        st = native.poseidon2_permute(st)
        return st[:4].copy()

    def _full_absorb(self, state12, enc8) -> np.ndarray:
        from ...runtime import native

        st = np.asarray(state12, np.uint64).copy()
        st[:8] = np.asarray(enc8, np.uint64)
        return native.poseidon2_permute(st)

    def _push_mem_query(self, ts, page, index, rw, is_ptr, value):
        from ...base_structures.memory_query import encode_memory_queries_np

        self.memory_tape.append(
            dict(timestamp=ts, memory_page=page, index=index,
                 rw_flag=bool(rw), is_ptr=bool(is_ptr), value=value & U256)
        )
        enc = encode_memory_queries_np(
            np.array([ts], np.uint32), np.array([page], np.uint32),
            np.array([index], np.uint32), np.array([rw], bool),
            np.array([is_ptr], bool), np.array([_limbs8(value)], np.uint32),
        )[0]
        self.mem_q_state = self._full_absorb(self.mem_q_state, enc)
        self.mem_q_len += 1

    def _encode_log_np(self, q: dict, rollback: bool) -> np.ndarray:
        from ...base_structures.log_query import encode_log_queries_np

        return encode_log_queries_np(
            np.array([[(q["address"] >> (32 * k)) & U32 for k in range(5)]], np.uint32),
            np.array([_limbs8(q["key"])], np.uint32),
            np.array([_limbs8(q["read_value"])], np.uint32),
            np.array([_limbs8(q["written_value"])], np.uint32),
            np.array([q["aux_byte"]], np.uint32),
            np.array([q["rw_flag"]], bool),
            np.array([rollback], bool),
            np.array([q["is_service"]], bool),
            np.array([q["shard_id"]], np.uint32),
            np.array([q["tx_number_in_block"]], np.uint32),
            np.array([q["timestamp"]], np.uint32),
        )[0]

    def _push_log_forward(self, q: dict):
        enc = self._encode_log_np(q, rollback=False)
        self.log_fwd_tail = self._narrow_hash(self.log_fwd_tail, enc)
        self.log_fwd_len += 1
        self.log_tape.append(dict(q, rollback=False))

    @staticmethod
    def _fat_ptr_parts(v: int):
        return v & U32, (v >> 32) & U32, (v >> 64) & U32, (v >> 96) & U32

    def _cur_head_ref(self):
        if self.ctx._segment:
            return ("push", self.ctx._segment[-1][1])
        return ("tail", self.ctx._tail_slot)

    # -------------------- main loop --------------------

    def run(self) -> dict:
        for _ in range(self.limit):
            self._snapshot_state()
            self.cs_events.append(None)
            self._cycle()
        self._snapshot_state()
        return self._assemble_witness()

    def _snapshot_state(self):
        c = self.ctx
        row = dict(
            regs=np.array([_limbs8(r[0]) for r in self.registers], np.uint32),
            regs_ptr=np.array([r[1] for r in self.registers], bool),
            f_of=self.flags["of"], f_eq=self.flags["eq"], f_gt=self.flags["gt"],
            ts=self.timestamp, page_counter=self.page_counter,
            tx_number=self.tx_number, prev_code_page=self.prev_code_page,
            prev_super_pc=self.prev_super_pc,
            prev_code_word=np.array(_limbs8(self.prev_code_word), np.uint32),
            pending_exc=self.pending_exception,
            ergs_pp=self.ergs_per_pubdata,
            ctx_u128=np.array(self.context_u128, np.uint32),
            cs_depth=self.cs_depth,
            mem_q_state=self.mem_q_state.copy(), mem_q_len=self.mem_q_len,
            dec_q_state=self.dec_q_state.copy(), dec_q_len=self.dec_q_len,
            log_fwd_tail=self.log_fwd_tail.copy(), log_fwd_len=self.log_fwd_len,
            ctx_this=np.array([(c.this >> (32 * k)) & U32 for k in range(5)], np.uint32),
            ctx_caller=np.array([(c.caller >> (32 * k)) & U32 for k in range(5)], np.uint32),
            ctx_code_address=np.array(
                [(c.code_address >> (32 * k)) & U32 for k in range(5)], np.uint32),
            ctx_code_page=c.code_page, ctx_base_page=c.base_page,
            ctx_heap_bound=c.heap_upper_bound,
            ctx_aux_heap_bound=c.aux_heap_upper_bound,
            ctx_pc=c.pc, ctx_sp=c.sp, ctx_eh=c.exception_handler_loc,
            ctx_ergs=c.ergs_remaining,
            ctx_is_static=c.is_static_execution, ctx_is_kernel=c.is_kernel_mode,
            ctx_is_local=c.is_local_call,
            ctx_shard_this=c.this_shard_id, ctx_shard_caller=c.caller_shard_id,
            ctx_shard_code=c.code_shard_id,
            ctx_ctx_u128=np.array(c.context_u128_value_composite, np.uint32),
            ctx_rq_len=c.reverted_queue_segment_len,
            _rq_head_ref=self._cur_head_ref(),
            _rq_tail_ref=("tail", c._tail_slot),
        )
        self._state_rows.append(row)

    # -------------------- one cycle --------------------

    def _cycle(self):
        t = {}
        self._trace.append(t)

        should_skip = self.cs_depth == 0
        pending = self.pending_exception
        execute_pending_exc = pending and not should_skip
        if execute_pending_exc:
            self.pending_exception = False
        should_try_read = (not should_skip) and (not pending)

        current_pc = self.ctx.pc
        pc_plus_one = (current_pc + 1) & U16
        super_pc, sub_pc = current_pc >> 2, current_pc & 3
        should_read_for_new_pc = not (
            self.prev_code_page == self.ctx.code_page
            and super_pc == self.prev_super_pc
        )
        should_read_opcode = should_try_read and should_read_for_new_pc

        ts = self.timestamp
        self.timestamp = ts if should_skip else ts + 4

        code_word_val, _ = self._mem_read(self.ctx.code_page, super_pc)
        if should_read_opcode:
            self._push_mem_query(
                ts, self.ctx.code_page, super_pc, False, False, code_word_val
            )
            code_word = code_word_val
        else:
            code_word = self.prev_code_word
        t["code_word_read"] = np.array(
            _limbs8(code_word_val if should_read_opcode else 0), np.uint32
        )
        t["should_read_opcode"] = should_read_opcode

        raw_opcode = (code_word >> (64 * (3 - sub_pc))) & ((1 << 64) - 1)
        if should_skip:
            raw_opcode = isa.NOP_ENCODING
        if execute_pending_exc:
            raw_opcode = isa.PANIC_ENCODING

        self.prev_code_word = code_word
        self.prev_code_page = self.ctx.code_page
        if not should_skip:
            self.ctx.pc = pc_plus_one
            self.prev_super_pc = super_pc

        # ---- decode + fast exceptions ----
        d = isa.decode_instruction(raw_opcode)
        cond_resolves = isa.condition_resolves(
            d["condition"], self.flags["of"], self.flags["eq"], self.flags["gt"]
        )
        price = 0 if should_skip else d["price"]
        ergs0 = self.ctx.ergs_remaining
        out_of_ergs = price > ergs0
        ergs1 = 0 if out_of_ergs else ergs0 - price

        props = d["props"]
        kernel_only = (props >> (isa.AUX_BITS_OFFSET + isa.KERNEL_MODE_FLAG_IDX)) & 1
        static_ok = (
            props >> (isa.AUX_BITS_OFFSET + isa.CAN_BE_USED_IN_STATIC_CONTEXT_FLAG_IDX)
        ) & 1
        explicit_panic = (props >> (isa.AUX_BITS_OFFSET + isa.EXPLICIT_PANIC_FLAG_IDX)) & 1
        kernel_exc = kernel_only and not self.ctx.is_kernel_mode
        static_exc = self.ctx.is_static_execution and not static_ok
        callstack_full = self.cs_depth == sp.VM_MAX_STACK_DEPTH
        mask_panic = bool(
            explicit_panic or out_of_ergs or kernel_exc or static_exc or callstack_full
        )
        mask_nop = (not mask_panic) and (not cond_resolves)
        if mask_panic:
            eff = isa.decode_instruction(isa.PANIC_ENCODING)
        elif mask_nop:
            eff = isa.decode_instruction(isa.NOP_ENCODING)
        else:
            eff = d
        op_type, variant = eff["op_type"], eff["variant"]
        src_mode, dst_mode, flags_bits = eff["src_mode"], eff["dst_mode"], eff["flags"]
        mask_any = mask_panic or mask_nop
        src0_idx = 0 if mask_any else d["src0"]
        src1_idx = 0 if mask_any else d["src1"]
        dst0_idx = 0 if mask_any else d["dst0"]
        dst1_idx = 0 if mask_any else d["dst1"]
        imm0, imm1 = d["imm0"], d["imm1"]

        self.ctx.ergs_remaining = ergs1
        t.update(
            raw_opcode_lo=raw_opcode & U32, raw_opcode_hi=(raw_opcode >> 32) & U32,
            op_type=op_type, variant=variant, src_mode=src_mode,
            dst_mode=dst_mode, flags_bits=flags_bits,
        )

        # ---- operand resolution ----
        def reg_val(idx):
            if idx == 0:
                return 0, False
            v, p = self.registers[idx - 1]
            return v, p

        draft_src0, draft_src0_ptr = reg_val(src0_idx)
        src1_val, src1_ptr = reg_val(src1_idx)
        dst0_reg_low = reg_val(dst0_idx)[0] & U16

        stack_page = (self.ctx.base_page + 1) & U32
        heap_page = (self.ctx.base_page + 2) & U32
        aux_heap_page = (self.ctx.base_page + 3) & U32
        current_sp = self.ctx.sp
        is_nop_op = op_type == isa.NOP

        src_reg_low = draft_src0 & U16
        idx_abs = (src_reg_low + imm0) & U16
        idx_rel = (current_sp - idx_abs) & U16
        use_code = src_mode == isa.SRC_CODE
        use_stack_abs = src_mode == isa.SRC_STACK_ABSOLUTE
        use_stack_rel = src_mode == isa.SRC_STACK_OFFSET
        use_stack_pp = src_mode == isa.SRC_STACK_PUSH_POP
        use_stack = use_stack_abs or use_stack_rel or use_stack_pp
        src0_did_read = (use_stack or use_code) and not is_nop_op
        src0_page = stack_page if use_stack else self.ctx.code_page
        src0_index = idx_abs if (use_code or use_stack_abs) else idx_rel
        new_sp = idx_rel if use_stack_pp else current_sp

        d_idx_abs = (dst0_reg_low + imm1) & U16
        d_idx_rel_push = (new_sp + d_idx_abs) & U16
        d_idx_rel = (new_sp - d_idx_abs) & U16
        d_use_stack_abs = dst_mode == isa.DST_STACK_ABSOLUTE
        d_use_stack_rel = dst_mode == isa.DST_STACK_OFFSET
        d_use_stack_pp = dst_mode == isa.DST_STACK_PUSH_POP
        dst0_did_write = (
            (d_use_stack_abs or d_use_stack_rel or d_use_stack_pp) and not is_nop_op
        )
        dst0_index = (
            d_idx_abs if d_use_stack_abs else (new_sp if d_use_stack_pp else d_idx_rel)
        )
        new_sp = d_idx_rel_push if d_use_stack_pp else new_sp
        self.ctx.sp = new_sp

        if src0_did_read:
            mval, mptr = self._mem_read(src0_page, src0_index)
            self._push_mem_query(ts, src0_page, src0_index, False, mptr, mval)
        else:
            mval, mptr = 0, False
        t["src0_mem_val"] = np.array(_limbs8(mval), np.uint32)
        t["src0_mem_is_ptr"] = mptr
        t["src0_did_read"] = src0_did_read
        t["dst0_did_write"] = dst0_did_write
        t["dst0_page"] = stack_page
        t["dst0_index"] = dst0_index

        if src_mode == isa.SRC_REG:
            src0_val, src0_ptr = draft_src0, draft_src0_ptr
        elif src_mode == isa.SRC_IMM:
            src0_val, src0_ptr = imm0, False
        else:
            src0_val, src0_ptr = mval, mptr

        is_asym = op_type in (isa.SUB, isa.DIV, isa.SHIFT)
        swap = (
            is_asym
            and bool((flags_bits >> isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES) & 1)
        ) or (
            op_type == isa.PTR
            and bool((flags_bits >> isa.SWAP_OPERANDS_FLAG_IDX_FOR_PTR_OPCODE) & 1)
        )
        if swap:
            src0_val, src1_val = src1_val, src0_val
            src0_ptr, src1_ptr = src1_ptr, src0_ptr

        # fat-pointer metadata erasure (pre_state.rs:456-482): clear the
        # ptr marker and zero limbs 1..3 (page/start) — register.rs:67-76
        not_kernel = not self.ctx.is_kernel_mode
        erase_mask = ~(((U32) << 32) | ((U32) << 64))
        keeps_ptr = op_type in (isa.RET, isa.PTR, isa.UMA, isa.FAR_CALL)
        if src0_ptr and (not keeps_ptr) and not_kernel:
            src0_ptr = False
            src0_val &= erase_mask
        if src1_ptr and not_kernel:
            src1_ptr = False
            src1_val &= erase_mask

        t["src0_val"] = np.array(_limbs8(src0_val), np.uint32)
        t["src0_is_ptr"] = src0_ptr
        t["src1_val"] = np.array(_limbs8(src1_val), np.uint32)
        t["src1_is_ptr"] = src1_ptr

        t.setdefault("uma_a_val", np.zeros(8, np.uint32))
        t.setdefault("uma_b_val", np.zeros(8, np.uint32))
        t.setdefault("storage_read_val", np.zeros(8, np.uint32))
        t.setdefault("pubdata_refund", 0)
        t.setdefault("dec_suggested_page", 0)
        t["fam_res0"] = np.zeros(8, np.uint32)
        t["fam_res1"] = np.zeros(8, np.uint32)

        st = dict(
            ts=ts, ergs1=ergs1, pc_plus_one=pc_plus_one,
            heap_page=heap_page, aux_heap_page=aux_heap_page,
            imm0=imm0, imm1=imm1, flags_bits=flags_bits, variant=variant,
            src0_val=src0_val, src0_ptr=src0_ptr,
            src1_val=src1_val, src1_ptr=src1_ptr,
            dst0_idx=dst0_idx, dst1_idx=dst1_idx,
            dst0_did_write=dst0_did_write, dst0_page=stack_page,
            dst0_index=dst0_index,
        )

        {
            isa.NOP: self._op_nop, isa.INVALID: self._op_nop,
            isa.ADD: self._op_add_sub, isa.SUB: self._op_add_sub,
            isa.MUL: self._op_mul_div, isa.DIV: self._op_mul_div,
            isa.JUMP: self._op_jump, isa.CONTEXT: self._op_context,
            isa.SHIFT: self._op_shift, isa.BINOP: self._op_binop,
            isa.PTR: self._op_ptr, isa.NEAR_CALL: self._op_near_call,
            isa.LOG: self._op_log, isa.FAR_CALL: self._op_far_call,
            isa.RET: self._op_ret, isa.UMA: self._op_uma,
        }[op_type](t, op_type, st)

    # -------------------- writeback helpers --------------------

    def _write_dst0(self, t, st, value, is_ptr):
        value &= U256
        if st["dst0_did_write"]:
            self._push_mem_query(
                st["ts"] + 3, st["dst0_page"], st["dst0_index"], True, is_ptr, value
            )
            self._mem_write(st["dst0_page"], st["dst0_index"], value, is_ptr)
        elif st["dst0_idx"] != 0:
            self.registers[st["dst0_idx"] - 1] = [value, bool(is_ptr)]

    def _write_dst1(self, st, value, is_ptr=False):
        if st["dst1_idx"] != 0:
            self.registers[st["dst1_idx"] - 1] = [value & U256, bool(is_ptr)]

    def _set_flags_if(self, st, of, eq, gt):
        if (st["flags_bits"] >> isa.SET_FLAGS_FLAG_IDX) & 1:
            self.flags = dict(of=bool(of), eq=bool(eq), gt=bool(gt))

    # -------------------- opcode families --------------------

    def _op_nop(self, t, op, st):
        pass

    def _op_add_sub(self, t, op, st):
        a, b = st["src0_val"], st["src1_val"]
        if op == isa.ADD:
            full = a + b
            of, r = full >> 256, full & U256
        else:
            of, r = int(a < b), (a - b) & U256
        self._write_dst0(t, st, r, False)
        eq = r == 0
        self._set_flags_if(st, of, eq, (not of) and (not eq))

    def _op_mul_div(self, t, op, st):
        a, b = st["src0_val"], st["src1_val"]
        if op == isa.MUL:
            full = a * b
            lo, hi = full & U256, full >> 256
            t["fam_res0"] = np.array(_limbs8(lo), np.uint32)
            t["fam_res1"] = np.array(_limbs8(hi), np.uint32)
            self._write_dst0(t, st, lo, False)
            self._write_dst1(st, hi)
            of, eq = hi != 0, lo == 0
            gt = (not of) and (not eq)
        else:
            q, r = (0, 0) if b == 0 else (a // b, a % b)
            t["fam_res0"] = np.array(_limbs8(q), np.uint32)
            t["fam_res1"] = np.array(_limbs8(r), np.uint32)
            self._write_dst0(t, st, q, False)
            self._write_dst1(st, r)
            of = b == 0
            eq = (b != 0) and q == 0
            gt = (b != 0) and r == 0
        self._set_flags_if(st, of, eq, gt)

    def _op_jump(self, t, op, st):
        self.ctx.pc = st["src0_val"] & U16

    def _op_context(self, t, op, st):
        v, c = st["variant"], self.ctx
        if v == isa.CTX_SET_CONTEXT_U128:
            self.context_u128 = [(st["src0_val"] >> (32 * k)) & U32 for k in range(4)]
            return
        if v == isa.CTX_SET_ERGS_PER_PUBDATA:
            self.ergs_per_pubdata = st["src0_val"] & U32
            return
        if v == isa.CTX_INCREMENT_TX_NUMBER:
            self.tx_number = (self.tx_number + 1) & U32
            return
        res = {
            isa.CTX_THIS: c.this,
            isa.CTX_CALLER: c.caller,
            isa.CTX_CODE_ADDRESS: c.code_address,
            isa.CTX_META: (
                self.ergs_per_pubdata
                | (c.heap_upper_bound << 64)
                | (c.aux_heap_upper_bound << 96)
                | (c.this_shard_id << 224)
                | (c.caller_shard_id << 232)
                | (c.code_shard_id << 240)
            ),
            isa.CTX_ERGS_LEFT: st["ergs1"],
            isa.CTX_SP: c.sp,
            isa.CTX_GET_CONTEXT_U128: sum(
                int(x) << (32 * k) for k, x in enumerate(c.context_u128_value_composite)
            ),
        }[v]
        self._write_dst0(t, st, res, False)

    def _op_shift(self, t, op, st):
        a = st["src0_val"]
        shift = st["src1_val"] & 0xFF
        v = st["variant"]
        is_cyclic = v in (isa.SHIFT_ROL, isa.SHIFT_ROR)
        full_shift = (256 - shift) if (v == isa.SHIFT_ROR and shift != 0) else shift
        is_right_shift = v == isa.SHIFT_SHR
        if is_right_shift:
            q, r = a >> full_shift, a & ((1 << full_shift) - 1)
            t["fam_res0"] = np.array(_limbs8(q), np.uint32)
            t["fam_res1"] = np.array(_limbs8(r), np.uint32)
            result = q
        else:
            full = a << full_shift
            lo, hi = full & U256, full >> 256
            t["fam_res0"] = np.array(_limbs8(lo), np.uint32)
            t["fam_res1"] = np.array(_limbs8(hi), np.uint32)
            result = (lo | hi) if is_cyclic else lo
        self._write_dst0(t, st, result, False)
        self._set_flags_if(st, False, result == 0, False)

    def _op_binop(self, t, op, st):
        a, b, v = st["src0_val"], st["src1_val"], st["variant"]
        r = a & b if v == isa.BINOP_AND else (a | b if v == isa.BINOP_OR else a ^ b)
        self._write_dst0(t, st, r, False)
        self._set_flags_if(st, False, r == 0, False)

    def _op_ptr(self, t, op, st):
        a, b, v = st["src0_val"], st["src1_val"], st["variant"]
        panic = not (st["src0_ptr"] and not st["src1_ptr"])
        b_lo32 = b & U32
        result = a
        if v in (isa.PTR_ADD, isa.PTR_SUB):
            panic = panic or (b >> 32) != 0
            off = a & U32
            noff = off + b_lo32 if v == isa.PTR_ADD else off - b_lo32
            panic = panic or noff < 0 or noff > U32
            result = (a & ~U32) | (noff & U32)
        elif v == isa.PTR_PACK:
            panic = panic or (b & ((1 << 128) - 1)) != 0
            result = (a & ((1 << 128) - 1)) | (b & ~((1 << 128) - 1))
        elif v == isa.PTR_SHRINK:
            nlen = ((a >> 96) & U32) - b_lo32
            panic = panic or nlen < 0
            result = (a & ~(U32 << 96)) | ((nlen & U32) << 96)
        if panic:
            self.pending_exception = True
        else:
            self._write_dst0(t, st, result, st["src0_ptr"])

    # ---- uma ----

    def _op_uma(self, t, op, st):
        v = st["variant"]
        increment = bool((st["flags_bits"] >> isa.UMA_INCREMENT_FLAG_IDX) & 1)
        is_fpr = v == isa.UMA_FAT_PTR_READ
        access_heap = v in (isa.UMA_HEAP_READ, isa.UMA_HEAP_WRITE)
        access_aux = v in (isa.UMA_AUX_HEAP_READ, isa.UMA_AUX_HEAP_WRITE)
        is_read = v in (isa.UMA_HEAP_READ, isa.UMA_AUX_HEAP_READ, isa.UMA_FAT_PTR_READ)

        src0 = st["src0_val"]
        offset, page, start, length = self._fat_ptr_parts(src0)
        not_ptr_when_expected = is_fpr and not st["src0_ptr"]

        offset_in_slice = offset < length
        skip_if_legit_ptr = is_fpr and not offset_in_slice
        formal_start = start if is_fpr else 0
        absolute_address = (formal_start + offset) & U32
        incremented_offset = (offset + 32) & U32
        non_addressable = (offset + 32 > U32) or (incremented_offset == U32)
        should_set_panic = not_ptr_when_expected or non_addressable
        skip_memory = not_ptr_when_expected or skip_if_legit_ptr or non_addressable
        bytes_oob = 0
        if (not skip_memory) and incremented_offset >= length:
            bytes_oob = (incremented_offset - length) % 32

        # heap growth (uma.rs:114-211); bound updates are unconditional on
        # panic, matching the reference's diff-push masks
        growth_cost = 0
        if access_heap or access_aux:
            bound = (
                self.ctx.heap_upper_bound if access_heap else self.ctx.aux_heap_upper_bound
            )
            if incremented_offset > bound:
                growth_cost = incremented_offset - bound
                if access_heap:
                    self.ctx.heap_upper_bound = incremented_offset
                else:
                    self.ctx.aux_heap_upper_bound = incremented_offset
            if (src0 >> 32) != 0 or non_addressable:
                growth_cost = U32
                should_set_panic = True
                skip_memory = True

        ergs2 = st["ergs1"] - growth_cost
        if ergs2 < 0:
            ergs2 = 0
            should_set_panic = True
            skip_memory = True
        self.ctx.ergs_remaining = ergs2

        mem_page = page
        if access_heap:
            mem_page = st["heap_page"]
        elif access_aux:
            mem_page = st["aux_heap_page"]

        cell = absolute_address >> 5
        unalign = absolute_address & 31
        read_a = not skip_memory
        read_b = read_a and unalign != 0

        a_val = b_val = 0
        if read_a:
            a_val, _ = self._mem_read(mem_page, cell)
            self._push_mem_query(st["ts"], mem_page, cell, False, False, a_val)
        if read_b:
            b_val, _ = self._mem_read(mem_page, (cell + 1) & U32)
            self._push_mem_query(st["ts"], mem_page, (cell + 1) & U32, False, False, b_val)
        t["uma_a_val"] = np.array(_limbs8(a_val), np.uint32)
        t["uma_b_val"] = np.array(_limbs8(b_val), np.uint32)

        buf = a_val.to_bytes(32, "big") + b_val.to_bytes(32, "big")
        selected = bytearray(buf[unalign : unalign + 32])
        cleanup = bytes_oob if is_fpr else 0
        for i in range(32 - cleanup, 32):
            selected[i] = 0
        read_value = int.from_bytes(bytes(selected), "big")

        execute_write = (not is_read) and not skip_memory
        if execute_write:
            newbuf = bytearray(buf)
            newbuf[unalign : unalign + 32] = st["src1_val"].to_bytes(32, "big")
            a_new = int.from_bytes(bytes(newbuf[:32]), "big")
            b_new = int.from_bytes(bytes(newbuf[32:]), "big")
            self._mem_write(mem_page, cell, a_new)
            self._push_mem_query(st["ts"] + 3, mem_page, cell, True, False, a_new)
            t["fam_res0"] = np.array(_limbs8(a_new), np.uint32)
            if unalign != 0:
                self._mem_write(mem_page, (cell + 1) & U32, b_new)
                self._push_mem_query(
                    st["ts"] + 3, mem_page, (cell + 1) & U32, True, False, b_new
                )
                t["fam_res1"] = np.array(_limbs8(b_new), np.uint32)

        if should_set_panic:
            self.pending_exception = True
        else:
            incr_src0 = (src0 & ~U32) | incremented_offset
            if is_read:
                self._write_dst0(t, st, read_value, False)
                if increment:
                    self._write_dst1(st, incr_src0, st["src0_ptr"])
            elif increment:
                self._write_dst0(t, st, incr_src0, st["src0_ptr"])

    # ---- log ----

    def _op_log(self, t, op, st):
        v = st["variant"]
        is_sread = v == isa.LOG_STORAGE_READ
        is_swrite = v == isa.LOG_STORAGE_WRITE
        is_event = v == isa.LOG_EVENT
        is_l1msg = v == isa.LOG_TO_L1_MESSAGE
        is_precompile = v == isa.LOG_PRECOMPILE_CALL
        is_storage = is_sread or is_swrite
        is_revertable = not (is_sread or is_precompile)

        key = st["src0_val"]
        written_value = st["src1_val"]
        if is_precompile:
            if (key >> 128) & U32 == 0:
                key |= st["heap_page"] << 128
            if (key >> 160) & U32 == 0:
                key |= st["heap_page"] << 160

        shard = self.ctx.this_shard_id
        aux_byte = (
            sp.STORAGE_AUX_BYTE if is_storage
            else sp.EVENT_AUX_BYTE if is_event
            else sp.L1_MESSAGE_AUX_BYTE if is_l1msg
            else sp.PRECOMPILE_AUX_BYTE
        )
        refund = 0
        if is_swrite and shard == 0:
            refund = 0  # oracle refund policy: none modeled
            burn = self.ergs_per_pubdata * (
                sp.INITIAL_STORAGE_WRITE_PUBDATA_BYTES - refund
            )
        elif is_l1msg:
            burn = self.ergs_per_pubdata * sp.L1_MESSAGE_PUBDATA_BYTES
        elif is_precompile:
            burn = written_value & U32
        else:
            burn = 0
        t["pubdata_refund"] = refund

        ergs2 = st["ergs1"] - burn
        have_ergs = ergs2 >= 0
        ergs2 = max(ergs2, 0)
        self.ctx.ergs_remaining = ergs2
        execute = have_ergs

        skey = (shard, self.ctx.this, key)
        read_value = self.storage.get(skey, 0) if (is_storage and execute) else 0
        t["storage_read_val"] = np.array(_limbs8(read_value), np.uint32)

        q = dict(
            address=self.ctx.this, key=key, read_value=read_value,
            written_value=written_value if is_revertable else read_value,
            rw_flag=is_revertable, aux_byte=aux_byte,
            is_service=bool((st["flags_bits"] >> isa.FIRST_MESSAGE_FLAG_IDX) & 1)
            if (is_event or is_l1msg) else False,
            shard_id=shard, tx_number_in_block=self.tx_number,
            timestamp=st["ts"] + 1,
        )

        if execute:
            self._push_log_forward(q)
            if is_revertable:
                enc_rb = self._encode_log_np(q, rollback=True)
                slot = {}
                self.ctx._segment.append((enc_rb, slot, dict(q)))
                self.ctx.reverted_queue_segment_len += 1
                t["_rb_push_slot"] = slot
            if is_swrite:
                self.storage[skey] = written_value
            if is_precompile:
                self._execute_precompile(dict(q))

        if is_sread:
            self._write_dst0(t, st, read_value, False)
        elif is_precompile:
            self._write_dst0(t, st, int(have_ergs), False)

    # ---- precompile host execution (the zk_evm host role) ----

    def _snapshot_word(self, page, index) -> bytes:
        val, _ = self._mem_read(page, index)
        word = int(val).to_bytes(32, "big")
        self.precompile_memory[(page, index)] = word
        return word

    def _execute_precompile(self, q: dict):
        """Execute keccak/sha256/ecrecover at call time; the memory traffic
        belongs to the precompile circuit (its generate_witness re-derives
        the exact read/write rows from `q` + `precompile_memory`), so only
        the OUTPUT lands in VM memory — not on the VM memory tape.
        ABI per models/{keccak256,sha256}_round_function.abi_from_key and
        models/ecrecover.generate_witness (ref precompile input.rs)."""
        addr = q["address"]
        key = int(q["key"])
        kl = [(key >> (32 * k)) & U32 for k in range(8)]
        in_page, out_page = kl[4], kl[5]
        if addr == sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS:
            off, length, out_word = kl[0], kl[1], kl[2]
            first_word = off // 32
            last_word = (off + length - 1) // 32 if length else first_word
            data = bytearray()
            for wi in range(first_word, last_word + 1):
                data += self._snapshot_word(in_page, wi)
            payload = bytes(data[off % 32 : off % 32 + length])
            digest = int.from_bytes(keccak256_ref(payload), "big")
            self._mem_write(out_page, out_word, digest)
            self.precompile_calls["keccak"].append(q)
        elif addr == sp.SHA256_PRECOMPILE_FORMAL_ADDRESS:
            in_off, out_off, nrounds = kl[0], kl[2], kl[6]
            state = list(sha_ops.H0)
            for r in range(nrounds):
                blk = b""
                for j in range(2):
                    blk += self._snapshot_word(in_page, in_off + 2 * r + j)
                block = [
                    int.from_bytes(blk[4 * j : 4 * j + 4], "big") for j in range(16)
                ]
                state = sha_ops.compress_ref(state, block)
            value = 0
            for k, l in enumerate(_digest_value_limbs(state)):
                value |= l << (32 * k)
            self._mem_write(out_page, out_off, value)
            self.precompile_calls["sha256"].append(q)
        elif addr == sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS:
            in_off, out_off = kl[0], kl[2]
            h, v, r, s = (
                int.from_bytes(self._snapshot_word(in_page, in_off + j), "big")
                for j in range(4)
            )
            # identical validity analysis to the circuit's witness oracle so
            # the sim's output writes match the circuit's write rows exactly
            a = _analyze_ecrecover_call(h, v, r, s)
            Q = None
            if a["ladder_on"]:
                r_inv = pow(r % ec.N, ec.N - 2, ec.N)
                u1, u2 = (-h * r_inv) % ec.N, (s * r_inv) % ec.N
                acc1 = ec.mul(u1, (ec.GX, ec.GY)) if u1 else None
                acc2 = ec.mul(u2, a["R"])
                exc_inf = (
                    acc1 is not None and acc1[0] == acc2[0]
                    and (acc1[1] + acc2[1]) % ec.P == 0
                )
                if not exc_inf:
                    Q = acc2 if acc1 is None else ec.add(acc1, acc2)
            if Q is not None:
                self._mem_write(out_page, out_off, 1)
                self._mem_write(out_page, out_off + 1, ec.eth_address(Q))
            else:
                self._mem_write(out_page, out_off, 0)
                self._mem_write(out_page, out_off + 1, 0)
            self.precompile_calls["ecrecover"].append(q)

    # ---- near_call ----

    def _op_near_call(self, t, op, st):
        old = self.ctx
        old.pc = st["pc_plus_one"]
        preliminary = st["ergs1"]
        ergs_passed = st["src0_val"] & U32
        ergs_to_pass = preliminary if ergs_passed == 0 else ergs_passed
        if ergs_to_pass > preliminary:
            remaining, passed = 0, preliminary
        else:
            remaining, passed = preliminary - ergs_to_pass, ergs_to_pass
        old.ergs_remaining = remaining

        new = old.copy()
        new.ergs_remaining = passed
        new.pc = st["imm0"]
        new.exception_handler_loc = st["imm1"]
        new.is_local_call = True
        self._push_and_enter(t, old, new)
        self.flags = dict(of=False, eq=False, gt=False)

    def _push_and_enter(self, t, old: ExecutionContextRecord, new: ExecutionContextRecord):
        """Save `old` on the callstack (phase-B sponge event), install `new`
        with a fresh rollback segment.  The new frame's claimed tail is an
        independent slot; phase B pins it (revert → forward-chain value,
        ok-ret → parent's saved head, still-live → finalize chain)."""
        old._head_ref = self._cur_head_ref()  # head at save time (encoding)
        self.frames.append(old)
        self.cs_events[-1] = ("push", old)
        self.cs_depth += 1
        new._tail_slot = {}
        t["_call_rb_tail_ref"] = ("tail", new._tail_slot)
        new._segment = []
        new.reverted_queue_segment_len = 0
        self.ctx = new

    # ---- far_call ----

    def _op_far_call(self, t, op, st):
        c = self.ctx
        v = st["variant"]
        is_delegate = v == isa.FAR_CALL_DELEGATE
        is_mimic = v == isa.FAR_CALL_MIMIC
        is_static_call = bool((st["flags_bits"] >> isa.FAR_CALL_STATIC_FLAG_IDX) & 1)
        is_shard_call = bool((st["flags_bits"] >> isa.FAR_CALL_SHARD_FLAG_IDX) & 1)

        old = c  # mutated in place then saved
        old.pc = st["pc_plus_one"]

        abi = st["src0_val"]
        abi_bytes = abi.to_bytes(32, "little")
        ergs_passed_abi = (abi >> 192) & U32
        forwarding_byte = abi_bytes[sp.FAR_CALL_FORWARDING_MODE_BYTE_IDX]
        shard_byte = abi_bytes[sp.FAR_CALL_SHARD_ID_BYTE_IDX]
        constructor_byte = abi_bytes[sp.FAR_CALL_CONSTRUCTOR_CALL_BYTE_IDX]
        system_byte = abi_bytes[sp.FAR_CALL_SYSTEM_CALL_BYTE_IDX]
        use_aux_heap = forwarding_byte == sp.FORWARD_PAGE_USE_AUX_HEAP
        forward_fat_ptr = forwarding_byte == sp.FORWARD_PAGE_FORWARD_FAT_POINTER
        use_heap = not (use_aux_heap or forward_fat_ptr)

        dest = st["src1_val"] & ((1 << 160) - 1)
        dest_shard = shard_byte if is_shard_call else c.this_shard_id
        target_is_zkporter = dest_shard != 0
        target_is_kernel = dest < (1 << 16)
        constructor_call = bool(constructor_byte) and c.is_kernel_mode
        system_call = bool(system_byte) and target_is_kernel

        offset, page, start, length = self._fat_ptr_parts(abi)
        as_fresh = not forward_fat_ptr
        nonzero_offset_fresh = (offset != 0) and as_fresh
        end_ni = start + length
        slice_overflow = end_ni > U32
        invalid_slice = length < offset
        ptr_invalid = nonzero_offset_fresh or slice_overflow or invalid_slice
        if ptr_invalid:
            offset = page = start = length = 0
        upper_bound = end_ni & U32

        new_base_page = self.page_counter
        self.page_counter = (self.page_counter + sp.NEW_MEMORY_PAGES_PER_FAR_CALL) & U32

        # code-hash read (far_call.rs:1104-1280)
        can_read = (not target_is_zkporter) or self.zkporter_available
        should_read = can_read
        skey = (dest_shard, sp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, dest)
        raw_hash = self.storage.get(skey, 0) if should_read else 0
        t["storage_read_val"] = np.array(_limbs8(raw_hash), np.uint32)
        needs_porter_mask = target_is_zkporter and not self.zkporter_available
        bytecode_is_empty = raw_hash == 0
        mask_default_aa = should_read and bytecode_is_empty and not target_is_kernel
        bytecode_hash = self.default_aa_code_hash if mask_default_aa else raw_hash
        if needs_porter_mask:
            bytecode_hash = 0
        if should_read:
            self._push_log_forward(
                dict(
                    address=sp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, key=dest,
                    read_value=raw_hash, written_value=raw_hash, rw_flag=False,
                    aux_byte=sp.STORAGE_AUX_BYTE, is_service=False,
                    shard_id=dest_shard, tx_number_in_block=self.tx_number,
                    timestamp=st["ts"] + 1,
                )
            )

        version_byte = (bytecode_hash >> 248) & 0xFF
        marker_byte = (bytecode_hash >> 240) & 0xFF
        version_ok = version_byte == sp.CODE_HASH_VERSION_BYTE
        is_normal_marker = marker_byte == sp.CODE_AT_REST_MARKER
        is_constructed_marker = marker_byte == sp.YET_CONSTRUCTED_MARKER
        code_format_exception = (not version_ok) or not (
            is_normal_marker or is_constructed_marker
        )
        can_call_code = (is_normal_marker and not constructor_call) or (
            is_constructed_marker and constructor_call
        )
        call_in_construction_kernel = (not can_call_code) and target_is_kernel
        if can_call_code:
            masked_hash = (bytecode_hash & ~(0xFF << 240)) | (
                sp.CODE_AT_REST_MARKER << 240
            )
        else:
            masked_hash = 0 if target_is_kernel else self.default_aa_code_hash
        code_len_words = 0 if code_format_exception else (masked_hash >> 224) & U16

        fat_ptr_expected_exception = forward_fat_ptr and not st["src0_ptr"]
        exceptions = (
            code_format_exception
            or call_in_construction_kernel
            or fat_ptr_expected_exception
            or ptr_invalid
        )

        # heap growth for forwarded-by-copy regions (far_call.rs:659-731)
        ub = 0 if exceptions else upper_bound
        if slice_overflow and not forward_fat_ptr:
            ub = U32
        growth_cost = 0
        if use_heap or use_aux_heap:
            bound = old.heap_upper_bound if use_heap else old.aux_heap_upper_bound
            if ub > bound:
                growth_cost = ub - bound
                if use_heap:
                    old.heap_upper_bound = ub
                else:
                    old.aux_heap_upper_bound = ub
        ergs2 = st["ergs1"] - growth_cost
        if ergs2 < 0:
            ergs2 = 0
            exceptions = True

        should_decommit = not exceptions
        cost = sp.ERGS_PER_CODE_WORD_DECOMMITTMENT * code_len_words
        if should_decommit and cost > ergs2:
            should_decommit = False
            exceptions = True
        ergs_after = ergs2 - cost if should_decommit else ergs2

        code_memory_page = sp.UNMAPPED_PAGE
        if should_decommit:
            target_page = new_base_page
            suggested = self.decommitted.get(masked_hash, target_page)
            t["dec_suggested_page"] = suggested
            is_first = suggested == target_page
            if not is_first:
                ergs_after = ergs2  # refund
            code_memory_page = suggested
            self.decommit_tape.append(
                dict(code_hash=masked_hash, page=suggested, is_first=is_first,
                     timestamp=st["ts"] + 1)
            )
            from ...base_structures.decommit_query import encode_decommit_query_ref

            enc = np.array(
                encode_decommit_query_ref(
                    dict(code_hash=masked_hash, page=suggested,
                         is_first=is_first, timestamp=st["ts"] + 1)
                ),
                np.uint64,
            )
            self.dec_q_state = self._full_absorb(self.dec_q_state, enc)
            self.dec_q_len += 1
            if is_first:
                self.decommitted[masked_hash] = suggested
                self.memory[suggested] = {
                    i: (w, False)
                    for i, w in enumerate(self.code_store.get(masked_hash, []))
                }

        # 63/64 rule (far_call.rs:856-890)
        max_passable = (ergs_after // 64) * 63
        ergs_to_pass = min(ergs_passed_abi, max_passable)
        old.ergs_remaining = ergs_after - ergs_to_pass

        mimic_caller = self.registers[sp.CALL_IMPLICIT_PARAMETER_REG_IDX][0] & (
            (1 << 160) - 1
        )
        new = ExecutionContextRecord(
            heap_upper_bound=sp.NEW_FRAME_MEMORY_STIPEND,
            aux_heap_upper_bound=sp.NEW_FRAME_MEMORY_STIPEND,
            ergs_remaining=ergs_to_pass,
            pc=0,
            exception_handler_loc=st["imm0"],
            is_static_execution=is_static_call or c.is_static_execution,
            is_kernel_mode=c.is_kernel_mode if is_delegate else target_is_kernel,
            code_shard_id=dest_shard,
            code_address=dest,
            this_shard_id=c.this_shard_id if is_delegate else dest_shard,
            this=c.this if is_delegate else dest,
            caller=c.caller if is_delegate else (mimic_caller if is_mimic else c.this),
            caller_shard_id=c.this_shard_id,
            code_page=code_memory_page,
            base_page=new_base_page,
            context_u128_value_composite=tuple(
                c.context_u128_value_composite if is_delegate else self.context_u128
            ),
            is_local_call=False,
        )

        # ABI registers (far_call.rs:1006-1071)
        if exceptions:
            final_ptr = (0, 0, 0, 0)
        elif forward_fat_ptr:
            final_ptr = (0, page, (start + offset) & U32, (length - offset) & U32)
        else:
            fpage = st["heap_page"] if use_heap else st["aux_heap_page"]
            final_ptr = (0, fpage, start, length)
        r1 = final_ptr[1] << 32 | final_ptr[2] << 64 | final_ptr[3] << 96
        self.registers[0] = [r1, True]
        self.registers[1] = [int(constructor_call) | (int(system_call) << 1), False]
        for idx in sp.CALL_SYSTEM_ABI_REGISTERS:
            if system_call:
                self.registers[idx][1] = False  # erase ptr markers only
            else:
                self.registers[idx] = [0, False]
        for idx in sp.CALL_RESERVED_RANGE:
            self.registers[idx] = [0, False]
        self.registers[sp.CALL_IMPLICIT_PARAMETER_REG_IDX] = [0, False]

        self._push_and_enter(t, old, new)
        self.context_u128 = [0, 0, 0, 0]
        self.flags = dict(of=False, eq=False, gt=False)
        if exceptions:
            self.pending_exception = True

    # ---- ret ----

    def _op_ret(self, t, op, st):
        c = self.ctx
        v = st["variant"]
        is_ok = v == isa.RET_OK
        is_revert = v == isa.RET_REVERT
        is_panic = v == isa.RET_PANIC
        is_local = c.is_local_call
        is_far_return = not is_local
        to_label = bool((st["flags_bits"] >> isa.RET_TO_LABEL_BIT_IDX) & 1)

        src0 = 0 if is_panic else st["src0_val"]
        src0_ptr = (not is_panic) and st["src0_ptr"]
        abi_bytes = src0.to_bytes(32, "little")
        forwarding_byte = abi_bytes[sp.FAR_CALL_FORWARDING_MODE_BYTE_IDX]
        use_aux_heap = forwarding_byte == sp.FORWARD_PAGE_USE_AUX_HEAP
        forward_fat_ptr = forwarding_byte == sp.FORWARD_PAGE_FORWARD_FAT_POINTER
        use_heap = not (use_aux_heap or forward_fat_ptr)

        # pop the saved record; it stays FROZEN for the push/pop sponge
        # witness (save-time values) — the live continuation is a copy
        popped = self.frames.pop()
        self.cs_events[-1] = ("pop", popped)
        t["_ret_popped"] = popped
        self.cs_depth -= 1
        parent = popped.copy()
        parent._segment = list(getattr(popped, "_segment", []))
        parent._tail_slot = popped._tail_slot
        parent._head_ref = popped._head_ref

        preliminary = st["ergs1"]
        offset, pg, start, length = self._fat_ptr_parts(src0)
        fat_ptr_expected_exc = forward_fat_ptr and (not src0_ptr) and is_far_return
        non_unidirectional = forward_fat_ptr and pg < c.base_page
        as_fresh = not forward_fat_ptr
        nonzero_offset_fresh = (offset != 0) and as_fresh
        end_ni = start + length
        slice_overflow = end_ni > U32
        invalid_slice = length < offset
        ptr_invalid = nonzero_offset_fresh or slice_overflow or invalid_slice
        exceptions = is_panic or (
            is_far_return
            and (fat_ptr_expected_exc or non_unidirectional or ptr_invalid)
        )

        growth_cost = 0
        if is_far_return and not exceptions:
            ub = end_ni & U32
            if slice_overflow and not forward_fat_ptr:
                ub = U32
            if use_heap or use_aux_heap:
                bound = c.heap_upper_bound if use_heap else c.aux_heap_upper_bound
                if ub > bound:
                    growth_cost = ub - bound
        ergs2 = preliminary - growth_cost
        if ergs2 < 0:
            ergs2 = 0
            exceptions = True
        if is_local:
            ergs2 = preliminary

        non_local_panic = is_far_return and (is_panic or exceptions)
        perform_revert = is_revert or is_panic or non_local_panic

        parent.ergs_remaining = (parent.ergs_remaining + ergs2) & U32
        if is_local:
            # local frames share the heaps; keep the grown bounds
            parent.heap_upper_bound = c.heap_upper_bound
            parent.aux_heap_upper_bound = c.aux_heap_upper_bound

        if perform_revert:
            # append this frame's rollback segment to the forward queue:
            # tail jumps to the frame's claimed rollback tail; consumed
            # entries' head claims anchor at the forward tail here
            h = self.log_fwd_tail.copy()
            for enc_rb, slot, q in reversed(c._segment):
                slot["head_after"] = h.copy()
                self.log_tape.append(dict(q, rollback=True))
                h = self._narrow_hash(h, enc_rb)
            self.log_fwd_len += len(c._segment)
            self.log_fwd_tail = h
            c._tail_slot["value"] = h.copy()  # the claimed tail, pinned
            dst_pc = c.exception_handler_loc
        else:
            # ok: the child tail must equal the parent's saved head
            # (ret.rs:368-374) and the child's segment joins the parent's
            # (child entries are shallower in the backward chain)
            c._tail_slot.setdefault("alias", parent._head_ref)
            parent._segment = parent._segment + c._segment
            parent.reverted_queue_segment_len += c.reverted_queue_segment_len
            dst_pc = parent.pc
        if to_label and is_local:
            dst_pc = st["imm0"]
        parent.pc = dst_pc

        if is_far_return:
            if exceptions:
                final_ptr = (0, 0, 0, 0)
            elif forward_fat_ptr:
                final_ptr = (0, pg, (start + offset) & U32, (length - offset) & U32)
            else:
                fpage = st["heap_page"] if use_heap else st["aux_heap_page"]
                final_ptr = (0, fpage, start, length)
            r1 = final_ptr[1] << 32 | final_ptr[2] << 64 | final_ptr[3] << 96
            self.registers[0] = [r1, True]
            for idx in range(1, 15):
                self.registers[idx] = [0, False]
            self.context_u128 = [0, 0, 0, 0]

        self.ctx = parent
        self.flags = dict(of=bool(is_panic or non_local_panic), eq=False, gt=False)

    # -------------------- phase B: resolution + assembly --------------------

    def _assemble_witness(self) -> dict:
        # 1) resolve still-live rollback segments against the final forward
        #    tail: the chain runs through every live frame's segment,
        #    innermost (latest pushes) first; crossing a frame boundary pins
        #    that frame's claimed tail
        h = self.log_fwd_tail.copy()
        for rec in [self.ctx] + list(reversed(self.frames)):
            for enc_rb, slot, _q in reversed(getattr(rec, "_segment", [])):
                if "head_after" not in slot:
                    slot["head_after"] = h.copy()
                h = self._narrow_hash(h, enc_rb)
            tslot = getattr(rec, "_tail_slot", None)
            if tslot is not None and "value" not in tslot and "alias" not in tslot:
                tslot["value"] = h.copy()
        self._block_slot.setdefault("value", h.copy())
        block_tail = np.asarray(self._block_slot["value"], np.uint64)
        self.block_rollback_tail = block_tail

        def rref(ref, _depth=0):
            assert _depth < 4096
            if ref[0] == "push":
                return np.asarray(ref[1]["head_after"], np.uint64)
            slot = ref[1]
            if "value" in slot:
                return np.asarray(slot["value"], np.uint64)
            return rref(slot["alias"], _depth + 1)

        def rec_tail(rec):
            return rref(("tail", rec._tail_slot))

        def rec_head(rec):
            return rref(rec._head_ref)

        # 2) replay the callstack sponge with resolved encodings
        from ...runtime import native  # noqa: F401 (warm the lib)

        boot = initial_bootloader_state()
        empty = self.frames[0] if self.frames else boot["empty_entry"]
        # boot sponge: absorb the empty entry (head = tail = block tail)
        def enc_record(rec):
            r = rec.copy()
            r.reverted_queue_tail = tuple(int(x) for x in rec_tail(rec))
            r.reverted_queue_head = tuple(int(x) for x in rec_head(rec))
            return encode_context_record(r)

        N = self.limit
        sponge_stack = [np.zeros(12, np.uint64)]
        boot_empty = boot["empty_entry"]
        boot_empty.reverted_queue_tail = tuple(int(x) for x in block_tail)
        boot_empty.reverted_queue_head = boot_empty.reverted_queue_tail
        cur = callstack_sponge_absorb(
            np.zeros(12, np.uint64), encode_context_record(boot_empty)
        )
        cs_col = np.zeros((N + 1, 12), np.uint64)
        ret_prev = np.zeros((N, 12), np.uint64)
        popped_recs = [None] * N
        for i in range(N):
            cs_col[i] = cur
            ev = self.cs_events[i]
            if ev is not None and ev[0] == "push":
                sponge_stack.append(cur)
                cur = callstack_sponge_absorb(cur, enc_record(ev[1]))
            elif ev is not None and ev[0] == "pop":
                prev = sponge_stack.pop()
                ret_prev[i] = prev
                popped_recs[i] = ev[1]
                cur = prev
        cs_col[N] = cur

        # 3) assemble columns
        w = {}
        sr = self._state_rows
        for key in sr[0]:
            if key.startswith("_"):
                continue
            w[key] = np.asarray([row[key] for row in sr])
        w["cs_sponge"] = cs_col
        w["ctx_rq_head"] = np.asarray([rref(row["_rq_head_ref"]) for row in sr])
        w["ctx_rq_tail"] = np.asarray([rref(row["_rq_tail_ref"]) for row in sr])

        tr = self._trace
        for key in [
            "code_word_read", "should_read_opcode", "src0_mem_val",
            "src0_mem_is_ptr", "uma_a_val", "uma_b_val", "storage_read_val",
            "pubdata_refund", "dec_suggested_page", "fam_res0", "fam_res1",
            "src0_val", "src0_is_ptr", "src1_val", "src1_is_ptr",
            "raw_opcode_lo", "raw_opcode_hi",
            "src0_did_read", "dst0_did_write", "dst0_page", "dst0_index",
        ]:
            w[key] = np.asarray([t[key] for t in tr])
        w["zkporter_available"] = np.asarray(self.zkporter_available)
        w["default_aa_code_hash"] = np.asarray(
            _limbs8(self.default_aa_code_hash), np.uint32
        )

        w["rb_prev_head"] = np.asarray(
            [
                t["_rb_push_slot"]["head_after"]
                if "_rb_push_slot" in t
                else np.zeros(4, np.uint64)
                for t in tr
            ]
        )
        w["call_rb_tail"] = np.asarray(
            [
                rref(t["_call_rb_tail_ref"])
                if "_call_rb_tail_ref" in t
                else np.zeros(4, np.uint64)
                for t in tr
            ]
        )
        # popped-record field columns (the circuit re-packs the 32-element
        # encoding and checks the pop sponge against them)
        empty_rec = ExecutionContextRecord()
        empty_rec._tail_slot = {"value": np.zeros(4, np.uint64)}
        empty_rec._head_ref = ("tail", empty_rec._tail_slot)

        def addr5(v):
            return [(v >> (32 * k)) & U32 for k in range(5)]

        pr = [rec if rec is not None else empty_rec for rec in popped_recs]
        w["ret_popped_this"] = np.asarray([addr5(r.this) for r in pr], np.uint32)
        w["ret_popped_caller"] = np.asarray([addr5(r.caller) for r in pr], np.uint32)
        w["ret_popped_code_address"] = np.asarray(
            [addr5(r.code_address) for r in pr], np.uint32
        )
        for name, attr in [
            ("code_page", "code_page"), ("base_page", "base_page"),
            ("heap_bound", "heap_upper_bound"),
            ("aux_heap_bound", "aux_heap_upper_bound"),
            ("pc", "pc"), ("sp", "sp"), ("eh", "exception_handler_loc"),
            ("ergs", "ergs_remaining"), ("rq_len", "reverted_queue_segment_len"),
            ("shard_this", "this_shard_id"), ("shard_caller", "caller_shard_id"),
            ("shard_code", "code_shard_id"),
        ]:
            w["ret_popped_" + name] = np.asarray(
                [getattr(r, attr) for r in pr], np.uint32
            )
        for name, attr in [
            ("is_static", "is_static_execution"),
            ("is_kernel", "is_kernel_mode"), ("is_local", "is_local_call"),
        ]:
            w["ret_popped_" + name] = np.asarray([getattr(r, attr) for r in pr], bool)
        w["ret_popped_ctx_u128"] = np.asarray(
            [list(r.context_u128_value_composite) for r in pr], np.uint32
        )
        w["ret_popped_rq_head"] = np.asarray([rec_head(r) for r in pr], np.uint64)
        w["ret_popped_rq_tail"] = np.asarray([rec_tail(r) for r in pr], np.uint64)

        w["ret_prev_cs_sponge"] = ret_prev
        w["block_rollback_tail"] = block_tail
        return w


def simulate(code_words, limit: int, **kw) -> dict:
    return EraVM(code_words, limit, **kw).run()
