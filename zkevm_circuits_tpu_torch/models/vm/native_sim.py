"""Native EraVM witness oracle: the ctypes front end of native/eravm.cpp (the
JAX package's `models/vm/native_sim.py`).

`NativeEraVM(code_words, limit, ...)` runs the cycle loop as native C++ and
`run()` returns the witness as a dict of numpy arrays (state columns with
limit + 1 rows, per-cycle columns with limit rows); the tapes and precompile
calls are attributes.  `models/vm/circuit.py:prepare_device_witness` takes
the dict to the device.  The ctypes structures follow native/eravm.cpp field
for field.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np

from ...isa import opcodes as isa
from ...isa import system_params as sp
from ...runtime import native

U32 = 0xFFFFFFFF
U256_MASK = (1 << 256) - 1

u64 = ctypes.c_uint64
u64p = ctypes.POINTER(ctypes.c_uint64)
u32p = ctypes.POINTER(ctypes.c_uint32)
u8p = ctypes.POINTER(ctypes.c_uint8)


class EravmParams(ctypes.Structure):
    _fields_ = [
        ("limit", u64),
        ("n_code_words", u64),
        ("n_calldata", u64),
        ("n_heap_init", u64),
        ("n_storage", u64),
        ("n_code_store", u64),
        ("zkporter_available", u64),
        ("default_aa_code_hash", u64 * 4),
        ("boot_code_hash", u64 * 4),
        ("initial_registers", u64 * (15 * 5)),
        ("mem_tape_cap", u64),
        ("log_tape_cap", u64),
        ("dec_tape_cap", u64),
        ("pc_calls_cap", u64),
        ("pm_cap", u64),
        ("opcode_props", u64p),
        ("opcode_prices", u64p),
        ("nop_encoding", u64),
        ("panic_encoding", u64),
        ("code_words", u64p),
        ("calldata_index", u64p),
        ("calldata_value", u64p),
        ("heap_init_index", u64p),
        ("heap_init_value", u64p),
        ("storage_shard", u64p),
        ("storage_addr", u64p),
        ("storage_key", u64p),
        ("storage_value", u64p),
        ("code_store_hash", u64p),
        ("code_store_off", u64p),
        ("code_store_len", u64p),
        ("code_store_words", u64p),
    ] + [
        (name, u64)
        for name in [
            "sp_bootloader_code_page", "sp_bootloader_calldata_page",
            "sp_bootloader_base_page", "sp_starting_timestamp",
            "sp_vm_max_stack_depth", "sp_starting_base_page",
            "sp_bootloader_formal_address", "sp_ecrecover_addr",
            "sp_sha256_addr", "sp_keccak_addr",
            "sp_aux_storage", "sp_aux_event", "sp_aux_l1", "sp_aux_precompile",
            "sp_vm_initial_frame_ergs", "sp_initial_frame_eh",
            "sp_bootloader_max_memory", "sp_new_frame_memory_stipend",
            "sp_new_pages_per_far_call", "sp_unmapped_page",
            "sp_ergs_per_code_word", "sp_deployer_address",
            "sp_initial_storage_write_pubdata_bytes", "sp_l1_message_pubdata_bytes",
            "sp_fwd_mode_byte_idx", "sp_shard_id_byte_idx",
            "sp_constructor_byte_idx", "sp_system_byte_idx",
            "sp_forward_use_heap", "sp_forward_fat_ptr", "sp_forward_use_aux_heap",
            "sp_code_hash_version_byte", "sp_code_at_rest_marker",
            "sp_yet_constructed_marker", "sp_call_system_abi_reg_mask",
            "sp_call_reserved_reg_mask", "sp_call_implicit_reg_idx",
        ]
    ]


# (name, kind, per-row-width, rows) — kind: u32/u8/u64; rows: "R" (=N+1),
# "N", or an int.  Declaration order IS the C struct order.
_OUT_FIELDS = [
    ("regs", "u32", 15 * 8, "R"),
    ("regs_ptr", "u8", 15, "R"),
    ("f_of", "u8", 1, "R"), ("f_eq", "u8", 1, "R"), ("f_gt", "u8", 1, "R"),
    ("ts", "u32", 1, "R"), ("page_counter", "u32", 1, "R"),
    ("tx_number", "u32", 1, "R"), ("prev_code_page", "u32", 1, "R"),
    ("prev_super_pc", "u32", 1, "R"),
    ("prev_code_word", "u32", 8, "R"),
    ("pending_exc", "u8", 1, "R"),
    ("ergs_pp", "u32", 1, "R"),
    ("ctx_u128", "u32", 4, "R"),
    ("cs_depth", "u32", 1, "R"),
    ("mem_q_state", "u64", 12, "R"),
    ("mem_q_len", "u32", 1, "R"),
    ("dec_q_state", "u64", 12, "R"),
    ("dec_q_len", "u32", 1, "R"),
    ("log_fwd_tail", "u64", 4, "R"),
    ("log_fwd_len", "u32", 1, "R"),
    ("ctx_this", "u32", 5, "R"), ("ctx_caller", "u32", 5, "R"),
    ("ctx_code_address", "u32", 5, "R"),
    ("ctx_code_page", "u32", 1, "R"), ("ctx_base_page", "u32", 1, "R"),
    ("ctx_heap_bound", "u32", 1, "R"), ("ctx_aux_heap_bound", "u32", 1, "R"),
    ("ctx_pc", "u32", 1, "R"), ("ctx_sp", "u32", 1, "R"),
    ("ctx_eh", "u32", 1, "R"), ("ctx_ergs", "u32", 1, "R"),
    ("ctx_is_static", "u8", 1, "R"), ("ctx_is_kernel", "u8", 1, "R"),
    ("ctx_is_local", "u8", 1, "R"),
    ("ctx_shard_this", "u32", 1, "R"), ("ctx_shard_caller", "u32", 1, "R"),
    ("ctx_shard_code", "u32", 1, "R"),
    ("ctx_ctx_u128", "u32", 4, "R"),
    ("ctx_rq_len", "u32", 1, "R"),
    ("ctx_rq_head", "u64", 4, "R"),
    ("ctx_rq_tail", "u64", 4, "R"),
    ("cs_sponge", "u64", 12, "R"),
    ("code_word_read", "u32", 8, "N"),
    ("should_read_opcode", "u8", 1, "N"),
    ("src0_mem_val", "u32", 8, "N"),
    ("src0_mem_is_ptr", "u8", 1, "N"),
    ("uma_a_val", "u32", 8, "N"), ("uma_b_val", "u32", 8, "N"),
    ("storage_read_val", "u32", 8, "N"),
    ("pubdata_refund", "u32", 1, "N"),
    ("dec_suggested_page", "u32", 1, "N"),
    ("fam_res0", "u32", 8, "N"), ("fam_res1", "u32", 8, "N"),
    ("src0_val", "u32", 8, "N"), ("src0_is_ptr", "u8", 1, "N"),
    ("src1_val", "u32", 8, "N"), ("src1_is_ptr", "u8", 1, "N"),
    ("raw_opcode_lo", "u32", 1, "N"), ("raw_opcode_hi", "u32", 1, "N"),
    ("src0_did_read", "u8", 1, "N"), ("dst0_did_write", "u8", 1, "N"),
    ("dst0_page", "u32", 1, "N"), ("dst0_index", "u32", 1, "N"),
    ("rb_prev_head", "u64", 4, "N"),
    ("call_rb_tail", "u64", 4, "N"),
    ("ret_popped_this", "u32", 5, "N"), ("ret_popped_caller", "u32", 5, "N"),
    ("ret_popped_code_address", "u32", 5, "N"),
    ("ret_popped_code_page", "u32", 1, "N"), ("ret_popped_base_page", "u32", 1, "N"),
    ("ret_popped_heap_bound", "u32", 1, "N"),
    ("ret_popped_aux_heap_bound", "u32", 1, "N"),
    ("ret_popped_pc", "u32", 1, "N"), ("ret_popped_sp", "u32", 1, "N"),
    ("ret_popped_eh", "u32", 1, "N"), ("ret_popped_ergs", "u32", 1, "N"),
    ("ret_popped_rq_len", "u32", 1, "N"),
    ("ret_popped_shard_this", "u32", 1, "N"),
    ("ret_popped_shard_caller", "u32", 1, "N"),
    ("ret_popped_shard_code", "u32", 1, "N"),
    ("ret_popped_is_static", "u8", 1, "N"), ("ret_popped_is_kernel", "u8", 1, "N"),
    ("ret_popped_is_local", "u8", 1, "N"),
    ("ret_popped_ctx_u128", "u32", 4, "N"),
    ("ret_popped_rq_head", "u64", 4, "N"), ("ret_popped_rq_tail", "u64", 4, "N"),
    ("ret_prev_cs_sponge", "u64", 12, "N"),
    ("block_rollback_tail", "u64", 4, 1),
    ("mt_ts", "u32", 1, "MC"), ("mt_page", "u32", 1, "MC"),
    ("mt_index", "u32", 1, "MC"), ("mt_rw", "u8", 1, "MC"),
    ("mt_is_ptr", "u8", 1, "MC"), ("mt_value", "u32", 8, "MC"),
    ("mem_tape_len", "u64", 1, 1),
    ("lt_address", "u32", 5, "LC"),
    ("lt_key", "u32", 8, "LC"), ("lt_read_value", "u32", 8, "LC"),
    ("lt_written_value", "u32", 8, "LC"),
    ("lt_aux_byte", "u32", 1, "LC"), ("lt_rw_flag", "u8", 1, "LC"),
    ("lt_rollback", "u8", 1, "LC"), ("lt_is_service", "u8", 1, "LC"),
    ("lt_shard_id", "u32", 1, "LC"), ("lt_tx_number", "u32", 1, "LC"),
    ("lt_timestamp", "u32", 1, "LC"),
    ("log_tape_len", "u64", 1, 1),
    ("dt_code_hash", "u32", 8, "DC"),
    ("dt_page", "u32", 1, "DC"), ("dt_is_first", "u8", 1, "DC"),
    ("dt_timestamp", "u32", 1, "DC"),
    ("dec_tape_len", "u64", 1, 1),
    ("pc_family", "u8", 1, "PC"), ("pc_log_index", "u64", 1, "PC"),
    ("pc_calls_len", "u64", 1, 1),
    ("pm_page", "u32", 1, "PM"), ("pm_word", "u32", 1, "PM"),
    ("pm_value", "u8", 32, "PM"),
    ("pm_len", "u64", 1, 1),
]

_KIND = {"u32": (np.uint32, u32p), "u8": (np.uint8, u8p), "u64": (np.uint64, u64p)}


class EravmOut(ctypes.Structure):
    _fields_ = [(name, _KIND[kind][1]) for name, kind, _, _ in _OUT_FIELDS]


_vm_lib = None


def _get_vm_lib():
    global _vm_lib
    if _vm_lib is None:
        lib = native.get_lib()  # builds the combined library, sets the constants
        lib.eravm_run.argtypes = [
            ctypes.POINTER(EravmParams), ctypes.POINTER(EravmOut)]
        lib.eravm_run.restype = ctypes.c_int
        _vm_lib = lib
    return _vm_lib


def _limbs4(v: int) -> list:
    return [(int(v) >> (64 * k)) & 0xFFFFFFFFFFFFFFFF for k in range(4)]


def _u256_from_limbs8(limbs8) -> int:
    return sum(int(x) << (32 * k) for k, x in enumerate(limbs8))


def _u64arr(vals) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(vals, dtype=np.uint64).reshape(-1))


def assemble_code_words(instructions) -> list:
    """Pack 64-bit instruction words into 256-bit code words, 4 per word.
    The instruction at sub-pc k occupies u32 limbs (6-2k, 7-2k); the tail is
    padded with INVALID (an explicit panic)."""
    pad = isa.encode_instruction(isa.INVALID)
    ins = list(instructions)
    while len(ins) % 4:
        ins.append(pad)
    words = []
    for base in range(0, len(ins), 4):
        w = 0
        for k in range(4):
            inst = ins[base + k]
            w |= (inst & U32) << (32 * (6 - 2 * k))
            w |= ((inst >> 32) & U32) << (32 * (7 - 2 * k))
        words.append(w)
    return words


def compute_boot_code_hash(code_words) -> int:
    """sha256-versioned bootloader code hash."""
    data = b"".join(int(x).to_bytes(32, "big") for x in code_words)
    boot_hash = int.from_bytes(hashlib.sha256(data).digest(), "big") & ((1 << 224) - 1)
    boot_hash |= (
        (sp.CODE_HASH_VERSION_BYTE << 8) << 16 | len(code_words)
    ) << 224
    return boot_hash


class NativeEraVM:
    """EraVM with the cycle loop in native C++."""

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
        from .state import initial_bootloader_state

        self.limit = limit
        self.code_words = list(code_words)
        self._storage = dict(storage or {})
        self._code_store = dict(code_store or {})
        self._calldata = dict(enumerate(calldata)) if isinstance(
            calldata, (list, tuple)) else dict(calldata or {})
        self.bootloader_heap_init = dict(bootloader_heap or {})
        self.default_aa_code_hash = default_aa_code_hash
        self.zkporter_available = zkporter_available

        boot = initial_bootloader_state()
        self.registers = [[0, False] for _ in range(15)]
        self.registers[0] = [boot["r1_value"], True]

        self.boot_code_hash = compute_boot_code_hash(self.code_words)
        self.initial_mem_rows = []
        hp = sp.BOOTLOADER_BASE_PAGE + 2
        for i, val in sorted(self.bootloader_heap_init.items()):
            self.initial_mem_rows.append(
                dict(timestamp=0, memory_page=hp, index=i, rw_flag=True,
                     is_ptr=False, value=int(val) & U256_MASK)
            )
        self.initial_dec_rows = [
            dict(code_hash=self.boot_code_hash, page=sp.BOOTLOADER_CODE_PAGE,
                 is_first=True, timestamp=1)
        ]
        self._ran = False

    def run(self) -> dict:
        lib = _get_vm_lib()
        N = self.limit
        R = N + 1
        caps = dict(MC=6 * N + len(self.initial_mem_rows) + 16,
                    LC=3 * N + 16, DC=N + 16, PC=N + 16, PM=16 * N + 1024)
        self._caps = caps

        p = EravmParams()
        p.limit = N
        p.n_code_words = len(self.code_words)
        p.zkporter_available = int(self.zkporter_available)
        for k, v in enumerate(_limbs4(self.default_aa_code_hash)):
            p.default_aa_code_hash[k] = v
        for k, v in enumerate(_limbs4(self.boot_code_hash)):
            p.boot_code_hash[k] = v
        for i, (val, ptr) in enumerate(self.registers):
            limbs = _limbs4(val)
            for k in range(4):
                p.initial_registers[i * 5 + k] = limbs[k]
            p.initial_registers[i * 5 + 4] = int(bool(ptr))
        p.mem_tape_cap = caps["MC"]
        p.log_tape_cap = caps["LC"]
        p.dec_tape_cap = caps["DC"]
        p.pc_calls_cap = caps["PC"]
        p.pm_cap = caps["PM"]

        keep = []  # keep numpy buffers alive through the call

        def hold(arr):
            keep.append(arr)
            return arr.ctypes.data_as(u64p)

        p.opcode_props = hold(_u64arr(isa.OPCODES_PROPS_INTEGER_BITMASKS))
        p.opcode_prices = hold(_u64arr(isa.OPCODES_PRICES))
        p.nop_encoding = isa.NOP_ENCODING
        p.panic_encoding = isa.PANIC_ENCODING
        p.code_words = hold(_u64arr([_limbs4(w) for w in self.code_words]))

        cd = sorted(self._calldata.items())
        p.n_calldata = len(cd)
        p.calldata_index = hold(_u64arr([i for i, _ in cd]))
        p.calldata_value = hold(_u64arr([_limbs4(v) for _, v in cd] or [0]))

        hi = sorted(self.bootloader_heap_init.items())
        p.n_heap_init = len(hi)
        p.heap_init_index = hold(_u64arr([i for i, _ in hi] or [0]))
        p.heap_init_value = hold(
            _u64arr([_limbs4(int(v) & U256_MASK) for _, v in hi] or [0]))

        st = sorted(self._storage.items())
        p.n_storage = len(st)
        p.storage_shard = hold(_u64arr([k[0] for k, _ in st] or [0]))
        p.storage_addr = hold(_u64arr([_limbs4(k[1]) for k, _ in st] or [0]))
        p.storage_key = hold(_u64arr([_limbs4(k[2]) for k, _ in st] or [0]))
        p.storage_value = hold(_u64arr([_limbs4(v) for _, v in st] or [0]))

        cs = sorted(self._code_store.items())
        p.n_code_store = len(cs)
        p.code_store_hash = hold(_u64arr([_limbs4(h) for h, _ in cs] or [0]))
        offs, lens, words = [], [], []
        off = 0
        for _, ws in cs:
            offs.append(off)
            lens.append(len(ws))
            off += len(ws)
            words.extend(_limbs4(w) for w in ws)
        p.code_store_off = hold(_u64arr(offs or [0]))
        p.code_store_len = hold(_u64arr(lens or [0]))
        p.code_store_words = hold(_u64arr(words or [0]))

        for name, value in [
            ("sp_bootloader_code_page", sp.BOOTLOADER_CODE_PAGE),
            ("sp_bootloader_calldata_page", sp.BOOTLOADER_CALLDATA_PAGE),
            ("sp_bootloader_base_page", sp.BOOTLOADER_BASE_PAGE),
            ("sp_starting_timestamp", sp.STARTING_TIMESTAMP),
            ("sp_vm_max_stack_depth", sp.VM_MAX_STACK_DEPTH),
            ("sp_starting_base_page", sp.STARTING_BASE_PAGE),
            ("sp_bootloader_formal_address", sp.BOOTLOADER_FORMAL_ADDRESS),
            ("sp_ecrecover_addr", sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS),
            ("sp_sha256_addr", sp.SHA256_PRECOMPILE_FORMAL_ADDRESS),
            ("sp_keccak_addr", sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS),
            ("sp_aux_storage", sp.STORAGE_AUX_BYTE),
            ("sp_aux_event", sp.EVENT_AUX_BYTE),
            ("sp_aux_l1", sp.L1_MESSAGE_AUX_BYTE),
            ("sp_aux_precompile", sp.PRECOMPILE_AUX_BYTE),
            ("sp_vm_initial_frame_ergs", sp.VM_INITIAL_FRAME_ERGS),
            ("sp_initial_frame_eh", sp.INITIAL_FRAME_FORMAL_EH_LOCATION),
            ("sp_bootloader_max_memory", sp.BOOTLOADER_MAX_MEMORY),
            ("sp_new_frame_memory_stipend", sp.NEW_FRAME_MEMORY_STIPEND),
            ("sp_new_pages_per_far_call", sp.NEW_MEMORY_PAGES_PER_FAR_CALL),
            ("sp_unmapped_page", sp.UNMAPPED_PAGE),
            ("sp_ergs_per_code_word", sp.ERGS_PER_CODE_WORD_DECOMMITTMENT),
            ("sp_deployer_address", sp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS),
            ("sp_initial_storage_write_pubdata_bytes",
             sp.INITIAL_STORAGE_WRITE_PUBDATA_BYTES),
            ("sp_l1_message_pubdata_bytes", sp.L1_MESSAGE_PUBDATA_BYTES),
            ("sp_fwd_mode_byte_idx", sp.FAR_CALL_FORWARDING_MODE_BYTE_IDX),
            ("sp_shard_id_byte_idx", sp.FAR_CALL_SHARD_ID_BYTE_IDX),
            ("sp_constructor_byte_idx", sp.FAR_CALL_CONSTRUCTOR_CALL_BYTE_IDX),
            ("sp_system_byte_idx", sp.FAR_CALL_SYSTEM_CALL_BYTE_IDX),
            ("sp_forward_use_heap", sp.FORWARD_PAGE_USE_HEAP),
            ("sp_forward_fat_ptr", sp.FORWARD_PAGE_FORWARD_FAT_POINTER),
            ("sp_forward_use_aux_heap", sp.FORWARD_PAGE_USE_AUX_HEAP),
            ("sp_code_hash_version_byte", sp.CODE_HASH_VERSION_BYTE),
            ("sp_code_at_rest_marker", sp.CODE_AT_REST_MARKER),
            ("sp_yet_constructed_marker", sp.YET_CONSTRUCTED_MARKER),
            ("sp_call_system_abi_reg_mask",
             sum(1 << i for i in sp.CALL_SYSTEM_ABI_REGISTERS)),
            ("sp_call_reserved_reg_mask",
             sum(1 << i for i in sp.CALL_RESERVED_RANGE)),
            ("sp_call_implicit_reg_idx", sp.CALL_IMPLICIT_PARAMETER_REG_IDX),
        ]:
            setattr(p, name, int(value))

        out = EravmOut()
        bufs = {}
        rows = dict(R=R, N=N, **caps)
        for name, kind, width, nrows in _OUT_FIELDS:
            n = rows[nrows] if isinstance(nrows, str) else nrows
            dtype, ptr_t = _KIND[kind]
            arr = np.zeros(n * width, dtype=dtype)
            bufs[name] = (arr, width)
            setattr(out, name, arr.ctypes.data_as(ptr_t))

        rc = lib.eravm_run(ctypes.byref(p), ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"eravm_run failed rc={rc} "
                               f"(2 = tape capacity exceeded)")
        self._bufs = bufs
        self._ran = True

        def arr(name, rows_key=None, extra_shape=None, dtype=None):
            a, width = bufs[name]
            n = rows[rows_key] if rows_key else a.shape[0] // width
            v = a[: n * width]
            if width > 1:
                v = v.reshape(n, *(extra_shape or (width,)))
            if dtype is not None:
                v = v.astype(dtype)
            return v

        w = {}
        w["regs"] = arr("regs", "R", (15, 8))
        w["regs_ptr"] = arr("regs_ptr", "R", (15,), bool)
        for k in ("f_of", "f_eq", "f_gt", "pending_exc"):
            w[k] = arr(k, "R", None, bool)
        for k in ("ts", "page_counter", "tx_number", "prev_code_page",
                  "prev_super_pc", "ergs_pp", "cs_depth", "mem_q_len",
                  "dec_q_len", "log_fwd_len", "ctx_code_page", "ctx_base_page",
                  "ctx_heap_bound", "ctx_aux_heap_bound", "ctx_pc", "ctx_sp",
                  "ctx_eh", "ctx_ergs", "ctx_shard_this", "ctx_shard_caller",
                  "ctx_shard_code", "ctx_rq_len"):
            w[k] = arr(k, "R")
        w["prev_code_word"] = arr("prev_code_word", "R")
        w["ctx_u128"] = arr("ctx_u128", "R")
        w["mem_q_state"] = arr("mem_q_state", "R")
        w["dec_q_state"] = arr("dec_q_state", "R")
        w["log_fwd_tail"] = arr("log_fwd_tail", "R")
        w["ctx_this"] = arr("ctx_this", "R")
        w["ctx_caller"] = arr("ctx_caller", "R")
        w["ctx_code_address"] = arr("ctx_code_address", "R")
        for k in ("ctx_is_static", "ctx_is_kernel", "ctx_is_local"):
            w[k] = arr(k, "R", None, bool)
        w["ctx_ctx_u128"] = arr("ctx_ctx_u128", "R")
        w["ctx_rq_head"] = arr("ctx_rq_head", "R")
        w["ctx_rq_tail"] = arr("ctx_rq_tail", "R")
        w["cs_sponge"] = arr("cs_sponge", "R")

        for k in ("code_word_read", "src0_mem_val", "uma_a_val", "uma_b_val",
                  "storage_read_val", "fam_res0", "fam_res1", "src0_val",
                  "src1_val"):
            w[k] = arr(k, "N")
        for k in ("should_read_opcode", "src0_mem_is_ptr", "src0_is_ptr",
                  "src1_is_ptr", "src0_did_read", "dst0_did_write"):
            w[k] = arr(k, "N", None, bool)
        for k in ("pubdata_refund", "dec_suggested_page", "raw_opcode_lo",
                  "raw_opcode_hi", "dst0_page", "dst0_index"):
            w[k] = arr(k, "N")
        w["zkporter_available"] = np.asarray(self.zkporter_available)
        w["default_aa_code_hash"] = np.asarray(
            [(self.default_aa_code_hash >> (32 * k)) & U32 for k in range(8)],
            np.uint32,
        )
        w["rb_prev_head"] = arr("rb_prev_head", "N")
        w["call_rb_tail"] = arr("call_rb_tail", "N")
        for k, _, width, _ in _OUT_FIELDS:
            if k.startswith("ret_popped_"):
                if k in ("ret_popped_is_static", "ret_popped_is_kernel",
                         "ret_popped_is_local"):
                    w[k] = arr(k, "N", None, bool)
                else:
                    w[k] = arr(k, "N")
        w["ret_prev_cs_sponge"] = arr("ret_prev_cs_sponge", "N")
        w["block_rollback_tail"] = bufs["block_rollback_tail"][0].copy()
        self.block_rollback_tail = w["block_rollback_tail"]
        return w

    # ---- tape attributes (dicts built on demand) ----

    def _len(self, name) -> int:
        return int(self._bufs[name][0][0])

    @property
    def memory_tape(self):
        n = self._len("mem_tape_len")
        b = self._bufs
        vals = b["mt_value"][0].reshape(-1, 8)
        return [
            dict(
                timestamp=int(b["mt_ts"][0][i]),
                memory_page=int(b["mt_page"][0][i]),
                index=int(b["mt_index"][0][i]),
                rw_flag=bool(b["mt_rw"][0][i]),
                is_ptr=bool(b["mt_is_ptr"][0][i]),
                value=_u256_from_limbs8(vals[i]),
            )
            for i in range(n)
        ]

    def _log_row(self, i: int) -> dict:
        b = self._bufs
        addr = b["lt_address"][0].reshape(-1, 5)
        key = b["lt_key"][0].reshape(-1, 8)
        rv = b["lt_read_value"][0].reshape(-1, 8)
        wv = b["lt_written_value"][0].reshape(-1, 8)
        return dict(
            address=_u256_from_limbs8(addr[i]),
            key=_u256_from_limbs8(key[i]),
            read_value=_u256_from_limbs8(rv[i]),
            written_value=_u256_from_limbs8(wv[i]),
            rw_flag=bool(b["lt_rw_flag"][0][i]),
            aux_byte=int(b["lt_aux_byte"][0][i]),
            rollback=bool(b["lt_rollback"][0][i]),
            is_service=bool(b["lt_is_service"][0][i]),
            shard_id=int(b["lt_shard_id"][0][i]),
            tx_number_in_block=int(b["lt_tx_number"][0][i]),
            timestamp=int(b["lt_timestamp"][0][i]),
        )

    @property
    def log_tape(self):
        return [self._log_row(i) for i in range(self._len("log_tape_len"))]

    @property
    def decommit_tape(self):
        n = self._len("dec_tape_len")
        b = self._bufs
        ch = b["dt_code_hash"][0].reshape(-1, 8)
        return [
            dict(
                code_hash=_u256_from_limbs8(ch[i]),
                page=int(b["dt_page"][0][i]),
                is_first=bool(b["dt_is_first"][0][i]),
                timestamp=int(b["dt_timestamp"][0][i]),
            )
            for i in range(n)
        ]

    @property
    def precompile_calls(self):
        n = self._len("pc_calls_len")
        b = self._bufs
        fams = {0: "keccak", 1: "sha256", 2: "ecrecover"}
        out = {"keccak": [], "sha256": [], "ecrecover": []}
        for i in range(n):
            row = self._log_row(int(b["pc_log_index"][0][i]))
            row.pop("rollback", None)
            out[fams[int(b["pc_family"][0][i])]].append(row)
        return out

    @property
    def precompile_memory(self):
        n = self._len("pm_len")
        b = self._bufs
        vals = b["pm_value"][0].reshape(-1, 32)
        return {
            (int(b["pm_page"][0][i]), int(b["pm_word"][0][i])):
                bytes(vals[i].tobytes())
            for i in range(n)
        }
