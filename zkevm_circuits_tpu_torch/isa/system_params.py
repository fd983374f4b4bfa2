"""System parameters of the zkEVM ISA (port of the zkevm_opcode_defs surface).

The torch port's own copy of the JAX package's `isa/system_params.py`;
tests/test_torch_copies.py holds the two equal by value.

The reference consumes these from the external `zkevm_opcode_defs` crate
(SURVEY.md §2.3, layer 1) — e.g. `BOOTLOADER_HEAP_PAGE` in
`src/ram_permutation/mod.rs:26,243`, `BOOTLOADER_CODE_PAGE` /
`BOOTLOADER_CALLDATA_PAGE` / `STARTING_TIMESTAMP` in
`src/main_vm/loading.rs:32,192,201`.

That crate is not vendored in this environment (zero egress), so values below
are pinned from the public Era protocol definitions; anything not
independently verifiable here is marked PROVISIONAL and treated as pure data
by every kernel (a corrected value changes witnesses, never code).
"""

# --- memory pages -----------------------------------------------------------
BOOTLOADER_CODE_PAGE = 8
BOOTLOADER_CALLDATA_PAGE = 3  # PROVISIONAL
BOOTLOADER_BASE_PAGE = 8
BOOTLOADER_HEAP_PAGE = 10  # PROVISIONAL: heap page derived from base page
BOOTLOADER_AUX_HEAP_PAGE = 11  # PROVISIONAL

# --- timestamps / limits ----------------------------------------------------
STARTING_TIMESTAMP = 8  # PROVISIONAL
TIMESTAMPS_PER_CYCLE = 4  # PROVISIONAL
VM_MAX_STACK_DEPTH = 1024  # PROVISIONAL
# first free page for far-call frames; must be beyond every bootloader page
# (loading.rs:193-194 inits memory_page_counter with it)
STARTING_BASE_PAGE = 16  # PROVISIONAL

# --- formal addresses -------------------------------------------------------
BOOTLOADER_FORMAL_ADDRESS = 0x8001
ECRECOVER_PRECOMPILE_FORMAL_ADDRESS = 0x0001
SHA256_PRECOMPILE_FORMAL_ADDRESS = 0x0002
KECCAK256_PRECOMPILE_FORMAL_ADDRESS = 0x8010

# --- log/query aux bytes (demux discriminators) -----------------------------
STORAGE_AUX_BYTE = 0
EVENT_AUX_BYTE = 1
L1_MESSAGE_AUX_BYTE = 2
PRECOMPILE_AUX_BYTE = 3

# --- misc -------------------------------------------------------------------
REGISTERS_COUNT = 15  # ref src/base_structures/vm_state/mod.rs:30
L2_TO_L1_MESSAGE_BYTE_LENGTH = 88  # ref src/base_structures/log_query/mod.rs
NUM_PROCESSABLE_SHARDS = 1  # ref src/scheduler/mod.rs:386

# --- full-VM frame/boot parameters (ref src/main_vm/loading.rs:29-226,
# opcodes/call_ret_impl/far_call.rs; zkevm_opcode_defs system_params role).
# All PROVISIONAL unless derivable from the reference structurally.
VM_INITIAL_FRAME_ERGS = 0xFFFFFFFF  # PROVISIONAL: bootloader frame gets max ergs
INITIAL_FRAME_FORMAL_EH_LOCATION = 0xFFFF  # PROVISIONAL: u16::MAX sentinel
BOOTLOADER_MAX_MEMORY = 0xFFFFFFFF  # PROVISIONAL: bootloader pays no resize
NEW_FRAME_MEMORY_STIPEND = 1024  # PROVISIONAL: fresh far-call heap stipend bytes
NEW_MEMORY_PAGES_PER_FAR_CALL = 8  # PROVISIONAL: base/stack/heap/aux + slack
UNMAPPED_PAGE = 0  # failed decommit target page (far_call.rs:1593)
ERGS_PER_CODE_WORD_DECOMMITTMENT = 4  # matches CODE_DECOMMITMENT_COST_PER_WORD
DEPLOYER_SYSTEM_CONTRACT_ADDRESS = 0x8006  # code-hash storage owner
MAX_OFFSET_TO_DEREF_LOW_U32 = 0xFFFFFFFF - 32  # uma non-addressable bound

# pubdata pricing (ref opcodes/log.rs:130-148)
INITIAL_STORAGE_WRITE_PUBDATA_BYTES = 64  # PROVISIONAL
L1_MESSAGE_PUBDATA_BYTES = 1 + 1 + 2 + 20 + 32 + 32  # PROVISIONAL (88-byte record)

# far-call ABI layout inside src0 (ref far_call.rs:66-94 + call_ret_impl/mod.rs)
# u32 limb 6 = ergs_passed; top 4 bytes (LE byte indices of the 32-byte view):
FAR_CALL_FORWARDING_MODE_BYTE_IDX = 28  # PROVISIONAL
FAR_CALL_SHARD_ID_BYTE_IDX = 29  # PROVISIONAL
FAR_CALL_CONSTRUCTOR_CALL_BYTE_IDX = 30  # PROVISIONAL
FAR_CALL_SYSTEM_CALL_BYTE_IDX = 31  # PROVISIONAL

# FarCallForwardPageType enum (call_ret_impl/mod.rs:50-66)
FORWARD_PAGE_USE_HEAP = 0
FORWARD_PAGE_FORWARD_FAT_POINTER = 1
FORWARD_PAGE_USE_AUX_HEAP = 2

# register conventions on far call (0-based indices over r1..r15;
# ref far_call.rs:1050-1071). PROVISIONAL split.
CALL_SYSTEM_ABI_REGISTERS = tuple(range(1, 11))  # r2..r11 carry system ABI
CALL_RESERVED_RANGE = (11, 12, 13)  # r12..r14 reserved
CALL_IMPLICIT_PARAMETER_REG_IDX = 14  # r15 carries mimic caller

# versioned code hash markers (ContractCodeSha256, far_call.rs:504-553)
CODE_HASH_VERSION_BYTE = 1
CODE_AT_REST_MARKER = 0
YET_CONSTRUCTED_MARKER = 1
