"""zkEVM (EraVM) ISA v1 — the zkevm_opcode_defs data surface, reconstructed.

The torch port's own copy of the JAX package's `isa/opcodes.py` (numpy
only); tests/test_torch_copies.py holds the two equal by value.

The reference consumes `OPCODES_TABLE` / `OPCODES_PROPS_INTEGER_BITMASKS` /
`OPCODES_PRICES` and the instruction-word layout from the external
zkevm_opcode_defs crate (layer 1, SURVEY.md §2.3).  That crate is not
vendored and this environment has zero egress, so this module RECONSTRUCTS
the full data surface from what the reference pins structurally:

  * 16 opcode types, max 10 sub-variants, 2 flag bits, 6 input addressing
    modes, 4 output addressing modes -> 38 meaningful description bits
    (`src/main_vm/opcode_bitmask.rs:24-29`: OPCODE_VARIANT_BITS=10,
    OPCODE_FLAGS_BITS=2, TOTAL_OPCODE_MEANINGFULL_DESCRIPTION_BITS=38,
    flattened to 48, + TOTAL_AUX_BITS=3 exception-handling bits);
  * a 2^11-entry decode table (OPCODES_TABLE_WIDTH=11,
    `src/main_vm/decoded_opcode.rs:239-247`) mapping variant index ->
    (ergs price u32, 51-bit properties bitspread), consumed via
    VMOpcodeDecodingTable (`src/tables/opcodes_decoding.rs:14-38`);
  * the 64-bit instruction word split (`decoded_opcode.rs:395-527`):
    bits [0..11) variant, [11..13) unused, [13..16) condition,
    [16..24) src0|src1 nibbles, [24..32) dst0|dst1 nibbles,
    [32..48) imm0, [48..64) imm1;
  * 8 branch conditions resolved against (of, eq, gt) flags
    (`src/tables/conditional.rs:27-46`).

The opcode/variant/mode/flag orderings and the table-synthesis nesting
below follow the public zkevm_opcode_defs v1.3.2 enum declarations to the
best of available knowledge; where upstream sources become available the
swap is pure data (the golden test pins the current instance so any change
fails loudly).  Everything downstream treats this module as data.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# structural constants (pinned by the reference)
# --------------------------------------------------------------------------

OPCODES_TABLE_WIDTH = 11  # 2^11-entry decode table
VARIANT_AND_CONDITION_ENCODING_BITS = 16
CONDITION_ENCODING_BITS = 3
UNUSED_GAP = 2  # VARIANT_AND_CONDITION - TABLE_WIDTH - CONDITION = 2
CONDITIONAL_BITS_SHIFT = OPCODES_TABLE_WIDTH + UNUSED_GAP  # 13

OPCODE_TYPE_BITS = 16
OPCODE_VARIANT_BITS = 10
OPCODE_FLAGS_BITS = 2
OPCODE_INPUT_VARIANT_FLAGS = 6
OPCODE_OUTPUT_VARIANT_FLAGS = 4
TOTAL_OPCODE_MEANINGFULL_DESCRIPTION_BITS = (
    OPCODE_TYPE_BITS + OPCODE_VARIANT_BITS + OPCODE_FLAGS_BITS
    + OPCODE_INPUT_VARIANT_FLAGS + OPCODE_OUTPUT_VARIANT_FLAGS
)  # 38
TOTAL_OPCODE_DESCRIPTION_BITS_FLATTENED = 48
TOTAL_AUX_BITS = 3
TOTAL_OPCODE_DESCRIPTION_AND_AUX_BITS = 51

REGISTER_ENCODING_BITS = 4

# bitspread section offsets (OpcodeBitmask::from_full_mask order,
# opcode_bitmask.rs:94-120; aux bits above the flattened 48,
# decoded_opcode.rs:313-387)
TYPE_BITS_OFFSET = 0
VARIANT_BITS_OFFSET = OPCODE_TYPE_BITS  # 16
FLAG_BITS_OFFSET = VARIANT_BITS_OFFSET + OPCODE_VARIANT_BITS  # 26
INPUT_BITS_OFFSET = FLAG_BITS_OFFSET + OPCODE_FLAGS_BITS  # 28
OUTPUT_BITS_OFFSET = INPUT_BITS_OFFSET + OPCODE_INPUT_VARIANT_FLAGS  # 34
AUX_BITS_OFFSET = TOTAL_OPCODE_DESCRIPTION_BITS_FLATTENED  # 48

# aux (exception-handling) bit indices (decoded_opcode.rs:81-84)
KERNEL_MODE_FLAG_IDX = 0
CAN_BE_USED_IN_STATIC_CONTEXT_FLAG_IDX = 1
EXPLICIT_PANIC_FLAG_IDX = 2

# --------------------------------------------------------------------------
# opcode types (enum order = zkevm_opcode_defs Opcode declaration order)
# --------------------------------------------------------------------------

INVALID = 0
NOP = 1
ADD = 2
SUB = 3
MUL = 4
DIV = 5
JUMP = 6
CONTEXT = 7
SHIFT = 8
BINOP = 9
PTR = 10
NEAR_CALL = 11
LOG = 12
FAR_CALL = 13
RET = 14
UMA = 15

TYPE_NAMES = [
    "invalid", "nop", "add", "sub", "mul", "div", "jump", "context",
    "shift", "binop", "ptr", "near_call", "log", "far_call", "ret", "uma",
]

# sub-variants (materialize_subvariant_idx order within each opcode type)
CTX_THIS = 0
CTX_CALLER = 1
CTX_CODE_ADDRESS = 2
CTX_META = 3
CTX_ERGS_LEFT = 4
CTX_SP = 5
CTX_GET_CONTEXT_U128 = 6
CTX_SET_CONTEXT_U128 = 7
CTX_SET_ERGS_PER_PUBDATA = 8
CTX_INCREMENT_TX_NUMBER = 9

SHIFT_SHL = 0
SHIFT_SHR = 1
SHIFT_ROL = 2
SHIFT_ROR = 3

BINOP_AND = 0
BINOP_OR = 1
BINOP_XOR = 2

PTR_ADD = 0
PTR_SUB = 1
PTR_PACK = 2
PTR_SHRINK = 3

LOG_STORAGE_READ = 0
LOG_STORAGE_WRITE = 1
LOG_EVENT = 2
LOG_TO_L1_MESSAGE = 3
LOG_PRECOMPILE_CALL = 4

FAR_CALL_NORMAL = 0
FAR_CALL_DELEGATE = 1
FAR_CALL_MIMIC = 2

RET_OK = 0
RET_REVERT = 1
RET_PANIC = 2

UMA_HEAP_READ = 0
UMA_HEAP_WRITE = 1
UMA_AUX_HEAP_READ = 2
UMA_AUX_HEAP_WRITE = 3
UMA_FAT_PTR_READ = 4

VARIANT_COUNTS = {
    INVALID: 1, NOP: 1, ADD: 1, SUB: 1, MUL: 1, DIV: 1, JUMP: 1,
    CONTEXT: 10, SHIFT: 4, BINOP: 3, PTR: 4, NEAR_CALL: 1, LOG: 5,
    FAR_CALL: 3, RET: 3, UMA: 5,
}

# --------------------------------------------------------------------------
# addressing modes (ImmMemHandlerFlags variant order)
# --------------------------------------------------------------------------

SRC_REG = 0  # UseRegOnly
SRC_STACK_PUSH_POP = 1  # UseStackWithPushPop (pop for src)
SRC_STACK_OFFSET = 2  # UseStackWithOffset (sp - (reg + imm))
SRC_STACK_ABSOLUTE = 3  # UseAbsoluteOnStack
SRC_IMM = 4  # UseImm16Only
SRC_CODE = 5  # UseCodePage

# dst modes reuse the first four input variants (is_allowed_for_dst)
DST_REG = 0
DST_STACK_PUSH_POP = 1  # push for dst
DST_STACK_OFFSET = 2
DST_STACK_ABSOLUTE = 3

# --------------------------------------------------------------------------
# per-opcode flag bits
# --------------------------------------------------------------------------

SET_FLAGS_FLAG_IDX = 0
SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES = 1
SWAP_OPERANDS_FLAG_IDX_FOR_PTR_OPCODE = 1
UMA_INCREMENT_FLAG_IDX = 0
FAR_CALL_STATIC_FLAG_IDX = 0
FAR_CALL_SHARD_FLAG_IDX = 1
FIRST_MESSAGE_FLAG_IDX = 0
RET_TO_LABEL_BIT_IDX = 0

# flag indices each (type, variant) may set; the table enumerates all
# combinations of exactly these
def _used_flags(op_type: int, variant: int) -> list:
    if op_type in (ADD, MUL):
        return [SET_FLAGS_FLAG_IDX]
    if op_type in (SUB, DIV, SHIFT):
        return [SET_FLAGS_FLAG_IDX, SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES]
    if op_type == BINOP:
        return [SET_FLAGS_FLAG_IDX]
    if op_type == PTR:
        return [SWAP_OPERANDS_FLAG_IDX_FOR_PTR_OPCODE]
    if op_type == UMA:
        return [UMA_INCREMENT_FLAG_IDX]
    if op_type == FAR_CALL:
        return [FAR_CALL_STATIC_FLAG_IDX, FAR_CALL_SHARD_FLAG_IDX]
    if op_type == RET:
        return [RET_TO_LABEL_BIT_IDX]
    if op_type == LOG and variant in (LOG_EVENT, LOG_TO_L1_MESSAGE):
        return [FIRST_MESSAGE_FLAG_IDX]
    return []


# full src0 addressing (all 6 input modes) vs register-only; the reference's
# "special rule for NOP" (utils.rs:281-287) implies NOP formally addresses
# memory, so it enumerates all modes too
_FULL_SRC_ADDRESSING = {NOP, ADD, SUB, MUL, DIV, JUMP, SHIFT, BINOP, PTR}
# dst0-to-memory capability (can_write_dst0_into_memory); asserted false in
# the reference for uma/log/call/ret (uma.rs:974, log.rs:458, call_ret.rs:423-425)
_FULL_DST_ADDRESSING = {NOP, ADD, SUB, MUL, DIV, SHIFT, BINOP, PTR}
# opcodes with no dst0 at all still get a single UseRegOnly output variant

# kernel-only (type, variant) pairs
_KERNEL_ONLY = {
    (CONTEXT, CTX_SET_CONTEXT_U128),
    (CONTEXT, CTX_SET_ERGS_PER_PUBDATA),
    (CONTEXT, CTX_INCREMENT_TX_NUMBER),
    (FAR_CALL, FAR_CALL_MIMIC),
    (LOG, LOG_EVENT),
    (LOG, LOG_TO_L1_MESSAGE),
    (LOG, LOG_PRECOMPILE_CALL),
}
# forbidden in static context (writes state)
_NOT_IN_STATIC = {
    (LOG, LOG_STORAGE_WRITE),
    (LOG, LOG_EVENT),
    (LOG, LOG_TO_L1_MESSAGE),
    (LOG, LOG_PRECOMPILE_CALL),
    (CONTEXT, CTX_SET_CONTEXT_U128),
    (CONTEXT, CTX_SET_ERGS_PER_PUBDATA),
    (CONTEXT, CTX_INCREMENT_TX_NUMBER),
}

# --------------------------------------------------------------------------
# ergs prices (circuit_prices.rs role; named constants, values best-effort)
# --------------------------------------------------------------------------

VM_CYCLE_COST_IN_ERGS = 4
RAM_PERMUTATION_COST_IN_ERGS = 1
LOG_DEMUXER_COST_IN_ERGS = 1
STORAGE_SORTER_COST_IN_ERGS = 2
EVENTS_OR_L1_MESSAGES_SORTER_COST_IN_ERGS = 1
CODE_DECOMMITTER_SORTER_COST_IN_ERGS = 1
CODE_DECOMMITMENT_COST_PER_WORD_IN_ERGS = 4

AVERAGE_OPCODE_ERGS = VM_CYCLE_COST_IN_ERGS + RAM_PERMUTATION_COST_IN_ERGS  # 5
RICH_ADDRESSING_OPCODE_ERGS = (
    VM_CYCLE_COST_IN_ERGS + 2 * RAM_PERMUTATION_COST_IN_ERGS
)  # 6

STORAGE_READ_IO_PRICE = 150
STORAGE_WRITE_IO_PRICE = 250
EVENT_IO_PRICE = 25
L1_MESSAGE_IO_PRICE = 100
CALL_LIKE_ERGS_COST = 20
UMA_EXTRA_RAM_QUERIES = 4  # up to 2 reads + 2 writes beyond the base cycle


def _price(op_type: int, variant: int, src_mode: int, dst_mode: int) -> int:
    rich = (src_mode not in (SRC_REG, SRC_IMM)) or (dst_mode != DST_REG)
    base = RICH_ADDRESSING_OPCODE_ERGS if rich else AVERAGE_OPCODE_ERGS
    if op_type == LOG:
        step = VM_CYCLE_COST_IN_ERGS + RAM_PERMUTATION_COST_IN_ERGS
        if variant == LOG_STORAGE_READ:
            return (STORAGE_READ_IO_PRICE + step
                    + LOG_DEMUXER_COST_IN_ERGS + STORAGE_SORTER_COST_IN_ERGS)
        if variant == LOG_STORAGE_WRITE:
            return (STORAGE_WRITE_IO_PRICE + step
                    + 2 * (LOG_DEMUXER_COST_IN_ERGS + STORAGE_SORTER_COST_IN_ERGS))
        if variant == LOG_EVENT:
            return (EVENT_IO_PRICE + step
                    + 2 * (LOG_DEMUXER_COST_IN_ERGS
                           + EVENTS_OR_L1_MESSAGES_SORTER_COST_IN_ERGS))
        if variant == LOG_TO_L1_MESSAGE:
            return (L1_MESSAGE_IO_PRICE + step
                    + 2 * (LOG_DEMUXER_COST_IN_ERGS
                           + EVENTS_OR_L1_MESSAGES_SORTER_COST_IN_ERGS))
        return step + LOG_DEMUXER_COST_IN_ERGS  # precompile call
    if op_type == NEAR_CALL:
        return AVERAGE_OPCODE_ERGS + CALL_LIKE_ERGS_COST
    if op_type == FAR_CALL:
        return (2 * VM_CYCLE_COST_IN_ERGS + RAM_PERMUTATION_COST_IN_ERGS
                + STORAGE_READ_IO_PRICE + CALL_LIKE_ERGS_COST
                + CODE_DECOMMITTER_SORTER_COST_IN_ERGS)
    if op_type == UMA:
        return (VM_CYCLE_COST_IN_ERGS
                + (1 + UMA_EXTRA_RAM_QUERIES) * RAM_PERMUTATION_COST_IN_ERGS)
    if op_type == INVALID:
        return AVERAGE_OPCODE_ERGS
    return base


# --------------------------------------------------------------------------
# table synthesis (OPCODES_TABLE / PROPS / PRICES)
# --------------------------------------------------------------------------


class OpcodeVariant:
    """One decode-table row: (type, variant, src0 mode, dst0 mode, flags)."""

    __slots__ = ("op_type", "variant", "src_mode", "dst_mode", "flags")

    def __init__(self, op_type, variant, src_mode, dst_mode, flags):
        self.op_type = op_type
        self.variant = variant
        self.src_mode = src_mode
        self.dst_mode = dst_mode
        self.flags = flags

    def key(self):
        return (self.op_type, self.variant, self.src_mode, self.dst_mode, self.flags)

    def __repr__(self):
        return (f"OpcodeVariant({TYPE_NAMES[self.op_type]}.{self.variant}"
                f" src={self.src_mode} dst={self.dst_mode} fl={self.flags:02b})")


def _bitspread(v: OpcodeVariant) -> int:
    spread = 1 << (TYPE_BITS_OFFSET + v.op_type)
    spread |= 1 << (VARIANT_BITS_OFFSET + v.variant)
    spread |= (v.flags & 0b11) << FLAG_BITS_OFFSET
    spread |= 1 << (INPUT_BITS_OFFSET + v.src_mode)
    spread |= 1 << (OUTPUT_BITS_OFFSET + v.dst_mode)
    if (v.op_type, v.variant) in _KERNEL_ONLY:
        spread |= 1 << (AUX_BITS_OFFSET + KERNEL_MODE_FLAG_IDX)
    if (v.op_type, v.variant) not in _NOT_IN_STATIC:
        spread |= 1 << (AUX_BITS_OFFSET + CAN_BE_USED_IN_STATIC_CONTEXT_FLAG_IDX)
    if v.op_type == INVALID:
        spread |= 1 << (AUX_BITS_OFFSET + EXPLICIT_PANIC_FLAG_IDX)
    return spread


def _synthesize():
    """Canonical enumeration: type -> variant -> src mode -> dst mode ->
    flag combos; remaining rows padded with Invalid (explicit panic)."""
    table = []
    for op_type in range(OPCODE_TYPE_BITS):
        for variant in range(VARIANT_COUNTS[op_type]):
            src_modes = (
                range(OPCODE_INPUT_VARIANT_FLAGS)
                if op_type in _FULL_SRC_ADDRESSING else (SRC_REG,)
            )
            for src_mode in src_modes:
                dst_modes = (
                    range(OPCODE_OUTPUT_VARIANT_FLAGS)
                    if op_type in _FULL_DST_ADDRESSING else (DST_REG,)
                )
                for dst_mode in dst_modes:
                    used = _used_flags(op_type, variant)
                    for combo in range(1 << len(used)):
                        flags = 0
                        for bit, idx in enumerate(used):
                            if (combo >> bit) & 1:
                                flags |= 1 << idx
                        table.append(
                            OpcodeVariant(op_type, variant, src_mode, dst_mode, flags)
                        )
    assert len(table) <= (1 << OPCODES_TABLE_WIDTH), len(table)
    pad = OpcodeVariant(INVALID, 0, SRC_REG, DST_REG, 0)
    while len(table) < (1 << OPCODES_TABLE_WIDTH):
        table.append(pad)
    inverse = {}
    for i, v in enumerate(table):
        inverse.setdefault(v.key(), i)
    props = np.asarray([_bitspread(v) for v in table], dtype=np.uint64)
    prices = np.asarray(
        [_price(v.op_type, v.variant, v.src_mode, v.dst_mode) for v in table],
        dtype=np.uint32,
    )
    return table, inverse, props, prices


OPCODES_TABLE, OPCODES_TABLE_INVERSE, OPCODES_PROPS_INTEGER_BITMASKS, OPCODES_PRICES = (
    _synthesize()
)


def variant_index(op_type, variant=0, src_mode=SRC_REG, dst_mode=DST_REG, flags=0) -> int:
    return OPCODES_TABLE_INVERSE[(op_type, variant, src_mode, dst_mode, flags)]


# --------------------------------------------------------------------------
# conditions (Condition enum order; resolution per tables/conditional.rs)
# --------------------------------------------------------------------------

COND_ALWAYS = 0
COND_GT = 1
COND_LT = 2
COND_EQ = 3
COND_GE = 4
COND_LE = 5
COND_NE = 6
COND_GT_OR_LT = 7


def condition_resolves(cond: int, of: bool, eq: bool, gt: bool) -> bool:
    return {
        COND_ALWAYS: True,
        COND_GT: gt,
        COND_LT: of,
        COND_EQ: eq,
        COND_GE: gt or eq,
        COND_LE: of or eq,
        COND_NE: not eq,
        COND_GT_OR_LT: gt or of,
    }[cond]


# --------------------------------------------------------------------------
# 64-bit instruction word encode/decode (decoded_opcode.rs:395-527)
# --------------------------------------------------------------------------


def encode_instruction(
    op_type, variant=0, src_mode=SRC_REG, dst_mode=DST_REG, flags=0,
    condition=COND_ALWAYS, src0=0, src1=0, dst0=0, dst1=0, imm0=0, imm1=0,
) -> int:
    """Assemble one instruction word.  Register index 0 is the constant-zero
    r0; 1..15 address the register file."""
    vi = variant_index(op_type, variant, src_mode, dst_mode, flags)
    word = vi
    word |= (condition & 0b111) << CONDITIONAL_BITS_SHIFT
    word |= (src0 & 0xF) << 16
    word |= (src1 & 0xF) << 20
    word |= (dst0 & 0xF) << 24
    word |= (dst1 & 0xF) << 28
    word |= (imm0 & 0xFFFF) << 32
    word |= (imm1 & 0xFFFF) << 48
    return word


def decode_instruction(word: int) -> dict:
    vi = word & ((1 << OPCODES_TABLE_WIDTH) - 1)
    v = OPCODES_TABLE[vi]
    return dict(
        variant_index=vi,
        op_type=v.op_type,
        variant=v.variant,
        src_mode=v.src_mode,
        dst_mode=v.dst_mode,
        flags=v.flags,
        condition=(word >> CONDITIONAL_BITS_SHIFT) & 0b111,
        src0=(word >> 16) & 0xF,
        src1=(word >> 20) & 0xF,
        dst0=(word >> 24) & 0xF,
        dst1=(word >> 28) & 0xF,
        imm0=(word >> 32) & 0xFFFF,
        imm1=(word >> 48) & 0xFFFF,
        price=int(OPCODES_PRICES[vi]),
        props=int(OPCODES_PROPS_INTEGER_BITMASKS[vi]),
    )


# canonical NOP / PANIC encodings (utils.rs:14-42 mask_into_nop/panic)
NOP_ENCODING = encode_instruction(NOP)
PANIC_ENCODING = encode_instruction(RET, RET_PANIC)
_MASK48 = (1 << TOTAL_OPCODE_DESCRIPTION_BITS_FLATTENED) - 1
NOP_BITSPREAD = int(OPCODES_PROPS_INTEGER_BITMASKS[variant_index(NOP)]) & _MASK48
PANIC_BITSPREAD = (
    int(OPCODES_PROPS_INTEGER_BITMASKS[variant_index(RET, RET_PANIC)]) & _MASK48
)


def spread_props(props: int) -> dict:
    """Split a 51-bit properties bitspread into its boolean sections."""
    return dict(
        op_type_bits=[(props >> (TYPE_BITS_OFFSET + i)) & 1 for i in range(OPCODE_TYPE_BITS)],
        variant_bits=[(props >> (VARIANT_BITS_OFFSET + i)) & 1 for i in range(OPCODE_VARIANT_BITS)],
        flag_bits=[(props >> (FLAG_BITS_OFFSET + i)) & 1 for i in range(OPCODE_FLAGS_BITS)],
        input_bits=[(props >> (INPUT_BITS_OFFSET + i)) & 1 for i in range(OPCODE_INPUT_VARIANT_FLAGS)],
        output_bits=[(props >> (OUTPUT_BITS_OFFSET + i)) & 1 for i in range(OPCODE_OUTPUT_VARIANT_FLAGS)],
        kernel_only=(props >> (AUX_BITS_OFFSET + KERNEL_MODE_FLAG_IDX)) & 1,
        static_ok=(props >> (AUX_BITS_OFFSET + CAN_BE_USED_IN_STATIC_CONTEXT_FLAG_IDX)) & 1,
        explicit_panic=(props >> (AUX_BITS_OFFSET + EXPLICIT_PANIC_FLAG_IDX)) & 1,
    )
