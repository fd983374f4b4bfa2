"""VM lookup tables and the evaluation-side lookup check (the JAX package's
`tables/__init__.py`).

Reference parity: `src/tables/` — the 7 VM lookup tables:

  * BitshiftTable (`bitshift.rs:12-40`): 1024 rows, (shift + limb_pair<<8)
    -> two 32-bit limbs of 2^shift.
  * VMConditionalResolutionTable (`conditional.rs:16-58`): 64 rows,
    (condition, packed flags) -> resolution; flags packed of|eq<<1|gt<<2.
  * RegisterIndexToBitmaskTable / UMAShiftToBitmaskTable /
    VMSubPCToBitmaskTable (`integer_to_boolean_mask.rs:5-43`): integer ->
    one-hot (0 -> 0, else 1 << (i-1)).
  * VMOpcodeDecodingTable (`opcodes_decoding.rs`): opcode -> (price, props)
    — data lives in isa/opcodes.py.
  * UMAPtrReadCleanupTable (`uma_ptr_read_cleanup.rs:11-40`): unalignment ->
    32-bit AND-mask keeping the top (32-a) bits.

A table is a dense numpy array of rows; `lookup_check` verifies that each
queried tuple appears in the table through an index witness (the witness
supplies the row id, the checker gathers and compares), row-parallel on the
row ids' device.  A u64 table value is held in an int64 tensor with the same
bits, so no split into u32 halves is needed.
"""

from __future__ import annotations

import numpy as np
import torch

FLAGS_PACKED_ENCODING_BIT_WIDTH = 3

# condition variant indices (zkevm_opcode_defs ALL_CONDITIONS order)
COND_ALWAYS, COND_LT, COND_EQ, COND_GT, COND_GE, COND_LE, COND_NE, COND_GT_OR_LT = range(8)


def create_bitshift_table() -> np.ndarray:
    """(1024, 3): [shift + limb_pair<<8, low_limb, high_limb] of 2^shift."""
    rows = []
    for shift in range(256):
        modulus = 1 << shift
        for idx in range(4):
            x = shift + (idx << 8)
            y = modulus & 0xFFFFFFFF
            modulus >>= 32
            z = modulus & 0xFFFFFFFF
            modulus >>= 32
            rows.append([x, y, z])
    return np.asarray(rows, dtype=np.uint64)


def create_conditionals_resolution_table() -> np.ndarray:
    """(64, 3): [condition, packed_flags, resolution]."""
    rows = []
    for cond in range(8):
        for i in range(1 << FLAGS_PACKED_ENCODING_BIT_WIDTH):
            of, eq, gt = (i & 1) != 0, (i & 2) != 0, (i & 4) != 0
            resolution = {
                COND_ALWAYS: True,
                COND_LT: of,
                COND_EQ: eq,
                COND_GT: gt,
                COND_GE: gt or eq,
                COND_LE: of or eq,
                COND_NE: not eq,
                COND_GT_OR_LT: gt or of,
            }[cond]
            rows.append([cond, i, int(resolution)])
    return np.asarray(rows, dtype=np.uint64)


def create_integer_to_bitmask_table(num_bits: int) -> np.ndarray:
    """(2^num_bits, 3): [i, 0 if i==0 else 1<<(i-1), 0]."""
    rows = []
    for i in range(1 << num_bits):
        rows.append([i, 0 if i == 0 else 1 << (i - 1), 0])
    return np.asarray(rows, dtype=np.uint64)


def create_register_index_to_bitmask_table() -> np.ndarray:
    return create_integer_to_bitmask_table(4)


def create_uma_shift_to_bitmask_table() -> np.ndarray:
    return create_integer_to_bitmask_table(5)


def create_subpc_to_bitmask_table() -> np.ndarray:
    return create_integer_to_bitmask_table(2)


def create_uma_ptr_read_cleanup_table() -> np.ndarray:
    """(32, 3): [a, mask keeping the top (32-a) bits, 0]."""
    full = (1 << 32) - 1
    rows = []
    for a in range(32):
        mask = full if a == 0 else full - ((1 << a) - 1)
        rows.append([a, mask, 0])
    return np.asarray(rows, dtype=np.uint64)


def create_opcode_decoding_table() -> np.ndarray:
    """(2^11, 3): [variant index, ergs price, props bitspread] over the REAL
    ISA decode table (VMOpcodeDecodingTable role, ref src/tables/* +
    zkevm_opcode_defs OPCODES_TABLE; isa/opcodes.py synthesizes the table)."""
    from ..isa import opcodes as isa

    n = 1 << isa.OPCODES_TABLE_WIDTH
    rows = [
        [i, isa.OPCODES_PRICES[i], isa.OPCODES_PROPS_INTEGER_BITMASKS[i]]
        for i in range(n)
    ]
    return np.asarray(rows, dtype=np.uint64)


ALL_TABLES = {
    "bitshift": create_bitshift_table,
    "conditional_resolution": create_conditionals_resolution_table,
    "register_index_to_bitmask": create_register_index_to_bitmask_table,
    "uma_shift_to_bitmask": create_uma_shift_to_bitmask_table,
    "subpc_to_bitmask": create_subpc_to_bitmask_table,
    "uma_ptr_read_cleanup": create_uma_ptr_read_cleanup_table,
    "opcode_decoding": create_opcode_decoding_table,
}


def lookup_check(table: np.ndarray, queries, row_ids: torch.Tensor) -> torch.Tensor:
    """Verify each queried tuple appears in the table.

    table: (R, W) host array; queries: (n, W) host u64; row_ids: (n,) witness
    row indices (a tensor; the check runs on its device, an index out of
    range is clamped).  Returns (n,) bool."""
    dev = row_ids.device
    tab = torch.from_numpy(np.ascontiguousarray(table.astype(np.uint64)).view(np.int64)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(np.asarray(queries, np.uint64)).view(np.int64)).to(dev)
    ids = row_ids.to(torch.int64).clamp(0, table.shape[0] - 1)
    return (tab[ids] == q).all(-1)


def lookup_row_ids(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Host-side witness: find the row id of each query tuple."""
    index = {tuple(int(x) for x in row): i for i, row in enumerate(table)}
    return np.asarray([index[tuple(int(x) for x in q)] for q in queries], dtype=np.int32)
