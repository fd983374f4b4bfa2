"""VM state structures: ExecutionContextRecord, callstack, boot state (the
JAX package's `models/vm/state.py`; host side, numpy only).

  * the 22-field ExecutionContextRecord and its 32-field-element encoding;
  * the callstack: the current context, its depth and the 12-lane stack
    sponge state;
  * the bootloader boot state (4 Poseidon2 absorb rounds of the empty entry
    encoding).

Host-side structures are plain python; the encoding routines are numpy and
bit-exact with the circuit's re-derivation (every packed element is
< 2^57 < p, so field elements are formed directly).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...isa import system_params as sp

FULL_SPONGE_QUEUE_STATE_WIDTH = 12
QUEUE_STATE_WIDTH = 4
REGISTERS_COUNT = 15
EXECUTION_CONTEXT_RECORD_ENCODING_WIDTH = 32

U32 = 0xFFFFFFFF
U16 = 0xFFFF


@dataclasses.dataclass
class ExecutionContextRecord:
    """One saved frame (ref saved_context.rs:36-66). Addresses are ints
    (<2^160); rollback queue head/tail are 4-tuples of GF values (u64)."""

    this: int = 0
    caller: int = 0
    code_address: int = 0
    code_page: int = 0
    base_page: int = 0
    heap_upper_bound: int = 0
    aux_heap_upper_bound: int = 0
    reverted_queue_head: tuple = (0, 0, 0, 0)
    reverted_queue_tail: tuple = (0, 0, 0, 0)
    reverted_queue_segment_len: int = 0
    pc: int = 0
    sp: int = 0
    exception_handler_loc: int = 0
    ergs_remaining: int = 0
    is_static_execution: bool = False
    is_kernel_mode: bool = False
    this_shard_id: int = 0
    caller_shard_id: int = 0
    code_shard_id: int = 0
    context_u128_value_composite: tuple = (0, 0, 0, 0)
    is_local_call: bool = False

    def copy(self) -> "ExecutionContextRecord":
        return dataclasses.replace(self)


def _addr_limbs(addr: int):
    return [(addr >> (32 * k)) & U32 for k in range(5)]


def encode_context_record(r: ExecutionContextRecord) -> list:
    """32-element encoding, exact packing of saved_context.rs:114-265."""
    rl = list(r.reverted_queue_head) + list(r.reverted_queue_tail)
    out = [int(x) for x in rl]  # v0..v7
    out += _addr_limbs(r.code_address)  # v8..v12
    out += _addr_limbs(r.this)  # v13..v17
    out += _addr_limbs(r.caller)  # v18..v22
    out += [int(x) for x in r.context_u128_value_composite]  # v23..v26
    out.append(
        (r.code_page & U32)
        | ((r.pc & U16) << 32)
        | ((r.this_shard_id & 0xFF) << 48)
        | (int(r.is_static_execution) << 56)
    )  # v27
    out.append(
        (r.base_page & U32)
        | ((r.sp & U16) << 32)
        | ((r.caller_shard_id & 0xFF) << 48)
        | (int(r.is_kernel_mode) << 56)
    )  # v28
    out.append(
        (r.ergs_remaining & U32)
        | ((r.exception_handler_loc & U16) << 32)
        | ((r.code_shard_id & 0xFF) << 48)
        | (int(r.is_local_call) << 56)
    )  # v29
    ql = r.reverted_queue_segment_len & U32
    out.append(
        (r.heap_upper_bound & U32)
        | ((ql & 0xFF) << 32)
        | (((ql >> 8) & 0xFF) << 40)
    )  # v30
    out.append(
        (r.aux_heap_upper_bound & U32)
        | (((ql >> 16) & 0xFF) << 32)
        | (((ql >> 24) & 0xFF) << 40)
    )  # v31
    assert len(out) == EXECUTION_CONTEXT_RECORD_ENCODING_WIDTH
    return out


def encode_context_records_np(cols: dict) -> np.ndarray:
    """Vectorized encoding from SoA columns (each (N,...) numpy array) —
    bit-identical to encode_context_record; used by the circuit-side witness
    assembly and by golden tests.

    Expects keys: rq_head (N,4) u64, rq_tail (N,4) u64, code_address (N,5),
    this (N,5), caller (N,5) u32, ctx_u128 (N,4) u32, code_page, base_page,
    heap_bound, aux_heap_bound, pc, sp, eh, ergs, rq_len u32, is_static,
    is_kernel, is_local bool, shard_this, shard_caller, shard_code u32.
    """
    n = cols["pc"].shape[0]
    out = np.zeros((n, 32), dtype=np.uint64)
    out[:, 0:4] = cols["rq_head"].astype(np.uint64)
    out[:, 4:8] = cols["rq_tail"].astype(np.uint64)
    out[:, 8:13] = cols["code_address"].astype(np.uint64)
    out[:, 13:18] = cols["this"].astype(np.uint64)
    out[:, 18:23] = cols["caller"].astype(np.uint64)
    out[:, 23:27] = cols["ctx_u128"].astype(np.uint64)
    u64 = lambda k: cols[k].astype(np.uint64)
    out[:, 27] = (
        u64("code_page")
        | (u64("pc") << np.uint64(32))
        | (u64("shard_this") << np.uint64(48))
        | (cols["is_static"].astype(np.uint64) << np.uint64(56))
    )
    out[:, 28] = (
        u64("base_page")
        | (u64("sp") << np.uint64(32))
        | (u64("shard_caller") << np.uint64(48))
        | (cols["is_kernel"].astype(np.uint64) << np.uint64(56))
    )
    out[:, 29] = (
        u64("ergs")
        | (u64("eh") << np.uint64(32))
        | (u64("shard_code") << np.uint64(48))
        | (cols["is_local"].astype(np.uint64) << np.uint64(56))
    )
    ql = u64("rq_len")
    out[:, 30] = (
        u64("heap_bound")
        | ((ql & np.uint64(0xFF)) << np.uint64(32))
        | (((ql >> np.uint64(8)) & np.uint64(0xFF)) << np.uint64(40))
    )
    out[:, 31] = (
        u64("aux_heap_bound")
        | (((ql >> np.uint64(16)) & np.uint64(0xFF)) << np.uint64(32))
        | (((ql >> np.uint64(24)) & np.uint64(0xFF)) << np.uint64(40))
    )
    return out


def callstack_sponge_absorb(state: np.ndarray, encoding32) -> np.ndarray:
    """Absorb a 32-element context encoding over 4 Poseidon2 rounds
    (absorb-by-replacement of lanes 0..8). state: (12,) u64 -> (12,) u64."""
    from ...runtime import native

    st = np.asarray(state, dtype=np.uint64).copy()
    enc = np.asarray(encoding32, dtype=np.uint64)
    for r in range(4):
        st[:8] = enc[8 * r : 8 * r + 8]
        st = native.poseidon2_permute(st)
    return st


@dataclasses.dataclass
class Frame:
    """Host callstack entry: the saved record + the sponge state *below*
    this frame (so ret can restore it as the popped previous state)."""

    record: ExecutionContextRecord
    sponge_below: np.ndarray  # (12,) u64 — callstack sponge before the push


def initial_bootloader_state() -> dict:
    """Boot-state pieces per loading.rs:13-226: the root context, the
    callstack sponge after absorbing the empty-entry encoding, and the r1
    formal calldata fat pointer.  Rollback tail/head are filled in by the
    simulator (they are block-level witness values)."""
    ctx = ExecutionContextRecord(
        this=sp.BOOTLOADER_FORMAL_ADDRESS,
        caller=0,
        code_address=sp.BOOTLOADER_FORMAL_ADDRESS,
        code_page=sp.BOOTLOADER_CODE_PAGE,
        base_page=sp.BOOTLOADER_BASE_PAGE,
        heap_upper_bound=sp.BOOTLOADER_MAX_MEMORY,
        aux_heap_upper_bound=sp.BOOTLOADER_MAX_MEMORY,
        pc=0,
        exception_handler_loc=sp.INITIAL_FRAME_FORMAL_EH_LOCATION,
        ergs_remaining=sp.VM_INITIAL_FRAME_ERGS,
        is_kernel_mode=True,
    )
    empty_entry = ExecutionContextRecord(is_kernel_mode=True)
    # formal r1: fat pointer to the (empty) bootloader calldata page
    r1 = (sp.BOOTLOADER_CALLDATA_PAGE & U32) << 32
    return dict(ctx=ctx, empty_entry=empty_entry, r1_value=r1)
