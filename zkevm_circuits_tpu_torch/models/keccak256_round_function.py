"""keccak256_round_function, circuit type 5: the keccak precompile (the JAX
package's `models/keccak256_round_function.py`).

Reference parity: `src/keccak256_round_function/` (ABI
`Keccak256PrecompileCallParams::from_encoding` mod.rs:74-98: key limbs
[0]=input_memory_byte_offset, [1]=input_memory_byte_length,
[2]=output_word_offset, [4]=input_page, [5]=output_page; full-padding round
when len % 136 == 0), per-cycle cadence of 1 keccak-f + up to
MEMORY_QUERIES_PER_CYCLE = 6 unaligned 32-byte reads (input.rs:23), digest
written back as one memory word.

Rows: one per keccak-f[1600] invocation, flat across all calls of the
instance.  The byte stream is materialized directly and every check is
row-parallel:

  * call-queue pops + ABI decode (per call)
  * memory reads: aligned 32-byte words covering [offset, offset+len) of the
    input page, in word order per call, pushed to the memory queue; the
    byte stream is a gather from those words
  * keccak state chain with reset at each call's first block; 0x01/0x80
    padding (0x81 fused case included); digest from the final state
  * one memory write of the BE digest per call

The witness is built on the host (`keccak.keccak_f1600_ref`, ragged per-call
lengths), its sponge chains by `queues.simulate_chains`; the evaluation
checks every block with one batched `keccak.absorb_block` on the witness's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..base_structures.log_query import LogQueries, encode_log_queries
from ..base_structures.memory_query import MemoryQueries, encode_memory_queries
from ..isa.system_params import KECCAK256_PRECOMPILE_FORMAL_ADDRESS, PRECOMPILE_AUX_BYTE
from ..ops import keccak, queues
from ..ops.keccak import KECCAK_RATE_BYTES as RATE
from ..utils.device import resolve_device
from ..utils.shard_plan import RowWindow, ShardPlan
from . import precompile_common as pc

MEMORY_QUERIES_PER_CYCLE = 6  # ref input.rs:23
M32 = pc.M32


@dataclasses.dataclass(frozen=True)
class KeccakRoundFunctionConfig:
    max_blocks: int  # total keccak-f rows in the instance
    max_reads: int  # total 32-byte memory reads in the instance


def abi_from_key(key_limbs) -> dict:
    """Decode PrecompileCallABI from the LogQuery key (limbs LE u32)."""
    return dict(
        input_memory_byte_offset=key_limbs[..., 0],
        input_memory_byte_length=key_limbs[..., 1],
        output_word_offset=key_limbs[..., 2],
        input_page=key_limbs[..., 4],
        output_page=key_limbs[..., 5],
    )


@dataclasses.dataclass(frozen=True)
class KeccakRoundWitness:
    num_calls: int
    calls: LogQueries  # (C,) padded call queue
    call_execute: torch.Tensor  # (C,)
    call_chain: torch.Tensor  # (C+1, 4) calls-queue head chain
    # per-block columns (B = max_blocks)
    block_execute: torch.Tensor  # (B,)
    block_call: torch.Tensor  # (B,) call index
    block_is_first: torch.Tensor  # (B,)
    block_is_last: torch.Tensor  # (B,)
    block_bytes: torch.Tensor  # (B, 136)
    state_lo: torch.Tensor  # (B+1, 25) state BEFORE each block (post-reset)
    state_hi: torch.Tensor
    out_lo: torch.Tensor  # (B, 25) state AFTER each block
    out_hi: torch.Tensor
    # memory side
    reads: MemoryQueries  # (R,) read queries in order
    read_execute: torch.Tensor  # (R,)
    read_call: torch.Tensor  # (R,) call index of each read
    writes: MemoryQueries  # (C,) digest writes
    mem_chain: torch.Tensor  # (R+C+1, 12) memory queue chain (reads then per-call write)
    mem_order_encodings: torch.Tensor  # (R+C, 8)
    mem_order_execute: torch.Tensor  # (R+C,)
    digests: torch.Tensor  # (C, 32)


def _call_span(call: dict, memory: dict):
    """(ABI limbs, the words read as (index, 32 bytes), the payload)."""
    limbs = pc.key_limbs(call["key"])
    off, length, in_page = limbs[0], limbs[1], limbs[4]
    first_word = off // 32
    last_word = (off + length - 1) // 32 if length else first_word
    words = [(wi, memory.get((in_page, wi), b"\x00" * 32))
             for wi in range(first_word, last_word + 1)]
    data = b"".join(word for _, word in words)
    return limbs, words, bytes(data[off % 32: off % 32 + length])


def call_payloads(calls: list, memory: dict) -> list:
    """The plaintext input byte stream of each precompile call (the bytes the
    in-circuit keccak absorbs)."""
    return [_call_span(call, memory)[2] for call in calls]


def _pad(payload: bytes) -> bytes:
    padded = bytearray(payload)
    pad_len = RATE - (len(padded) % RATE)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    return bytes(padded)


def _lo_hi(states: np.ndarray):
    return ((states & np.uint64(M32)).astype(np.int64), (states >> np.uint64(32)).astype(np.int64))


def generate_witness(calls: list, memory: dict, config: KeccakRoundFunctionConfig,
                     mem_init_state=None, device=None) -> KeccakRoundWitness:
    """calls: list of dicts (LogQuery fields; key encodes the ABI).
    memory: {(page, word_index): 32-byte bytes object} backing store.
    mem_init_state: optional (12,) initial memory-queue sponge state — the
    scheduler's memory-queue threading (ref scheduler/mod.rs:284-349).
    `device=None` is the card."""
    device = resolve_device(device)
    C = len(calls)
    C1 = max(C, 1)
    B, R = config.max_blocks, config.max_reads

    block_rows = []
    read_rows = []
    write_rows = []
    digests = []
    order_rows = []  # the pinned memory order: a call's reads, then its write
    for ci, call in enumerate(calls):
        limbs, words, payload = _call_span(call, memory)
        out_word, in_page, out_page = limbs[2], limbs[4], limbs[5]
        ts = int(call["timestamp"])
        call_reads = [dict(timestamp=ts, memory_page=in_page, index=wi, rw_flag=False,
                           is_ptr=False, value=int.from_bytes(word, "big"), call=ci)
                      for wi, word in words]
        read_rows += call_reads
        # the call's keccak chain from the zero state; the digest is its last state's
        padded = _pad(payload)
        nb = len(padded) // RATE
        cur = [0] * 25
        for b in range(nb):
            block = padded[b * RATE: (b + 1) * RATE]
            lanes = keccak.bytes_to_lanes(block)
            before = cur
            cur = keccak.keccak_f1600_ref([cur[i] ^ (lanes[i] if i < 17 else 0) for i in range(25)])
            block_rows.append(dict(call=ci, first=b == 0, last=b == nb - 1, bytes=block,
                                   before=before, after=cur))
        digest = b"".join(lane.to_bytes(8, "little") for lane in cur[:4])
        digests.append(list(digest))
        write_rows.append(dict(timestamp=ts + 1, memory_page=out_page, index=out_word,
                               rw_flag=True, is_ptr=False, value=int.from_bytes(digest, "big")))
        order_rows += call_reads + [write_rows[-1]]
    if len(block_rows) > B:
        raise ValueError(f"{len(block_rows)} keccak blocks do not fit max_blocks={B}")
    if len(read_rows) > R:
        raise ValueError(f"{len(read_rows)} reads do not fit max_reads={R}")

    # flat block columns of the keccak chains
    n_b = len(block_rows)
    blk_bytes = np.zeros((B, RATE), np.int64)
    blk_call = np.zeros(B, np.int64)
    blk_first = np.zeros(B, bool)
    blk_last = np.zeros(B, bool)
    states = np.zeros((B + 1, 25), np.uint64)
    outs = np.zeros((B, 25), np.uint64)
    if n_b:
        blk_bytes[:n_b] = np.frombuffer(b"".join(r["bytes"] for r in block_rows),
                                        np.uint8).reshape(n_b, RATE)
        blk_call[:n_b] = [r["call"] for r in block_rows]
        blk_first[:n_b] = [r["first"] for r in block_rows]
        blk_last[:n_b] = [r["last"] for r in block_rows]
        states[:n_b] = [r["before"] for r in block_rows]
        outs[:n_b] = [r["after"] for r in block_rows]

    reads_q = pc.memory_rows(read_rows, R, device)
    read_call = np.zeros(R, np.int64)
    read_call[:len(read_rows)] = [r["call"] for r in read_rows]
    writes_q = pc.memory_rows(write_rows, C1, device)

    mem_q = pc.memory_rows(order_rows, R + C1, device)
    mem_exec = pc.executed(R + C1, len(order_rows), device)
    mem_enc = encode_memory_queries(mem_q)
    (mem_chain,) = queues.simulate_chains(
        queues.FULL_STATE_WIDTH, [(mem_enc, mem_exec)], init=[mem_init_state])

    calls_q = pc.call_rows(calls, C1, device)
    call_exec = pc.executed(C1, C, device)
    (call_chain,) = queues.simulate_chains(
        queues.NARROW_STATE_WIDTH, [(encode_log_queries(calls_q), call_exec)])

    dig = np.zeros((C1, 32), np.int64)
    if digests:
        dig[:C] = digests

    def t(a):
        return torch.from_numpy(a).to(device)

    slo, shi = _lo_hi(states)
    olo, ohi = _lo_hi(outs)
    return KeccakRoundWitness(
        num_calls=C,
        calls=calls_q,
        call_execute=call_exec,
        call_chain=call_chain,
        block_execute=pc.executed(B, n_b, device),
        block_call=t(blk_call),
        block_is_first=t(blk_first),
        block_is_last=t(blk_last),
        block_bytes=t(blk_bytes),
        state_lo=t(slo),
        state_hi=t(shi),
        out_lo=t(olo),
        out_hi=t(ohi),
        reads=reads_q,
        read_execute=pc.executed(R, len(read_rows), device),
        read_call=t(read_call),
        writes=writes_q,
        mem_chain=mem_chain,
        mem_order_encodings=mem_enc,
        mem_order_execute=mem_exec,
        digests=t(dig),
    )


def _word_bytes_be(value: torch.Tensor) -> torch.Tensor:
    """u256 (..., 8) LE u32 limbs -> (..., 32) bytes in memory order (BE)."""
    outs = []
    for k in range(8):
        limb = value[..., 7 - k]
        for j in range(4):
            outs.append((limb >> (8 * (3 - j))) & 0xFF)
    return torch.stack(outs, dim=-1)


def _call_read_start(read_call: torch.Tensor, num_calls: int) -> torch.Tensor:
    """the first flat read index of each call (R where a call has none)."""
    R = read_call.shape[0]
    idx = torch.arange(R, device=read_call.device)
    keep = (read_call >= 0) & (read_call < num_calls)
    starts = torch.full((num_calls,), R, dtype=torch.int64, device=read_call.device)
    return starts.scatter_reduce(0, torch.where(keep, read_call, torch.zeros_like(read_call)),
                                 torch.where(keep, idx, torch.full_like(idx, R)), reduce="amin")


def eval_constraints(w: KeccakRoundWitness, config: KeccakRoundFunctionConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Row-parallel constraint evaluation on the witness's device; every
    entry must be all-True.  `window` places a block of the block axis in
    its run (`parallel/auto.py`); None is the whole run."""
    B = config.max_blocks
    dev = w.block_execute.device
    res = {}
    ce = w.call_execute
    true_c = torch.ones_like(ce)
    true_b = torch.ones_like(w.block_execute)

    # (1) call queue: chain + precompile address/aux byte
    res["call_chain"] = queues.check_chain(w.call_chain, encode_log_queries(w.calls), ce)
    res["call_is_keccak_precompile"] = torch.where(
        ce, pc.address_is(w.calls.address, KECCAK256_PRECOMPILE_FORMAL_ADDRESS)
        & (w.calls.aux_byte == PRECOMPILE_AUX_BYTE), true_c)

    # (2) keccak chain: reset at first block, absorb, digest at last
    abs_lo, abs_hi = keccak.absorb_block(w.state_lo[:-1], w.state_hi[:-1],
                                         *keccak.lane_halves(w.block_bytes))
    out_ok = (abs_lo == w.out_lo).all(-1) & (abs_hi == w.out_hi).all(-1)
    res["keccak_transitions"] = torch.where(w.block_execute, out_ok, true_b)
    zero = torch.zeros((1, 25), dtype=torch.int64, device=dev)
    first = w.block_is_first[:, None]
    cont_lo = torch.where(first, 0, torch.cat([zero, w.out_lo[:-1]]))
    cont_hi = torch.where(first, 0, torch.cat([zero, w.out_hi[:-1]]))
    res["state_continuity"] = torch.where(
        w.block_execute,
        (w.state_lo[:-1] == cont_lo).all(-1) & (w.state_hi[:-1] == cont_hi).all(-1), true_b)
    dig = keccak.digest_bytes(w.out_lo, w.out_hi)  # (B, 32)
    res["digest_extraction"] = torch.where(
        w.block_execute & w.block_is_last, (dig == w.digests[w.block_call]).all(-1), true_b)

    # (3) block byte stream matches memory reads + padding
    abi = abi_from_key(w.calls.key)
    blk_off = pc.offset_within_group(
        w.block_is_first, *((window.row0, window.flag_carry) if window else ()))
    byte_pos = blk_off[:, None] * RATE + torch.arange(RATE, device=dev)[None, :]  # (B, 136)
    call_off = abi["input_memory_byte_offset"][w.block_call]
    call_len = abi["input_memory_byte_length"][w.block_call]
    gpos = (call_off % 32)[:, None] + byte_pos  # position within the read words
    widx = gpos // 32  # word index within the call's reads
    bidx = gpos % 32
    read_start = _call_read_start(w.read_call, ce.shape[0])
    flat_read = (read_start[w.block_call][:, None] + widx).clamp(0, w.reads.shape[0] - 1)
    word_bytes = _word_bytes_be(w.reads.value)  # (R, 32)
    data_byte = word_bytes[flat_read, bidx]
    in_msg = byte_pos < call_len[:, None]
    pad_one_pos = byte_pos == call_len[:, None]
    nb_call = call_len // RATE + 1
    last_byte = byte_pos == nb_call[:, None] * RATE - 1
    expected = torch.where(in_msg, data_byte, torch.zeros_like(data_byte))
    expected = torch.where(pad_one_pos, expected | 0x01, expected)
    expected = torch.where(last_byte, expected | 0x80, expected)
    res["block_bytes"] = torch.where(w.block_execute, (expected == w.block_bytes).all(-1), true_b)

    # (4) read queries address the right page/words
    read_off = pc.offset_within_group(pc.group_starts(w.read_call))
    res["read_addressing"] = torch.where(
        w.read_execute,
        (w.reads.memory_page == abi["input_page"][w.read_call]) & ~w.reads.rw_flag
        & (w.reads.index == ((abi["input_memory_byte_offset"][w.read_call] // 32 + read_off)
                             & M32)),
        torch.ones_like(w.read_execute))

    # (5) writes carry the digest to the right location
    res["write_value_is_digest"] = torch.where(
        ce, (_word_bytes_be(w.writes.value) == w.digests).all(-1), true_c)
    res["write_addressing"] = torch.where(
        ce, (w.writes.memory_page == abi["output_page"])
        & (w.writes.index == abi["output_word_offset"]) & w.writes.rw_flag, true_c)

    # (6) memory queue chain over the pinned order
    res["mem_chain"] = queues.check_chain(w.mem_chain, w.mem_order_encodings, w.mem_order_execute)
    return res


all_ok = pc.all_ok

# row-sharded over the block axis: a block reads the previous block's output;
# the call, read, write and memory-queue fields stay whole on every member
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 0),
    rows=frozenset({"block_execute", "block_call", "block_is_first", "block_is_last",
                    "block_bytes", "state_lo", "state_hi", "out_lo", "out_hi"}),
    whole=frozenset({"call_chain", "call_is_keccak_precompile", "read_addressing",
                     "write_value_is_digest", "write_addressing", "mem_chain"}),
    takes_window=True,
    carry_flag=lambda w: w.block_is_first,
)

# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


def instance_compact_forms(w: KeccakRoundWitness, config: KeccakRoundFunctionConfig,
                           limit_blocks: int):
    """Multi-instance ClosedFormInput: the block axis sliced into
    `limit_blocks`-block instances, continuation ACROSS calls and mid-call
    (the Keccak256RoundFunctionFSM role, ref keccak256_round_function/
    input.rs:21-45).

    The hidden FSM at boundary b: the keccak state BEFORE block b (25 lo
    lanes, then 25 hi), the in-call progress (call index + block offset
    within the call), the calls-queue state after the calls fully consumed,
    and the memory-queue state at the call boundary (the pinned order absorbs
    all of a call's reads before its first block)."""
    B = config.max_blocks
    dev = w.block_execute.device
    bounds = pc.boundaries(B, limit_blocks, dev)
    C = w.call_execute.shape[0]
    # the mem position at any block of call ci: sum_{c<ci}(reads_c + 1) + reads_ci
    reads_per_call = pc.scatter_add(C + 1, w.read_call + 1, w.read_execute)
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(reads_per_call[1:] + 1, 0) & M32])
    mem_pos_call = (prefix[:-1] + reads_per_call[1:]) & M32
    blk_off = pc.offset_within_group(w.block_is_first)

    in_range = bounds < B
    bi = bounds.clamp(max=B - 1)
    live = in_range & w.block_execute[bi]
    call = torch.where(live, w.block_call[bi], torch.full_like(bi, C))
    call_u = call.clamp(max=C - 1)
    off = torch.where(in_range, blk_off[bi], torch.zeros_like(bi))
    zero = torch.zeros_like(w.state_lo[bi])
    state = torch.cat([torch.where(in_range[:, None], w.state_lo[bi], zero),
                       torch.where(in_range[:, None], w.state_hi[bi], zero)], dim=-1)
    done_calls = torch.where(live, call, torch.full_like(call, w.num_calls))
    n_mem = int(w.mem_order_execute.sum())
    mem_pos = torch.where(live, mem_pos_call[call_u], torch.full_like(call, n_mem))
    mem_state = w.mem_chain[mem_pos.clamp(max=w.mem_chain.shape[0] - 1)]
    fsm = torch.cat([state, call[:, None], off[:, None], mem_pos[:, None],
                     w.call_chain[done_calls], mem_state], dim=-1)
    return pc.multi_instance_forms(w.call_chain, w.num_calls, w.mem_chain, n_mem, fsm,
                                   int(w.block_execute.sum()), limit_blocks)


def instance_compact_form(w: KeccakRoundWitness, config: KeccakRoundFunctionConfig):
    """Single-instance ClosedFormInput (PrecompileFunctionInputData/OutputData
    shape, ref base_structures/precompile_input_outputs/mod.rs:23-44)."""
    return pc.single_instance_form(w.call_chain, w.num_calls, w.mem_chain,
                                   int(w.mem_order_execute.sum()))
