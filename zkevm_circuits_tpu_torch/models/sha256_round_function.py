"""sha256_round_function, circuit type 6: the sha256 precompile (the JAX
package's `models/sha256_round_function.py`).

Reference parity: `src/sha256_round_function/` — ABI
`Sha256PrecompileCallParams::from_encoding` (mod.rs:65-83: key limbs
[0]=input_offset (word-aligned), [2]=output_offset, [4]=input_page,
[5]=output_page, [6]=num_rounds), cadence of MEMORY_READ_QUERIES_PER_CYCLE=2
aligned word reads + one sha256 compression per cycle (mod.rs:86), state
reset to IV at each call, digest written once num_rounds are exhausted with
per-word little-endian repacking into the u256 (mod.rs:290-305: limb[7-k] =
le_bytes(digest[4k..4k+4])).  The input is caller-pre-padded: no padding
logic in-circuit.

Rows: one per compression, flat across calls.  The witness is built on the
host (`sha256.compress_ref`, ragged per-call round counts), its memory and
call sponge chains by `queues.simulate_chains` (`backend="host"`: the native
runtime); `eval_constraints` checks every compression with one batched
`sha256.compress` and everything else row-parallel on the witness's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..base_structures.log_query import LogQueries, encode_log_queries
from ..base_structures.memory_query import MemoryQueries, encode_memory_queries
from ..isa.system_params import PRECOMPILE_AUX_BYTE, SHA256_PRECOMPILE_FORMAL_ADDRESS
from ..ops import queues, sha256
from ..utils.device import resolve_device
from ..utils.shard_plan import RowWindow, ShardPlan, owned_rows, summed
from . import precompile_common as pc

MEMORY_READ_QUERIES_PER_CYCLE = 2
M32 = pc.M32


@dataclasses.dataclass(frozen=True)
class Sha256RoundFunctionConfig:
    max_rounds: int


def abi_from_key(key_limbs) -> dict:
    return dict(
        input_offset=key_limbs[..., 0],
        output_offset=key_limbs[..., 2],
        input_page=key_limbs[..., 4],
        output_page=key_limbs[..., 5],
        num_rounds=key_limbs[..., 6],
    )


@dataclasses.dataclass(frozen=True)
class Sha256RoundWitness:
    num_calls: int
    calls: LogQueries  # (C,)
    call_execute: torch.Tensor
    call_chain: torch.Tensor  # (C+1, 4)
    # per-round columns (N = max_rounds)
    round_execute: torch.Tensor  # (N,)
    round_call: torch.Tensor  # (N,)
    round_is_first: torch.Tensor
    round_is_last: torch.Tensor
    block_words: torch.Tensor  # (N, 16) u32 BE message words
    state_before: torch.Tensor  # (N, 8)
    state_after: torch.Tensor  # (N, 8)
    reads: MemoryQueries  # (2N,)
    read_execute: torch.Tensor
    writes: MemoryQueries  # (C,)
    mem_chain: torch.Tensor  # over reads-then-write per call order
    mem_order_encodings: torch.Tensor
    mem_order_execute: torch.Tensor


def _digest_value_limbs(state_words) -> list:
    """Final sha256 state -> u256 limbs per the reference's LE repack."""
    limbs = [0] * 8
    for k in range(8):
        w = int(state_words[k])
        limbs[7 - k] = int.from_bytes(w.to_bytes(4, "big"), "little")
    return limbs


def generate_witness(calls: list, memory: dict, config: Sha256RoundFunctionConfig,
                     mem_init_state=None, backend: str = "host",
                     device=None) -> Sha256RoundWitness:
    """memory: {(page, word_index): 32 bytes} — input must be pre-padded.
    mem_init_state ((12,) u64 or field tensor) threads the global memory
    queue (scheduler mod.rs:284-349).  backend: how the two sponge chains run
    (`queues.simulate_chains`); `device=None` is the card."""
    device = resolve_device(device)
    C = max(len(calls), 1)
    N = config.max_rounds

    rounds = []
    read_rows = []
    write_rows = []
    for ci, call in enumerate(calls):
        limbs = pc.key_limbs(call["key"])
        in_off, out_off, in_page, out_page, nr = (limbs[0], limbs[2], limbs[4], limbs[5], limbs[6])
        ts = int(call["timestamp"])
        state = list(sha256.H0)
        for r in range(nr):
            words64 = b""
            for j in range(2):
                wi = in_off + 2 * r + j
                word = memory.get((in_page, wi), b"\x00" * 32)
                read_rows.append(dict(timestamp=ts, memory_page=in_page, index=wi, rw_flag=False,
                                      is_ptr=False, value=int.from_bytes(word, "big"), call=ci))
                words64 += word
            block = [int.from_bytes(words64[4 * j: 4 * j + 4], "big") for j in range(16)]
            new_state = sha256.compress_ref(state, block)
            rounds.append(dict(call=ci, first=r == 0, last=r == nr - 1, block=block,
                               before=list(state), after=list(new_state)))
            state = new_state
        value = 0
        for k, l in enumerate(_digest_value_limbs(state)):
            value |= l << (32 * k)
        write_rows.append(dict(timestamp=ts + 1, memory_page=out_page, index=out_off,
                               rw_flag=True, is_ptr=False, value=value))
    if len(rounds) > N:
        raise ValueError(f"{len(rounds)} sha256 rounds do not fit max_rounds={N}")

    blk = np.zeros((N, 16), np.int64)
    before = np.tile(np.array(sha256.H0, np.int64), (N, 1))
    after = np.zeros((N, 8), np.int64)
    rcall = np.zeros(N, np.int64)
    rfirst = np.zeros(N, bool)
    rlast = np.zeros(N, bool)
    n_r = len(rounds)
    if n_r:
        blk[:n_r] = [r["block"] for r in rounds]
        before[:n_r] = [r["before"] for r in rounds]
        after[:n_r] = [r["after"] for r in rounds]
        rcall[:n_r] = [r["call"] for r in rounds]
        rfirst[:n_r] = [r["first"] for r in rounds]
        rlast[:n_r] = [r["last"] for r in rounds]

    R = 2 * N
    reads_q = pc.memory_rows(read_rows, R, device)
    writes_q = pc.memory_rows(write_rows, C, device)
    # the pinned memory order: a call's reads, then its write
    order_rows = []
    by_call = [[] for _ in calls]
    for r in read_rows:
        by_call[r["call"]].append(r)
    for ci in range(len(calls)):
        order_rows += by_call[ci] + [write_rows[ci]]
    mem_q = pc.memory_rows(order_rows, R + C, device)
    mem_exec = pc.executed(R + C, len(order_rows), device)
    mem_enc = encode_memory_queries(mem_q)
    (mem_chain,) = queues.simulate_chains(
        queues.FULL_STATE_WIDTH, [(mem_enc, mem_exec)], backend, [mem_init_state])

    calls_q = pc.call_rows(calls, C, device)
    call_exec = pc.executed(C, len(calls), device)
    (call_chain,) = queues.simulate_chains(
        queues.NARROW_STATE_WIDTH, [(encode_log_queries(calls_q), call_exec)], backend)

    def t(a):
        return torch.from_numpy(a).to(device)

    return Sha256RoundWitness(
        num_calls=len(calls),
        calls=calls_q,
        call_execute=call_exec,
        call_chain=call_chain,
        round_execute=pc.executed(N, n_r, device),
        round_call=t(rcall),
        round_is_first=t(rfirst),
        round_is_last=t(rlast),
        block_words=t(blk),
        state_before=t(before),
        state_after=t(after),
        reads=reads_q,
        read_execute=pc.executed(R, len(read_rows), device),
        writes=writes_q,
        mem_chain=mem_chain,
        mem_order_encodings=mem_enc,
        mem_order_execute=mem_exec,
    )


def _h0(device):
    return torch.tensor(sha256.H0, dtype=torch.int64, device=device)


def state_checks(state_before, state_after, block_words, is_first, execute) -> tuple:
    """(compress_transitions, state_continuity): every compression at once,
    and each row's state is the IV at a first round, else the previous
    row's output (shared with the code unpacker)."""
    dev = state_before.device
    expected_after = sha256.compress(state_before, block_words)
    true = torch.ones_like(execute)
    transitions = torch.where(execute, (expected_after == state_after).all(-1), true)
    iv = _h0(dev)
    prev_after = torch.cat([iv[None], state_after[:-1]])
    cont = torch.where(is_first[:, None], iv[None, :], prev_after)
    continuity = torch.where(execute, (state_before == cont).all(-1), true)
    return transitions, continuity


def eval_constraints(w: Sha256RoundWitness, config: Sha256RoundFunctionConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Row-parallel constraint evaluation on the witness's device; every
    entry must be all-True.  `window` places a block of rounds in its run
    (`parallel/auto.py`); None is the whole run."""
    N = config.max_rounds
    dev = w.round_execute.device
    res = {}
    ce = w.call_execute
    true_c = torch.ones_like(ce)
    true_n = torch.ones_like(w.round_execute)

    call_enc = encode_log_queries(w.calls)
    res["call_chain"] = queues.check_chain(w.call_chain, call_enc, ce)
    res["call_is_sha256_precompile"] = torch.where(
        ce, pc.address_is(w.calls.address, SHA256_PRECOMPILE_FORMAL_ADDRESS)
        & (w.calls.aux_byte == PRECOMPILE_AUX_BYTE), true_c)

    res["compress_transitions"], res["state_continuity"] = state_checks(
        w.state_before, w.state_after, w.block_words, w.round_is_first, w.round_execute)

    # block words == read memory words (BE)
    abi = abi_from_key(w.calls.key)
    ridx = torch.arange(N, device=dev)
    r0 = 2 * ridx
    r1 = r0 + 1
    expected_block = torch.cat([w.reads.value[r0].flip(-1), w.reads.value[r1].flip(-1)], dim=-1)
    res["block_words"] = torch.where(
        w.round_execute, (expected_block == w.block_words).all(-1), true_n)

    # read addressing: aligned words at input_offset + 2*round_in_call + j
    roff = pc.group_offsets(pc.group_starts(w.round_call), window)
    in_page = abi["input_page"][w.round_call]
    in_off = abi["input_offset"][w.round_call]
    read_ok0 = ((w.reads.memory_page[r0] == in_page)
                & (w.reads.index[r0] == ((in_off + 2 * roff) & M32)) & ~w.reads.rw_flag[r0])
    read_ok1 = ((w.reads.memory_page[r1] == in_page)
                & (w.reads.index[r1] == ((in_off + 2 * roff + 1) & M32)) & ~w.reads.rw_flag[r1])
    res["read_addressing"] = torch.where(w.round_execute, read_ok0 & read_ok1, true_n)

    # digest write: value limbs = LE repack of the final state of the call
    C = ce.shape[0]
    own = owned_rows(window, N, dev)
    contrib = torch.where((w.round_is_last & w.round_execute & own)[:, None], w.state_after,
                          torch.zeros_like(w.state_after))
    final_states = pc.scatter_add(C, w.round_call, contrib)

    def write_value_ok(final_states):
        expected_limbs = pc.bswap32(final_states & M32).flip(-1)  # limb[7-k] = bswap(H_k)
        return torch.where(ce, (w.writes.value == expected_limbs).all(-1), true_c)

    res["write_value"] = summed(final_states, write_value_ok, window)
    res["write_addressing"] = torch.where(
        ce, (w.writes.memory_page == abi["output_page"]) & (w.writes.index == abi["output_offset"])
        & w.writes.rw_flag, true_c)
    # num_rounds per call must match the executed rounds
    rounds_per_call = pc.scatter_add(C, w.round_call, w.round_execute & own)
    res["num_rounds"] = summed(
        rounds_per_call, lambda s: torch.where(ce, (s & M32) == abi["num_rounds"], true_c), window)

    res["mem_chain"] = queues.check_chain(w.mem_chain, w.mem_order_encodings, w.mem_order_execute)
    return res


all_ok = pc.all_ok

# row-sharded over the rounds (two reads a round): a round reads the
# previous round's output; its offset in its call carries the last call
# start before the block; the call, write and memory-queue fields stay
# whole on every member (the memory chain runs in the calls' order), their
# residuals computed on each and taken from the first; the digest and the
# round count of a call are sums of its rounds over the members
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 0),
    rows=frozenset({"round_execute", "round_call", "round_is_first", "round_is_last",
                    "block_words", "state_before", "state_after", "reads", "read_execute"}),
    entries={"reads": 2, "read_execute": 2},
    whole=frozenset({"call_chain", "call_is_sha256_precompile", "write_addressing",
                     "mem_chain"}),
    sums=frozenset({"write_value", "num_rounds"}),
    takes_window=True,
    carry_flag=lambda w: pc.group_starts(w.round_call),
    window_config=lambda config, rows: dataclasses.replace(config, max_rounds=rows),
)

# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


def _fsm_lanes(state, unit, off, mem_pos, unit_tail, mem_state):
    """the hidden FSM at each boundary: [state, unit index, offset in the
    unit, memory position, input-queue tail, memory-queue state]."""
    return torch.cat([state, unit[:, None], off[:, None], mem_pos[:, None], unit_tail, mem_state],
                     dim=-1)


def instance_compact_forms(w: Sha256RoundWitness, config: Sha256RoundFunctionConfig,
                           limit_rounds: int):
    """Multi-instance ClosedFormInput over the round axis, continuation
    across calls and mid-call (the Sha256RoundFunctionFSM role, ref
    sha256_round_function/input.rs).  FSM at boundary r: the sha256 state
    BEFORE round r, the in-call progress, the calls-queue state after fully
    consumed calls, and the memory-queue state at the call boundary (the
    pinned order absorbs a call's reads before its rounds, write after)."""
    N = config.max_rounds
    dev = w.round_execute.device
    bounds = pc.boundaries(N, limit_rounds, dev)
    C = w.call_execute.shape[0]
    rounds_per_call = pc.scatter_add(C + 1, w.round_call + 1, w.round_execute)
    reads_per_call = 2 * rounds_per_call
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(reads_per_call[1:] + 1, 0) & M32])
    mem_pos_call = (prefix[:-1] + reads_per_call[1:]) & M32
    round_off = pc.offset_within_group(w.round_is_first)

    in_range = bounds < N
    bi = bounds.clamp(max=N - 1)
    live = in_range & w.round_execute[bi]
    call = torch.where(live, w.round_call[bi], torch.full_like(bi, C))
    call_u = call.clamp(max=C - 1)
    off = torch.where(in_range, round_off[bi], torch.zeros_like(bi))
    state = torch.where(live[:, None], w.state_before[bi], torch.zeros_like(w.state_before[bi]))
    n_mem = int(w.mem_order_execute.sum())
    done_calls = torch.where(live, call, torch.full_like(call, w.num_calls))
    mem_pos = torch.where(live, mem_pos_call[call_u], torch.full_like(call, n_mem))
    mem_state = w.mem_chain[mem_pos.clamp(max=w.mem_chain.shape[0] - 1)]
    fsm = _fsm_lanes(state, call, off, mem_pos, w.call_chain[done_calls], mem_state)
    return pc.multi_instance_forms(w.call_chain, w.num_calls, w.mem_chain, n_mem, fsm,
                                   int(w.round_execute.sum()), limit_rounds)


def instance_compact_form(w: Sha256RoundWitness, config: Sha256RoundFunctionConfig):
    """Single-instance ClosedFormInput (same precompile I/O shape as keccak)."""
    return pc.single_instance_form(w.call_chain, w.num_calls, w.mem_chain,
                                   int(w.mem_order_execute.sum()))
