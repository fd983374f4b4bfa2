"""code_unpacker_sha256, circuit type 3: the code decommitter (the JAX
package's `models/code_unpacker_sha256.py`).

Reference parity: `src/code_unpacker_sha256/`
(`unpack_code_into_memory_inner` mod.rs:150-430).  Semantics replicated:

  * pops the deduplicated decommit queue; code_hash limb[7] packs
    [length_in_words : u16 | version_byte<<8 : u16]; the version byte must
    match ContractCodeSha256::VERSION_BYTE == 1 (mod.rs:195-209).
  * length_in_words is odd (Era invariant); rounds = (length+1)/2; each round
    writes 2 code words to (page, index++) at the request timestamp — except
    the final round which writes only the first word (mod.rs:310-345).
  * sha256 runs over the BE code words; the final round's second half-block
    is replaced by the padding [1<<31, 0..0, length_in_bits]
    (mod.rs:352-376).
  * at the final round the digest (as u256 limbs [H7..H1, 0], i.e. the code
    hash with limb 7 zeroed) must equal the requested hash (mod.rs:380-404).

Rows: sha256 rounds flat across requests.  The witness is built on the host
(`sha256.compress_ref`), its memory and request chains by
`queues.simulate_chains`; the checks are row-parallel, the compressions one
batched `sha256.compress`, on the witness's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..base_structures.decommit_query import DecommitQueries, encode_decommit_queries
from ..base_structures.memory_query import MemoryQueries, encode_memory_queries
from ..ops import queues, sha256
from ..utils.device import resolve_device
from ..utils.shard_plan import RowWindow, ShardPlan, owned_rows, summed
from . import precompile_common as pc
from .sha256_round_function import _fsm_lanes, state_checks

VERSION_BYTE = 1  # zkevm_opcode_defs ContractCodeSha256::VERSION_BYTE
M32 = pc.M32


@dataclasses.dataclass(frozen=True)
class CodeUnpackerConfig:
    max_rounds: int


@dataclasses.dataclass(frozen=True)
class CodeUnpackerWitness:
    num_requests: int
    requests: DecommitQueries  # (Q,)
    request_execute: torch.Tensor
    request_chain: torch.Tensor  # (Q+1, 12)
    # per-round columns (N = max_rounds)
    round_execute: torch.Tensor  # (N,)
    round_request: torch.Tensor  # (N,) request index
    round_is_first: torch.Tensor
    round_is_last: torch.Tensor
    word0: torch.Tensor  # (N, 8) u32 limbs (LE), code word 0
    word1: torch.Tensor  # (N, 8)
    block_words: torch.Tensor  # (N, 16) sha256 BE input words
    state_before: torch.Tensor  # (N, 8)
    state_after: torch.Tensor  # (N, 8)
    writes: MemoryQueries  # (2N,) memory writes (word1 slot masked on final)
    write_execute: torch.Tensor  # (2N,)
    mem_chain: torch.Tensor  # (2N+1, 12)


def make_request(code_words: list, page: int, timestamp: int) -> dict:
    """A DecommitQuery dict for a bytecode of odd word length, with its
    canonical versioned hash: sha256 of the BE words with the top 4 bytes
    replaced by [version << 8 : u16 | length in words : u16]."""
    W = len(code_words)
    if W % 2 != 1:
        raise ValueError("Era bytecode length in words must be odd")
    data = b"".join(w.to_bytes(32, "big") for w in code_words)
    hash_int = int.from_bytes(sha256.sha256_ref(data), "big")
    hash_int &= (1 << 224) - 1  # drop top 4 bytes (H0)
    hash_int |= ((VERSION_BYTE << 8) << 16 | W) << 224
    return dict(code_hash=hash_int, page=page, timestamp=timestamp, is_first=True)


def _limbs(v: int) -> list:
    return [(v >> (32 * k)) & M32 for k in range(8)]


def generate_witness(requests: list, code_store: dict, config: CodeUnpackerConfig,
                     mem_init_state=None, device=None) -> CodeUnpackerWitness:
    """requests: DecommitQuery dicts (see make_request).
    code_store: {code_hash_int: [word_int, ...]}.
    mem_init_state ((12,) u64 or field tensor) threads the global memory
    queue (scheduler mod.rs:284-349).  `device=None` is the card."""
    device = resolve_device(device)
    Q = max(len(requests), 1)
    N = config.max_rounds

    rounds = []
    write_rows = []
    for qi, req in enumerate(requests):
        ch = int(req["code_hash"])
        W = ch >> 224 & 0xFFFF
        words = code_store[ch]
        if len(words) != W:
            raise ValueError(f"request {qi}: {len(words)} code words, the hash says {W}")
        ts, page = int(req["timestamp"]), int(req["page"])
        state = list(sha256.H0)
        nrounds = (W + 1) // 2
        bitlen = W * 32 * 8
        for r in range(nrounds):
            final = r == nrounds - 1
            w0 = words[2 * r]
            w1 = words[2 * r + 1] if not final else 0
            blk_bytes = w0.to_bytes(32, "big") + w1.to_bytes(32, "big")
            block = [int.from_bytes(blk_bytes[4 * j: 4 * j + 4], "big") for j in range(16)]
            if final:
                block[8:] = [1 << 31, 0, 0, 0, 0, 0, 0, bitlen]
            new_state = sha256.compress_ref(state, block)
            rounds.append(dict(req=qi, first=r == 0, last=final, w0=w0, w1=w1,
                               block=block, before=list(state), after=list(new_state)))
            state = new_state
            write_rows.append(dict(timestamp=ts, memory_page=page, index=2 * r, rw_flag=True,
                                   is_ptr=False, value=w0, execute=True))
            write_rows.append(dict(timestamp=ts, memory_page=page, index=2 * r + 1, rw_flag=True,
                                   is_ptr=False, value=w1, execute=not final))
    if len(rounds) > N:
        raise ValueError(f"{len(rounds)} unpack rounds do not fit max_rounds={N}")

    n_r = len(rounds)
    blk = np.zeros((N, 16), np.int64)
    before = np.tile(np.array(sha256.H0, np.int64), (N, 1))
    after = np.zeros((N, 8), np.int64)
    w0 = np.zeros((N, 8), np.int64)
    w1 = np.zeros((N, 8), np.int64)
    rreq = np.zeros(N, np.int64)
    rfirst = np.zeros(N, bool)
    rlast = np.zeros(N, bool)
    if n_r:
        blk[:n_r] = [r["block"] for r in rounds]
        before[:n_r] = [r["before"] for r in rounds]
        after[:n_r] = [r["after"] for r in rounds]
        w0[:n_r] = [_limbs(r["w0"]) for r in rounds]
        w1[:n_r] = [_limbs(r["w1"]) for r in rounds]
        rreq[:n_r] = [r["req"] for r in rounds]
        rfirst[:n_r] = [r["first"] for r in rounds]
        rlast[:n_r] = [r["last"] for r in rounds]

    wr_exec = np.zeros(2 * N, bool)
    wr_exec[:len(write_rows)] = [r["execute"] for r in write_rows]
    writes_q = pc.memory_rows(write_rows, 2 * N, device)
    wr_exec_t = torch.from_numpy(wr_exec).to(device)
    mem_enc = encode_memory_queries(writes_q)

    req_pad = list(requests) + [dict(code_hash=0, page=0, timestamp=0, is_first=False)] * (
        Q - len(requests))
    reqs = DecommitQueries.from_lists(req_pad, device)
    req_exec = pc.executed(Q, len(requests), device)
    # both chains are full-state: one native call
    mem_chain, req_chain = queues.simulate_chains(
        queues.FULL_STATE_WIDTH,
        [(mem_enc, wr_exec_t), (encode_decommit_queries(reqs), req_exec)],
        init=[mem_init_state, None])

    def t(a):
        return torch.from_numpy(a).to(device)

    return CodeUnpackerWitness(
        num_requests=len(requests),
        requests=reqs,
        request_execute=req_exec,
        request_chain=req_chain,
        round_execute=pc.executed(N, n_r, device),
        round_request=t(rreq),
        round_is_first=t(rfirst),
        round_is_last=t(rlast),
        word0=t(w0),
        word1=t(w1),
        block_words=t(blk),
        state_before=t(before),
        state_after=t(after),
        writes=writes_q,
        write_execute=wr_exec_t,
        mem_chain=mem_chain,
    )


def eval_constraints(w: CodeUnpackerWitness, config: CodeUnpackerConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Row-parallel constraint evaluation on the witness's device; every
    entry must be all-True.  `window` places a block of rounds in its run
    (`parallel/auto.py`); None is the whole run."""
    N = config.max_rounds
    dev = w.round_execute.device
    res = {}
    true_q = torch.ones_like(w.request_execute)
    true_n = torch.ones_like(w.round_execute)

    req_enc = encode_decommit_queries(w.requests)
    res["request_chain"] = queues.check_chain(w.request_chain, req_enc, w.request_execute)
    # versioned hash: limb7 top u16 == version<<8, low u16 = length (odd)
    limb7 = w.requests.code_hash[..., 7]
    version_ok = (limb7 >> 16) == (VERSION_BYTE << 8)
    length = limb7 & 0xFFFF
    res["versioned_hash"] = torch.where(w.request_execute, version_ok & (length % 2 == 1), true_q)

    # rounds per request match (length+1)/2
    Q = w.request_execute.shape[0]
    rounds_per_req = pc.scatter_add(Q, w.round_request,
                                    w.round_execute & owned_rows(window, N, dev))
    res["round_count"] = summed(
        rounds_per_req,
        lambda s: torch.where(w.request_execute, (s & M32) == (length + 1) // 2, true_q), window)

    # sha256 block construction from code words
    be0, be1 = w.word0.flip(-1), w.word1.flip(-1)
    bitlen = (length[w.round_request] * 256) & M32
    zeros = torch.zeros(N, dtype=torch.int64, device=dev)
    pad_half = torch.stack([torch.full((N,), 1 << 31, dtype=torch.int64, device=dev)]
                           + [zeros] * 6 + [bitlen], dim=-1)
    expected_blk = torch.where(w.round_is_last[:, None], torch.cat([be0, pad_half], dim=-1),
                               torch.cat([be0, be1], dim=-1))
    res["block_construction"] = torch.where(
        w.round_execute, (expected_blk == w.block_words).all(-1), true_n)

    # compression transitions + IV reset
    res["compress_transitions"], res["state_continuity"] = state_checks(
        w.state_before, w.state_after, w.block_words, w.round_is_first, w.round_execute)

    # final-round digest equals the cutted hash: limbs [H7..H1, 0]
    digest_limbs = torch.cat([w.state_after.flip(-1)[..., :7],
                              torch.zeros((N, 1), dtype=torch.int64, device=dev)], dim=-1)
    cutted = w.requests.code_hash[w.round_request].clone()
    cutted[..., 7] = 0
    res["hash_equality"] = torch.where(w.round_execute & w.round_is_last,
                                       (digest_limbs == cutted).all(-1), true_n)

    # memory writes: correct page/index/ts, values = code words, word1 masked
    # on final rounds
    ridx = torch.arange(N, device=dev)
    roff = pc.group_offsets(pc.group_starts(w.round_request), window)
    page = w.requests.page[w.round_request]
    ts = w.requests.timestamp[w.round_request]
    i0, i1 = 2 * ridx, 2 * ridx + 1
    wq = w.writes
    ok0 = ((wq.memory_page[i0] == page) & (wq.index[i0] == ((2 * roff) & M32))
           & (wq.timestamp[i0] == ts) & wq.rw_flag[i0] & (wq.value[i0] == w.word0).all(-1))
    ok1 = ((wq.memory_page[i1] == page) & (wq.index[i1] == ((2 * roff + 1) & M32))
           & (wq.value[i1] == w.word1).all(-1))
    res["write_word0"] = torch.where(w.round_execute, ok0, true_n)
    res["write_word1"] = torch.where(w.round_execute & ~w.round_is_last, ok1, true_n)
    exec_ok0 = w.write_execute[i0] == w.round_execute
    exec_ok1 = w.write_execute[i1] == (w.round_execute & ~w.round_is_last)
    res["write_execute_flags"] = exec_ok0 & exec_ok1

    res["mem_chain"] = queues.check_chain(w.mem_chain, encode_memory_queries(w.writes),
                                          w.write_execute)
    return res


all_ok = pc.all_ok

# row-sharded over the rounds (two memory writes a round, the memory chain
# over them): a round reads the previous round's output; its offset in its
# request carries the last request start before the block; the request
# fields stay whole on every member, their residuals computed on each and
# taken from the first; a request's round count is a sum over the members
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 0),
    rows=frozenset({"round_execute", "round_request", "round_is_first", "round_is_last",
                    "word0", "word1", "block_words", "state_before", "state_after", "writes",
                    "write_execute", "mem_chain"}),
    entries={"writes": 2, "write_execute": 2, "mem_chain": 2},
    whole=frozenset({"request_chain", "versioned_hash"}),
    sums=frozenset({"round_count"}),
    takes_window=True,
    carry_flag=lambda w: pc.group_starts(w.round_request),
    window_config=lambda config, rows: dataclasses.replace(config, max_rounds=rows),
)

# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


def instance_compact_forms(w: CodeUnpackerWitness, config: CodeUnpackerConfig,
                           limit_rounds: int):
    """Multi-instance ClosedFormInput over the unpack-round axis,
    continuation across and INSIDE decommit requests (the
    CodeDecommitterFSM role, ref code_decommiter/input.rs).  FSM at
    boundary r: the running sha256 state, request progress, the request
    queue consumed so far, and the memory queue after the writes emitted by
    rounds < r (2 per round, the final round's second slot masked)."""
    N = config.max_rounds
    dev = w.round_execute.device
    bounds = pc.boundaries(N, limit_rounds, dev)
    Q = w.request_execute.shape[0]
    write_prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              torch.cumsum(w.write_execute.to(torch.int64), 0)])
    round_off = pc.offset_within_group(w.round_is_first)

    in_range = bounds < N
    bi = bounds.clamp(max=N - 1)
    live = in_range & w.round_execute[bi]
    req = torch.where(live, w.round_request[bi], torch.full_like(bi, Q))
    off = torch.where(in_range, round_off[bi], torch.zeros_like(bi))
    state = torch.where(live[:, None], w.state_before[bi], torch.zeros_like(w.state_before[bi]))
    done = torch.where(live, req, torch.full_like(req, w.num_requests))
    n_mem = int(w.write_execute.sum())
    mem_pos = torch.where(live, write_prefix[2 * bi], torch.full_like(bi, n_mem))
    mem_state = w.mem_chain[mem_pos.clamp(max=w.mem_chain.shape[0] - 1)]
    fsm = _fsm_lanes(state, req, off, mem_pos, w.request_chain[done], mem_state)
    return pc.multi_instance_forms(w.request_chain, w.num_requests, w.mem_chain, n_mem, fsm,
                                   int(w.round_execute.sum()), limit_rounds)


def instance_compact_form(w: CodeUnpackerWitness, config: CodeUnpackerConfig):
    """Single-instance ClosedFormInput (CodeDecommitterInputData shape:
    deduped decommit queue + memory queue; output = final memory queue)."""
    return pc.single_instance_form(w.request_chain, w.num_requests, w.mem_chain,
                                   int(w.write_execute.sum()))
