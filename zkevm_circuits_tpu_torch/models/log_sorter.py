"""log_sorter, circuit types 11/12: events / L1-messages deduplicator (the
JAX package's `models/log_sorter.py`).

Reference parity: `src/log_sorter/` (entry `sort_and_deduplicate_events_entry_point`
mod.rs:34-232, inner `repack_and_prove_events_rollbacks_inner` mod.rs:234-441,
I/O types input.rs).  The same circuit is instantiated twice by the scheduler
(events, L1 messages).  Semantics replicated:

  * two narrow (width-4) log queues popped in lockstep; equal lengths
    (mod.rs:275-279); grand products over the 20-element LogQuery encodings
    with FS challenges from both initial tails (mod.rs:113-132).
  * every popped item (both queues) must be a write (mod.rs:294-297, 317-320).
  * sort key = timestamp only; non-strict ascending (equal only for a
    forward/rollback pair) (mod.rs:326-334).
  * rollback-cancellation: a new timestamp must be non-rollback; a repeated
    timestamp must be the rollback of the previous log, and their key and
    written_value must agree (mod.rs:336-363).
  * the surviving (non-rolled-back) previous item is pushed into the result
    queue with cleaned fields: read_value=0, rw_flag=false, aux_byte=0,
    rollback=false, timestamp=0 (mod.rs:367-397); a finalization push after
    the last pop when the queue drained (mod.rs:405-435).

Flat rows = pops; one extra virtual row for the finalization push; per-row
chain states for all three queues, so the constraint pass is row-parallel.
Witness generation: `generate_witness` takes query tensors and runs the three
chains through the native runtime in one call (`backend="host"`) or the step
loop (`backend="device"`); `generate_witness_host_tapes` takes numpy tapes,
encodes and deduplicates them with numpy, runs the chains natively and
uploads once (the production-scale path).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base_structures.log_query import (
    LOG_QUERY_PACKED_WIDTH,
    LogQueries,
    encode_log_queries,
    encode_log_queries_np,
)
from ..ops import gf, queues
from ..ops.queues import QueueState
from ..runtime import native
from ..utils import challenges as chal
from ..utils import protocol
from ..utils.device import resolve_device
from ..utils.shard_plan import ShardPlan
from .demux_log_queue import pad_log_queries

NUM_REPETITIONS = chal.DEFAULT_NUM_REPETITIONS
NUM_CHALLENGES = LOG_QUERY_PACKED_WIDTH + 1


@dataclasses.dataclass(frozen=True)
class LogSorterConfig:
    limit: int


@dataclasses.dataclass(frozen=True)
class LogSorterWitness:
    n: int
    execute: torch.Tensor  # (N,)
    unsorted: LogQueries  # (N,)
    sorted: LogQueries  # (N,)
    enc_unsorted: torch.Tensor  # (N, 20)
    enc_sorted: torch.Tensor  # (N, 20)
    chain_unsorted: torch.Tensor  # (N+1, 4)
    chain_sorted: torch.Tensor  # (N+1, 4)
    challenges: torch.Tensor  # (2, 21)
    lhs: torch.Tensor  # (N, 2)
    rhs: torch.Tensor  # (N, 2)
    result_items: LogQueries  # (N+1,) cleaned previous items
    result_add: torch.Tensor  # (N+1,) bool
    result_chain: torch.Tensor  # (N+2, 4)
    result_count: torch.Tensor  # (N+1,) int64 cumulative pushes


def _shift_one(q: LogQueries, extra_last: bool = False) -> LogQueries:
    """prev-row view: row i -> q[i-1]; row 0 -> zeros.  If extra_last, append
    one more row equal to q[N-1] (the finalization row's 'previous')."""
    zero = LogQueries.zeros((1,), q.timestamp.device)
    return LogQueries(*[
        _shift_field(getattr(q, f.name), getattr(zero, f.name), extra_last)
        for f in dataclasses.fields(LogQueries)
    ])


def _shift_field(a: torch.Tensor, zero: torch.Tensor, extra_last: bool) -> torch.Tensor:
    parts = [zero, a[:-1]]
    if extra_last:
        parts.append(a[-1:])
    return torch.cat(parts)


def _cleaned(prev: LogQueries) -> LogQueries:
    """The result-queue push payload (ref mod.rs:383-395)."""
    z = torch.zeros_like(prev.timestamp)
    return LogQueries(
        address=prev.address,
        key=prev.key,
        read_value=torch.zeros_like(prev.read_value),
        written_value=prev.written_value,
        aux_byte=z,
        rw_flag=torch.zeros_like(prev.rw_flag),
        rollback=torch.zeros_like(prev.rollback),
        is_service=prev.is_service,
        shard_id=prev.shard_id,
        tx_number_in_block=prev.tx_number_in_block,
        timestamp=z,
    )


def _row_flags(sorted_q: LogQueries, execute: torch.Tensor, total: int) -> dict:
    """Per-row dedup logic flags, flat across instances."""
    dev = execute.device
    row = torch.arange(total, device=dev)
    prev = (row - 1).clamp(min=0)
    first = row == 0
    prev_ts = torch.where(first, torch.zeros_like(row), sorted_q.timestamp[prev])
    trivial = ~execute
    prev_trivial = first | ~execute[prev]
    prev_rollback = ~first & sorted_q.rollback[prev]
    same_log = prev_ts == sorted_q.timestamp
    order_ok = prev_ts <= sorted_q.timestamp
    add = (~prev_trivial) & (~same_log | trivial) & (~prev_rollback)
    return dict(
        prev_ts=prev_ts,
        trivial=trivial,
        prev_trivial=prev_trivial,
        prev_rollback=prev_rollback,
        same_log=same_log,
        order_ok=order_ok,
        add=add,
    )


def _final_add(sorted_q: LogQueries, execute: torch.Tensor) -> torch.Tensor:
    """finalization row: previous = last row, add iff it executed and is not
    a rollback (queue drained is implied at the end of the padded layout)."""
    return execute[-1:] & ~sorted_q.rollback[-1:]


def _finish_stage_host(unsorted, sorted_q, execute, enc_u, enc_s, chain_u, chain_s,
                      result_items, result_add, result_chain, n) -> LogSorterWitness:
    """Everything after the sponge chains (challenges, running products,
    counts), on the device of the inputs; both witness paths end here."""
    total = execute.shape[0]
    zeros4 = gf.zeros((4,), execute.device)
    fs = chal.produce_fs_challenges(
        QueueState(zeros4, chain_u[total], n), QueueState(zeros4, chain_s[total], n),
        NUM_CHALLENGES, NUM_REPETITIONS,
    )
    ones = gf.ones((NUM_REPETITIONS,), execute.device)
    lhs = chal.product_accumulate(
        chal.masked_factors(chal.grand_product_factors(enc_u, fs), execute), ones)
    rhs = chal.product_accumulate(
        chal.masked_factors(chal.grand_product_factors(enc_s, fs), execute), ones)
    return LogSorterWitness(
        n=n, execute=execute, unsorted=unsorted, sorted=sorted_q,
        enc_unsorted=enc_u, enc_sorted=enc_s, chain_unsorted=chain_u,
        chain_sorted=chain_s, challenges=fs, lhs=lhs, rhs=rhs,
        result_items=result_items, result_add=result_add,
        result_chain=result_chain,
        result_count=torch.cumsum(result_add.to(torch.int64), dim=0),
    )


def generate_witness(
    unsorted: LogQueries,
    sorted_q: LogQueries,
    config: LogSorterConfig,
    backend: str = "host",
) -> LogSorterWitness:
    """The full trace from the two log tapes, on the tapes' device.
    backend: how the three sponge chains run (`queues.simulate_chains`)."""
    n = unsorted.shape[0]
    if sorted_q.shape[0] != n:
        raise ValueError("queues must pop in lockstep")
    dev = unsorted.timestamp.device
    total = max(1, -(-n // config.limit)) * config.limit
    unsorted = pad_log_queries(unsorted, total)
    sorted_q = pad_log_queries(sorted_q, total)
    execute = torch.arange(total, device=dev) < n

    enc_u = encode_log_queries(unsorted)
    enc_s = encode_log_queries(sorted_q)
    flags = _row_flags(sorted_q, execute, total)
    result_add = torch.cat([flags["add"], _final_add(sorted_q, execute)])
    result_items = _cleaned(_shift_one(sorted_q, extra_last=True))  # (N+1,)
    chain_u, chain_s, result_chain = queues.simulate_chains(
        queues.NARROW_STATE_WIDTH,
        [(enc_u, execute), (enc_s, execute), (encode_log_queries(result_items), result_add)],
        backend,
    )
    return _finish_stage_host(unsorted, sorted_q, execute, enc_u, enc_s, chain_u, chain_s,
                         result_items, result_add, result_chain, n)


def eval_constraints(w: LogSorterWitness, config: LogSorterConfig) -> dict:
    """Row-parallel constraint evaluation; every entry must be all-True."""
    total = w.execute.shape[0]
    dev = w.execute.device
    s = w.sorted
    true = torch.ones((), dtype=torch.bool, device=dev)

    chain_u_ok = queues.check_chain(w.chain_unsorted, w.enc_unsorted, w.execute)
    chain_s_ok = queues.check_chain(w.chain_sorted, w.enc_sorted, w.execute)

    zeros4 = gf.zeros((4,), dev)
    fs = chal.produce_fs_challenges(
        QueueState(zeros4, w.chain_unsorted[total], w.n),
        QueueState(zeros4, w.chain_sorted[total], w.n),
        NUM_CHALLENGES, NUM_REPETITIONS,
    )
    challenges_ok = gf.equal(fs, w.challenges).all()

    factors_u = chal.masked_factors(chal.grand_product_factors(w.enc_unsorted, fs), w.execute)
    factors_s = chal.masked_factors(chal.grand_product_factors(w.enc_sorted, fs), w.execute)
    ones = gf.ones((1, NUM_REPETITIONS), dev)
    lhs_ok = gf.equal(w.lhs, gf.mul(torch.cat([ones, w.lhs[:-1]]), factors_u)).all(-1)
    rhs_ok = gf.equal(w.rhs, gf.mul(torch.cat([ones, w.rhs[:-1]]), factors_s)).all(-1)

    enc_u_ok = gf.equal(encode_log_queries(w.unsorted), w.enc_unsorted).all(-1)
    enc_s_ok = gf.equal(encode_log_queries(s), w.enc_sorted).all(-1)

    # writes only (both queues) where popped
    writes_ok = torch.where(w.execute, w.unsorted.rw_flag & s.rw_flag, true)

    flags = _row_flags(s, w.execute, total)
    order_ok = torch.where(w.execute, flags["order_ok"], true)
    # new timestamp (different, nontrivial) => not rollback
    diff_ok = torch.where(w.execute & ~flags["same_log"], ~s.rollback, true)
    # repeated timestamp (nontrivial) => must be rollback
    same_ok = torch.where(w.execute & flags["same_log"], s.rollback, true)
    # body equality for the rollback pair
    prev_items = _shift_one(s)
    body_eq = (s.key == prev_items.key).all(-1) & (s.written_value == prev_items.written_value).all(-1)
    body_ok = torch.where(flags["same_log"] & ~flags["prev_trivial"] & w.execute, body_eq, true)

    # result queue: add flags + cleaned payloads + chain
    expected_add = torch.cat([flags["add"], _final_add(s, w.execute)])
    add_ok = expected_add == w.result_add
    expected_items = _cleaned(_shift_one(s, extra_last=True))
    items_ok = torch.ones(total + 1, dtype=torch.bool, device=dev)
    for f in dataclasses.fields(LogQueries):
        a, b = getattr(expected_items, f.name), getattr(w.result_items, f.name)
        items_ok = items_ok & (a == b).reshape(a.shape[0], -1).all(-1)
    result_chain_ok = queues.check_chain(
        w.result_chain, encode_log_queries(w.result_items), w.result_add)
    prev_count = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), w.result_count[:-1]])
    count_ok = w.result_count == prev_count + w.result_add.to(torch.int64)

    final_eq = gf.equal(w.lhs[total - 1], w.rhs[total - 1]).all()

    return {
        "chain_unsorted": chain_u_ok,
        "chain_sorted": chain_s_ok,
        "challenges": challenges_ok,
        "lhs_transitions": lhs_ok,
        "rhs_transitions": rhs_ok,
        "encoding_unsorted": enc_u_ok,
        "encoding_sorted": enc_s_ok,
        "writes_only": writes_ok,
        "sort_order": order_ok,
        "new_log_not_rollback": diff_ok,
        "repeated_log_is_rollback": same_ok,
        "rollback_body_equal": body_ok,
        "result_add_flags": add_ok,
        "result_items": items_ok,
        "result_chain": result_chain_ok,
        "result_count": count_ok,
        "grand_product_final": final_eq,
    }


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())


# row-sharded: a row reads the previous row, the result queue one entry
# more; the challenges come from the run's queue tails
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 1),
    replicated=frozenset({"challenges"}),
    tails=frozenset({"chain_unsorted", "chain_sorted"}),
    last=frozenset({"challenges", "grand_product_final"}),
)


# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


# ---------------------------------------------------------------------------
# production-scale host pipeline (numpy tapes + native C++ narrow chains)
# ---------------------------------------------------------------------------


def generate_witness_host_tapes(
    tapes_unsorted: dict, tapes_sorted: dict, config: LogSorterConfig, device=None
) -> LogSorterWitness:
    """Full host pipeline: numpy LogQuery tapes in (one array per field,
    limbed fields (n, limbs) u32), numpy encodings and dedup flags, the
    three chains through the native runtime in one call, one upload to
    `device` (None: the card, `utils.device.default_device`), then the
    device stage."""
    device = resolve_device(device)
    n = int(tapes_unsorted["timestamp"].shape[0])
    total = max(1, -(-n // config.limit)) * config.limit

    def pad(t):
        out = {}
        for k, v in t.items():
            v = np.asarray(v)
            if v.shape[0] < total:
                v = np.concatenate([v, np.zeros((total - v.shape[0],) + v.shape[1:], v.dtype)])
            out[k] = v
        return out

    tu, ts_ = pad(tapes_unsorted), pad(tapes_sorted)
    execute_np = np.arange(total) < n
    enc_u_np = encode_log_queries_np(**tu)
    enc_s_np = encode_log_queries_np(**ts_)

    # dedup flags + result payloads (numpy mirror of _row_flags/_cleaned)
    ts_col = ts_["timestamp"].astype(np.uint64)
    prev_ts = np.concatenate([[0], ts_col[:-1]]).astype(np.uint64)
    prev_trivial = np.concatenate([[True], ~execute_np[:-1]])
    prev_rollback = np.concatenate([[False], ts_["rollback"][:-1].astype(bool)])
    same_log = prev_ts == ts_col  # row 0 compares against 0 (as on device)
    trivial = ~execute_np
    add = (~prev_trivial) & (~same_log | trivial) & (~prev_rollback)
    final_add = bool(execute_np[total - 1]) and not bool(ts_["rollback"][total - 1])
    result_add_np = np.concatenate([add, [final_add]])

    def shift_extra(v):
        prev = np.concatenate([np.zeros((1,) + v.shape[1:], v.dtype), v[:-1]])
        return np.concatenate([prev, v[total - 1 : total]])

    result_tape = dict(
        address=shift_extra(ts_["address"]),
        key=shift_extra(ts_["key"]),
        read_value=np.zeros((total + 1, 8), ts_["read_value"].dtype),
        written_value=shift_extra(ts_["written_value"]),
        aux_byte=np.zeros(total + 1, ts_["aux_byte"].dtype),
        rw_flag=np.zeros(total + 1, bool),
        rollback=np.zeros(total + 1, bool),
        is_service=shift_extra(ts_["is_service"].astype(bool)),
        shard_id=shift_extra(ts_["shard_id"]),
        tx_number_in_block=shift_extra(ts_["tx_number_in_block"]),
        timestamp=np.zeros(total + 1, ts_["timestamp"].dtype),
    )
    enc_r_np = encode_log_queries_np(**result_tape)

    # native chains (3 in parallel; the result chain one row longer)
    enc_stack = np.zeros((3, total + 1, 20), np.uint64)
    enc_stack[0, :total] = enc_u_np
    enc_stack[1, :total] = enc_s_np
    enc_stack[2] = enc_r_np
    ex_stack = np.zeros((3, total + 1), np.uint8)
    ex_stack[0, :total] = execute_np
    ex_stack[1, :total] = execute_np
    ex_stack[2] = result_add_np
    chains = native.narrow_chains(enc_stack, ex_stack, np.zeros((3, 4), np.uint64))

    return _finish_stage_host(
        LogQueries.from_numpy(tu, device),
        LogQueries.from_numpy(ts_, device),
        torch.from_numpy(execute_np).to(device),
        gf.from_u64(enc_u_np, device),
        gf.from_u64(enc_s_np, device),
        gf.from_u64(chains[0][: total + 1], device),
        gf.from_u64(chains[1][: total + 1], device),
        LogQueries.from_numpy(result_tape, device),
        torch.from_numpy(result_add_np).to(device),
        gf.from_u64(chains[2], device),
        n,
    )


# ---------------------------------------------------------------------------
# ClosedFormInput per instance
# ---------------------------------------------------------------------------


def _encode_log_query_flat(q: LogQueries) -> torch.Tensor:
    """36-element CSVarLengthEncodable field-order encoding of a LogQuery."""
    b = protocol.bool_to_gf
    return torch.cat(
        [
            q.address,
            q.key,
            q.read_value,
            q.written_value,
            q.aux_byte.unsqueeze(-1),
            b(q.rw_flag).unsqueeze(-1),
            b(q.rollback).unsqueeze(-1),
            b(q.is_service).unsqueeze(-1),
            q.shard_id.unsqueeze(-1),
            q.tx_number_in_block.unsqueeze(-1),
            q.timestamp.unsqueeze(-1),
        ],
        dim=-1,
    )


def instance_compact_forms(
    w: LogSorterWitness, config: LogSorterConfig
) -> protocol.ClosedFormInputCompactForm:
    """Per-instance compact forms.  FSM mirrors EventsDeduplicatorFSMInputOutput
    (ref input.rs:28-36): [lhs(2), rhs(2), unsorted_qs(9), intermediate_qs(9),
    final_result_qs(9), previous_key(1), previous_item(36)] = 68 elements,
    batched over the k + 1 boundaries."""
    dev = w.execute.device
    total = w.execute.shape[0]
    limit = config.limit
    k = total // limit
    bounds = torch.arange(k + 1, device=dev) * limit
    prev_row = (bounds - 1).clamp(min=0)
    at_start = bounds == 0
    col = at_start.unsqueeze(-1)
    ones = gf.ones((k + 1, NUM_REPETITIONS), dev)
    remaining = w.n - bounds.clamp(max=w.n)

    def qs(chain):
        return protocol.encode_queue_state_generic(
            chain[bounds], chain[total].expand(k + 1, -1), remaining)

    def sel(v):
        return torch.where(at_start.reshape((-1,) + (1,) * (v.dim() - 1)), torch.zeros_like(v), v)

    prev_item = w.sorted[prev_row]
    prev_item = LogQueries(*[sel(getattr(prev_item, f.name)) for f in dataclasses.fields(LogQueries)])
    fsm_states = torch.cat(
        [
            torch.where(col, ones, w.lhs[prev_row]),
            torch.where(col, ones, w.rhs[prev_row]),
            qs(w.chain_unsorted),
            qs(w.chain_sorted),
            protocol.result_queue_state_at(w.result_chain, w.result_count, bounds, total),
            sel(w.sorted.timestamp[prev_row]).unsqueeze(-1),
            _encode_log_query_flat(prev_item),
        ],
        dim=-1,
    )  # (k + 1, 68)

    zeros4 = gf.zeros((4,), dev)
    obs_in = torch.cat([
        protocol.encode_queue_state_generic(zeros4, w.chain_unsorted[total], w.n),
        protocol.encode_queue_state_generic(zeros4, w.chain_sorted[total], w.n),
    ]).expand(k, -1)
    # observable output: the final result queue state (zeros unless completed:
    # the compact-form masking zeroes it for the other instances)
    obs_out = protocol.encode_queue_state_generic(
        zeros4, w.result_chain[total + 1], w.result_count[total]).expand(k, -1)
    inst = torch.arange(k, device=dev)
    return protocol.compact_form_from_parts(
        inst == 0, (inst + 1) * limit >= w.n, obs_in, obs_out, fsm_states[:-1], fsm_states[1:]
    )
