"""storage_validity_by_grand_product, circuit type 9: storage-log dedup/sort
(the JAX package's `models/storage_validity.py`).

Reference parity: `src/storage_validity_by_grand_product/` (entry
mod.rs:166-506, inner `sort_and_deduplicate_storage_access_inner`
mod.rs:510-897, I/O input.rs).  Semantics replicated:

  * `TimestampedStorageLogRecord` = LogQuery + extra 32-bit timestamp packed
    into encoding element 19 at bit offset 8 (mod.rs:63-95); the unsorted
    side gets the extension on the fly with timestamp = global cycle index
    (mod.rs:584-610).
  * grand products over the 20-element extended encodings; challenges from
    the two observable-input tails.
  * shard_id of every sorted record must equal shard_id_to_process
    (mod.rs:612-614).
  * ordering: packed key [key[0..8], address[0..5]] LSW-first non-strict
    ascending; equal keys => strictly increasing timestamps
    (mod.rs:635-648).
  * per-cell rollback-aware state machine (mod.rs:654-833): tracks
    {base_value, current_value, rollback depth, explicit-read-at-depth-0};
    on a cell switch emits a protective read (rw=false) or a write
    (rw=true, read_value = base, written_value = final) into the final
    sorted queue; finalization push when drained (mod.rs:835-880).

The cell state machine is materialized as per-row state columns.  The
witness runs it on the host, row after row on python ints
(`_cell_states_host`, the JAX package's `lax.scan` of `_cell_transition`),
and uploads the columns once; `eval_constraints` re-runs the torch
`_cell_transition` over all rows at once on the witness's device.  The three
sponge chains go through the native runtime in one call (`backend="host"`) or
the step loop (`backend="device"`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..base_structures.log_query import LogQueries, encode_log_queries
from ..ops import gf, queues
from ..ops.queues import QueueState
from ..utils import challenges as chal
from ..utils import protocol
from ..utils.shard_plan import RowWindow, ShardPlan
from .demux_log_queue import pad_log_queries

NUM_REPETITIONS = chal.DEFAULT_NUM_REPETITIONS
TIMESTAMPED_STORAGE_LOG_ENCODING_LEN = 20
NUM_CHALLENGES = TIMESTAMPED_STORAGE_LOG_ENCODING_LEN + 1
EXTENDED_TIMESTAMP_ENCODING_ELEMENT = 19
EXTENDED_TIMESTAMP_ENCODING_OFFSET = 8
PACKED_KEY_LENGTH = 13  # ref input.rs:28

M32 = 0xFFFFFFFF
# the cell state's columns, in the JAX package's order
CELL_STATE_KEYS = ("base_value", "current_value", "depth", "explicit_read",
                   "prev_address", "prev_key", "prev_timestamp", "prev_trivial")


@dataclasses.dataclass(frozen=True)
class StorageValidityConfig:
    limit: int
    shard_id: int = 0


def extend_encoding_with_timestamp(enc: torch.Tensor, timestamp: torch.Tensor) -> torch.Tensor:
    """enc[19] += ts << 8 (element 19 is the <8-bit rollback flag)."""
    shifted = gf.mul_const(gf.from_u32(timestamp), 1 << EXTENDED_TIMESTAMP_ENCODING_OFFSET)
    elem = gf.add(enc[..., EXTENDED_TIMESTAMP_ENCODING_ELEMENT], shifted)
    return torch.cat([enc[..., :EXTENDED_TIMESTAMP_ENCODING_ELEMENT], elem.unsqueeze(-1)], dim=-1)


def _keys_equal(state, rec: LogQueries):
    return (state["prev_key"] == rec.key).all(-1) & (state["prev_address"] == rec.address).all(-1)


def _push_decision(state, shard_id):
    """The 'finish with the previous cell' push payload + should_update flag
    (ref mod.rs:666-705); everything derived from the carried state."""
    value_unchanged = (state["current_value"] == state["base_value"]).all(-1)
    depth_zero = state["depth"] == 0
    unchanged_not_by_rollback = value_unchanged & ~depth_zero
    issue_protective_read = state["explicit_read"] | unchanged_not_by_rollback
    should_write = ~value_unchanged
    should_update = issue_protective_read | should_write
    z = torch.zeros_like(state["depth"])
    f = torch.zeros_like(should_write)
    query = LogQueries(
        address=state["prev_address"],
        key=state["prev_key"],
        read_value=state["base_value"],
        written_value=state["current_value"],
        aux_byte=z,
        rw_flag=should_write,
        rollback=f,
        is_service=f,
        shard_id=torch.full_like(z, shard_id),
        tx_number_in_block=z,
        timestamp=z,
    )
    return should_update, query


def _cell_transition(state, rec: LogQueries, ts: torch.Tensor, execute, shard_id):
    """One row of the inner loop (ref mod.rs:584-833), batched over rows.

    Returns (new_state, push_flag, push_query, checks_dict)."""
    trivial = ~execute
    keys_equal = _keys_equal(state, rec) & execute
    new_non_trivial_cell = execute & ~_keys_equal(state, rec)

    should_update, push_query = _push_decision(state, shard_id)
    push_flag = (~state["prev_trivial"]) & (~_keys_equal(state, rec)) & should_update

    # --- new-cell state refresh (mod.rs:707-752) ---
    ncol = new_non_trivial_cell.unsqueeze(-1)
    meaningful = torch.where(rec.rw_flag.unsqueeze(-1), rec.written_value, rec.read_value)
    base = torch.where(ncol, rec.read_value, state["base_value"])
    current = torch.where(ncol, meaningful, state["current_value"])
    depth = torch.where(new_non_trivial_cell, rec.rw_flag.to(torch.int64), state["depth"])
    explicit = torch.where(new_non_trivial_cell, ~rec.rw_flag, state["explicit_read"])

    # --- same-cell update (mod.rs:755-825); depth is a u32 that wraps ---
    same = execute & keys_equal
    read_same = same & ~rec.rw_flag
    write_no_rb = same & rec.rw_flag & ~rec.rollback
    write_rb = same & rec.rw_flag & rec.rollback
    depth = torch.where(write_no_rb, (depth + 1) & M32, depth)
    depth = torch.where(write_rb, (depth - 1) & M32, depth)
    read_consistent = (current == rec.read_value).all(-1)
    check_read = read_same | write_no_rb
    current = torch.where(write_no_rb.unsqueeze(-1), rec.written_value, current)
    current = torch.where(write_rb.unsqueeze(-1), rec.read_value, current)
    read_at_zero = (depth == 0) & read_same
    base = torch.where(read_at_zero.unsqueeze(-1), rec.read_value, base)
    explicit = explicit | read_at_zero

    ex = execute.unsqueeze(-1)
    new_state = dict(
        base_value=base,
        current_value=current,
        depth=depth,
        explicit_read=explicit,
        prev_address=torch.where(ex, rec.address, state["prev_address"]),
        prev_key=torch.where(ex, rec.key, state["prev_key"]),
        prev_timestamp=torch.where(execute, ts, state["prev_timestamp"]),
        prev_trivial=trivial,
    )
    checks = dict(read_consistency=torch.where(check_read, read_consistent, torch.ones_like(check_read)))
    return new_state, push_flag, push_query, checks


def _cell_states_host(sorted_q: LogQueries, sorted_ts: torch.Tensor, execute: torch.Tensor,
                      device) -> dict:
    """The cell state machine on the host, row after row on python ints (the
    JAX package's `lax.scan` of `_cell_transition`): every state column,
    (N + 1, ...) with the state BEFORE each row and the final state last,
    uploaded once to `device`."""
    total = execute.shape[0]
    addr = [tuple(r) for r in sorted_q.address.cpu().tolist()]
    key = [tuple(r) for r in sorted_q.key.cpu().tolist()]
    rv = [tuple(r) for r in sorted_q.read_value.cpu().tolist()]
    wv = [tuple(r) for r in sorted_q.written_value.cpu().tolist()]
    rw = sorted_q.rw_flag.cpu().tolist()
    rb = sorted_q.rollback.cpu().tolist()
    ts = sorted_ts.cpu().tolist()
    ex = execute.cpu().tolist()

    z8, z5 = (0,) * 8, (0,) * 5
    base, current, depth, explicit = z8, z8, 0, False
    p_addr, p_key, p_ts, p_trivial = z5, z8, 0, True
    cols = {k: [] for k in CELL_STATE_KEYS}
    for i in range(total + 1):
        for k, v in zip(CELL_STATE_KEYS,
                        (base, current, depth, explicit, p_addr, p_key, p_ts, p_trivial)):
            cols[k].append(v)
        if i == total:
            break
        if ex[i]:
            if p_key != key[i] or p_addr != addr[i]:  # a new cell
                base = rv[i]
                current = wv[i] if rw[i] else rv[i]
                depth = 1 if rw[i] else 0
                explicit = not rw[i]
            elif not rw[i]:  # a read of the same cell
                if depth == 0:
                    base = rv[i]
                    explicit = True
            elif not rb[i]:  # a write
                depth = (depth + 1) & M32
                current = wv[i]
            else:  # a rollback of a write
                depth = (depth - 1) & M32
                current = rv[i]
            p_addr, p_key, p_ts = addr[i], key[i], ts[i]
        p_trivial = not ex[i]

    flags = ("explicit_read", "prev_trivial")
    return {k: torch.from_numpy(np.asarray(v, dtype=bool if k in flags else np.int64)).to(device)
            for k, v in cols.items()}


@dataclasses.dataclass(frozen=True)
class StorageValidityWitness:
    n: int
    execute: torch.Tensor
    unsorted: LogQueries  # (N,)
    sorted: LogQueries  # (N,) records of the intermediate sorted queue
    sorted_ts: torch.Tensor  # (N,) the extra TimestampedStorageLogRecord ts
    enc_unsorted_ext: torch.Tensor  # (N, 20) extended with cycle index
    enc_sorted_ext: torch.Tensor  # (N, 20)
    chain_unsorted: torch.Tensor  # (N+1, 4), over the RAW LogQuery encodings
    chain_sorted: torch.Tensor  # (N+1, 4), over the extended encodings
    challenges: torch.Tensor
    lhs: torch.Tensor
    rhs: torch.Tensor
    cell_states: dict  # per-row state BEFORE the row, leaves (N+1, ...)
    push_flags: torch.Tensor  # (N+1,)
    push_items: LogQueries  # (N+1,)
    result_chain: torch.Tensor  # (N+2, 4)
    result_count: torch.Tensor  # (N+1,) int64


def _append(a: LogQueries, b: LogQueries) -> LogQueries:
    """a with the single query b (batch shape ()) appended."""
    return LogQueries(*[
        torch.cat([getattr(a, f.name), getattr(b, f.name).unsqueeze(0)])
        for f in dataclasses.fields(LogQueries)
    ])


def _pushes(cell_states: dict, sorted_q: LogQueries, total: int, shard_id: int):
    """push flags and payloads (N + 1,) from the state columns: row i pushes
    when it leaves a cell, the finalization row when the last state holds one."""
    before = {k: v[:-1] for k, v in cell_states.items()}
    update, query = _push_decision(before, shard_id)
    flags = (~before["prev_trivial"]) & (~_keys_equal(before, sorted_q)) & update
    final = {k: v[total] for k, v in cell_states.items()}
    fin_update, fin_query = _push_decision(final, shard_id)
    fin_flag = (~final["prev_trivial"]) & fin_update
    return torch.cat([flags, fin_flag.unsqueeze(0)]), _append(query, fin_query)


def _fs_challenges(chain_u: torch.Tensor, chain_s: torch.Tensor, total: int, n: int):
    zeros4 = gf.zeros((4,), chain_u.device)
    return chal.produce_fs_challenges(
        QueueState(zeros4, chain_u[total], n), QueueState(zeros4, chain_s[total], n),
        NUM_CHALLENGES, NUM_REPETITIONS,
    )


def generate_witness(
    unsorted: LogQueries,
    sorted_q: LogQueries,
    sorted_ts,
    config: StorageValidityConfig,
    backend: str = "host",
) -> StorageValidityWitness:
    """The trace from the two storage-log tapes and the sorted rows' cycle
    indices (`sorted_ts`), on the tapes' device.  backend: how the three
    sponge chains run (`queues.simulate_chains`); the cell state machine
    always runs on the host."""
    n = unsorted.shape[0]
    if sorted_q.shape[0] != n:
        raise ValueError("queues must pop in lockstep")
    dev = unsorted.timestamp.device
    total = max(1, -(-n // config.limit)) * config.limit
    unsorted = pad_log_queries(unsorted, total)
    sorted_q = pad_log_queries(sorted_q, total)
    if not isinstance(sorted_ts, torch.Tensor):
        sorted_ts = torch.from_numpy(np.asarray(sorted_ts, dtype=np.int64))
    sorted_ts = sorted_ts.to(device=dev, dtype=torch.int64)
    sorted_ts = torch.cat([sorted_ts, torch.zeros(total - n, dtype=torch.int64, device=dev)])
    execute = torch.arange(total, device=dev) < n
    cycle_idx = torch.arange(total, device=dev)

    enc_u_raw = encode_log_queries(unsorted)
    enc_s_ext = extend_encoding_with_timestamp(encode_log_queries(sorted_q), sorted_ts)
    enc_u_ext = extend_encoding_with_timestamp(enc_u_raw, cycle_idx)

    cell_states = _cell_states_host(sorted_q, sorted_ts, execute, dev)
    push_flags, push_items = _pushes(cell_states, sorted_q, total, config.shard_id)
    chain_u, chain_s, result_chain = queues.simulate_chains(
        queues.NARROW_STATE_WIDTH,
        [(enc_u_raw, execute), (enc_s_ext, execute),
         (encode_log_queries(push_items), push_flags)],
        backend,
    )

    fs = _fs_challenges(chain_u, chain_s, total, n)
    ones = gf.ones((NUM_REPETITIONS,), dev)
    lhs = chal.product_accumulate(
        chal.masked_factors(chal.grand_product_factors(enc_u_ext, fs), execute), ones)
    rhs = chal.product_accumulate(
        chal.masked_factors(chal.grand_product_factors(enc_s_ext, fs), execute), ones)

    return StorageValidityWitness(
        n=n,
        execute=execute,
        unsorted=unsorted,
        sorted=sorted_q,
        sorted_ts=sorted_ts,
        enc_unsorted_ext=enc_u_ext,
        enc_sorted_ext=enc_s_ext,
        chain_unsorted=chain_u,
        chain_sorted=chain_s,
        challenges=fs,
        lhs=lhs,
        rhs=rhs,
        cell_states=cell_states,
        push_flags=push_flags,
        push_items=push_items,
        result_chain=result_chain,
        result_count=torch.cumsum(push_flags.to(torch.int64), dim=0),
    )


def _key_geq_prev(rec: LogQueries, total: int):
    """(cur > prev, cur == prev) on the 13-limb packed key vs previous row."""
    dev = rec.timestamp.device
    row = torch.arange(total, device=dev)
    prev = rec[(row - 1).clamp(min=0)]
    cur_k = torch.cat([rec.key, rec.address], dim=-1)  # address most significant
    prev_k = torch.cat([prev.key, prev.address], dim=-1)
    gt = torch.zeros(total, dtype=torch.bool, device=dev)
    eq = torch.ones(total, dtype=torch.bool, device=dev)
    for k in range(12, -1, -1):
        gt = gt | (eq & (cur_k[..., k] > prev_k[..., k]))
        eq = eq & (cur_k[..., k] == prev_k[..., k])
    eq = eq & (row > 0)
    gt = gt | (row == 0)  # row 0 compares against the zero key
    return gt, eq


def _fields_equal(a: LogQueries, b: LogQueries, rows: int) -> torch.Tensor:
    ok = torch.ones(rows, dtype=torch.bool, device=a.timestamp.device)
    for f in dataclasses.fields(LogQueries):
        ok = ok & (getattr(a, f.name) == getattr(b, f.name)).reshape(rows, -1).all(-1)
    return ok


def eval_constraints(w: StorageValidityWitness, config: StorageValidityConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Row-parallel constraint evaluation; every entry must be all-True.
    `window` places a block of rows in its run (`parallel/auto.py`); None is
    the whole run."""
    total = w.execute.shape[0]
    dev = w.execute.device
    s = w.sorted
    true = torch.ones((), dtype=torch.bool, device=dev)
    row0 = window.row0 if window else 0
    cycle_idx = torch.arange(row0, row0 + total, device=dev)

    enc_u_raw = encode_log_queries(w.unsorted)
    enc_u_ok = gf.equal(extend_encoding_with_timestamp(enc_u_raw, cycle_idx),
                        w.enc_unsorted_ext).all(-1)
    enc_s_ok = gf.equal(extend_encoding_with_timestamp(encode_log_queries(s), w.sorted_ts),
                        w.enc_sorted_ext).all(-1)

    chain_u_ok = queues.check_chain(w.chain_unsorted, enc_u_raw, w.execute)
    chain_s_ok = queues.check_chain(w.chain_sorted, w.enc_sorted_ext, w.execute)

    fs = _fs_challenges(w.chain_unsorted, w.chain_sorted, total, w.n)
    challenges_ok = gf.equal(fs, w.challenges).all()

    factors_u = chal.masked_factors(chal.grand_product_factors(w.enc_unsorted_ext, fs), w.execute)
    factors_s = chal.masked_factors(chal.grand_product_factors(w.enc_sorted_ext, fs), w.execute)
    ones = gf.ones((1, NUM_REPETITIONS), dev)
    lhs_ok = gf.equal(w.lhs, gf.mul(torch.cat([ones, w.lhs[:-1]]), factors_u)).all(-1)
    rhs_ok = gf.equal(w.rhs, gf.mul(torch.cat([ones, w.rhs[:-1]]), factors_s)).all(-1)

    shard_ok = torch.where(w.execute, s.shard_id == config.shard_id, true)

    key_gt, key_eq = _key_geq_prev(s, total)
    order_ok = torch.where(w.execute, key_gt | key_eq, true)
    row = torch.arange(total, device=dev)
    prev_ts = torch.where(row > 0, w.sorted_ts[(row - 1).clamp(min=0)], torch.zeros_like(row))
    ts_ok = torch.where(w.execute & key_eq, prev_ts < w.sorted_ts, true)

    # cell-state transitions + pushes, all rows at once
    states_before = {k: v[:-1] for k, v in w.cell_states.items()}
    new_state, push_flags, push_items, checks = _cell_transition(
        states_before, s, w.sorted_ts, w.execute, config.shard_id
    )
    state_ok = torch.ones(total, dtype=torch.bool, device=dev)
    for k in new_state:
        state_ok = state_ok & (new_state[k] == w.cell_states[k][1:]).reshape(total, -1).all(-1)
    final = {k: v[total] for k, v in w.cell_states.items()}
    fin_update, fin_query = _push_decision(final, config.shard_id)
    fin_flag = (~final["prev_trivial"]) & fin_update
    flags_ok = torch.cat([push_flags, fin_flag.unsqueeze(0)]) == w.push_flags
    items_ok = _fields_equal(_append(push_items, fin_query), w.push_items, total + 1)
    result_chain_ok = queues.check_chain(
        w.result_chain, encode_log_queries(w.push_items), w.push_flags)
    prev_count = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), w.result_count[:-1]])
    count_ok = w.result_count == prev_count + w.push_flags.to(torch.int64)

    final_eq = gf.equal(w.lhs[total - 1], w.rhs[total - 1]).all()

    return {
        "encoding_unsorted": enc_u_ok,
        "encoding_sorted": enc_s_ok,
        "chain_unsorted": chain_u_ok,
        "chain_sorted": chain_s_ok,
        "challenges": challenges_ok,
        "lhs_transitions": lhs_ok,
        "rhs_transitions": rhs_ok,
        "shard_id": shard_ok,
        "key_order": order_ok,
        "timestamp_order": ts_ok,
        "read_consistency": checks["read_consistency"],
        "cell_state_transitions": state_ok,
        "push_flags": flags_ok,
        "push_items": items_ok,
        "result_chain": result_chain_ok,
        "result_count": count_ok,
        "grand_product_final": final_eq,
    }


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())


# row-sharded: a row reads the previous row and its cell state after it; the
# unsorted encodings carry the run row; the challenges come from the run's tails
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 1),
    replicated=frozenset({"challenges"}),
    tails=frozenset({"chain_unsorted", "chain_sorted"}),
    last=frozenset({"challenges", "grand_product_final"}),
    takes_window=True,
)


# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


# ---------------------------------------------------------------------------
# ClosedFormInput per instance
# ---------------------------------------------------------------------------


def instance_compact_forms(w: StorageValidityWitness, config: StorageValidityConfig):
    """FSM mirrors StorageDeduplicatorFSMInputOutput (ref input.rs:38-51):
    [lhs(2), rhs(2), unsorted_qs(9), intermediate_qs(9), final_qs(9),
    cycle_idx(1), previous_packed_key(13), previous_key(8),
    previous_address(5), previous_timestamp(1),
    this_cell_has_explicit_read_and_rollback_depth_zero(1), base_value(8),
    current_value(8), current_depth(1)] = 77 elements, batched over the
    k + 1 boundaries."""
    dev = w.execute.device
    total = w.execute.shape[0]
    limit = config.limit
    k = total // limit
    bounds = torch.arange(k + 1, device=dev) * limit
    prev_row = (bounds - 1).clamp(min=0)
    col = (bounds == 0).unsqueeze(-1)
    ones = gf.ones((k + 1, NUM_REPETITIONS), dev)
    remaining = w.n - bounds.clamp(max=w.n)
    st = {key: v[bounds] for key, v in w.cell_states.items()}

    def qs(chain):
        return protocol.encode_queue_state_generic(
            chain[bounds], chain[total].expand(k + 1, -1), remaining)

    fsm_states = torch.cat(
        [
            torch.where(col, ones, w.lhs[prev_row]),
            torch.where(col, ones, w.rhs[prev_row]),
            qs(w.chain_unsorted),
            qs(w.chain_sorted),
            protocol.result_queue_state_at(w.result_chain, w.result_count, bounds, total),
            bounds.unsqueeze(-1),
            st["prev_key"], st["prev_address"],
            st["prev_key"],
            st["prev_address"],
            st["prev_timestamp"].unsqueeze(-1),
            protocol.bool_to_gf(st["explicit_read"]).unsqueeze(-1),
            st["base_value"],
            st["current_value"],
            st["depth"].unsqueeze(-1),
        ],
        dim=-1,
    )  # (k + 1, 77)

    zeros4 = gf.zeros((4,), dev)
    obs_in = torch.cat([
        gf.constant(config.shard_id, dev).reshape(1),
        protocol.encode_queue_state_generic(zeros4, w.chain_unsorted[total], w.n),
        protocol.encode_queue_state_generic(zeros4, w.chain_sorted[total], w.n),
    ]).expand(k, -1)
    obs_out = protocol.encode_queue_state_generic(
        zeros4, w.result_chain[total + 1], w.result_count[total]).expand(k, -1)
    inst = torch.arange(k, device=dev)
    return protocol.compact_form_from_parts(
        inst == 0, (inst + 1) * limit >= w.n, obs_in, obs_out, fsm_states[:-1], fsm_states[1:]
    )
