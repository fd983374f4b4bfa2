"""sort_decommittment_requests, circuit type 2: decommit-request dedup (the
JAX package's `models/sort_decommittment_requests.py`).

Reference parity: `src/sort_decommittment_requests/` (entry mod.rs:40-233,
inner `sort_and_deduplicate_code_decommittments_inner` mod.rs:235-380, I/O
input.rs).  Semantics replicated:

  * two full-state (width-12) decommit queues popped in lockstep, equal
    lengths; 2 grand products over the 8-element encodings.
  * strict ascending by packed key [timestamp, code_hash[0..8]] LSW-first
    (code_hash most significant), `concatenate_key` mod.rs:382-397.
  * a new code_hash must carry the is_first marker (mod.rs:317-323);
    repeats of a hash must use the same memory page (mod.rs:325-335).
  * result queue receives one record per distinct hash: the previous record
    with is_first=true and timestamp = first-encounter timestamp
    (mod.rs:337-351); finalization push when drained (mod.rs:362-372).

Flat rows = pops (+1 finalization row); the per-group first-encounter
timestamp is a row-parallel gather through a running maximum of the group
start indices.  Witness generation takes the three sponge chains through the
native runtime in one call (`backend="host"`) or the step loop
(`backend="device"`, a few rows on the CPU); `eval_constraints` checks every
row in parallel on the witness's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..base_structures.decommit_query import (
    DECOMMIT_QUERY_PACKED_WIDTH,
    DecommitQueries,
    encode_decommit_queries,
)
from ..ops import gf, queues
from ..ops.queues import QueueState
from ..utils import challenges as chal
from ..utils import protocol
from ..utils.shard_plan import RowWindow, ShardPlan

NUM_REPETITIONS = chal.DEFAULT_NUM_REPETITIONS
NUM_CHALLENGES = DECOMMIT_QUERY_PACKED_WIDTH + 1
PACKED_KEY_LENGTH = 9  # ref input.rs:21


@dataclasses.dataclass(frozen=True)
class DecommitSorterConfig:
    limit: int


@dataclasses.dataclass(frozen=True)
class DecommitSorterWitness:
    n: int
    execute: torch.Tensor  # (N,)
    unsorted: DecommitQueries
    sorted: DecommitQueries
    enc_unsorted: torch.Tensor  # (N, 8)
    enc_sorted: torch.Tensor  # (N, 8)
    chain_unsorted: torch.Tensor  # (N+1, 12)
    chain_sorted: torch.Tensor  # (N+1, 12)
    challenges: torch.Tensor
    lhs: torch.Tensor
    rhs: torch.Tensor
    first_enc_ts: torch.Tensor  # (N,) first-encounter ts of each row's group
    result_items: DecommitQueries  # (N+1,)
    result_add: torch.Tensor  # (N+1,)
    result_chain: torch.Tensor  # (N+2, 12)
    result_count: torch.Tensor  # (N+1,) int64


def _cat(a: DecommitQueries, b: DecommitQueries) -> DecommitQueries:
    return DecommitQueries(*[
        torch.cat([getattr(a, f.name), getattr(b, f.name)])
        for f in dataclasses.fields(DecommitQueries)
    ])


def _pad(q: DecommitQueries, total: int) -> DecommitQueries:
    n = q.shape[0]
    if n == total:
        return q
    return _cat(q, DecommitQueries.zeros((total - n,), q.timestamp.device))


def _prev_rows(total: int, device) -> torch.Tensor:
    return (torch.arange(total, device=device) - 1).clamp(min=0)


def _same_hash_as_prev(s: DecommitQueries, total: int) -> torch.Tensor:
    row = torch.arange(total, device=s.timestamp.device)
    prev = s[_prev_rows(total, row.device)]
    same = (s.code_hash == prev.code_hash).all(-1)
    return same & (row > 0)


def _key_gt_prev(s: DecommitQueries, total: int) -> torch.Tensor:
    """strict (code_hash, timestamp) lexicographic cur > prev (hash-major)."""
    prev = s[_prev_rows(total, s.timestamp.device)]
    hash_gt = torch.zeros(total, dtype=torch.bool, device=s.timestamp.device)
    hash_eq = torch.ones(total, dtype=torch.bool, device=s.timestamp.device)
    # compare limbs MSW->LSW
    for k in range(7, -1, -1):
        cur_l, prev_l = s.code_hash[..., k], prev.code_hash[..., k]
        hash_gt = hash_gt | (hash_eq & (cur_l > prev_l))
        hash_eq = hash_eq & (cur_l == prev_l)
    return hash_gt | (hash_eq & (s.timestamp > prev.timestamp))


def _group_first_ts(s: DecommitQueries, same: torch.Tensor, total: int,
                    window: Optional[RowWindow] = None) -> torch.Tensor:
    row = torch.arange(total, device=same.device)
    if window is None:
        start_idx = torch.where(~same, row, torch.zeros_like(row))
        group_start = torch.cummax(start_idx, dim=0).values
        return s.timestamp[group_start]
    # a window: the group starts of its own rows, else the last one before
    # them (the plan's carry) and its timestamp
    run = row + window.row0
    starts = ~same & (row >= window.own[0])
    group_start = torch.cummax(torch.where(starts, run, torch.full_like(run, window.flag_carry)),
                               dim=0).values
    inside = group_start >= window.row0 + window.own[0]
    return torch.where(inside, s.timestamp[(group_start - window.row0).clamp(min=0)],
                       window.carried["timestamp"])


def _fs_challenges(chain_u: torch.Tensor, chain_s: torch.Tensor, total: int, n: int):
    zeros12 = gf.zeros((12,), chain_u.device)
    return chal.produce_fs_challenges(
        QueueState(zeros12, chain_u[total], n), QueueState(zeros12, chain_s[total], n),
        NUM_CHALLENGES, NUM_REPETITIONS,
    )


def _prev_executed(execute: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=torch.bool, device=execute.device), execute[:-1]])


def generate_witness(
    unsorted: DecommitQueries,
    sorted_q: DecommitQueries,
    config: DecommitSorterConfig,
    backend: str = "host",
) -> DecommitSorterWitness:
    """The full trace from the two request tapes, on the tapes' device.
    backend: how the three sponge chains run (`queues.simulate_chains`)."""
    n = unsorted.shape[0]
    if sorted_q.shape[0] != n:
        raise ValueError("queues must pop in lockstep")
    dev = unsorted.timestamp.device
    total = max(1, -(-n // config.limit)) * config.limit
    unsorted = _pad(unsorted, total)
    sorted_q = _pad(sorted_q, total)
    execute = torch.arange(total, device=dev) < n

    enc_u = encode_decommit_queries(unsorted)
    enc_s = encode_decommit_queries(sorted_q)

    # first-encounter timestamp per hash group: gather ts at the group start
    same = _same_hash_as_prev(sorted_q, total)
    first_enc_ts = _group_first_ts(sorted_q, same, total)

    # result pushes: the previous record is emitted when this row starts a
    # new hash group (padding rows are all-zero, i.e. a different hash) and
    # the previous row executed (the reference's different_hash &
    # previous_nontrivial)
    add = (~same) & _prev_executed(execute)
    result_add = torch.cat([add, execute[total - 1 :]])
    prev_rows = _prev_rows(total, dev)
    prev = sorted_q[prev_rows]
    body = DecommitQueries(
        code_hash=prev.code_hash,
        page=prev.page,
        is_first=torch.ones(total, dtype=torch.bool, device=dev),
        timestamp=first_enc_ts[prev_rows],
    )
    last = DecommitQueries(
        sorted_q.code_hash[total - 1 :], sorted_q.page[total - 1 :],
        torch.ones(1, dtype=torch.bool, device=dev), first_enc_ts[total - 1 :],
    )
    result_items = _cat(body, last)
    enc_result = encode_decommit_queries(result_items)

    chain_u, chain_s, result_chain = queues.simulate_chains(
        queues.FULL_STATE_WIDTH,
        [(enc_u, execute), (enc_s, execute), (enc_result, result_add)],
        backend,
    )
    fs = _fs_challenges(chain_u, chain_s, total, n)
    ones = gf.ones((NUM_REPETITIONS,), dev)
    lhs = chal.product_accumulate(
        chal.masked_factors(chal.grand_product_factors(enc_u, fs), execute), ones)
    rhs = chal.product_accumulate(
        chal.masked_factors(chal.grand_product_factors(enc_s, fs), execute), ones)
    result_count = torch.cumsum(result_add.to(torch.int64), dim=0)

    return DecommitSorterWitness(
        n=n,
        execute=execute,
        unsorted=unsorted,
        sorted=sorted_q,
        enc_unsorted=enc_u,
        enc_sorted=enc_s,
        chain_unsorted=chain_u,
        chain_sorted=chain_s,
        challenges=fs,
        lhs=lhs,
        rhs=rhs,
        first_enc_ts=first_enc_ts,
        result_items=result_items,
        result_add=result_add,
        result_chain=result_chain,
        result_count=result_count,
    )


def eval_constraints(w: DecommitSorterWitness, config: DecommitSorterConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Row-parallel constraint evaluation; every entry must be all-True.
    `window` places a block of rows in its run (`parallel/auto.py`); None is
    the whole run."""
    total = w.execute.shape[0]
    dev = w.execute.device
    s = w.sorted
    true = torch.ones((), dtype=torch.bool, device=dev)

    chain_u_ok = queues.check_chain(w.chain_unsorted, w.enc_unsorted, w.execute)
    chain_s_ok = queues.check_chain(w.chain_sorted, w.enc_sorted, w.execute)

    fs = _fs_challenges(w.chain_unsorted, w.chain_sorted, total, w.n)
    challenges_ok = gf.equal(fs, w.challenges).all()

    factors_u = chal.masked_factors(chal.grand_product_factors(w.enc_unsorted, fs), w.execute)
    factors_s = chal.masked_factors(chal.grand_product_factors(w.enc_sorted, fs), w.execute)
    ones = gf.ones((1, NUM_REPETITIONS), dev)
    prev_lhs = torch.cat([ones, w.lhs[:-1]])
    prev_rhs = torch.cat([ones, w.rhs[:-1]])
    lhs_ok = gf.equal(w.lhs, gf.mul(prev_lhs, factors_u)).all(-1)
    rhs_ok = gf.equal(w.rhs, gf.mul(prev_rhs, factors_s)).all(-1)

    enc_u_ok = gf.equal(encode_decommit_queries(w.unsorted), w.enc_unsorted).all(-1)
    enc_s_ok = gf.equal(encode_decommit_queries(s), w.enc_sorted).all(-1)

    # strict ascending by (code_hash, timestamp); row 0 against the zero key
    # is trivially greater (timestamps are nonzero)
    row = torch.arange(total, device=dev)
    order_ok = torch.where(w.execute & (row > 0), _key_gt_prev(s, total), true)

    same = _same_hash_as_prev(s, total)
    prev_exec = _prev_executed(w.execute)
    # new hash => is_first marker
    first_ok = torch.where(w.execute & ~same, s.is_first, true)
    # same hash (prev nontrivial) => same page
    prev = s[_prev_rows(total, dev)]
    page_ok = torch.where(w.execute & same & prev_exec, s.page == prev.page, true)

    # result queue checks
    first_ts_ok = _group_first_ts(s, same, total, window) == w.first_enc_ts
    add = (~same) & prev_exec
    add_ok = torch.cat([add, w.execute[total - 1 :]]) == w.result_add
    enc_result = encode_decommit_queries(w.result_items)
    result_chain_ok = queues.check_chain(w.result_chain, enc_result, w.result_add)
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
        "sort_order": order_ok,
        "is_first_markers": first_ok,
        "same_page_within_group": page_ok,
        "first_encounter_ts": first_ts_ok,
        "result_add_flags": add_ok,
        "result_chain": result_chain_ok,
        "result_count": count_ok,
        "grand_product_final": final_eq,
    }


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())


def _group_starts(w: DecommitSorterWitness) -> torch.Tensor:
    return ~_same_hash_as_prev(w.sorted, w.execute.shape[0])


# row-sharded as log_sorter: a row reads the previous row, the result queue
# one entry more; the challenges come from the run's queue tails; a row's
# first-encounter timestamp is its hash group's first row's, carried from
# the last group start before the block
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 1),
    replicated=frozenset({"challenges"}),
    tails=frozenset({"chain_unsorted", "chain_sorted"}),
    last=frozenset({"challenges", "grand_product_final"}),
    takes_window=True,
    carry_flag=_group_starts,
    carry_values=lambda w: {"timestamp": w.sorted.timestamp},
)


# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


# ---------------------------------------------------------------------------
# ClosedFormInput per instance
# ---------------------------------------------------------------------------


def _encode_decommit_flat(q: DecommitQueries) -> torch.Tensor:
    """11-element field-order encoding of a DecommitQuery (code_hash(8),
    page, is_first, timestamp)."""
    return torch.cat(
        [
            q.code_hash,
            q.page.unsqueeze(-1),
            protocol.bool_to_gf(q.is_first).unsqueeze(-1),
            q.timestamp.unsqueeze(-1),
        ],
        dim=-1,
    )


def instance_compact_forms(w: DecommitSorterWitness, config: DecommitSorterConfig):
    """FSM mirrors CodeDecommittmentsDeduplicatorFSMInputOutput (ref
    input.rs:26-37): [initial_qs(25), sorted_qs(25), final_qs(25), lhs(2),
    rhs(2), previous_packed_key(9), first_encountered_timestamp(1),
    previous_record(11)] = 100 elements, batched over the k + 1 boundaries."""
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
        return torch.where(at_start if v.dim() == 1 else col, torch.zeros_like(v), v)

    srow = w.sorted[prev_row]
    prev_record = DecommitQueries(
        sel(srow.code_hash), sel(srow.page), srow.is_first & ~at_start, sel(srow.timestamp))
    fsm_states = torch.cat(
        [
            qs(w.chain_unsorted),
            qs(w.chain_sorted),
            protocol.result_queue_state_at(w.result_chain, w.result_count, bounds, total),
            torch.where(col, ones, w.lhs[prev_row]),
            torch.where(col, ones, w.rhs[prev_row]),
            torch.cat([sel(srow.timestamp).unsqueeze(-1), sel(srow.code_hash)], dim=-1),
            sel(w.first_enc_ts[prev_row]).unsqueeze(-1),
            _encode_decommit_flat(prev_record),
        ],
        dim=-1,
    )  # (k + 1, 100)

    zeros12 = gf.zeros((12,), dev)
    obs_in = torch.cat([
        protocol.encode_queue_state_generic(zeros12, w.chain_unsorted[total], w.n),
        protocol.encode_queue_state_generic(zeros12, w.chain_sorted[total], w.n),
    ]).expand(k, -1)
    obs_out = protocol.encode_queue_state_generic(
        zeros12, w.result_chain[total + 1], w.result_count[total]).expand(k, -1)
    inst = torch.arange(k, device=dev)
    return protocol.compact_form_from_parts(
        inst == 0, (inst + 1) * limit >= w.n, obs_in, obs_out, fsm_states[:-1], fsm_states[1:]
    )
