"""ram_permutation (circuit type 8): the witness of the memory-consistency
argument, as the JAX package's `models/ram_permutation.py` builds it.

Two full-state queues (unsorted from the VM, prover-sorted) are popped in
lockstep; multiset equality is checked by NUM_REPETITIONS = 2 grand
products over the 8-element memory-query encodings, with Fiat-Shamir
challenges derived from both queue tails.  Nondeterministic bootloader-heap
writes (timestamp 0, heap page, write, not a pointer) are counted.

Sort order is strict ascending by (memory_page, index, timestamp).  RW
semantics: the first touch of a cell by a read must see zero (and no
pointer); a read of the same cell must see the previous value and is_ptr.
The nondeterministic writes must number `snapshot_length` at completion.

Witness generation: the tapes are encoded with numpy and the two sequential
sponge chains run in the native C++ runtime on the host; the finish stage
(re-encoding, challenges, factors, running products, the nondet count) runs
in torch on `device`.  Constraint evaluation (`eval_constraints`) is
row-parallel: every transition (sponge, product, counter, ordering, RW) is
checked per row in one batched pass.  Instance k of a multi-instance run
covers rows [k * limit, (k + 1) * limit), and its ClosedFormInput FSM
snapshots are gathers at those boundaries (`instance_compact_forms`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..base_structures.memory_query import (
    MEMORY_QUERY_PACKED_WIDTH,
    MemoryQueries,
    encode_memory_queries,
    encode_memory_queries_np,
)
from ..isa.system_params import BOOTLOADER_HEAP_PAGE
from ..ops import gf, queues
from ..ops.queues import QueueState
from ..runtime import native
from ..utils import challenges as chal
from ..utils import protocol
from ..utils.device import resolve_device
from ..utils.shard_plan import RowWindow, ShardPlan

NUM_REPETITIONS = chal.DEFAULT_NUM_REPETITIONS


@dataclasses.dataclass(frozen=True)
class RamPermutationConfig:
    limit: int  # pops per instance
    bootloader_heap_page: int = BOOTLOADER_HEAP_PAGE
    # when set, the chain witnesses hold only every chain_stride-th state
    chain_stride: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RamPermutationWitness:
    """The trace of a whole run (all instances, flat rows of N = total)."""

    n: int  # true queue length
    execute: torch.Tensor  # (N,) bool
    unsorted: MemoryQueries  # (N,)
    sorted: MemoryQueries  # (N,)
    enc_unsorted: torch.Tensor  # (N, 8)
    enc_sorted: torch.Tensor  # (N, 8)
    chain_unsorted: torch.Tensor  # (N / stride + 1, 12) sponge states
    chain_sorted: torch.Tensor
    challenges: torch.Tensor  # (2, 9)
    lhs: torch.Tensor  # (N, 2) running products after row i
    rhs: torch.Tensor  # (N, 2)
    nondet_count: torch.Tensor  # (N,) int64 count after row i
    snapshot_length: int


def _is_nondet_write(q: MemoryQueries, execute: torch.Tensor, heap_page: int) -> torch.Tensor:
    return (
        execute & (q.timestamp == 0) & (q.memory_page == heap_page) & q.rw_flag & ~q.is_ptr
    )


def finish_stage(
    unsorted: MemoryQueries,
    sorted_q: MemoryQueries,
    execute: torch.Tensor,
    chain_u: torch.Tensor,
    chain_s: torch.Tensor,
    n: int,
    snapshot_length: Optional[int],
    heap_page: int,
) -> RamPermutationWitness:
    """Everything after the sponge chains, on the device of the inputs."""
    enc_u = encode_memory_queries(unsorted)
    enc_s = encode_memory_queries(sorted_q)
    zeros12 = gf.zeros((12,), execute.device)
    fs = chal.produce_fs_challenges(
        QueueState(zeros12, chain_u[-1], n),
        QueueState(zeros12, chain_s[-1], n),
        MEMORY_QUERY_PACKED_WIDTH + 1,
        NUM_REPETITIONS,
    )
    ones = gf.ones((NUM_REPETITIONS,), execute.device)
    lhs = chal.product_accumulate(
        chal.masked_factors(chal.grand_product_factors(enc_u, fs), execute), ones)
    rhs = chal.product_accumulate(
        chal.masked_factors(chal.grand_product_factors(enc_s, fs), execute), ones)
    is_nondet = _is_nondet_write(sorted_q, execute, heap_page)
    nondet_count = torch.cumsum(is_nondet.to(torch.int64), dim=0)
    if snapshot_length is None:
        snapshot_length = int(nondet_count[-1])
    return RamPermutationWitness(
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
        nondet_count=nondet_count,
        snapshot_length=snapshot_length,
    )


def generate_witness_host_tapes(
    tapes_unsorted: dict,
    tapes_sorted: dict,
    config: RamPermutationConfig,
    snapshot_length: Optional[int] = None,
    device=None,
) -> RamPermutationWitness:
    """numpy tapes in, a witness of tensors on `device` out (None: the card,
    `utils.device.default_device`).

    tapes_*: dict of numpy arrays {timestamp, memory_page, index, rw_flag,
    is_ptr, value (n, 8)}.  Rows are padded with zero queries to a whole
    number of instances of `config.limit` rows."""
    device = resolve_device(device)
    n = int(tapes_unsorted["timestamp"].shape[0])
    if int(tapes_sorted["timestamp"].shape[0]) != n:
        raise ValueError("queues must pop in lockstep")
    total = max(1, -(-n // config.limit)) * config.limit

    def pad(t):
        out = {}
        for k, v in t.items():
            v = np.asarray(v)
            if v.shape[0] != total:
                padshape = (total - v.shape[0],) + v.shape[1:]
                v = np.concatenate([v, np.zeros(padshape, dtype=v.dtype)])
            out[k] = v
        return out

    tu, ts_ = pad(tapes_unsorted), pad(tapes_sorted)
    execute_np = np.arange(total) < n
    enc = np.stack([encode_memory_queries_np(**tu), encode_memory_queries_np(**ts_)])
    ex2 = np.stack([execute_np, execute_np]).astype(np.uint8)
    init = np.zeros((2, 12), np.uint64)
    if config.chain_stride:
        chains = native.full_state_chains_strided(enc, ex2, init, config.chain_stride)
    else:
        chains = native.full_state_chains(enc, ex2, init)

    return finish_stage(
        MemoryQueries.from_numpy(tu, device),
        MemoryQueries.from_numpy(ts_, device),
        torch.from_numpy(execute_np).to(device),
        gf.from_u64(chains[0], device),
        gf.from_u64(chains[1], device),
        n,
        snapshot_length,
        config.bootloader_heap_page,
    )


def _pad_queries(q: MemoryQueries, total: int) -> MemoryQueries:
    n = q.shape[0]
    if n == total:
        return q
    pad = MemoryQueries.zeros((total - n,), q.timestamp.device)
    return MemoryQueries(*[
        torch.cat([getattr(q, f.name), getattr(pad, f.name)])
        for f in dataclasses.fields(MemoryQueries)
    ])


def generate_witness(
    unsorted: MemoryQueries,
    sorted_q: MemoryQueries,
    config: RamPermutationConfig,
    snapshot_length: Optional[int] = None,
    backend: str = "device",
) -> RamPermutationWitness:
    """The full trace from the two query tapes, on the tapes' device.

    backend: how the two sponge chains run (`queues.simulate_chains`):
    "device", step by step in torch; "host", the native C++ runtime."""
    n = unsorted.shape[0]
    if sorted_q.shape[0] != n:
        raise ValueError("queues must pop in lockstep")
    dev = unsorted.timestamp.device
    total = max(1, -(-n // config.limit)) * config.limit
    unsorted = _pad_queries(unsorted, total)
    sorted_q = _pad_queries(sorted_q, total)
    execute = torch.arange(total, device=dev) < n
    enc_u = encode_memory_queries(unsorted)
    enc_s = encode_memory_queries(sorted_q)
    chain_u, chain_s = queues.simulate_chains(
        queues.FULL_STATE_WIDTH, [(enc_u, execute), (enc_s, execute)], backend)
    return finish_stage(
        unsorted, sorted_q, execute, chain_u, chain_s, n, snapshot_length,
        config.bootloader_heap_page,
    )


def _sorting_key_gt_prev(cur: MemoryQueries, prev: MemoryQueries) -> torch.Tensor:
    """strict (page, index, timestamp) lexicographic cur > prev, row-wise."""
    pg_eq = cur.memory_page == prev.memory_page
    ix_eq = cur.index == prev.index
    return (
        (cur.memory_page > prev.memory_page)
        | (pg_eq & (cur.index > prev.index))
        | (pg_eq & ix_eq & (cur.timestamp > prev.timestamp))
    )


def _fs_challenges(w: RamPermutationWitness) -> torch.Tensor:
    zeros12 = gf.zeros((12,), w.execute.device)
    return chal.produce_fs_challenges(
        QueueState(zeros12, w.chain_unsorted[-1], w.n),
        QueueState(zeros12, w.chain_sorted[-1], w.n),
        MEMORY_QUERY_PACKED_WIDTH + 1,
        NUM_REPETITIONS,
    )


def eval_constraints(w: RamPermutationWitness, config: RamPermutationConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Row-parallel constraint evaluation; every entry must be all-True.
    `window` places a block of rows in its run (`parallel/auto.py`); None is
    the whole run."""
    dev = w.execute.device
    total = w.execute.shape[0]
    s = w.sorted
    true = torch.ones((), dtype=torch.bool, device=dev)

    # (1) queue sponge chains: one batched Poseidon2 each, or the segmented
    # recompute when the witness holds boundary states only (both chains in
    # one call, so that on the card they share one launch)
    if config.chain_stride:
        chain_u_ok, chain_s_ok = queues.check_chains_segmented([
            (w.chain_unsorted, w.enc_unsorted, w.execute),
            (w.chain_sorted, w.enc_sorted, w.execute),
        ])
    else:
        chain_u_ok = queues.check_chain(w.chain_unsorted, w.enc_unsorted, w.execute)
        chain_s_ok = queues.check_chain(w.chain_sorted, w.enc_sorted, w.execute)

    # (2) grand-product transitions, with the challenges recomputed from the tails
    fs = _fs_challenges(w)
    challenges_ok = gf.equal(fs, w.challenges).all()
    factors_u = chal.masked_factors(chal.grand_product_factors(w.enc_unsorted, fs), w.execute)
    factors_s = chal.masked_factors(chal.grand_product_factors(w.enc_sorted, fs), w.execute)
    ones = gf.ones((1, NUM_REPETITIONS), dev)
    prev_lhs = torch.cat([ones, w.lhs[:-1]])
    prev_rhs = torch.cat([ones, w.rhs[:-1]])
    lhs_ok = gf.equal(w.lhs, gf.mul(prev_lhs, factors_u)).all(-1)
    rhs_ok = gf.equal(w.rhs, gf.mul(prev_rhs, factors_s)).all(-1)

    # (3) the encodings match the query fields (packing recomputed)
    enc_u_ok = gf.equal(encode_memory_queries(w.unsorted), w.enc_unsorted).all(-1)
    enc_s_ok = gf.equal(encode_memory_queries(w.sorted), w.enc_sorted).all(-1)

    # (4) strict sort order on rows 1.. where executed (row 0 of the run is exempt)
    row_idx = torch.arange(total, device=dev)
    prev = s[(row_idx - 1).clamp(min=0)]
    not_first = row_idx > 0
    order_ok = torch.where(w.execute & not_first, _sorting_key_gt_prev(s, prev), true)

    # (5) RW semantics; row 0 of the run starts a fresh cell
    same_cell = (s.memory_page == prev.memory_page) & (s.index == prev.index) & not_first
    is_read = ~s.rw_flag
    value_zero = (s.value == 0).all(-1) & ~s.is_ptr
    value_eq_prev = (s.value == prev.value).all(-1) & (s.is_ptr == prev.is_ptr)
    uninit_read_ok = torch.where(w.execute & is_read & ~same_cell, value_zero, true)
    rw_read_ok = torch.where(w.execute & is_read & same_cell, value_eq_prev, true)

    # (6) the nondet counter's per-row transitions are not among the JAX
    # package's residuals (it computes them and drops them); the port returns
    # the same keys, so only the counter's final value is held, below

    # (7) completion: queues drained => lhs == rhs, counter == snapshot
    run_rows = window.total if window else total
    completed = torch.full((), run_rows >= w.n, dtype=torch.bool, device=dev)
    final_eq = gf.equal(w.lhs[total - 1], w.rhs[total - 1]).all()
    nondet_final_ok = w.nondet_count[total - 1] == w.snapshot_length

    return {
        "chain_unsorted": chain_u_ok,
        "chain_sorted": chain_s_ok,
        "challenges": challenges_ok,
        "lhs_transitions": lhs_ok,
        "rhs_transitions": rhs_ok,
        "encoding_unsorted": enc_u_ok,
        "encoding_sorted": enc_s_ok,
        "sort_order": order_ok,
        "uninit_read_zero": uninit_read_ok,
        "read_consistency": rw_read_ok,
        "grand_product_final": ~completed | final_eq,
        "nondet_writes_final": ~completed | nondet_final_ok,
    }


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())


def _rows_of_a_state_a_row(config: RamPermutationConfig, rows: int) -> RamPermutationConfig:
    if config.chain_stride:
        raise NotImplementedError("a strided chain (chain_stride) cannot be row-sharded: "
                                  "its states do not lie a row apart")
    return config


# row-sharded: a row reads the previous row (products, order) and the next
# chain state; the challenges are drawn from the run's queue tails
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 1),
    replicated=frozenset({"challenges"}),
    tails=frozenset({"chain_unsorted", "chain_sorted"}),
    last=frozenset({"challenges", "grand_product_final", "nondet_writes_final"}),
    takes_window=True,
    window_config=_rows_of_a_state_a_row,
)


# PyTorch runs eagerly: the counterpart of the JAX package's jitted name.
eval_constraints_jit = eval_constraints


# ---------------------------------------------------------------------------
# ClosedFormInput per instance
# ---------------------------------------------------------------------------


def instance_compact_forms(
    w: RamPermutationWitness, config: RamPermutationConfig
) -> protocol.ClosedFormInputCompactForm:
    """Per-instance ClosedFormInput compact forms, batched over the k
    instances.  FSM payload: [lhs(2), rhs(2), unsorted_queue_state(25),
    sorted_queue_state(25), previous_sorting_key(3), previous_full_key(2),
    previous_value(8), previous_is_ptr(1), num_nondeterministic_writes(1)]
    = 69 elements."""
    dev = w.execute.device
    total = w.execute.shape[0]
    limit = config.limit
    k = total // limit
    stride = config.chain_stride or 1
    if limit % stride and k != 1:
        raise ValueError("chain_stride must divide the instance limit for FSM snapshots")

    # FSM snapshots after b rows, b on the k + 1 instance boundaries
    bounds = torch.arange(k + 1, device=dev) * limit
    prev_row = (bounds - 1).clamp(min=0)
    at_start = bounds == 0
    col = at_start.unsqueeze(-1)
    ones = gf.ones((k + 1, NUM_REPETITIONS), dev)
    remaining = w.n - bounds.clamp(max=w.n)
    tail_u = w.chain_unsorted[-1].expand(k + 1, -1)
    tail_s = w.chain_sorted[-1].expand(k + 1, -1)
    cb = bounds // stride
    srow = w.sorted[prev_row]

    def sel(v):
        return torch.where(at_start if v.dim() == 1 else col, torch.zeros_like(v), v)

    fsm_states = torch.cat(
        [
            torch.where(col, ones, w.lhs[prev_row]),
            torch.where(col, ones, w.rhs[prev_row]),
            protocol.encode_queue_state_generic(w.chain_unsorted[cb], tail_u, remaining),
            protocol.encode_queue_state_generic(w.chain_sorted[cb], tail_s, remaining),
            torch.stack([sel(srow.timestamp), sel(srow.index), sel(srow.memory_page)], dim=-1),
            torch.stack([sel(srow.index), sel(srow.memory_page)], dim=-1),
            sel(srow.value),
            protocol.bool_to_gf(srow.is_ptr & ~at_start).unsqueeze(-1),
            sel(w.nondet_count[prev_row]).unsqueeze(-1),
        ],
        dim=-1,
    )  # (k + 1, 69)

    # observable input: both initial queue states and the snapshot length
    zeros12 = gf.zeros((12,), dev)
    obs_in = torch.cat(
        [
            protocol.encode_queue_state_generic(zeros12, w.chain_unsorted[-1], w.n),
            protocol.encode_queue_state_generic(zeros12, w.chain_sorted[-1], w.n),
            torch.tensor([w.snapshot_length], dtype=torch.int64, device=dev),
        ]
    ).expand(k, -1)
    obs_out = gf.zeros((k, 0), dev)  # the observable output is (): an empty encoding

    inst = torch.arange(k, device=dev)
    return protocol.compact_form_from_parts(
        inst == 0, (inst + 1) * limit >= w.n, obs_in, obs_out, fsm_states[:-1], fsm_states[1:]
    )
