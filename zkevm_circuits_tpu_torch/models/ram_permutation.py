"""ram_permutation (circuit type 8): the witness of the memory-consistency
argument, as the JAX package's `models/ram_permutation.py` builds it.

Two full-state queues (unsorted from the VM, prover-sorted) are popped in
lockstep; multiset equality is checked by NUM_REPETITIONS = 2 grand
products over the 8-element memory-query encodings, with Fiat-Shamir
challenges derived from both queue tails.  Nondeterministic bootloader-heap
writes (timestamp 0, heap page, write, not a pointer) are counted.

Witness generation: the tapes are encoded with numpy and the two sequential
sponge chains run in the native C++ runtime on the host; the finish stage
(re-encoding, challenges, factors, running products, the nondet count) runs
in torch on `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from zkevm_circuits_tpu.isa.system_params import BOOTLOADER_HEAP_PAGE

from ..base_structures.memory_query import (
    MEMORY_QUERY_PACKED_WIDTH,
    MemoryQueries,
    encode_memory_queries,
    encode_memory_queries_np,
)
from ..ops import gf
from ..ops.queues import QueueState
from ..runtime import native
from ..utils import challenges as chal

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
    is_nondet = (
        execute
        & (sorted_q.timestamp == 0)
        & (sorted_q.memory_page == heap_page)
        & sorted_q.rw_flag
        & ~sorted_q.is_ptr
    )
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
    """numpy tapes in, a witness of tensors on `device` out.

    tapes_*: dict of numpy arrays {timestamp, memory_page, index, rw_flag,
    is_ptr, value (n, 8)}.  Rows are padded with zero queries to a whole
    number of instances of `config.limit` rows."""
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
