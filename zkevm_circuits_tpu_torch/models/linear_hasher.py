"""linear_hasher, circuit type 13: the L1-messages pubdata hasher (the JAX
package's `models/linear_hasher.py`).

Reference parity: `src/linear_hasher/` (entry mod.rs:~50-214).  Single
instance only (start_flag enforced true, mod.rs:67); pops the L1-message
queue, serializes each LogQuery to L2_TO_L1_MESSAGE_BYTE_LENGTH = 88 bytes
(`into_bytes`, log_query/mod.rs:645-686):

    shard_id(1) || is_service(1) || tx_number_be[2..4](2) || address_be(20)
    || key_be(32) || written_value_be(32)

streams them through keccak256 with 136-byte-rate buffering and 0x01/0x80
padding (mod.rs:105-168), and exposes the 32-byte digest.  An empty queue
yields keccak256("") (mod.rs:87-95), which the uniform padding produces.

The ragged byte buffering is a static layout: the padded byte stream is
materialized as (B, 136) blocks (B = max blocks for the instance capacity)
and every check (serialization, stream gather, block transitions, digest
extraction) is batch-parallel.  The keccak state chain over blocks, the only
sequential part, is built on the host with `keccak.keccak_f1600_ref` and
uploaded once; `eval_constraints` checks every block transition at once with
the batched `keccak.absorb_block` on the witness's device.  The input queue's
sponge chain goes through the native runtime (`backend="host"`) or the step
loop (`backend="device"`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..base_structures.log_query import LogQueries, encode_log_queries
from ..ops import gf, keccak, queues
from ..utils import protocol
from ..utils.shard_plan import Axis, RowWindow, ShardPlan
from .demux_log_queue import pad_log_queries

L2_TO_L1_MESSAGE_BYTE_LENGTH = 88
RATE = keccak.KECCAK_RATE_BYTES  # 136


@dataclasses.dataclass(frozen=True)
class LinearHasherConfig:
    limit: int  # queue-pop capacity of the (single) instance


def serialize_l2_l1_bytes(q: LogQueries) -> torch.Tensor:
    """(..., 88) int64 byte values, the exact reference layout."""

    def be_bytes(limbs, n_limbs):
        # limbs: (..., n) u32 little-endian limb order -> big-endian bytes
        return [(limbs[..., k] >> (8 * j)) & 0xFF
                for k in range(n_limbs - 1, -1, -1) for j in (3, 2, 1, 0)]

    cols = [q.shard_id & 0xFF, q.is_service.to(torch.int64)]
    # tx_number_in_block: 4 BE bytes, top 2 dropped (enforced zero)
    cols.append((q.tx_number_in_block >> 8) & 0xFF)
    cols.append(q.tx_number_in_block & 0xFF)
    cols.extend(be_bytes(q.address, 5))
    cols.extend(be_bytes(q.key, 8))
    cols.extend(be_bytes(q.written_value, 8))
    return torch.stack(cols, dim=-1)


def _build_blocks(msg_bytes: torch.Tensor, n: int, max_blocks: int, first: int = 0,
                  count: Optional[int] = None):
    """Flatten (N, 88) messages of which the first n are real, pad keccak-style,
    return ((B, 17) lane lo, (B, 17) lane hi, (B,) execute, nblocks) of the
    `count` blocks from block `first` (all `max_blocks` by default)."""
    dev = msg_bytes.device
    count = max_blocks - first if count is None else count
    flat = msg_bytes.reshape(-1)
    idx = torch.arange(first * RATE, (first + count) * RATE, device=dev)
    stream = torch.where(idx < flat.shape[0], flat[idx.clamp(max=flat.shape[0] - 1)],
                         torch.zeros_like(idx))
    msg_len = n * L2_TO_L1_MESSAGE_BYTE_LENGTH
    nblocks = msg_len // RATE + 1
    stream = torch.where(idx < msg_len, stream, torch.zeros_like(stream))
    stream = torch.where(idx == msg_len, torch.full_like(stream, 0x01), stream)
    stream = torch.where(idx == nblocks * RATE - 1, stream | 0x80, stream)
    # bytes -> 64-bit lanes (17 per block), little-endian within lane
    lo, hi = keccak.lane_halves(stream.reshape(count, RATE))
    execute = torch.arange(first, first + count, device=dev) < nblocks
    return lo, hi, execute, nblocks


def _keccak_chain_host(block_lo: torch.Tensor, block_hi: torch.Tensor, execute: torch.Tensor):
    """The keccak state chain over the blocks on the host (python ints,
    `keccak_f1600_ref`), every state, (B+1, 25) lo / hi uploaded to the
    blocks' device."""
    lanes = (block_lo.cpu().numpy().astype(np.uint64)
             | (block_hi.cpu().numpy().astype(np.uint64) << np.uint64(32))).tolist()
    ex = execute.cpu().tolist()
    state = [0] * 25
    states = [state]
    for blk, run in zip(lanes, ex):
        if run:
            state = keccak.keccak_f1600_ref(
                [s ^ b for s, b in zip(state, blk)] + state[len(blk):])
        states.append(state)
    full = np.asarray(states, dtype=np.uint64)
    lo = (full & np.uint64(keccak.M32)).astype(np.int64)
    hi = (full >> np.uint64(32)).astype(np.int64)
    dev = block_lo.device
    return torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)


@dataclasses.dataclass(frozen=True)
class LinearHasherWitness:
    n: int
    execute: torch.Tensor  # (N,)
    queries: LogQueries
    encodings: torch.Tensor
    input_chain: torch.Tensor  # (N+1, 4)
    msg_bytes: torch.Tensor  # (N, 88)
    block_lo: torch.Tensor  # (B, 17)
    block_hi: torch.Tensor
    block_execute: torch.Tensor  # (B,)
    state_lo: torch.Tensor  # (B+1, 25)
    state_hi: torch.Tensor
    digest: torch.Tensor  # (32,) bytes


def _max_blocks(limit: int) -> int:
    return (limit * L2_TO_L1_MESSAGE_BYTE_LENGTH) // RATE + 1


def generate_witness(queries: LogQueries, config: LinearHasherConfig,
                     backend: str = "host") -> LinearHasherWitness:
    """The trace from the L1-message queue, on its device.  backend: how the
    input queue's sponge chain runs (`queues.simulate_chains`); the keccak
    chain always runs on the host."""
    n = queries.shape[0]
    total = config.limit
    if n > total:
        raise ValueError(f"linear_hasher is single-instance (ref mod.rs:67): {n} > {total}")
    dev = queries.timestamp.device
    queries = pad_log_queries(queries, total)
    execute = torch.arange(total, device=dev) < n
    enc = encode_log_queries(queries)
    (input_chain,) = queues.simulate_chains(queues.NARROW_STATE_WIDTH, [(enc, execute)], backend)
    msg_bytes = serialize_l2_l1_bytes(queries)
    blo, bhi, bex, nblocks = _build_blocks(msg_bytes, n, _max_blocks(total))
    slo, shi = _keccak_chain_host(blo, bhi, bex)
    return LinearHasherWitness(
        n=n,
        execute=execute,
        queries=queries,
        encodings=enc,
        input_chain=input_chain,
        msg_bytes=msg_bytes,
        block_lo=blo,
        block_hi=bhi,
        block_execute=bex,
        state_lo=slo,
        state_hi=shi,
        digest=keccak.digest_bytes(slo[nblocks], shi[nblocks]),
    )


def eval_constraints(w: LinearHasherWitness, config: LinearHasherConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Batch-parallel constraint evaluation; every entry must be all-True.
    `window` places a block of queries and one of keccak blocks in their
    run (`parallel/auto.py`); None is the whole run."""
    rows = w.execute.shape[0]
    row0, total = (window.row0, window.total) if window else (0, rows)
    b0 = window.axes["blocks"].row0 if window else 0
    enc_ok = gf.equal(encode_log_queries(w.queries), w.encodings).all(-1)
    chain_ok = queues.check_chain(w.input_chain, w.encodings, w.execute)
    ser_ok = (serialize_l2_l1_bytes(w.queries) == w.msg_bytes[row0:row0 + rows]).all(-1)
    # tx number must fit in 16 bits (truncated BE bytes enforced zero)
    tx_ok = ~w.execute | (w.queries.tx_number_in_block < (1 << 16))
    blo, bhi, bex, nblocks = _build_blocks(w.msg_bytes, w.n, _max_blocks(total), b0,
                                           w.block_execute.shape[0])
    blocks_ok = (blo == w.block_lo).all(-1) & (bhi == w.block_hi).all(-1) & (bex == w.block_execute)
    # batch-parallel keccak transition check
    exp_lo, exp_hi = keccak.absorb_block(w.state_lo[:-1], w.state_hi[:-1], w.block_lo, w.block_hi)
    run = w.block_execute.unsqueeze(-1)
    exp_lo = torch.where(run, exp_lo, w.state_lo[:-1])
    exp_hi = torch.where(run, exp_hi, w.state_hi[:-1])
    keccak_ok = ((exp_lo == w.state_lo[1:]) & (exp_hi == w.state_hi[1:])).all(-1)
    # the digest is read at the run's last executed block, clamped to the
    # run's last state as the JAX package's gather clamps an `n` past the
    # run: the window holding that state checks it, the others hold true
    at = min(nblocks, _max_blocks(total)) - b0
    digest_ok = torch.ones((), dtype=torch.bool, device=w.digest.device)
    if 0 <= at < w.state_lo.shape[0]:
        digest_ok = (keccak.digest_bytes(w.state_lo[at], w.state_hi[at]) == w.digest).all()
    return {
        "encodings": enc_ok,
        "input_chain": chain_ok,
        "serialization": ser_ok,
        "tx_number_range": tx_ok,
        "blocks": blocks_ok,
        "keccak_chain": keccak_ok,
        "digest": digest_ok,
    }


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())


# row-sharded over the queries and, as a further axis, over the keccak
# blocks (the keccak work); the serialized messages stay whole on every
# member, for a block window reads the bytes of its own blocks by range;
# the digest, at the run's last executed block, is ANDed over the members
eval_constraints.shard_plan = ShardPlan(
    rows=frozenset({"execute", "queries", "encodings", "input_chain"}),
    axes={"blocks": Axis(rows_of="block_execute",
                         fields=frozenset({"block_lo", "block_hi", "block_execute",
                                           "state_lo", "state_hi"}),
                         residuals=frozenset({"blocks", "keccak_chain"}))},
    every=frozenset({"digest"}),
    takes_window=True,
)


def serialize_l2_l1_ref(row: dict) -> bytes:
    """Host mirror of the 88-byte serialization."""
    out = bytearray()
    out.append(int(row.get("shard_id", 0)) & 0xFF)
    out.append(1 if row.get("is_service") else 0)
    out += int(row.get("tx_number_in_block", 0)).to_bytes(4, "big")[2:]
    out += int(row.get("address", 0)).to_bytes(20, "big")
    out += int(row.get("key", 0)).to_bytes(32, "big")
    out += int(row.get("written_value", 0)).to_bytes(32, "big")
    if len(out) != L2_TO_L1_MESSAGE_BYTE_LENGTH:
        raise ValueError(f"a message serializes to {L2_TO_L1_MESSAGE_BYTE_LENGTH} bytes")
    return bytes(out)


# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


def instance_compact_form(w: LinearHasherWitness, config: LinearHasherConfig):
    """Single-instance ClosedFormInput: input = queue state, output = the
    32-byte keccak hash (LinearHasherOutputData)."""
    total = w.execute.shape[0]
    in_qs = protocol.encode_queue_state_generic(
        gf.zeros((4,), w.execute.device), w.input_chain[total], w.n)
    return protocol.single_instance_compact_form(in_qs[None], w.digest[None])
