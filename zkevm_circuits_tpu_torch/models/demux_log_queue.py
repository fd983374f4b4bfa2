"""demux_log_queue, circuit type 4: the log-queue demultiplexer (the JAX
package's `models/demux_log_queue.py`).

Reference parity: `src/demux_log_queue/` (`demultiplex_storage_logs_inner`
mod.rs:234-..., `LogType` mod.rs:222-232).  Routes the VM's unified log queue
into NUM_SEPARATE_QUEUES = 6 output queues by aux_byte / precompile address:

    rollup storage   aux==STORAGE  && shard_id == 0 (porter shard FORBIDDEN)
    events           aux==EVENT
    L1 messages      aux==L1_MESSAGE
    keccak calls     aux==PRECOMPILE && address == keccak formal address
    sha256 calls     aux==PRECOMPILE && address == sha256 formal address
    ecrecover calls  aux==PRECOMPILE && address == ecrecover formal address

All routing decisions are row-parallel; the 6 output tails are sponge chains
over the same 20-element encodings with per-queue execute masks.  Witness
generation runs the input chain and the six output chains in one call of the
native runtime (`backend="host"`) or the step loop (`backend="device"`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..base_structures.log_query import LogQueries, encode_log_queries
from ..isa.system_params import (
    ECRECOVER_PRECOMPILE_FORMAL_ADDRESS,
    EVENT_AUX_BYTE,
    KECCAK256_PRECOMPILE_FORMAL_ADDRESS,
    L1_MESSAGE_AUX_BYTE,
    PRECOMPILE_AUX_BYTE,
    SHA256_PRECOMPILE_FORMAL_ADDRESS,
    STORAGE_AUX_BYTE,
)
from ..ops import gf, queues
from ..ops.queues import QueueState
from ..utils import protocol
from ..utils.shard_plan import ShardPlan

NUM_SEPARATE_QUEUES = 6
QUEUE_NAMES = (
    "rollup_storage",
    "events",
    "l1_messages",
    "keccak",
    "sha256",
    "ecrecover",
)


@dataclasses.dataclass(frozen=True)
class DemuxConfig:
    limit: int


def _address_equals(addr: torch.Tensor, const: int) -> torch.Tensor:
    ok = torch.ones(addr.shape[:-1], dtype=torch.bool, device=addr.device)
    for i in range(5):
        ok = ok & (addr[..., i] == ((const >> (32 * i)) & 0xFFFFFFFF))
    return ok


def route_flags(q: LogQueries, execute: torch.Tensor):
    """Per-row routing masks + the porter-forbidden residual."""
    aux = q.aux_byte
    is_storage = aux == STORAGE_AUX_BYTE
    is_precompile = aux == PRECOMPILE_AUX_BYTE
    is_rollup_shard = q.shard_id == 0
    flags = {
        "rollup_storage": execute & is_storage & is_rollup_shard,
        "events": execute & (aux == EVENT_AUX_BYTE),
        "l1_messages": execute & (aux == L1_MESSAGE_AUX_BYTE),
        "keccak": execute & is_precompile
        & _address_equals(q.address, KECCAK256_PRECOMPILE_FORMAL_ADDRESS),
        "sha256": execute & is_precompile
        & _address_equals(q.address, SHA256_PRECOMPILE_FORMAL_ADDRESS),
        "ecrecover": execute & is_precompile
        & _address_equals(q.address, ECRECOVER_PRECOMPILE_FORMAL_ADDRESS),
    }
    porter_forbidden = ~(execute & is_storage & ~is_rollup_shard)
    return flags, porter_forbidden


@dataclasses.dataclass(frozen=True)
class DemuxWitness:
    n: int
    execute: torch.Tensor
    queries: LogQueries  # (N,)
    encodings: torch.Tensor  # (N, 20)
    input_chain: torch.Tensor  # (N+1, 4)
    out_flags: dict  # name -> (N,) bool
    out_chains: dict  # name -> (N+1, 4)
    out_counts: dict  # name -> (N,) int64


def pad_log_queries(q: LogQueries, total: int) -> LogQueries:
    """q with zero queries appended up to `total` rows."""
    n = q.shape[0]
    if n == total:
        return q
    pad = LogQueries.zeros((total - n,), q.timestamp.device)
    return LogQueries(*[
        torch.cat([getattr(q, f.name), getattr(pad, f.name)])
        for f in dataclasses.fields(LogQueries)
    ])


def generate_witness(queries: LogQueries, config: DemuxConfig, backend: str = "host") -> DemuxWitness:
    """The trace from the unified log tape, on its device.  backend: how the
    seven sponge chains run (`queues.simulate_chains`)."""
    n = queries.shape[0]
    dev = queries.timestamp.device
    total = max(1, -(-n // config.limit)) * config.limit
    queries = pad_log_queries(queries, total)
    execute = torch.arange(total, device=dev) < n
    enc = encode_log_queries(queries)
    flags, _ = route_flags(queries, execute)
    chains = queues.simulate_chains(
        queues.NARROW_STATE_WIDTH,
        [(enc, execute)] + [(enc, flags[name]) for name in QUEUE_NAMES],
        backend,
    )
    return DemuxWitness(
        n=n,
        execute=execute,
        queries=queries,
        encodings=enc,
        input_chain=chains[0],
        out_flags=flags,
        out_chains=dict(zip(QUEUE_NAMES, chains[1:])),
        out_counts={name: torch.cumsum(flags[name].to(torch.int64), dim=0)
                    for name in QUEUE_NAMES},
    )


def eval_constraints(w: DemuxWitness, config: DemuxConfig) -> dict:
    """Row-parallel constraint evaluation; every entry must be all-True."""
    total = w.execute.shape[0]
    dev = w.execute.device
    enc_ok = gf.equal(encode_log_queries(w.queries), w.encodings).all(-1)
    input_chain_ok = queues.check_chain(w.input_chain, w.encodings, w.execute)
    flags, porter_ok = route_flags(w.queries, w.execute)
    res = {
        "encodings": enc_ok,
        "input_chain": input_chain_ok,
        "porter_forbidden": porter_ok,
    }
    # each executed row routes to exactly one queue or none (plain log types)
    total_routed = torch.zeros(total, dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    for name in QUEUE_NAMES:
        res[f"flags_{name}"] = flags[name] == w.out_flags[name]
        res[f"chain_{name}"] = queues.check_chain(
            w.out_chains[name], w.encodings, w.out_flags[name]
        )
        prev = torch.cat([zero, w.out_counts[name][:-1]])
        res[f"count_{name}"] = w.out_counts[name] == prev + w.out_flags[name].to(torch.int64)
        total_routed = total_routed + flags[name].to(torch.int64)
    res["at_most_one_route"] = total_routed <= 1
    return res


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())


# row-sharded: a row reads the previous row's output counts; the input and
# output chains' after-states are the fields' extra entries
eval_constraints.shard_plan = ShardPlan(halo=(1, 0))


def output_queue_states(w: DemuxWitness) -> dict:
    """name -> the output queue's final QueueState (head zeros, the tail at row
    N, the count after the last row)."""
    total = w.execute.shape[0]
    zeros4 = gf.zeros((4,), w.execute.device)
    return {
        name: QueueState(zeros4, w.out_chains[name][total], w.out_counts[name][total - 1])
        for name in QUEUE_NAMES
    }


# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


def instance_compact_form(w: DemuxWitness, config: DemuxConfig):
    """Single-instance ClosedFormInput: input = the unified log queue state,
    output = the 6 demuxed queue states (ref demux input.rs)."""
    total = w.execute.shape[0]
    zeros4 = gf.zeros((4,), w.execute.device)
    in_qs = protocol.encode_queue_state_generic(zeros4, w.input_chain[total], w.n)
    outs = [
        protocol.encode_queue_state_generic(
            zeros4, w.out_chains[name][total], w.out_counts[name][total - 1])
        for name in QUEUE_NAMES
    ]
    return protocol.single_instance_compact_form(in_qs[None], torch.cat(outs, dim=-1)[None])
