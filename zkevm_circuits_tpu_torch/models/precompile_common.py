"""What the code unpacker (type 3) and the keccak, sha256 and ecrecover
precompile circuits (types 5, 6, 7) share: padded query batches from host
rows, the group offsets and scatter sums of their row-parallel checks, and
their compact forms (the precompile I/O shape, ref
base_structures/precompile_input_outputs/mod.rs:23-44: the input queue's
state and the memory queue's initial state in, the memory queue's final
state out).

The JAX package writes each of these inline in every circuit; the values
are the same.  The u32 arithmetic of its checks wraps at 2^32, so the sums
that can pass it here are cut back with `& M32`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..base_structures.log_query import LogQueries
from ..base_structures.memory_query import MemoryQueries
from ..ops import gf
from ..utils import protocol
from ..utils.shard_plan import RowWindow

M32 = 0xFFFFFFFF

_ZERO_MEMORY_ROW = dict(timestamp=0, memory_page=0, index=0, rw_flag=False, is_ptr=False, value=0)
_ZERO_CALL_ROW = dict(address=0, key=0, read_value=0, written_value=0, aux_byte=0,
                      rw_flag=False, rollback=False, is_service=False, shard_id=0,
                      tx_number_in_block=0, timestamp=0)


def key_limbs(key: int) -> list:
    """the 8 little-endian u32 limbs of a 256-bit ABI key."""
    key = int(key)
    return [(key >> (32 * k)) & M32 for k in range(8)]


def memory_rows(rows: Sequence[dict], count: int, device) -> MemoryQueries:
    """`rows` (dicts of memory-query fields; other keys ignored) padded with
    zero queries to `count`."""
    rows = list(rows)
    if len(rows) > count:
        raise ValueError(f"{len(rows)} memory rows do not fit {count}")
    return MemoryQueries.from_lists(rows + [_ZERO_MEMORY_ROW] * (count - len(rows)), device)


def call_rows(calls: Sequence[dict], count: int, device) -> LogQueries:
    """the call queue, padded with zero queries to `count`."""
    calls = list(calls)
    return LogQueries.from_lists(calls + [_ZERO_CALL_ROW] * (count - len(calls)), device)


def executed(count: int, n: int, device) -> torch.Tensor:
    return torch.arange(count, device=device) < n


def offset_within_group(first: torch.Tensor, row0: int = 0, carry: int = 0) -> torch.Tensor:
    """row index minus the index of the last row at or before it where
    `first` holds (0 where none did): a row's offset inside its group.
    For a window of a longer run (`utils.shard_plan.RowWindow`), row j is
    run row row0 + j and `carry` is the last run row before the window where
    `first` holds."""
    idx = torch.arange(row0, row0 + first.shape[0], device=first.device)
    return idx - torch.cummax(torch.where(first, idx, torch.full_like(idx, carry)), dim=0).values


def group_offsets(first: torch.Tensor, window: Optional[RowWindow] = None) -> torch.Tensor:
    """`offset_within_group` of a run, or of a window of one: the window's
    rows before its own block start no group (the window's `flag_carry`
    stands for the last start before the block)."""
    if window is None:
        return offset_within_group(first)
    own = torch.arange(first.shape[0], device=first.device) >= window.own[0]
    return offset_within_group(first & own, window.row0, window.flag_carry)


def group_starts(group: torch.Tensor) -> torch.Tensor:
    """True where `group` changes (and at row 0)."""
    first = torch.ones_like(group, dtype=torch.bool)
    first[1:] = group[1:] != group[:-1]
    return first


def scatter_add(n: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """zeros(n).at[index].add(values, mode="drop"): indices out of [0, n)
    add nothing; the sums are u32 (cut at 2^32)."""
    keep = (index >= 0) & (index < n)
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=torch.int64, device=values.device)
    mask = keep.reshape(keep.shape + (1,) * (values.dim() - 1))
    values = values.to(torch.int64)
    out.index_add_(0, torch.where(keep, index, torch.zeros_like(index)),
                   torch.where(mask, values, torch.zeros_like(values)))
    return out & M32


def address_is(address: torch.Tensor, formal: int) -> torch.Tensor:
    """(..., 5) u160 limbs equal the formal address."""
    ok = torch.ones(address.shape[:-1], dtype=torch.bool, device=address.device)
    for i in range(5):
        ok = ok & (address[..., i] == ((formal >> (32 * i)) & M32))
    return ok


def bswap32(x: torch.Tensor) -> torch.Tensor:
    return ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00) | (x >> 24)


def precompile_io(call_chain: torch.Tensor, num_calls: int, mem_chain: torch.Tensor, n_mem):
    """(observable input, observable output) encodings of one precompile-shaped
    instance: [call queue state, memory queue initial state] and the memory
    queue's final state.  `call_chain` (C + 1, W), `mem_chain` (M + 1, 12)."""
    dev = call_chain.device
    width = call_chain.shape[-1]
    calls_qs = protocol.encode_queue_state_generic(
        gf.zeros((width,), dev), call_chain[call_chain.shape[0] - 1], num_calls)
    mem_initial = protocol.encode_queue_state_generic(gf.zeros((12,), dev), mem_chain[0], 0)
    mem_final = protocol.encode_queue_state_generic(
        gf.zeros((12,), dev), mem_chain[mem_chain.shape[0] - 1], n_mem)
    return torch.cat([calls_qs, mem_initial], dim=-1), mem_final


def single_instance_form(call_chain, num_calls, mem_chain, n_mem):
    """the one-instance compact form of the precompile I/O shape."""
    obs_in, obs_out = precompile_io(call_chain, num_calls, mem_chain, n_mem)
    return protocol.single_instance_compact_form(obs_in[None], obs_out[None])


def multi_instance_forms(call_chain, num_calls, mem_chain, n_mem, fsm_states,
                         n_rows, limit: int):
    """The ClosedFormInput compact forms of the row axis cut into instances of
    `limit` rows: the same observable input and output for each, the hidden
    FSM states at the k + 1 boundaries, instance 0 starting and those at or
    past the last executed row completing."""
    obs_in, obs_out = precompile_io(call_chain, num_calls, mem_chain, n_mem)
    k = fsm_states.shape[0] - 1
    dev = fsm_states.device
    steps = torch.arange(k, device=dev)
    start_flags = steps == 0
    completion_flags = (steps + 1) * limit >= n_rows
    return protocol.compact_form_from_parts(
        start_flags, completion_flags, obs_in.expand((k,) + tuple(obs_in.shape)),
        obs_out.expand((k,) + tuple(obs_out.shape)), fsm_states[:-1], fsm_states[1:])


def boundaries(n: int, limit: int, device) -> torch.Tensor:
    if n % limit:
        raise ValueError(f"instances of {limit} rows do not divide {n}")
    return torch.arange(n // limit + 1, device=device) * limit


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())
