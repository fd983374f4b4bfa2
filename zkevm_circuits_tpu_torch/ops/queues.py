"""Circuit queues as tensor programs (the JAX package's `ops/queues.py`).

A queue trace holds the per-element sponge states as dense columns.  The
chain is sequential, but once it is written down, checking every transition
`state[i+1] == absorb(state[i], enc[i])` is row-parallel: one batched
Poseidon2 over all rows.

Sponge conventions:
  * Full-state queue (W = 12): the tail IS the 12-lane sponge state.
    push(enc8): state' = P(state with the rate lanes replaced by enc8).
  * Narrow queue (W = 4): the tail is 4 lanes.  push(enc_L):
      s = zeros(12); s[8:12] = tail
      for each 8-chunk of the zero-padded encoding: s[0:8] = chunk; s = P(s)
      tail' = s[0:4]
  * The length grows by 1 per executed push or pop.

`simulate_chain` steps through the chain in a Python loop, one batched
permutation (one kernel launch on the card) per step; bulk tapes go through
the native runtime (`runtime/native.py`), several chains in one call through
`simulate_chains(..., backend="host")`.  The segmented recompute
(`check_chain_segmented`) of a full-state chain on the card is one launch of
the fused chain kernel (`ops/poseidon2_cuda.py:chain_segmented_cuda`), the
two chains of an evaluation sharing it; on the CPU, and for the narrow queue
on either device, it is the step loop of `segment_landing_states_plain`
(for a narrow chain on the card each step still launches the permutation
kernel once per 8-chunk).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from . import gf, poseidon2

FULL_STATE_WIDTH = 12
NARROW_STATE_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class QueueState:
    """head lanes, tail lanes, length (a python int, or an int64 tensor of
    the batch shape)."""

    head: torch.Tensor  # (..., W)
    tail: torch.Tensor  # (..., W)
    length: Union[int, torch.Tensor]

    @property
    def width(self) -> int:
        return self.head.shape[-1]


def empty_queue_state(width: int, batch_shape=(), device=None) -> QueueState:
    """The empty queue; `device=None` is the card, or an error without one."""
    device = resolve_device(device)
    z = gf.zeros(tuple(batch_shape) + (width,), device)
    return QueueState(z, z, torch.zeros(tuple(batch_shape), dtype=torch.int64, device=device))


def is_queue_empty(state: QueueState):
    return state.length == 0


def queue_states_equal(a: QueueState, b: QueueState):
    heads = gf.equal(a.head, b.head).all(-1)
    tails = gf.equal(a.tail, b.tail).all(-1)
    return heads & tails & (a.length == b.length)


# ---------------------------------------------------------------------------
# single transitions (batch-parallel over the leading axes)
# ---------------------------------------------------------------------------


def full_state_transition(state: torch.Tensor, encoding: torch.Tensor, execute: torch.Tensor):
    """W = 12 push; identity where not executed.
    state (..., 12), encoding (..., 8), execute (...,) bool."""
    new = poseidon2.absorb_round(encoding, state)
    return gf.select(execute.unsqueeze(-1), new, state)


def narrow_state_transition(tail: torch.Tensor, encoding: torch.Tensor, execute: torch.Tensor):
    """W = 4 push (multi-chunk absorb); identity where not executed.
    tail (..., 4), encoding (..., L), execute (...,) bool."""
    batch = tuple(tail.shape[:-1])
    dev = tail.device
    length = encoding.shape[-1]
    padded = length + (-length) % poseidon2.RATE
    if padded != length:
        encoding = torch.cat([encoding, gf.zeros(batch + (padded - length,), dev)], dim=-1)
    state = torch.cat([gf.zeros(batch + (poseidon2.RATE,), dev), tail], dim=-1)
    for i in range(0, padded, poseidon2.RATE):
        state = poseidon2.absorb_round(encoding[..., i : i + poseidon2.RATE], state)
    return gf.select(execute.unsqueeze(-1), state[..., :NARROW_STATE_WIDTH], tail)


def transition(state_lanes: torch.Tensor, encoding: torch.Tensor, execute: torch.Tensor):
    if state_lanes.shape[-1] == FULL_STATE_WIDTH:
        return full_state_transition(state_lanes, encoding, execute)
    return narrow_state_transition(state_lanes, encoding, execute)


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------


def _all_executed(n: int, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.bool, device=device)


def simulate_chain(
    init_lanes: torch.Tensor, encodings: torch.Tensor, execute: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The sponge chain over n elements, all n + 1 states.

    init_lanes (W,), encodings (n, L), execute (n,) bool or None.  Returns
    (n + 1, W): states[0] == init, states[i+1] = push(states[i], enc[i]).
    Sequential: for one instance's rows; bulk tapes use the native runtime."""
    n = encodings.shape[0]
    if execute is None:
        execute = _all_executed(n, encodings.device)
    states = [init_lanes]
    for i in range(n):
        states.append(transition(states[-1], encodings[i], execute[i]))
    return torch.stack(states)


def simulate_chains(
    width: int, chains: Sequence[Tuple[torch.Tensor, torch.Tensor]], backend: str = "host",
    init: Optional[Sequence] = None,
) -> List[torch.Tensor]:
    """Several sponge chains, every state of each.

    chains: [(encodings (n_k, L), execute (n_k,) bool)], all of one encoding
    length L and on one device; returns [(n_k + 1, W)] on that device.
    init: each chain's first state ((W,) field tensor, u64 numpy or ints; None
    for the empty state), or None for all of them empty: a memory chain that
    continues where the previous circuit's stopped starts from its last state.
    backend="host": one call of the native runtime for all of them (the
    shorter chains padded to the longest with rows not executed, then cut
    back), one download of the encodings and one upload of the states; the
    witness path on the card.
    backend="device": `simulate_chain` chain by chain, a batched permutation
    a step: the plain version, for a few rows on the CPU."""
    starts = np.zeros((len(chains), width), np.uint64)
    for k, state in enumerate(init or []):
        if state is not None:
            starts[k] = gf.to_u64(state) if isinstance(state, torch.Tensor) else np.asarray(
                state, np.uint64)
    if backend == "device":
        return [simulate_chain(gf.from_u64(starts[k], enc.device), enc, ex)
                for k, (enc, ex) in enumerate(chains)]
    if backend != "host":
        raise ValueError(f"unknown backend {backend!r}")
    from ..runtime import native

    dev = chains[0][0].device
    length = chains[0][0].shape[-1]
    longest = max(enc.shape[0] for enc, _ in chains)
    enc = np.zeros((len(chains), longest, length), np.uint64)
    ex = np.zeros((len(chains), longest), np.uint8)
    for k, (e, x) in enumerate(chains):
        enc[k, : e.shape[0]] = gf.to_u64(e)
        ex[k, : e.shape[0]] = x.cpu().numpy()
    if width == FULL_STATE_WIDTH:
        if length != poseidon2.RATE:
            raise ValueError(f"a full-state chain absorbs {poseidon2.RATE} elements a row")
        states = native.full_state_chains(enc, ex, starts)
    else:
        states = native.narrow_chains(enc, ex, starts)
    return [gf.from_u64(states[k, : e.shape[0] + 1], dev) for k, (e, _) in enumerate(chains)]


Chain = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _segments_and_stride(boundaries: torch.Tensor, encodings: torch.Tensor) -> Tuple[int, int]:
    n = encodings.shape[0]
    segments = boundaries.shape[0] - 1
    if segments <= 0 or n == 0 or n % segments:
        raise ValueError(f"{segments} segments do not divide {n} rows")
    return segments, n // segments


def segment_landing_states_plain(
    boundaries: torch.Tensor, encodings: torch.Tensor, execute: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Where every segment of a chain lands, by the step loop: all segments in
    parallel, `stride` sequential transitions, one batched permutation each.
    boundaries (S + 1, W), encodings (n, L), execute (n,) bool -> (S, W).
    The plain version of the fused chain kernel; any width, any device."""
    segments, stride = _segments_and_stride(boundaries, encodings)
    if execute is None:
        execute = _all_executed(encodings.shape[0], encodings.device)
    # step-major, so that each step reads one contiguous (S, L) block
    enc_steps = encodings.reshape((segments, stride) + tuple(encodings.shape[1:]))
    enc_steps = enc_steps.transpose(0, 1).contiguous()
    ex_steps = execute.reshape(segments, stride).t().contiguous()
    state = boundaries[:-1]
    for step in range(stride):
        state = transition(state, enc_steps[step], ex_steps[step])
    return state


def _fused(boundaries: torch.Tensor, encodings: torch.Tensor) -> bool:
    """whether the fused chain kernel takes this chain: a full-state queue
    with one-chunk encodings, on the card."""
    return (
        boundaries.device.type == "cuda"
        and boundaries.shape[-1] == FULL_STATE_WIDTH
        and encodings.dim() == 2
        and encodings.shape[-1] == poseidon2.RATE
    )


def check_chains_segmented(chains: Sequence[Chain]) -> List[torch.Tensor]:
    """`check_chain_segmented` of one or two chains (boundaries, encodings,
    execute): (S,) bool each.  Full-state chains on the card (contiguous, two
    of one shape) go to the fused chain kernel in one launch, so that both fill
    the card together; anything else takes the step loop, chain by chain."""
    from .poseidon2_cuda import chain_segmented_cuda

    if all(_fused(boundaries, encodings) for boundaries, encodings, _ in chains):
        landing = chain_segmented_cuda([
            (b, e, _all_executed(e.shape[0], e.device) if x is None else x)
            for b, e, x in chains])
    else:
        landing = [segment_landing_states_plain(*chain) for chain in chains]
    return [gf.equal(state, chain[0][1:]).all(-1) for state, chain in zip(landing, chains)]


def check_chain_segmented(
    boundaries: torch.Tensor, encodings: torch.Tensor, execute: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Verify a sponge chain from its segment-boundary states only.

    boundaries (S + 1, W): the chain state every `stride` = n / S rows;
    encodings (n, L).  Every segment is recomputed from its start state, all
    segments in parallel, `stride` sequential steps, and the landing states
    are compared.  Returns (S,) bool.  A change to a rate lane of a boundary
    fails the segment that lands on it only: the next segment's first absorb
    replaces those lanes."""
    return check_chains_segmented([(boundaries, encodings, execute)])[0]


def check_chain(
    states: torch.Tensor, encodings: torch.Tensor, execute: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Row-parallel check that `states` (n + 1, W) is a valid sponge chain
    over `encodings` (n, L): one batched Poseidon2 over all n rows.
    Returns (n,) bool."""
    n = encodings.shape[0]
    if execute is None:
        execute = _all_executed(n, encodings.device)
    expected = transition(states[:-1], encodings, execute)
    return gf.equal(expected, states[1:]).all(-1)
