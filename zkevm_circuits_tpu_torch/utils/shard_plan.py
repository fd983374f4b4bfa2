"""What a circuit tells `parallel/auto.py` so that its `eval_constraints`
can run on a block of rows and give the whole run's residuals.

A member of the mesh's "rows" axis holds one contiguous block of the run's
rows and evaluates the circuit on a window: its block with `halo` rows of
each neighbour, the neighbours' rows coming by point-to-point messages.
The blocks are ceil(N / D) rows, the last member's the rest.  A witness
field on the row axis has k entries a row (`entries`, 1 unless named) and
0, 1 or 2 extra entries after the N k (after-states and finalisation
rows); a window takes the k entries of each of its rows and, where it ends
the run, the extra ones after them.  Residuals with k entries a row (or
those plus the extra ones) are cut back to the member's block and
gathered.  A row-0 term needs no naming: only the first member's window
starts at the run's row 0.

The other residuals are named, each by how the run's value is made:
  * `last`: taken from the member holding the run's last row (its final
    checks);
  * `whole`: taken from the first member: a residual over fields kept whole
    (the call, query and memory-queue fields a row reaches by index stay
    whole on every member), computed the same on every member, or over the
    run's first entries, which only the first member's window holds;
  * `every`: ANDed over the members (a scalar over all rows, such as a
    range check: each window's rows are run rows, and the windows cover
    the run);
  * `sums`: in a window, `eval_constraints` returns a `PartialSum` for it:
    this member's share of a sum over rows (per call, per query), its own
    rows only; the shares are summed over the members and the partial's
    `finish` turns the run's sum into the residual.

The run-wide terms of a circuit are what a plan spells out:
  * `tails`: fields whose last entry seeds run-wide values (the queue tails
    the Fiat-Shamir challenges are drawn from); a window ends with the
    run's last entry of them (the after-halo row's own value is never read
    for a kept row, so the substitution changes no kept residual);
  * `takes_window`: the circuit's `eval_constraints(w, config, window=)`
    reads a `RowWindow` for the terms a window cannot see: the run row of
    its first row, the run's length, its own rows, the last group start
    before it (`carry_flag`, a function of the window giving a bool a row) and
    that row's values (`carry_values`);
  * `axes`: further row axes (keccak blocks beside queries, say), each
    with its own fields, residuals and halo, cut into blocks over the same
    members; their windows are in `RowWindow.axes`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, FrozenSet, Mapping, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RowWindow:
    """Where a window lies in its run: window row j is run row `row0 + j`;
    the run has `total` rows; window rows [own[0], own[1]) are the member's
    block; `flag_carry` is the last run row before the block where the
    plan's `carry_flag` holds (0 when none does) and `carried` the plan's
    `carry_values` at that row; `axes` the windows of the plan's further
    axes, by name."""

    row0: int
    total: int
    flag_carry: int = 0
    own: Tuple[int, int] = (0, 0)
    carried: Optional[dict] = None
    axes: Optional[Mapping[str, "RowWindow"]] = None


@dataclasses.dataclass(frozen=True)
class PartialSum:
    """A `sums` residual on one member: `value` sums the member's own rows;
    `finish` makes the residual of the run's sum (every member's value
    added)."""

    value: torch.Tensor
    finish: Callable[[torch.Tensor], torch.Tensor]


def owned_rows(window: Optional[RowWindow], rows: int, device) -> torch.Tensor:
    """(rows,) bool: the window rows that are the member's own (every row
    of an unsharded run)."""
    if window is None:
        return torch.ones(rows, dtype=torch.bool, device=device)
    idx = torch.arange(rows, device=device)
    return (idx >= window.own[0]) & (idx < window.own[1])


def summed(value: torch.Tensor, finish: Callable, window: Optional[RowWindow]):
    """The residual `finish(value)` of an unsharded run; a `PartialSum` in a
    window (`value` then sums the window's own rows only)."""
    return finish(value) if window is None else PartialSum(value, finish)


@dataclasses.dataclass(frozen=True)
class Axis:
    """A further row axis: `rows_of` names a field with one entry a row of
    it; `fields` are the witness fields on it (one entry a row and 0, 1 or
    2 extra), `residuals` the residuals with one entry a row of it."""

    rows_of: str
    fields: FrozenSet[str]
    residuals: FrozenSet[str] = frozenset()
    halo: Tuple[int, int] = (0, 0)


def _same_config(config, rows):
    return config


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How a circuit's `eval_constraints` shards over rows (module docstring)."""

    halo: Tuple[int, int] = (0, 0)  # rows read before / after a block
    # the witness fields on the row axis; None: every field whose leading
    # dimension is k N, k N + 1 or k N + 2, but those in `replicated` and on
    # the further axes
    rows: Optional[FrozenSet[str]] = None
    replicated: FrozenSet[str] = frozenset()
    # fields and residuals of the row axis with k entries a row (k != 1)
    entries: Mapping[str, int] = dataclasses.field(default_factory=dict)
    tails: FrozenSet[str] = frozenset()
    last: FrozenSet[str] = frozenset()
    whole: FrozenSet[str] = frozenset()
    every: FrozenSet[str] = frozenset()
    sums: FrozenSet[str] = frozenset()
    takes_window: bool = False
    carry_flag: Optional[Callable[[Any], torch.Tensor]] = None
    carry_values: Optional[Callable[[Any], dict]] = None
    axes: Mapping[str, Axis] = dataclasses.field(default_factory=dict)
    # the config of a window of `rows` rows
    window_config: Callable[[Any, int], Any] = _same_config
