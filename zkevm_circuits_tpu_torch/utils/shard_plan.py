"""What a circuit tells `parallel/auto.py` so that its `eval_constraints`
can run on a block of rows and give the whole run's residuals.

A member of the mesh's "rows" axis holds one contiguous block of the run's
rows and evaluates the circuit on a window: its block with `halo` rows of
each neighbour, the neighbours' rows coming by point-to-point messages.
Each witness field on the row axis has N, N + 1 or N + 2 entries (N rows;
the extra entries are after-states and finalisation rows); a window takes
those entries of the same rows and the extra ones after them.  Residuals
with one entry a row (or a row plus the extra ones) are cut back to the
member's block and gathered; a residual named in `last` or `whole` is
taken from one member: the one holding the run's last row (its final
checks), or the first member (residuals over the replicated fields, the
same on every member).  A row-0 term needs no naming: only the first
member's window starts at the run's row 0.

The run-wide terms of a circuit are what a plan spells out:
  * `tails`: fields whose last entry seeds run-wide values (the queue tails
    the Fiat-Shamir challenges are drawn from); a window ends with the
    run's last entry of them (the after-halo row's own value is never read
    for a kept row, so the substitution changes no kept residual);
  * `takes_window`: the circuit's `eval_constraints(w, config, window=)`
    reads a `RowWindow` for the terms a window cannot see: the run row of
    its first row, the run's length, the last group start before it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, FrozenSet, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RowWindow:
    """Where a window lies in its run: window row j is run row `row0 + j`;
    the run has `total` rows; `flag_carry` is the last run row before the
    window where the plan's `carry_flag` field holds (0 when none does)."""

    row0: int
    total: int
    flag_carry: int = 0


def _same_config(config, rows):
    return config


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How a circuit's `eval_constraints` shards over rows (module docstring)."""

    halo: Tuple[int, int] = (0, 0)  # rows read before / after a block
    # the witness fields on the row axis; None: every field whose leading
    # dimension is N, N + 1 or N + 2, but those in `replicated`
    rows: Optional[FrozenSet[str]] = None
    replicated: FrozenSet[str] = frozenset()
    tails: FrozenSet[str] = frozenset()
    last: FrozenSet[str] = frozenset()
    whole: FrozenSet[str] = frozenset()
    takes_window: bool = False
    carry_flag: Optional[str] = None
    # the config of a window of `rows` rows
    window_config: Callable[[Any, int], Any] = _same_config
