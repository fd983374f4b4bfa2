"""A check's verdict: where its residuals are false.

Every residual of a constraint evaluation is a bool tensor (a scalar, one
entry a row, one a segment).  The verdict of one check is the set of
(key, flat index) pairs that are false: the honest witness has none.  On the
device the residuals are flattened in the order of their sorted keys and
joined, so that one `nonzero` (and the one copy to the host it waits for)
ends the check.
"""

from __future__ import annotations

import numpy as np
import torch


def false_positions(residuals: dict) -> torch.Tensor:
    """flat indices of the false entries over the residuals in key order (a
    device tensor; reading it waits for the check)."""
    flat = torch.cat([residuals[k].reshape(-1) for k in sorted(residuals)])
    return torch.nonzero(~flat).reshape(-1)


def layout(residuals: dict) -> list:
    """[(key, offset, size)] of the flattened residuals, in key order."""
    out, at = [], 0
    for k in sorted(residuals):
        size = residuals[k].numel()
        out.append((k, at, size))
        at += size
    return out


def named(positions: np.ndarray, lay: list) -> frozenset:
    """the flat positions as (key, index within the key) pairs."""
    starts = np.array([at for _, at, _ in lay])
    which = np.searchsorted(starts, positions, side="right") - 1
    return frozenset((lay[w][0], int(p - lay[w][1])) for w, p in zip(which, positions))


def positions(pairs, lay: list) -> np.ndarray:
    """(key, index) pairs back to flat positions."""
    at = {k: offset for k, offset, _ in lay}
    return np.array(sorted(at[k] + i for k, i in pairs), dtype=np.int64)


def of(residuals: dict) -> frozenset:
    """(key, index) pairs of the false entries, on the host."""
    lay = layout(residuals)
    return named(false_positions(residuals).cpu().numpy(), lay)
