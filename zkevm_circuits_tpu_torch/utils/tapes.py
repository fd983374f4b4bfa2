"""The benchmark memory tapes, on the host (numpy).

`build_tapes_np(n)` gives the two ram_permutation tapes the 2^16-row prove
and the 2^20-row constraint evaluation run on: n writes to distinct cells,
the sorted tape ordered by (page, index, timestamp), the unsorted tape a
seeded shuffle of it.  Same seed and same arrays as `bench.build_tapes_np`.
"""

from __future__ import annotations

import numpy as np

TAPE_SEED = 0xBE7C


def build_tapes_np(n: int):
    """(unsorted, sorted) dicts of {timestamp, memory_page, index, rw_flag,
    is_ptr, value (n, 8)} numpy arrays."""
    rng = np.random.default_rng(TAPE_SEED)
    pages = np.sort(rng.integers(4, 1 << 20, size=n, dtype=np.uint32))
    index = np.arange(n, dtype=np.uint32) % 1024
    ts = np.arange(n, dtype=np.uint32) + 16
    order = np.lexsort((ts, index, pages))
    pages, index, ts = pages[order], index[order], ts[order]
    value = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    sorted_t = dict(
        timestamp=ts, memory_page=pages, index=index,
        rw_flag=np.ones(n, dtype=bool), is_ptr=np.zeros(n, dtype=bool), value=value,
    )
    perm = rng.permutation(n)
    unsorted_t = {k: v[perm] for k, v in sorted_t.items()}
    return unsorted_t, sorted_t
