"""MemoryQuery: the memory-queue element, as a container of tensors.

Packed to MEMORY_QUERY_PACKED_WIDTH = 8 field elements with the layout of
the JAX package's `base_structures/memory_query.py`:

    v0 = timestamp
    v1 = memory_page
    v2 = index + rw_flag * 2^32 + is_ptr * 2^33
    v3 = value[0] + b5_0 * 2^32 + b5_1 * 2^40 + b5_2 * 2^48
    v4 = value[1] + b5_3 * 2^32 + b6_0 * 2^40 + b6_1 * 2^48
    v5 = value[2] + b6_2 * 2^32 + b6_3 * 2^40 + b7_0 * 2^48
    v6 = value[3] + b7_1 * 2^32 + b7_2 * 2^40 + b7_3 * 2^48
    v7 = value[4]

value is 8 little-endian u32 limbs and bK_j is byte j of limb K.  Every
packed element is < 2^56 < p, so no reduction is needed.  The u32 fields
are held in int64 tensors, the flags in bool tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device

MEMORY_QUERY_PACKED_WIDTH = 8


@dataclasses.dataclass(frozen=True)
class MemoryQueries:
    """A batch of memory queries (leading axes arbitrary)."""

    timestamp: torch.Tensor  # int64 holding u32
    memory_page: torch.Tensor  # int64 holding u32
    index: torch.Tensor  # int64 holding u32
    rw_flag: torch.Tensor  # bool
    is_ptr: torch.Tensor  # bool
    value: torch.Tensor  # (..., 8) int64 holding u32 little-endian limbs

    @property
    def shape(self):
        return tuple(self.timestamp.shape)

    def __getitem__(self, idx) -> "MemoryQueries":
        return MemoryQueries(
            self.timestamp[idx], self.memory_page[idx], self.index[idx],
            self.rw_flag[idx], self.is_ptr[idx], self.value[idx],
        )

    @staticmethod
    def zeros(shape, device=None) -> "MemoryQueries":
        device = resolve_device(device)
        shape = tuple(shape)
        z = torch.zeros(shape, dtype=torch.int64, device=device)
        b = torch.zeros(shape, dtype=torch.bool, device=device)
        return MemoryQueries(
            z, z, z, b, b, torch.zeros(shape + (8,), dtype=torch.int64, device=device))

    @staticmethod
    def from_lists(rows, device=None) -> "MemoryQueries":
        """rows: dicts with keys timestamp, memory_page, index, rw_flag,
        is_ptr, value (value a python int < 2^256)."""
        rows = list(rows)
        tapes = dict(
            timestamp=np.array([r["timestamp"] for r in rows], dtype=np.uint32),
            memory_page=np.array([r["memory_page"] for r in rows], dtype=np.uint32),
            index=np.array([r["index"] for r in rows], dtype=np.uint32),
            rw_flag=np.array([bool(r["rw_flag"]) for r in rows], dtype=bool),
            is_ptr=np.array([bool(r["is_ptr"]) for r in rows], dtype=bool),
            value=np.array(
                [[(int(r["value"]) >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for r in rows],
                dtype=np.uint32,
            ).reshape(len(rows), 8),
        )
        return MemoryQueries.from_numpy(tapes, device)

    @staticmethod
    def from_numpy(tapes: dict, device=None) -> "MemoryQueries":
        """tapes: {timestamp, memory_page, index, rw_flag, is_ptr, value (n, 8)};
        `device` None is the card (`utils.device.default_device`)."""
        device = resolve_device(device)

        def u32(name):
            return torch.from_numpy(np.asarray(tapes[name]).astype(np.int64)).to(device)

        def flag(name):
            return torch.from_numpy(np.asarray(tapes[name]).astype(bool)).to(device)

        return MemoryQueries(
            u32("timestamp"), u32("memory_page"), u32("index"),
            flag("rw_flag"), flag("is_ptr"), u32("value"),
        )


def _byte(x: torch.Tensor, j: int) -> torch.Tensor:
    return (x >> (8 * j)) & 0xFF


def encode_memory_queries(q: MemoryQueries) -> torch.Tensor:
    """(...,) queries -> (..., 8) packed field elements."""
    v = q.value
    v5, v6, v7 = v[..., 5], v[..., 6], v[..., 7]
    lanes = [
        q.timestamp,
        q.memory_page,
        q.index | (q.rw_flag.to(torch.int64) << 32) | (q.is_ptr.to(torch.int64) << 33),
        v[..., 0] | (_byte(v5, 0) << 32) | (_byte(v5, 1) << 40) | (_byte(v5, 2) << 48),
        v[..., 1] | (_byte(v5, 3) << 32) | (_byte(v6, 0) << 40) | (_byte(v6, 1) << 48),
        v[..., 2] | (_byte(v6, 2) << 32) | (_byte(v6, 3) << 40) | (_byte(v7, 0) << 48),
        v[..., 3] | (_byte(v7, 1) << 32) | (_byte(v7, 2) << 40) | (_byte(v7, 3) << 48),
        v[..., 4],
    ]
    return torch.stack(lanes, dim=-1)


def encode_memory_queries_np(
    timestamp: np.ndarray,
    memory_page: np.ndarray,
    index: np.ndarray,
    rw_flag: np.ndarray,
    is_ptr: np.ndarray,
    value: np.ndarray,
) -> np.ndarray:
    """The same packing on the host, numpy u64 out (feeds the native chains)."""
    ts = timestamp.astype(np.uint64)
    pg = memory_page.astype(np.uint64)
    ix = index.astype(np.uint64)
    rw = rw_flag.astype(np.uint64)
    ptr = is_ptr.astype(np.uint64)
    v = value.astype(np.uint64)

    def byte(limb, j):
        return (v[..., limb] >> np.uint64(8 * j)) & np.uint64(0xFF)

    def sh(x, k):
        return x << np.uint64(k)

    out = np.empty(ts.shape + (8,), dtype=np.uint64)
    out[..., 0] = ts
    out[..., 1] = pg
    out[..., 2] = ix | sh(rw, 32) | sh(ptr, 33)
    out[..., 3] = v[..., 0] | sh(byte(5, 0), 32) | sh(byte(5, 1), 40) | sh(byte(5, 2), 48)
    out[..., 4] = v[..., 1] | sh(byte(5, 3), 32) | sh(byte(6, 0), 40) | sh(byte(6, 1), 48)
    out[..., 5] = v[..., 2] | sh(byte(6, 2), 32) | sh(byte(6, 3), 40) | sh(byte(7, 0), 48)
    out[..., 6] = v[..., 3] | sh(byte(7, 1), 32) | sh(byte(7, 2), 40) | sh(byte(7, 3), 48)
    out[..., 7] = v[..., 4]
    return out
