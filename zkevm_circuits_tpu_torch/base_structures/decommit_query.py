"""DecommitQuery: the decommit-queue element, as a container of tensors (the
JAX package's `base_structures/decommit_query.py`).

Fields {code_hash: u256, page, is_first, timestamp}, packed width 8:

    v0 = code_hash[0] + pb0*2^32 + pb1*2^40 + pb2*2^48
    v1 = code_hash[1] + pb3*2^32 + tb0*2^40 + tb1*2^48
    v2 = code_hash[2] + tb2*2^32 + tb3*2^40 + is_first*2^48
    v3..v7 = code_hash[3..8]

(pbK / tbK = byte K, little-endian, of page / timestamp.)  The u32 fields
are int64 tensors, `is_first` a bool tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device

DECOMMIT_QUERY_PACKED_WIDTH = 8


@dataclasses.dataclass(frozen=True)
class DecommitQueries:
    code_hash: torch.Tensor  # (..., 8) u32 LE limbs
    page: torch.Tensor  # u32
    is_first: torch.Tensor  # bool
    timestamp: torch.Tensor  # u32

    @property
    def shape(self):
        return tuple(self.timestamp.shape)

    def __getitem__(self, idx) -> "DecommitQueries":
        return DecommitQueries(
            self.code_hash[idx], self.page[idx], self.is_first[idx], self.timestamp[idx]
        )

    @staticmethod
    def from_numpy(cols: dict, device=None) -> "DecommitQueries":
        """cols: {code_hash (n, 8) u32, page, is_first, timestamp}; `device`
        None is the card (`utils.device.default_device`)."""
        device = resolve_device(device)

        def u32(name):
            return torch.from_numpy(np.asarray(cols[name]).astype(np.int64)).to(device)

        return DecommitQueries(
            u32("code_hash"), u32("page"),
            torch.from_numpy(np.asarray(cols["is_first"]).astype(bool)).to(device),
            u32("timestamp"),
        )

    @staticmethod
    def from_lists(rows, device=None) -> "DecommitQueries":
        """rows: dicts {code_hash (python int), page, is_first, timestamp}."""
        rows = list(rows)
        return DecommitQueries.from_numpy(
            dict(
                code_hash=np.array(
                    [[(int(r["code_hash"]) >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
                     for r in rows], dtype=np.uint32,
                ).reshape(len(rows), 8),
                page=np.array([r["page"] for r in rows], dtype=np.uint32),
                is_first=np.array([bool(r.get("is_first", False)) for r in rows], dtype=bool),
                timestamp=np.array([r["timestamp"] for r in rows], dtype=np.uint32),
            ),
            device,
        )

    @staticmethod
    def zeros(shape, device=None) -> "DecommitQueries":
        device = resolve_device(device)
        shape = tuple(shape)
        z = torch.zeros(shape, dtype=torch.int64, device=device)
        return DecommitQueries(
            torch.zeros(shape + (8,), dtype=torch.int64, device=device),
            z, torch.zeros(shape, dtype=torch.bool, device=device), z,
        )


def _byte(x: torch.Tensor, j: int) -> torch.Tensor:
    return (x >> (8 * j)) & 0xFF


def encode_decommit_queries(q: DecommitQueries) -> torch.Tensor:
    """(...,) queries -> (..., 8) packed field elements."""
    pb = [_byte(q.page, j) for j in range(4)]
    tb = [_byte(q.timestamp, j) for j in range(4)]
    fi = q.is_first.to(torch.int64)
    ch = q.code_hash
    lanes = [
        ch[..., 0] | (pb[0] << 32) | (pb[1] << 40) | (pb[2] << 48),
        ch[..., 1] | (pb[3] << 32) | (tb[0] << 40) | (tb[1] << 48),
        ch[..., 2] | (tb[2] << 32) | (tb[3] << 40) | (fi << 48),
    ] + [ch[..., k] for k in range(3, 8)]
    return torch.stack(lanes, dim=-1)


def encode_decommit_query_ref(row: dict) -> list:
    """The packing of one row in python ints, for golden tests."""
    v = int(row["code_hash"])
    ch = [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    pb = [(int(row["page"]) >> (8 * j)) & 0xFF for j in range(4)]
    tb = [(int(row["timestamp"]) >> (8 * j)) & 0xFF for j in range(4)]
    fi = int(bool(row.get("is_first", False)))
    return [
        ch[0] + (pb[0] << 32) + (pb[1] << 40) + (pb[2] << 48),
        ch[1] + (pb[3] << 32) + (tb[0] << 40) + (tb[1] << 48),
        ch[2] + (tb[2] << 32) + (tb[3] << 40) + (fi << 48),
        ch[3], ch[4], ch[5], ch[6], ch[7],
    ]
