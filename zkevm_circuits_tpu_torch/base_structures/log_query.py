"""LogQuery: the unified log-queue element, as a container of tensors (the
JAX package's `base_structures/log_query.py`).

11 fields, LOG_QUERY_PACKED_WIDTH = 20, 3 sponge absorption rounds; the
rollback flag sits alone at packed index 19, so the forward and rollback
packings share the first two sponge rounds.

Packing, with kb[i][j] = byte j (LE) of key limb i and ab[i][j] = byte j of
address limb i:

    v0..v7  = read_value[k]    + 3 key bytes      * 2^32 / 2^40 / 2^48
              (key bytes streamed in order kb[0][0..3], kb[1][0..3], ...)
    v8..v15 = written_value[k] + remaining key bytes, then address bytes
    v16     = timestamp + ab[4][0..2] * shifts
    v17     = tx_number_in_block + ab[4][3]*2^32 + aux_byte*2^40 + shard_id*2^48
    v18     = rw_flag + 2 * is_service
    v19     = rollback

Every packed value is < 2^56 < p for fields in range.  The u32 fields are
int64 tensors, the flags bool tensors; the high part of an element is cut to
32 bits, as the JAX package's u32 high lane cuts it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device

LOG_QUERY_PACKED_WIDTH = 20
LOG_QUERY_ABSORBTION_ROUNDS = 3
ROLLBACK_PACKING_FLAG_VARIABLE_IDX = 19
FLATTENED_VARIABLE_LENGTH = 36

_M32 = 0xFFFFFFFF
_U32_FIELDS = ("address", "key", "read_value", "written_value", "aux_byte", "shard_id",
               "tx_number_in_block", "timestamp")
_LIMBS = dict(address=5, key=8, read_value=8, written_value=8)


@dataclasses.dataclass(frozen=True)
class LogQueries:
    """A batch of log queries (leading axes arbitrary)."""

    address: torch.Tensor  # (..., 5) u32 LE limbs (u160)
    key: torch.Tensor  # (..., 8) u32
    read_value: torch.Tensor  # (..., 8) u32
    written_value: torch.Tensor  # (..., 8) u32
    aux_byte: torch.Tensor  # u32 (byte range)
    rw_flag: torch.Tensor  # bool
    rollback: torch.Tensor  # bool
    is_service: torch.Tensor  # bool
    shard_id: torch.Tensor  # u32 (byte range)
    tx_number_in_block: torch.Tensor  # u32
    timestamp: torch.Tensor  # u32

    @property
    def shape(self):
        return tuple(self.timestamp.shape)

    def __getitem__(self, idx) -> "LogQueries":
        return LogQueries(*[getattr(self, f.name)[idx] for f in dataclasses.fields(self)])

    @staticmethod
    def from_numpy(cols: dict, device=None) -> "LogQueries":
        """cols: one numpy array per field (limbed fields as (n, limbs) u32);
        `device` None is the card (`utils.device.default_device`)."""
        device = resolve_device(device)
        out = {}
        for f in dataclasses.fields(LogQueries):
            dtype = np.int64 if f.name in _U32_FIELDS else bool
            out[f.name] = torch.from_numpy(np.asarray(cols[f.name]).astype(dtype)).to(device)
        return LogQueries(**out)

    @staticmethod
    def from_lists(rows, device=None) -> "LogQueries":
        """rows: dicts with keys address, key, read_value, written_value
        (python ints), aux_byte, rw_flag, rollback, is_service, shard_id,
        tx_number_in_block, timestamp; a missing key is 0 / False."""
        rows = list(rows)
        cols = {}
        for f in dataclasses.fields(LogQueries):
            name = f.name
            if name in _LIMBS:
                k = _LIMBS[name]
                cols[name] = np.array(
                    [[(int(r.get(name, 0)) >> (32 * i)) & _M32 for i in range(k)] for r in rows],
                    dtype=np.uint32,
                ).reshape(len(rows), k)
            elif name in _U32_FIELDS:
                cols[name] = np.array([r.get(name, 0) for r in rows], dtype=np.uint32)
            else:
                cols[name] = np.array([bool(r.get(name, False)) for r in rows], dtype=bool)
        return LogQueries.from_numpy(cols, device)

    @staticmethod
    def zeros(shape, device=None) -> "LogQueries":
        device = resolve_device(device)
        t = tuple(shape)

        def z(s):
            return torch.zeros(s, dtype=torch.int64, device=device)

        b = torch.zeros(t, dtype=torch.bool, device=device)
        return LogQueries(
            z(t + (5,)), z(t + (8,)), z(t + (8,)), z(t + (8,)),
            z(t), b, b, b, z(t), z(t), z(t),
        )


def _byte(x: torch.Tensor, j: int) -> torch.Tensor:
    return (x >> (8 * j)) & 0xFF


def _pack(lo32: torch.Tensor, b0, b1, b2) -> torch.Tensor:
    """lo32 + (b0 | b1 << 8 | b2 << 16, cut to 32 bits) * 2^32."""
    return lo32 | (((b0 | (b1 << 8) | (b2 << 16)) & _M32) << 32)


def encode_log_queries(q: LogQueries) -> torch.Tensor:
    """(...,) queries -> (..., 20) packed field elements."""

    def kb(i):  # key bytes in limb-major LE order, i in 0..31
        return _byte(q.key[..., i // 4], i % 4)

    def ab(i):  # address bytes, i in 0..19
        return _byte(q.address[..., i // 4], i % 4)

    lanes = []
    for k in range(8):
        lanes.append(_pack(q.read_value[..., k], kb(3 * k), kb(3 * k + 1), kb(3 * k + 2)))
    stream = [kb(i) for i in range(24, 32)] + [ab(i) for i in range(16)]
    for k in range(8):
        lanes.append(
            _pack(q.written_value[..., k], stream[3 * k], stream[3 * k + 1], stream[3 * k + 2]))
    lanes.append(_pack(q.timestamp, ab(16), ab(17), ab(18)))
    lanes.append(_pack(q.tx_number_in_block, ab(19), q.aux_byte, q.shard_id))
    lanes.append(q.rw_flag.to(torch.int64) + 2 * q.is_service.to(torch.int64))
    lanes.append(q.rollback.to(torch.int64))
    return torch.stack(lanes, dim=-1)


def encode_with_rollback_flag(q: LogQueries) -> torch.Tensor:
    """The rollback-side packing: the same encoding with element 19 forced to 1."""
    enc = encode_log_queries(q)
    one = torch.ones_like(enc[..., :1])
    return torch.cat([enc[..., :ROLLBACK_PACKING_FLAG_VARIABLE_IDX], one], dim=-1)


def encode_log_queries_np(
    address: np.ndarray,
    key: np.ndarray,
    read_value: np.ndarray,
    written_value: np.ndarray,
    aux_byte: np.ndarray,
    rw_flag: np.ndarray,
    rollback: np.ndarray,
    is_service: np.ndarray,
    shard_id: np.ndarray,
    tx_number_in_block: np.ndarray,
    timestamp: np.ndarray,
) -> np.ndarray:
    """The same packing on the host, numpy u64 out (for the native chains)."""
    key64 = key.astype(np.uint64)
    addr64 = address.astype(np.uint64)

    def kb(i):
        return (key64[..., i // 4] >> np.uint64(8 * (i % 4))) & np.uint64(0xFF)

    def ab(i):
        return (addr64[..., i // 4] >> np.uint64(8 * (i % 4))) & np.uint64(0xFF)

    def hi3(b0, b1, b2):
        return (b0 << np.uint64(32)) | (b1 << np.uint64(40)) | (b2 << np.uint64(48))

    out = np.zeros(timestamp.shape + (20,), dtype=np.uint64)
    rv = read_value.astype(np.uint64)
    wv = written_value.astype(np.uint64)
    for k in range(8):
        out[..., k] = rv[..., k] | hi3(kb(3 * k), kb(3 * k + 1), kb(3 * k + 2))
    stream = [kb(i) for i in range(24, 32)] + [ab(i) for i in range(16)]
    for k in range(8):
        out[..., 8 + k] = wv[..., k] | hi3(stream[3 * k], stream[3 * k + 1], stream[3 * k + 2])
    out[..., 16] = timestamp.astype(np.uint64) | hi3(ab(16), ab(17), ab(18))
    out[..., 17] = tx_number_in_block.astype(np.uint64) | hi3(
        ab(19), aux_byte.astype(np.uint64), shard_id.astype(np.uint64)
    )
    out[..., 18] = rw_flag.astype(np.uint64) + 2 * is_service.astype(np.uint64)
    out[..., 19] = rollback.astype(np.uint64)
    return out


def encode_log_query_ref(row: dict) -> list:
    """The packing of one row in python ints, for golden tests."""

    def limbs(v, k):
        return [(int(v) >> (32 * i)) & _M32 for i in range(k)]

    key_l = limbs(row.get("key", 0), 8)
    addr_l = limbs(row.get("address", 0), 5)
    rv = limbs(row.get("read_value", 0), 8)
    wv = limbs(row.get("written_value", 0), 8)
    kb = [(key_l[i // 4] >> (8 * (i % 4))) & 0xFF for i in range(32)]
    ab = [(addr_l[i // 4] >> (8 * (i % 4))) & 0xFF for i in range(20)]

    def pack(base, b0, b1, b2):
        return base + (b0 << 32) + (b1 << 40) + (b2 << 48)

    out = []
    for k in range(8):
        out.append(pack(rv[k], kb[3 * k], kb[3 * k + 1], kb[3 * k + 2]))
    stream = kb[24:32] + ab[:16]
    for k in range(8):
        out.append(pack(wv[k], stream[3 * k], stream[3 * k + 1], stream[3 * k + 2]))
    out.append(pack(row.get("timestamp", 0), ab[16], ab[17], ab[18]))
    out.append(
        pack(row.get("tx_number_in_block", 0), ab[19], row.get("aux_byte", 0),
             row.get("shard_id", 0))
    )
    out.append(int(bool(row.get("rw_flag", False))) + 2 * int(bool(row.get("is_service", False))))
    out.append(int(bool(row.get("rollback", False))))
    return out
