"""Seeded inputs of the eight circuits whose shard plans `auto.eval_sharded`
runs beside the five of `tests/test_auto_sharding.py`: the log-queue
demultiplexer, the decommit sorter, the linear hasher, eip_4844, storage
application, the sha256 precompile, the code unpacker and ecrecover.

`case(name, rows, seed, device)` makes one circuit's witness from a seed
with the port's own witness generators: `rows` rows of its row axis (log
queries, decommit requests, L1 messages, blob elements, stage rows,
rounds), or `rows` calls of ecrecover (512 ladder steps a call).
`tamper(name, w, row)` changes one value of the witness at run row `row`
of the row axis.  `entry.dryrun_multichip` (phase 3c) runs them at the
block cells' sizes and the CPU tests at 16 rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..base_structures.decommit_query import DecommitQueries
from ..base_structures.log_query import LogQueries
from ..isa import system_params as sp
from ..models import code_unpacker_sha256 as cu
from ..models import demux_log_queue as dm
from ..models import ecrecover as ecr
from ..models import eip_4844 as e44
from ..models import linear_hasher as lh
from ..models import precompile_common as pc
from ..models import sha256_round_function as sh
from ..models import sort_decommittment_requests as sd
from ..models import storage_application as sa
from ..ops import secp256k1 as ec

CIRCUITS = ("demux_log_queue", "sort_decommittment_requests", "linear_hasher", "eip_4844",
            "storage_application", "sha256_round_function", "code_unpacker_sha256", "ecrecover")


class Case(NamedTuple):
    eval_fn: Callable
    witness: object
    config: object
    rows: int  # the row axis's rows: `auto.eval_sharded`'s num_rows


def _u32(rng, *shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)


def _log_queries(rng, n: int, aux: np.ndarray, device, address=None) -> LogQueries:
    cols = dict(address=_u32(rng, n, 5) if address is None else address,
                key=_u32(rng, n, 8), read_value=_u32(rng, n, 8), written_value=_u32(rng, n, 8),
                aux_byte=aux, rw_flag=rng.integers(0, 2, n).astype(bool),
                rollback=np.zeros(n, bool), is_service=rng.integers(0, 2, n).astype(bool),
                shard_id=np.zeros(n, np.uint64), tx_number_in_block=rng.integers(0, 1 << 16, n),
                timestamp=np.arange(n) * 4 + 8)
    return LogQueries.from_numpy(cols, device)


def demux(rows: int, rng, device) -> Case:
    """log queries of every route: storage, events, L1 messages and the
    three precompiles, with random bodies."""
    kinds = rng.integers(0, 6, rows)
    aux = np.array([sp.STORAGE_AUX_BYTE, sp.EVENT_AUX_BYTE, sp.L1_MESSAGE_AUX_BYTE]
                   + [sp.PRECOMPILE_AUX_BYTE] * 3)[kinds]
    address = _u32(rng, rows, 5)
    for kind, formal in ((3, sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS),
                         (4, sp.SHA256_PRECOMPILE_FORMAL_ADDRESS),
                         (5, sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS)):
        address[kinds == kind] = pc.key_limbs(formal)[:5]
    cfg = dm.DemuxConfig(limit=rows)
    return Case(dm.eval_constraints,
                dm.generate_witness(_log_queries(rng, rows, aux, device, address), cfg), cfg, rows)


def decommit_sorter(rows: int, rng, device) -> Case:
    """requests in groups of one to four of a code hash (one page, the
    first marked), sorted by hash and timestamp; the unsorted queue a
    permutation of them."""
    sizes = []
    while sum(sizes) < rows:
        sizes.append(int(min(rng.integers(1, 5), rows - sum(sizes))))
    hashes = sorted({int.from_bytes(rng.bytes(32), "big") for _ in range(2 * len(sizes))})
    hashes = [hashes[i] for i in sorted(rng.choice(len(hashes), len(sizes), replace=False))]
    ts = rng.permutation(rows) * 3 + 1
    code, page, first = [], [], []
    for g, (h, size) in enumerate(zip(hashes, sizes)):
        start = len(code)
        ts[start:start + size].sort()  # ascending within a group
        code += [pc.key_limbs(h)] * size
        page += [1000 + g] * size
        first += [True] + [False] * (size - 1)
    cols = dict(code_hash=np.array(code, np.uint64), page=np.array(page), is_first=np.array(first),
                timestamp=ts)
    perm = rng.permutation(rows)
    cfg = sd.DecommitSorterConfig(limit=rows)
    w = sd.generate_witness(DecommitQueries.from_numpy({k: v[perm] for k, v in cols.items()},
                                                       device),
                            DecommitQueries.from_numpy(cols, device), cfg)
    return Case(sd.eval_constraints, w, cfg, rows)


def linear_hasher(rows: int, rng, device) -> Case:
    """`rows` L1 messages; the keccak blocks are the further axis."""
    q = _log_queries(rng, rows, np.full(rows, sp.L1_MESSAGE_AUX_BYTE), device)
    cfg = lh.LinearHasherConfig(limit=rows)
    return Case(lh.eval_constraints, lh.generate_witness(q, cfg), cfg, rows)


def eip_4844(rows: int, rng, device) -> Case:
    """one blob of `rows` random 31-byte chunks and a versioned hash."""
    chunks = [rng.bytes(e44.CHUNK_BYTES) for _ in range(rows)]
    cfg = e44.EIP4844Config(rows)
    return Case(e44.eval_constraints,
                e44.generate_witness(chunks, rng.bytes(32), cfg, device=device), cfg, rows)


def storage_application(rows: int, rng, device) -> Case:
    """`rows` stage rows over a tree of rows / 4 seeded leaves: three
    queries in four write (two rows), fresh cells and seeded ones, the
    fourth reads a seeded cell."""
    tree = sa.SparseStorageTree()
    cells = [(int(rng.integers(1, 1 << 62)), int(rng.integers(0, 1 << 62)))
             for _ in range(max(rows // 4, 1))]
    values = {}
    for i, (a, k) in enumerate(cells):
        values[(a, k)] = int(rng.integers(1, 1 << 62))
        tree.set_leaf(sa.path_bits(sa.derive_key_ref(a, k)), i + 1, values[(a, k)])
    queries, used, fill = [], 0, 0
    while used < rows:
        write = len(queries) % 4 != 3 and rows - used >= 2
        seeded = fill < len(cells) and (not write or len(queries) % 2 == 0)
        if seeded:
            cell, fill = cells[fill], fill + 1
        else:
            cell = (int(rng.integers(1 << 62, 1 << 63)), int(rng.integers(0, 1 << 62)))
        read = values.get(cell, 0)
        queries.append(dict(address=cell[0], key=cell[1], read_value=read,
                            written_value=int(rng.integers(1, 1 << 62)) if write else read,
                            aux_byte=sp.STORAGE_AUX_BYTE, rw_flag=write, rollback=False,
                            is_service=False, shard_id=0, tx_number_in_block=0,
                            timestamp=3 * len(queries)))
        used += 2 if write else 1
    cfg = sa.StorageApplicationConfig(max_rows=rows)
    w = sa.generate_witness(queries, tree, len(cells) + 1, cfg, device=device)
    return Case(sa.eval_constraints, w, cfg, rows)


def _call(address: int, key: list, timestamp: int) -> dict:
    return dict(address=address, key=sum(int(x) << (32 * k) for k, x in enumerate(key)),
                read_value=0, written_value=0, aux_byte=sp.PRECOMPILE_AUX_BYTE, rw_flag=False,
                rollback=False, is_service=False, shard_id=0, tx_number_in_block=0,
                timestamp=timestamp)


def _mem_init(rng) -> np.ndarray:
    return rng.integers(0, 1 << 63, size=12, dtype=np.uint64)


def sha256(rows: int, rng, device) -> Case:
    """calls of one to eight rounds over pre-padded random words, filling
    the `rows` rounds."""
    memory, calls, used = {}, [], 0
    while used < rows:
        nr = int(min(rng.integers(1, 9), rows - used))
        base = 2 * used
        for j in range(2 * nr):
            memory[(5, base + j)] = rng.bytes(32)
        calls.append(_call(sp.SHA256_PRECOMPILE_FORMAL_ADDRESS,
                           [base, 0, len(calls), 0, 5, 6, nr, 0], 8 + 4 * len(calls)))
        used += nr
    cfg = sh.Sha256RoundFunctionConfig(rows)
    w = sh.generate_witness(calls, memory, cfg, mem_init_state=_mem_init(rng), device=device)
    return Case(sh.eval_constraints, w, cfg, rows)


def code_unpacker(rows: int, rng, device) -> Case:
    """bytecodes of 1 to 15 words (odd), filling the `rows` rounds."""
    store, requests, used = {}, [], 0
    while used < rows:
        n_rounds = int(min(rng.integers(1, 9), rows - used))
        code = [int.from_bytes(rng.bytes(32), "big") for _ in range(2 * n_rounds - 1)]
        req = cu.make_request(code, 100 + len(requests), 7 + len(requests))
        store[req["code_hash"]] = code
        requests.append(req)
        used += n_rounds
    cfg = cu.CodeUnpackerConfig(rows)
    w = cu.generate_witness(requests, store, cfg, mem_init_state=_mem_init(rng), device=device)
    return Case(cu.eval_constraints, w, cfg, rows)


def _signature(rng, kind: int):
    """(digest, v, r, s) of kind 0-4 a valid signature; 5 a high s; 6 r = 0;
    7 an x off the curve."""
    h = int.from_bytes(rng.bytes(32), "big")
    r, s, recid = ec.sign(h, int.from_bytes(rng.bytes(31), "big") + 1,
                          int.from_bytes(rng.bytes(31), "big") + 1)
    if kind == 5:
        return h, recid ^ 1, r, ec.N - s
    if kind == 6:
        return h, recid, 0, s
    if kind == 7:
        off = r
        while ec.lift_x(off, False) is not None:
            off += 1
        return h, recid & 1, off, s
    return h, recid, r, s


def ecrecover(calls: int, rng, device) -> Case:
    """`calls` calls, the kinds of `_signature` in turn (five valid in
    eight)."""
    memory, rows = {}, []
    for ci in range(calls):
        for j, value in enumerate(_signature(rng, ci % 8)):
            memory[(3, 4 * ci + j)] = value.to_bytes(32, "big")
        rows.append(_call(sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS,
                          [4 * ci, 0, 2 * ci, 0, 3, 4, 0, 0], 100 + 4 * ci))
    cfg = ecr.EcrecoverConfig(calls)
    w = ecr.generate_witness(rows, memory, cfg, mem_init_state=_mem_init(rng), device=device)
    return Case(ecr.eval_constraints, w, cfg, 2 * ecr.BITS * calls)


_BUILDERS = dict(demux_log_queue=demux, sort_decommittment_requests=decommit_sorter,
                 linear_hasher=linear_hasher, eip_4844=eip_4844,
                 storage_application=storage_application, sha256_round_function=sha256,
                 code_unpacker_sha256=code_unpacker, ecrecover=ecrecover)


def case(name: str, rows: int, seed: int, device) -> Case:
    """circuit `name`'s witness of `rows` rows (ecrecover: calls) made from
    `seed`, on `device`."""
    return _BUILDERS[name](rows, np.random.default_rng(seed), device)


def _flip(t: torch.Tensor, index) -> torch.Tensor:
    out = t.clone()
    out[index] = ~out[index] if out.dtype == torch.bool else out[index] ^ 1
    return out


def tamper(name: str, w, row: int):
    """w with one value changed at run row `row` of the row axis."""
    rep = dataclasses.replace
    if name == "demux_log_queue":
        return rep(w, out_counts=dict(w.out_counts, events=_flip(w.out_counts["events"], row)))
    if name == "sort_decommittment_requests":
        return rep(w, first_enc_ts=_flip(w.first_enc_ts, row))
    if name == "linear_hasher":
        return rep(w, msg_bytes=_flip(w.msg_bytes, (row, 5)))
    if name == "eip_4844":
        return rep(w, acc=_flip(w.acc, (row, 0)))
    if name == "storage_application":
        return rep(w, row_path=_flip(w.row_path, (row, 3, 0)))
    if name == "sha256_round_function":
        return rep(w, round_execute=_flip(w.round_execute, row))
    if name == "code_unpacker_sha256":
        return rep(w, writes=rep(w.writes, value=_flip(w.writes.value, (2 * row, 0))))
    if name == "ecrecover":
        return rep(w, steps=dict(w.steps, base_x=_flip(w.steps["base_x"], (row, 0))))
    raise KeyError(name)
