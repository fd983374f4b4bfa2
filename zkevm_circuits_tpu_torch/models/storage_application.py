"""storage_application, circuit type 10: the Merkle-tree storage applicator
(the JAX package's `models/storage_application.py`).

Reference parity: `src/storage_application/` (entry mod.rs:267-720) and
`src/base_structures/state_diff_record/mod.rs`.  Semantics replicated:

  * depth-256 binary Merkle tree of blake2s nodes (STORAGE_DEPTH = 256,
    input.rs:24); derived key = blake2s(0^12 || address_be || key_be)
    (mod.rs:433-439); path bits taken LSB-first from the derived key bytes.
  * leaf = blake2s(enumeration_index_bytes(8: high_be||low_be) || value_be)
    (mod.rs:523-570).
  * each query runs a read stage (path must recompute the current root) and,
    for writes, a write stage with the written value re-rooting the tree
    (mod.rs:583-600).
  * enumeration indices: reads carry a witness index; a write to a fresh
    slot (index 0) is assigned next_enumeration_counter, which increments
    (mod.rs:448-478).
  * per write, a 156-byte StateDiffRecord
    [address|key|derived_key|enum_index|initial|final] is keccak-absorbed
    over 2 rate blocks (state_diff_record/mod.rs:15-16); a final 0x01/0x80
    padding block closes the accumulator and the digest is exposed
    (mod.rs:662-689).

Rows: stages (1 per read, 2 per write).  All 256 path levels of all rows are
checked by batched blake2s compressions on the witness's device, a block of
rows at a time; the root, counter and keccak chains are columns checked
row-parallel.

The out-of-circuit tree (`SparseStorageTree`) keeps the JAX package's
interface and meaning (a node is the empty subtree's hash iff no set leaf
lies under it) but holds a node cache, a dict a level, updated along the
leaf's path on every `set_leaf`: `root` and `path` are lookups, and the
witness reads each row's 257 path nodes from the cache instead of hashing
them.  The host hash is `hashlib.blake2s`, the same function as
`blake2s.blake2s_ref` on the message lengths used here (0, 40 and 64 bytes).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from ..base_structures.log_query import LogQueries, encode_log_queries
from ..isa.system_params import STORAGE_AUX_BYTE
from ..ops import blake2s, gf, keccak, queues
from ..utils import protocol
from ..utils.device import resolve_device
from ..utils.shard_plan import Axis, PartialSum, RowWindow, ShardPlan, owned_rows, summed
from . import precompile_common as pc

STORAGE_DEPTH = 256
STATE_DIFF_RECORD_BYTE_ENCODING_LEN = 156
RATE = keccak.KECCAK_RATE_BYTES
M32 = pc.M32
# stage rows whose 256 path levels one batched compression checks at a time
PATH_ROWS_PER_BLOCK = 2048


@dataclasses.dataclass(frozen=True)
class StorageApplicationConfig:
    max_rows: int  # stage rows (reads + 2x writes)
    shard: int = 0


# ---------------------------------------------------------------------------
# host helpers (witness generation + an out-of-circuit sparse tree)
# ---------------------------------------------------------------------------


def _blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


def derive_key_ref(address: int, key: int) -> bytes:
    return _blake2s(b"\x00" * 12 + address.to_bytes(20, "big") + key.to_bytes(32, "big"))


def _index_bytes(enum_index: int) -> bytes:
    return (enum_index >> 32).to_bytes(4, "big") + (enum_index & M32).to_bytes(4, "big")


def leaf_hash_ref(enum_index: int, value: int) -> bytes:
    return _blake2s(_index_bytes(enum_index) + value.to_bytes(32, "big"))


def path_bits(derived_key: bytes):
    return [(derived_key[i // 8] >> (i % 8)) & 1 for i in range(STORAGE_DEPTH)]


class SparseStorageTree:
    """Out-of-circuit depth-256 sparse Merkle tree (witness/test oracle).

    A leaf position is the 256-bit integer formed LSB-first from the derived
    key's path bits; a node at level L has id = position >> L and children
    ids (2*id | b) where b is path bit L-1 — bit b = 0 is the LEFT child
    (the circuit places `current` on the right when the bit is 1).  Nodes
    with a set leaf under them live in a cache, one dict a level; every other
    node is `empty[level]`."""

    def __init__(self):
        self.empty = [leaf_hash_ref(0, 0)]
        for _ in range(STORAGE_DEPTH):
            self.empty.append(_blake2s(self.empty[-1] + self.empty[-1]))
        self.leaves = {}  # position int -> (enum_index, value)
        self._nodes = [dict() for _ in range(STORAGE_DEPTH + 1)]

    @staticmethod
    def position(bits) -> int:
        p = 0
        for i, b in enumerate(bits):
            p |= int(b) << i
        return p

    def set_leaf(self, bits, enum_index: int, value: int):
        """set the leaf and rehash its 256 ancestors."""
        p = self.position(bits)
        self.leaves[p] = (enum_index, value)
        cur = leaf_hash_ref(enum_index, value)
        self._nodes[0][p] = cur
        node = p
        for level in range(STORAGE_DEPTH):
            sib = self._nodes[level].get(node ^ 1, self.empty[level])
            cur = _blake2s(sib + cur) if node & 1 else _blake2s(cur + sib)
            node >>= 1
            self._nodes[level + 1][node] = cur

    def node(self, level: int, node_id: int) -> bytes:
        return self._nodes[level].get(node_id, self.empty[level])

    def root(self) -> bytes:
        return self.node(STORAGE_DEPTH, 0)

    def path(self, bits) -> list:
        """sibling hashes bottom-up (level 0 first)."""
        return self.path_at(self.position(bits))

    def path_at(self, p: int) -> list:
        nodes, empty = self._nodes, self.empty
        return [nodes[level].get((p >> level) ^ 1, empty[level]) for level in range(STORAGE_DEPTH)]

    def nodes_at(self, p: int) -> list:
        """the 257 nodes from the leaf at position p up to the root."""
        nodes, empty = self._nodes, self.empty
        return [nodes[level].get(p >> level, empty[level]) for level in range(STORAGE_DEPTH + 1)]


def apply_path_ref(leaf_hash: bytes, bits, path: list) -> bytes:
    """climb from leaf to root (circuit mod.rs:572-582)."""
    return _climb(leaf_hash, bits, path)[-1]


def _climb(leaf_hash: bytes, bits, path: list) -> list:
    cur = leaf_hash
    nodes = [cur]
    for b, sib in zip(bits, path):
        cur = _blake2s(sib + cur) if b else _blake2s(cur + sib)
        nodes.append(cur)
    return nodes


def state_diff_bytes_ref(address, key, derived_key, enum_index, initial, final):
    out = (address.to_bytes(20, "big") + key.to_bytes(32, "big") + derived_key
           + _index_bytes(enum_index) + initial.to_bytes(32, "big") + final.to_bytes(32, "big"))
    if len(out) != STATE_DIFF_RECORD_BYTE_ENCODING_LEN:
        raise ValueError(f"a state diff record is {STATE_DIFF_RECORD_BYTE_ENCODING_LEN} bytes")
    return out


def _words_le(data: bytes, shape) -> np.ndarray:
    """bytes -> little-endian u32 words as int64, in `shape`."""
    return np.frombuffer(data, "<u4").astype(np.int64).reshape(shape)


@dataclasses.dataclass(frozen=True)
class StorageApplicationWitness:
    num_queries: int
    queries: LogQueries  # (Q,)
    query_execute: torch.Tensor
    query_chain: torch.Tensor  # (Q+1, 4)
    derived_keys: torch.Tensor  # (Q, 8) u32 LE words of the 32 derived-key bytes
    read_indices: torch.Tensor  # (Q, 2) u32 (lo, hi) witness enumeration index
    # stage rows (N = max_rows)
    row_execute: torch.Tensor  # (N,)
    row_query: torch.Tensor  # (N,)
    row_is_write_stage: torch.Tensor  # (N,)
    row_leaf_index: torch.Tensor  # (N, 2) u32 (lo, hi) index used for the leaf
    row_leaf_value: torch.Tensor  # (N, 8) u32 LE words of the 32 BE value bytes
    row_path: torch.Tensor  # (N, 256, 8) u32 LE words of sibling hashes
    row_nodes: torch.Tensor  # (N, 257, 8) u32 LE words: leaf hash -> root
    roots: torch.Tensor  # (N+1, 8) u32 LE words of the tree root
    counters: torch.Tensor  # (N+1, 2) u32 next_enumeration_counter (lo, hi)
    # state-diff keccak accumulator
    diff_blocks_lo: torch.Tensor  # (B, 17)
    diff_blocks_hi: torch.Tensor  # (B, 17)
    diff_block_execute: torch.Tensor  # (B,)
    diff_states_lo: torch.Tensor  # (B+1, 25)
    diff_states_hi: torch.Tensor
    diffs_digest: torch.Tensor  # (32,) bytes


def generate_witness(queries: list, tree: SparseStorageTree, initial_counter: int,
                     config: StorageApplicationConfig,
                     device=None) -> StorageApplicationWitness:
    """queries: LogQuery dicts (deduplicated, sorted storage accesses).
    `tree` is mutated as writes are applied (it is the backing state).
    `device=None` is the card."""
    device = resolve_device(device)
    Q = max(len(queries), 1)
    N = config.max_rows

    rows = []  # (query, write, leaf index, leaf value, path, nodes)
    diff_records = []
    counter = initial_counter
    counters = [counter]
    roots = [tree.root()]
    derived_list = []
    read_idx_list = []
    for qi, q in enumerate(queries):
        addr, key = int(q["address"]), int(q["key"])
        rv, wv = int(q["read_value"]), int(q["written_value"])
        dk = derive_key_ref(addr, key)
        bits = path_bits(dk)
        derived_list.append(dk)
        pos = tree.position(bits)
        existing = tree.leaves.get(pos)
        read_index = existing[0] if existing else 0
        read_idx_list.append(read_index)
        path = tree.path_at(pos)
        # read stage: the tree's own nodes when the claimed leaf is the
        # tree's, else the climb from the claimed leaf
        leaf = leaf_hash_ref(read_index, rv)
        nodes = tree.nodes_at(pos) if leaf == tree.node(0, pos) else _climb(leaf, bits, path)
        rows.append((qi, False, read_index, rv, path, nodes))
        roots.append(roots[-1])
        counters.append(counter)
        if q["rw_flag"]:
            # write stage: maybe assign a fresh index
            if read_index == 0:
                idx = counter
                counter += 1
            else:
                idx = read_index
            tree.set_leaf(bits, idx, wv)
            rows.append((qi, True, idx, wv, path, tree.nodes_at(pos)))
            roots.append(tree.root())
            counters.append(counter)
            diff_records.append(state_diff_bytes_ref(addr, key, dk, read_index, rv, wv))
    if len(rows) > N:
        raise ValueError(f"{len(rows)} stage rows do not fit max_rows={N}")

    n_rows = len(rows)
    zero_hash = bytes(32)
    pad_rows = N - n_rows
    row_nodes = _words_le(b"".join(b"".join(r[5]) for r in rows)
                          + zero_hash * ((STORAGE_DEPTH + 1) * pad_rows),
                          (N, STORAGE_DEPTH + 1, 8))
    row_path = _words_le(b"".join(b"".join(r[4]) for r in rows)
                         + zero_hash * (STORAGE_DEPTH * pad_rows), (N, STORAGE_DEPTH, 8))
    row_leaf_index = np.zeros((N, 2), np.int64)
    row_leaf_value = np.zeros((N, 8), np.int64)
    row_query = np.zeros(N, np.int64)
    row_write = np.zeros(N, bool)
    if n_rows:
        row_leaf_index[:n_rows] = [[r[2] & M32, r[2] >> 32] for r in rows]
        row_leaf_value[:n_rows] = _words_le(b"".join(r[3].to_bytes(32, "big") for r in rows),
                                            (n_rows, 8))
        row_query[:n_rows] = [r[0] for r in rows]
        row_write[:n_rows] = [r[1] for r in rows]

    last = len(roots) - 1
    roots_np = _words_le(b"".join(roots) + roots[last] * (N + 1 - len(roots)), (N + 1, 8))
    counters_all = counters + [counters[-1]] * (N + 1 - len(counters))
    counters_np = np.asarray([[c & M32, c >> 32] for c in counters_all], np.int64)

    # keccak accumulator over diff records (2 blocks each) + final padding
    B = 2 * Q + 1
    blocks = []
    for rec in diff_records:
        ext = rec + b"\x00" * (2 * RATE - len(rec))
        blocks += [ext[:RATE], ext[RATE:]]
    pad = bytearray(RATE)
    pad[0] = 0x01
    pad[RATE - 1] = 0x80
    blocks.append(bytes(pad))
    lanes_np = np.zeros((B, 17), np.uint64)
    states = np.zeros((B + 1, 25), np.uint64)
    cur = [0] * 25
    for b, blk in enumerate(blocks):
        lanes = keccak.bytes_to_lanes(blk)
        cur = keccak.keccak_f1600_ref([cur[j] ^ (lanes[j] if j < 17 else 0) for j in range(25)])
        states[b + 1] = cur
        lanes_np[b] = lanes
    digest = b"".join(int(states[len(blocks)][j]).to_bytes(8, "little") for j in range(4))

    qpad = dict(address=0, key=0, read_value=0, written_value=0, aux_byte=STORAGE_AUX_BYTE,
                rw_flag=False, rollback=False, is_service=False, shard_id=config.shard,
                tx_number_in_block=0, timestamp=0)
    queries_q = LogQueries.from_lists(list(queries) + [qpad] * (Q - len(queries)), device)
    q_exec = pc.executed(Q, len(queries), device)
    (q_chain,) = queues.simulate_chains(
        queues.NARROW_STATE_WIDTH, [(encode_log_queries(queries_q), q_exec)])

    dk_np = np.zeros((Q, 8), np.int64)
    ri_np = np.zeros((Q, 2), np.int64)
    if queries:
        dk_np[:len(queries)] = _words_le(b"".join(derived_list), (len(queries), 8))
        ri_np[:len(queries)] = [[i & M32, i >> 32] for i in read_idx_list]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def lo_hi(a):
        return t((a & np.uint64(M32)).astype(np.int64)), t((a >> np.uint64(32)).astype(np.int64))

    blo, bhi = lo_hi(lanes_np)
    slo, shi = lo_hi(states)
    return StorageApplicationWitness(
        num_queries=len(queries),
        queries=queries_q,
        query_execute=q_exec,
        query_chain=q_chain,
        derived_keys=t(dk_np),
        read_indices=t(ri_np),
        row_execute=pc.executed(N, n_rows, device),
        row_query=t(row_query),
        row_is_write_stage=t(row_write),
        row_leaf_index=t(row_leaf_index),
        row_leaf_value=t(row_leaf_value),
        row_path=t(row_path),
        row_nodes=t(row_nodes),
        roots=t(roots_np),
        counters=t(counters_np),
        diff_blocks_lo=blo,
        diff_blocks_hi=bhi,
        diff_block_execute=pc.executed(B, len(blocks), device),
        diff_states_lo=slo,
        diff_states_hi=shi,
        diffs_digest=t(np.frombuffer(digest, np.uint8).astype(np.int64)),
    )


def blake2s_calls(w: StorageApplicationWitness):
    """Plaintext (messages, digests) of every blake2s invocation the
    executed stage rows perform — derived keys (ref mod.rs:433-439), leaf
    hashes (mod.rs:523-570) and all 256 path levels per stage
    (mod.rs:390-400) — deduplicated, in a deterministic order."""

    def wb(ws) -> bytes:
        return np.asarray(ws, "<u4").tobytes()

    seen = set()
    msgs, digs = [], []

    def put(msg: bytes, dig: bytes):
        # dedup identical (message, digest) pairs; distinct digests for one
        # message are both kept
        if (msg, dig) in seen:
            return
        seen.add((msg, dig))
        msgs.append(msg)
        digs.append(dig)

    Q = w.num_queries
    addr_l = w.queries.address.cpu().numpy()
    key_l = w.queries.key.cpu().numpy()
    dks = w.derived_keys.cpu().numpy()
    dk_bytes = {}
    for qi in range(Q):
        addr = sum(int(addr_l[qi, j]) << (32 * j) for j in range(5))
        key = sum(int(key_l[qi, j]) << (32 * j) for j in range(8))
        dk_bytes[qi] = wb(dks[qi])
        put(b"\x00" * 12 + addr.to_bytes(20, "big") + key.to_bytes(32, "big"), dk_bytes[qi])
    rex = w.row_execute.cpu().numpy()
    rq = w.row_query.cpu().numpy()
    ridx = w.row_leaf_index.cpu().numpy()
    rval = w.row_leaf_value.cpu().numpy()
    rpath = w.row_path.cpu().numpy()
    rnodes = w.row_nodes.cpu().numpy()
    for i in range(rex.shape[0]):
        if not rex[i]:
            continue
        idx = int(ridx[i, 0]) | (int(ridx[i, 1]) << 32)
        put(_index_bytes(idx) + wb(rval[i]), wb(rnodes[i, 0]))
        bits = path_bits(dk_bytes[int(rq[i])])
        for level in range(STORAGE_DEPTH):
            node, sib = wb(rnodes[i, level]), wb(rpath[i, level])
            left, right = (sib, node) if bits[level] else (node, sib)
            put(left + right, wb(rnodes[i, level + 1]))
    return msgs, digs


def _blake2s_fixed(m_words: torch.Tensor, nbytes: int) -> torch.Tensor:
    """blake2s of a single sub-64-byte block: m_words (..., 16) LE u32."""
    h = blake2s.initial_state(m_words.shape[:-1], device=m_words.device)
    return blake2s.compress(h, m_words, nbytes, True)


def _be_value_words(value_limbs: torch.Tensor) -> torch.Tensor:
    """u256 (or u160) LE limbs -> LE words of the 32 (20) BE bytes."""
    return pc.bswap32(value_limbs.flip(-1))


def path_levels_ok(derived_keys: torch.Tensor, row_query: torch.Tensor, row_nodes: torch.Tensor,
                   row_path: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool: each level's parent is blake2s(left || right) of the
    node below and its sibling, ordered by the derived key's path bit; one
    batched compression over PATH_ROWS_PER_BLOCK rows x 256 levels at a time."""
    N = row_nodes.shape[0]
    dev = row_nodes.device
    lvl = torch.arange(STORAGE_DEPTH, device=dev)
    byte_idx = lvl // 8
    word_idx = byte_idx // 4
    shift = (byte_idx % 4) * 8 + (lvl % 8)
    out = []
    for start in range(0, N, PATH_ROWS_PER_BLOCK):
        rows = slice(start, min(N, start + PATH_ROWS_PER_BLOCK))
        dkq = derived_keys[row_query[rows]]  # (n, 8)
        bits = ((dkq[:, word_idx] >> shift) & 1)[..., None] == 1  # (n, 256, 1)
        cur = row_nodes[rows, :-1]
        sib = row_path[rows]
        msg = torch.cat([torch.where(bits, sib, cur), torch.where(bits, cur, sib)], dim=-1)
        parent = _blake2s_fixed(msg.reshape(-1, 16), 64).reshape(cur.shape)
        out.append((parent == row_nodes[rows, 1:]).all(-1))
    return torch.cat(out)


def eval_constraints(w: StorageApplicationWitness, config: StorageApplicationConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Row-parallel constraint evaluation on the witness's device; every
    entry must be all-True.  `window` places a block of stage rows and one
    of diff blocks in their run (`parallel/auto.py`); None is the whole
    run."""
    N = config.max_rows
    dev = w.row_execute.device
    res = {}
    q = w.queries
    qe, re_ = w.query_execute, w.row_execute
    true_q = torch.ones_like(qe)
    true_n = torch.ones_like(re_)

    res["query_chain"] = queues.check_chain(w.query_chain, encode_log_queries(q), qe)
    res["shard_and_aux"] = torch.where(
        qe, (q.shard_id == config.shard) & (q.aux_byte == STORAGE_AUX_BYTE), true_q)

    # derived key = blake2s(0^12 || addr_be || key_be) — 64-byte message
    dk_msg = torch.cat([torch.zeros(q.shape + (3,), dtype=torch.int64, device=dev),
                        _be_value_words(q.address), _be_value_words(q.key)], dim=-1)
    dk = _blake2s_fixed(dk_msg, 64)
    res["derived_key"] = torch.where(qe, (dk == w.derived_keys).all(-1), true_q)

    # leaf hashes: blake2s over 40 bytes [idx_hi_be, idx_lo_be, value_be]
    leaf_msg = torch.cat([pc.bswap32(w.row_leaf_index[:, 1])[:, None],
                          pc.bswap32(w.row_leaf_index[:, 0])[:, None], w.row_leaf_value,
                          torch.zeros((N, 6), dtype=torch.int64, device=dev)], dim=-1)
    leaf_hash = _blake2s_fixed(leaf_msg, 40)
    res["leaf_hash"] = torch.where(re_, (leaf_hash == w.row_nodes[:, 0]).all(-1), true_n)

    # path climb: every level of every row
    levels = path_levels_ok(w.derived_keys, w.row_query, w.row_nodes, w.row_path)
    res["merkle_path"] = torch.where(re_[:, None], levels, torch.ones_like(levels)).all(-1)

    # roots: read rows must reproduce the running root; write rows re-root
    computed_root = w.row_nodes[:, STORAGE_DEPTH]
    write_rows = re_ & w.row_is_write_stage
    res["read_root_match"] = torch.where(re_ & ~w.row_is_write_stage,
                                         (computed_root == w.roots[:-1]).all(-1), true_n)
    next_root = torch.where(write_rows[:, None], computed_root, w.roots[:-1])
    res["root_chain"] = (next_root == w.roots[1:]).all(-1)

    # stage structure: write rows follow their read rows with same query/path
    prev_q = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev), w.row_query[:-1]])
    prev_w = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), w.row_is_write_stage[:-1]])
    res["write_follows_read"] = torch.where(write_rows, (w.row_query == prev_q) & ~prev_w, true_n)
    prev_path = torch.cat([torch.zeros_like(w.row_path[:1]), w.row_path[:-1]])
    res["write_same_path"] = torch.where(
        write_rows, (w.row_path == prev_path).reshape(N, -1).all(-1), true_n)
    # read rows use read_value + witness read index; write rows use written
    rv_words = _be_value_words(q.read_value)[w.row_query]
    wv_words = _be_value_words(q.written_value)[w.row_query]
    expect_value = torch.where(w.row_is_write_stage[:, None], wv_words, rv_words)
    res["leaf_values"] = torch.where(re_, (expect_value == w.row_leaf_value).all(-1), true_n)
    read_idx = w.read_indices[w.row_query]
    res["read_leaf_index"] = torch.where(re_ & ~w.row_is_write_stage,
                                         (w.row_leaf_index == read_idx).all(-1), true_n)
    # write index: fresh (read idx 0) -> counter value; else read idx;
    # counter increments exactly on fresh writes
    fresh = (read_idx == 0).all(-1)
    assigned = torch.where(fresh[:, None], w.counters[:-1], read_idx)
    res["write_leaf_index"] = torch.where(write_rows, (w.row_leaf_index == assigned).all(-1),
                                          true_n)
    inc = (write_rows & fresh).to(torch.int64)
    # 64-bit increment across (lo, hi)
    new_lo = (w.counters[:-1, 0] + inc) & M32
    carry = (new_lo < w.counters[:-1, 0]).to(torch.int64)
    new_hi = (w.counters[:-1, 1] + carry) & M32
    res["counter_chain"] = (w.counters[1:, 0] == new_lo) & (w.counters[1:, 1] == new_hi)

    # queries must alternate correctly: every write query has both stages
    rows_per_query = pc.scatter_add(q.shape[0], w.row_query, re_ & owned_rows(window, N, dev))
    expected_rows = torch.where(q.rw_flag, 2, 1)
    res["stage_counts"] = summed(
        rows_per_query, lambda s: torch.where(qe, (s & M32) == expected_rows, true_q), window)

    # keccak accumulator chain + digest
    abs_lo, abs_hi = keccak.absorb_block(w.diff_states_lo[:-1], w.diff_states_hi[:-1],
                                         w.diff_blocks_lo, w.diff_blocks_hi)
    ok = (abs_lo == w.diff_states_lo[1:]).all(-1) & (abs_hi == w.diff_states_hi[1:]).all(-1)
    res["diffs_keccak_chain"] = torch.where(w.diff_block_execute, ok, torch.ones_like(ok))
    diffs = window.axes["diffs"] if window else None
    if diffs is None:
        nblocks = w.diff_block_execute.sum()
        res["diffs_digest"] = (keccak.digest_bytes(w.diff_states_lo[nblocks],
                                                   w.diff_states_hi[nblocks])
                               == w.diffs_digest).all()
        return res
    # the digest is read at the run's count of executed blocks: each member
    # counts its own blocks and marks which of its own states hold the digest
    b = w.diff_block_execute.shape[0]
    own = owned_rows(diffs, b + 1, dev) | (torch.arange(b + 1, device=dev) + diffs.row0
                                           == diffs.total)
    holds = (keccak.digest_bytes(w.diff_states_lo, w.diff_states_hi)
             == w.diffs_digest).all(-1) & own
    share = torch.zeros(diffs.total + 2, dtype=torch.int64, device=dev)
    share[diffs.row0:diffs.row0 + b + 1] = holds.to(torch.int64)
    share[-1] = (w.diff_block_execute & owned_rows(diffs, b, dev)).sum()
    res["diffs_digest"] = PartialSum(share, lambda s: s[s[-1]] == 1)
    return res


all_ok = pc.all_ok

# row-sharded over the stage rows (the path climbs) and, as a further axis,
# over the diff keccak blocks; a row reads the previous row and reaches its
# query by index: the query fields stay whole on every member (their
# residuals computed on each, taken from the first); the stages a query
# counts and the digest at the run's block count are sums over the members
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 0),
    rows=frozenset({"row_execute", "row_query", "row_is_write_stage", "row_leaf_index",
                    "row_leaf_value", "row_path", "row_nodes", "roots", "counters"}),
    axes={"diffs": Axis(rows_of="diff_block_execute",
                        fields=frozenset({"diff_blocks_lo", "diff_blocks_hi",
                                          "diff_block_execute", "diff_states_lo",
                                          "diff_states_hi"}),
                        residuals=frozenset({"diffs_keccak_chain"}))},
    whole=frozenset({"query_chain", "shard_and_aux", "derived_key"}),
    sums=frozenset({"stage_counts", "diffs_digest"}),
    takes_window=True,
    window_config=lambda config, rows: dataclasses.replace(config, max_rows=rows),
)

# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


def instance_compact_form(w: StorageApplicationWitness, config: StorageApplicationConfig):
    """Single-instance ClosedFormInput (StorageApplicationInput/OutputData:
    shard, roots, enumeration counters, queue state, diffs hash)."""
    dev = w.row_execute.device
    Q = w.query_execute.shape[0]
    N = w.row_execute.shape[0]
    qs = protocol.encode_queue_state_generic(gf.zeros((4,), dev), w.query_chain[Q], w.num_queries)
    shard = torch.full((1,), config.shard, dtype=torch.int64, device=dev)
    obs_in = torch.cat([shard, gf.from_u32(w.roots[0]), gf.from_u32(w.counters[0]), qs])[None]
    obs_out = torch.cat([gf.from_u32(w.roots[N]), gf.from_u32(w.counters[N]),
                         gf.from_u32(w.diffs_digest)])[None]
    return protocol.single_instance_compact_form(obs_in, obs_out)
