"""storage_application (circuit type 10) and its sparse tree in the torch
port against the JAX package on the CPU.

The port's tree (a node cache a level) against the JAX package's
`SparseStorageTree` (which recomputes from its leaves): the root and every
path of a small random tree, an overwrite, a leaf written twice.  The
circuit on seeded queries — reads and writes of cells that exist, fresh
cells, a cell written twice, a read-only cell — over a seeded tree: the
witness, the residual dict, the compact form, `blake2s_calls`, the port's
evaluation of the JAX package's witness, and chip_smoke.py's negative probe
(a changed path sibling) under both packages' evaluations.  The block
runtime's snapshot tree and chip_smoke.py's replayed root (a plain recursion
with no node cache) against the JAX tree after its witness applied the same
queries.  Exact equality.
"""

import numpy as np
import pytest

import chip_smoke
from torch_log_helpers import assert_same_residuals, failing_rows, jax_to_numpy
from torch_precompile_helpers import assert_same_forms, assert_same_witness, to_jax
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.isa import system_params as jsp
from zkevm_circuits_tpu.models import storage_application as jsa

from zkevm_circuits_tpu_torch.models import storage_application as sa
from zkevm_circuits_tpu_torch.runtime import block
from zkevm_circuits_tpu_torch.utils.convert import (
    residuals_to_numpy, storage_application_witness_from_numpy, witness_to_numpy,
)
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
ROWS = 16
FIELDS = ("query_chain",)


def _cells(rng, n):
    return [(int(rng.integers(1, 1 << 60)), int(rng.integers(0, 1 << 60))) for _ in range(n)]


def test_tree_equals_jax_tree():
    rng = np.random.default_rng(10)
    jt, t = jsa.SparseStorageTree(), sa.SparseStorageTree()
    assert t.empty == jt.empty and t.root() == jt.root()
    cells = _cells(rng, 6)
    for i, (a, k) in enumerate(cells + [cells[2]]):  # the last one writes a leaf twice
        value = int(rng.integers(1, 1 << 60))
        for tree, mod in ((jt, jsa), (t, sa)):
            tree.set_leaf(mod.path_bits(mod.derive_key_ref(a, k)), i + 1, value)
    assert t.leaves == jt.leaves and t.root() == jt.root()
    for a, k in cells + _cells(rng, 2):  # every set leaf, and two empty ones
        bits = sa.path_bits(sa.derive_key_ref(a, k))
        assert bits == jsa.path_bits(jsa.derive_key_ref(a, k))
        path = t.path(bits)
        assert path == jt.path(bits)
        leaf = t.node(0, t.position(bits))
        root = sa.apply_path_ref(leaf, bits, path)
        assert root == jsa.apply_path_ref(leaf, bits, path) == t.root()
    assert sa.leaf_hash_ref(7, 9) == jsa.leaf_hash_ref(7, 9)
    dk = sa.derive_key_ref(*cells[0])
    assert (sa.state_diff_bytes_ref(cells[0][0], cells[0][1], dk, 3, 4, 5)
            == jsa.state_diff_bytes_ref(cells[0][0], cells[0][1], dk, 3, 4, 5))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    seeded = _cells(rng, 4)
    trees = []
    for tree, mod in ((jsa.SparseStorageTree(), jsa), (sa.SparseStorageTree(), sa)):
        for i, (a, k) in enumerate(seeded):
            tree.set_leaf(mod.path_bits(mod.derive_key_ref(a, k)), i + 1, 1000 + i)
        trees.append(tree)
    fresh = _cells(rng, 3)
    # (cell, read value, written value or None): writes of existing cells,
    # fresh writes, a read-only cell, one cell written twice
    plan = [(seeded[0], 1000, 77), (fresh[0], 0, 5), (seeded[1], 1001, None),
            (fresh[1], 0, None), (fresh[2], 0, 9), (seeded[3], 1003, 11), (fresh[2], 9, 12)]
    queries = [dict(address=a, key=k, read_value=rv, written_value=rv if wv is None else wv,
                    aux_byte=jsp.STORAGE_AUX_BYTE, rw_flag=wv is not None, rollback=False,
                    is_service=False, shard_id=0, tx_number_in_block=0, timestamp=3 * i)
               for i, ((a, k), rv, wv) in enumerate(plan)]
    jt, t = trees
    cfg, jcfg = sa.StorageApplicationConfig(ROWS), jsa.StorageApplicationConfig(ROWS)
    jw = jsa.generate_witness(queries, jt, 5, jcfg)
    w = sa.generate_witness(queries, t, 5, cfg, device=CPU)
    want = {k: np.asarray(v) for k, v in jsa.eval_constraints(jw, jcfg).items()}
    return jt, t, jw, w, want


def test_witness_residuals_and_form_equal_jax(case):
    jt, t, jw, w, want = case
    cfg, jcfg = sa.StorageApplicationConfig(ROWS), jsa.StorageApplicationConfig(ROWS)
    assert t.root() == jt.root() and t.leaves == jt.leaves
    assert_same_witness(w, jw, FIELDS)
    assert int(w.row_execute.sum()) == 12
    assert not failing_rows(want)
    assert_same_residuals(residuals_to_numpy(sa.eval_constraints(w, cfg)), want)
    carried = storage_application_witness_from_numpy(jax_to_numpy(jw), device=CPU)
    assert_same_residuals(residuals_to_numpy(sa.eval_constraints_jit(carried, cfg)), want)
    assert_same_forms(sa.instance_compact_form(w, cfg), jsa.instance_compact_form(jw, jcfg))
    assert sa.blake2s_calls(w) == jsa.blake2s_calls(jw)


def test_changed_sibling_fails_as_in_jax(case):
    *_, w, _ = case
    forged, want = chip_smoke.probe_storage_sibling(w)
    cfg = sa.StorageApplicationConfig(ROWS)
    assert failing_rows(residuals_to_numpy(sa.eval_constraints(forged, cfg))) == want
    jforged = to_jax(jsa.StorageApplicationWitness, witness_to_numpy(forged, FIELDS), FIELDS,
                     dict(queries=JLogQueries))
    assert failing_rows(jsa.eval_constraints(jforged, jsa.StorageApplicationConfig(ROWS))) == want


def test_a_read_of_a_stale_value_fails_as_in_jax():
    """a read whose value is not the tree's climbs from its own leaf (no
    cached path): the read root fails in both packages"""
    rng = np.random.default_rng(12)
    (a, k), = _cells(rng, 1)
    q = [dict(address=a, key=k, read_value=4, written_value=4, aux_byte=jsp.STORAGE_AUX_BYTE,
              rw_flag=False, rollback=False, is_service=False, shard_id=0,
              tx_number_in_block=0, timestamp=1)]
    jt, t = jsa.SparseStorageTree(), sa.SparseStorageTree()
    for tree, mod in ((jt, jsa), (t, sa)):
        tree.set_leaf(mod.path_bits(mod.derive_key_ref(a, k)), 1, 3)
    jw = jsa.generate_witness(q, jt, 2, jsa.StorageApplicationConfig(2))
    w = sa.generate_witness(q, t, 2, sa.StorageApplicationConfig(2), device=CPU)
    assert_same_witness(w, jw, FIELDS)
    got = failing_rows(residuals_to_numpy(sa.eval_constraints(w, sa.StorageApplicationConfig(2))))
    assert got == {"read_root_match": [0]}
    assert failing_rows(jsa.eval_constraints(jw, jsa.StorageApplicationConfig(2))) == got


def test_snapshot_tree_and_replayed_root_equal_jax():
    """`block.storage_tree` seeds the tree from a storage snapshot (nonzero
    rollup cells, indices from 1 in key order); chip_smoke.py's replayed root
    of the snapshot and the queries is the JAX tree's root after its witness
    applied them, and moves with a changed written value"""
    rng = np.random.default_rng(13)
    cells = _cells(rng, 8)
    storage = {(0, a, k): 2000 + i for i, (a, k) in enumerate(cells[:4])}
    storage[(0,) + cells[4]] = 0  # a zero cell is not in the tree
    storage[(1,) + cells[5]] = 5  # nor is a cell of another shard
    jt, counter = jsa.SparseStorageTree(), 1
    for (shard, a, k), value in sorted(storage.items()):
        if shard == 0 and value:
            jt.set_leaf(jsa.path_bits(jsa.derive_key_ref(a, k)), counter, value)
            counter += 1
    t, c = block.storage_tree(storage)
    assert (t.root(), t.leaves, c) == (jt.root(), jt.leaves, counter)
    # an overwrite, a read, fresh writes (the zero cell's among them), a cell written twice
    plan = [(cells[0], 2000, 31), (cells[1], 2001, None), (cells[4], 0, 6), (cells[6], 0, 7),
            (cells[7], 0, 8), (cells[7], 8, 9)]
    queries = [dict(address=a, key=k, read_value=rv, written_value=rv if wv is None else wv,
                    aux_byte=jsp.STORAGE_AUX_BYTE, rw_flag=wv is not None, rollback=False,
                    is_service=False, shard_id=0, tx_number_in_block=0, timestamp=2 * i)
               for i, ((a, k), rv, wv) in enumerate(plan)]
    jsa.generate_witness(queries, jt, counter, jsa.StorageApplicationConfig(ROWS))
    assert chip_smoke._replayed_root(storage, queries) == jt.root()
    queries[3] = dict(queries[3], written_value=70)
    assert chip_smoke._replayed_root(storage, queries) != jt.root()
