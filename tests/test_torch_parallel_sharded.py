"""The row-sharded ram_permutation check (`parallel/sharded.py`): the port's
gloo worlds of 2 and 4 ranks against the JAX package's
`sharded_eval_constraints` on sub-meshes of its 8-device virtual mesh.

The same seeded tapes (2^10 rows in instances of 2^7: a written cell, then
cells written and read back) go through both packages' witnesses.  Two
tampers sit at the boundary of the first two shards, each read across it: a
sorted value at the first shard's last row, and the chain state before the
second shard's first row.  A third changes the value of a write no read
follows, which neither package's sharded check sees (ROADMAP Queue 3).
Residuals are bools: equal key for key and row for row, with no tolerance.
Each world is started once for the file and joined within
the time limit of the test that waits on it (tests/torch_test_policy.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from zkevm_circuits_tpu.models import ram_permutation as jram
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.parallel import mesh as jmesh
from zkevm_circuits_tpu.parallel.sharded import sharded_eval_constraints as jax_sharded

import torch_parallel_ranks as ranks
from zkevm_circuits_tpu_torch.models import ram_permutation as ram
from zkevm_circuits_tpu_torch.utils.convert import residuals_to_numpy
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

N_ROWS, LIMIT = 1 << 10, 1 << 7
SHARED = ("chain_unsorted", "chain_sorted", "sort_order", "uninit_read_zero", "read_consistency")


def _jax_tamper(w, tamper, row):
    if tamper in ranks.VALUE_TAMPERS:
        value = w.sorted.value.at[row, 0].set(w.sorted.value[row, 0] ^ 1)
        return dataclasses.replace(w, sorted=dataclasses.replace(w.sorted, value=value))
    if tamper == "before_state":
        c = w.chain_sorted
        return dataclasses.replace(w, chain_sorted=jgf.GF(c.lo.at[row, 9].set(c.lo[row, 9] ^ 1),
                                                          c.hi))
    return w


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the port's ranks' residuals, the JAX residuals), by world and case."""
    worlds = ranks.start_worlds(ranks.ram_sharded_rank, (N_ROWS, LIMIT),
                                tmp_path_factory.mktemp("worlds"))
    jcfg = jram.RamPermutationConfig(limit=LIMIT)
    jw = jram.generate_witness_host_tapes(*ranks.ram_tapes(N_ROWS), jcfg)
    want = {}
    for d in ranks.WORLDS:
        mesh = jmesh.make_mesh(n_rows=d, devices=jax.devices()[:d])
        step = jax.jit(lambda w, mesh=mesh: jax_sharded(mesh, w, jcfg))
        for case in ranks.RAM_TAMPERS:
            row = ranks.ram_tamper_row(case, N_ROWS, d)
            w = jax.device_put(_jax_tamper(jw, case, row), NamedSharding(mesh, P()))
            want[d, case] = {k: np.asarray(v) for k, v in step(w).items()}
    return {d: f.result() for d, f in worlds.items()}, want


@pytest.mark.parametrize("case", ranks.RAM_TAMPERS)
@pytest.mark.parametrize("world", ranks.WORLDS)
def test_sharded_check_equals_jax(results, world, case):
    got_by_rank, want = results
    want = want[world, case]
    assert len(got_by_rank[world]) == world
    for got in got_by_rank[world]:
        got = got[case]
        assert sorted(got) == sorted(want)  # a jitted dict comes back in sorted keys
        for key in want:
            assert got[key].shape == (N_ROWS,), key
            assert np.array_equal(got[key], want[key]), key
    failing = {k: np.flatnonzero(~v).tolist() for k, v in want.items() if not v.all()}
    boundary = N_ROWS // world
    assert failing == {"honest": {},
                       "sorted_value": {"read_consistency": [boundary]},
                       "before_state": {"chain_sorted": [boundary - 1, boundary]},
                       "unchecked_value": {}}[case]


@pytest.mark.parametrize("case", ranks.RAM_TAMPERS)
def test_sharded_check_equals_unsharded_eval(results, case):
    """Where the two evaluations check the same relation, the sharded rows
    equal the port's unsharded `eval_constraints`."""
    got_by_rank, _ = results
    w, cfg = ranks.ram_witness(N_ROWS, LIMIT, case, ranks.ram_tamper_row(case, N_ROWS, 4))
    whole = residuals_to_numpy(ram.eval_constraints(w, cfg))
    got = got_by_rank[4][0][case]
    for key in SHARED:
        assert np.array_equal(got[key], whole[key]), key
    if case == "unchecked_value":  # the encodings are the unsharded check's alone
        assert {k: np.flatnonzero(~v).tolist() for k, v in whole.items()
                if not v.all()} == {"encoding_sorted": [0]}
