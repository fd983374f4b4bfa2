"""Row-sharded evaluation by shard plan (`parallel/auto.py`) of the eight
circuits beyond tests/test_auto_sharding.py's five, in gloo worlds of 2 and
4 ranks: the log-queue demultiplexer, the decommit sorter, the linear
hasher, eip_4844, storage application, the sha256 precompile, the code
unpacker and ecrecover, on seeded inputs of `parallel/cases.py` (16 rows,
rounds or elements; two ecrecover calls).

Every rank's `auto.eval_sharded` equals the port's unsharded
`eval_constraints` key for key and bit for bit, honest (all true) and with
one value changed at the first row of the second member (caught); also
where a member starts in the middle of an ecrecover ladder (a change to
the step before it caught by `step_continuity` through the halo) and
where the hasher's `n` lies past the run (a wrong digest caught)
(`torch_parallel_ranks.EDGE_CASES`); each
rank's evaluation received its block of every row axis plus the plan's
halo (k entries a row where the plan says so, the extra entries on the
last member) and every other field whole.  Every circuit module of the
port that defines `eval_constraints` carries a shard plan.  The port's
unsharded evaluations are held to the JAX package's in
tests/test_torch_demux.py, test_torch_decommit_sorter.py,
test_torch_log_path.py, test_torch_eip_4844.py,
test_torch_storage_application.py, test_torch_sha256_circuits.py and
test_torch_ecrecover.py; the JAX package's own `auto.eval_sharded` on
these inputs is compared in tests/test_torch_parallel_slow.py.  Each world
is started once for the file and joined within
the time limit of the test that waits on it (tests/torch_test_policy.py).
"""

import importlib
import pkgutil

import numpy as np
import pytest

import torch_parallel_ranks as ranks
import zkevm_circuits_tpu_torch.models as models
from zkevm_circuits_tpu_torch.parallel import auto, cases
from zkevm_circuits_tpu_torch.utils.convert import residuals_to_numpy
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    worlds = ranks.start_worlds(ranks.circuits_rank, (), tmp_path_factory.mktemp("worlds"))
    return {d: f.result() for d, f in worlds.items()}


@pytest.fixture(scope="module")
def unsharded():
    """{name: (case, honest residuals, {world: tampered residuals})}"""
    out = {}
    for name in ranks.CIRCUIT_CASES:
        c = ranks.circuit_case(name)
        out[name] = (c, residuals_to_numpy(c.eval_fn(c.witness, c.config)),
                     {d: residuals_to_numpy(c.eval_fn(cases.tamper(name, c.witness, c.rows // d),
                                                      c.config))
                      for d in ranks.WORLDS})
    return out


def _equal(got: dict, want: dict):
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("name", ranks.CIRCUIT_CASES)
@pytest.mark.parametrize("world", ranks.WORLDS)
def test_eval_sharded_equals_unsharded(ranks_out, unsharded, world, name):
    _, honest, tampered = unsharded[name]
    assert all(v.all() for v in honest.values())
    assert not all(v.all() for v in tampered[world].values())
    assert len(ranks_out[world]) == world
    for out in ranks_out[world]:
        _equal(out[name]["honest"], honest)
        _equal(out[name]["tampered"], tampered[world])


@pytest.mark.parametrize("world,name", ranks.EDGE_RUNS)
def test_eval_sharded_equals_unsharded_at_a_plan_edge(ranks_out, world, name):
    c, change = ranks.edge_case(name)
    changed = change(c.witness, -(-c.rows // world))
    for which, w in (("honest", c.witness), ("tampered", changed)):
        want = residuals_to_numpy(c.eval_fn(w, c.config))
        if which == "honest":
            assert all(v.all() for v in want.values())
        else:
            assert not want[ranks.EDGE_CASES[name].fails].all()
        for out in ranks_out[world]:
            _equal(out[name][which], want)


def _window_rows(n: int, halo, world: int, r: int) -> int:
    """the window rows of rank r: its block of ceil(n / world) rows (the
    last rank's the rest) and the halo rows inside the run."""
    block = -(-n // world)
    mine = block if r < world - 1 else n - (world - 1) * block
    return (halo[0] if r > 0 else 0) + mine + (halo[1] if r < world - 1 else 0)


@pytest.mark.parametrize("name", ranks.CIRCUIT_CASES)
@pytest.mark.parametrize("world", ranks.WORLDS)
def test_each_rank_received_its_block_and_the_halo(ranks_out, unsharded, world, name):
    c = unsharded[name][0]
    plan = auto.plan_of(c.eval_fn)
    full = ranks.leaf_sizes(c.witness)
    main = auto._row_fields(c.witness, plan, c.rows)
    axis_of = {f: ax for ax in plan.axes.values() for f in ax.fields}
    assert main, "no field is on the row axis"
    for r, out in enumerate(ranks_out[world]):
        want = {}
        for path, size in full.items():
            field = path.split(".")[0]
            if field in main:
                k = plan.entries.get(field, 1)
                want[path] = _window_rows(c.rows, plan.halo, world, r) * k + size - k * c.rows
            elif field in axis_of:
                ax = axis_of[field]
                n = full[ax.rows_of]
                want[path] = _window_rows(n, ax.halo, world, r) + size - n
            else:
                want[path] = size
        assert out[name]["window"] == want


def test_every_circuit_of_the_port_carries_a_shard_plan():
    found = {}
    for info in pkgutil.walk_packages(models.__path__, models.__name__ + "."):
        module = importlib.import_module(info.name)
        fn = getattr(module, "eval_constraints", None)
        if fn is not None and fn.__module__ == module.__name__:
            found[info.name] = fn
    assert len(found) == 13, sorted(found)
    for name, fn in found.items():
        assert auto.plan_of(fn) is not None, name
