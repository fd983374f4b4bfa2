"""The multi-device layer against the JAX package's own sharded functions,
which take minutes of XLA:CPU compiles each (`slow`):

    python -m pytest tests/test_torch_parallel_slow.py -m slow

Gloo worlds of 2 and 4 ranks (`torch_parallel_ranks`) against sub-meshes of
the JAX package's 8-device virtual mesh, on the same inputs:
  * `sharded_commit_columns`: cap, leaves and levels as u64;
  * `auto.eval_sharded` on the five circuits of tests/test_auto_sharding.py
    and on the eight of `parallel/cases.py`, honest and tampered, and on
    `torch_parallel_ranks.EDGE_CASES` (the JAX side evaluates the port's
    seeded witness, turned into the JAX package's witness), the residuals
    as exact bools, key for key;
  * `vm_eval_instances_sharded` on that file's program.
The tier-1 files (test_torch_parallel_{sharded,commit,auto}.py) hold the
same results to the JAX sharded ram check and to the port's single-device
functions.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zkevm_circuits_tpu.base_structures.decommit_query import DecommitQueries as JDecommitQueries
from zkevm_circuits_tpu.base_structures.log_query import LogQueries as JLogQueries
from zkevm_circuits_tpu.base_structures.memory_query import MemoryQueries as JMemoryQueries
from zkevm_circuits_tpu.models import keccak256_round_function as jkc
from zkevm_circuits_tpu.models import log_sorter as jls
from zkevm_circuits_tpu.models import ram_permutation as jram
from zkevm_circuits_tpu.models import storage_validity as jsv
from zkevm_circuits_tpu.models import vm as jvm
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.parallel import auto as jauto, mesh as jmesh
from zkevm_circuits_tpu.parallel.prover import sharded_commit_columns as jax_commit
from zkevm_circuits_tpu.prover import stark as jstark

import torch_parallel_ranks as ranks
from torch_log_helpers import FIELDS
from torch_precompile_helpers import to_jax
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.parallel import cases
from zkevm_circuits_tpu_torch.utils.convert import witness_to_numpy
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

pytestmark = pytest.mark.slow

SHAPES = ((8, 8), (5, 9))


def _jmesh(d, n_inst=1):
    return jmesh.make_mesh(n_rows=d // n_inst, n_inst=n_inst, devices=jax.devices()[:d])


def _jax_auto_case(name):
    """(eval_fn, witness, config, rows) of tests/test_auto_sharding.py."""
    if name == "log_sorter":
        q = JLogQueries.from_lists(ranks.log_sorter_rows())
        cfg = jls.LogSorterConfig(limit=16)
        return jls.eval_constraints, jls.generate_witness_jit(q, q, cfg), cfg, 16
    if name == "ram_permutation":
        q = JMemoryQueries.from_lists(ranks.ram_rows())
        cfg = jram.RamPermutationConfig(limit=16)
        return jram.eval_constraints, jram.generate_witness(q, q, cfg), cfg, 16
    if name == "storage_validity":
        rows, order = ranks.storage_rows()
        cfg = jsv.StorageValidityConfig(limit=16)
        w = jsv.generate_witness_jit(JLogQueries.from_lists(rows),
                                     JLogQueries.from_lists([rows[i] for i in order]),
                                     jnp.asarray(order, jnp.uint32), cfg)
        return jsv.eval_constraints, w, cfg, 16
    if name == "keccak256_round_function":
        calls, memory = ranks.keccak_inputs()
        cfg = jkc.KeccakRoundFunctionConfig(max_blocks=8, max_reads=16)
        return jkc.eval_constraints, jkc.generate_witness(calls, memory, cfg), cfg, 8
    prog = ranks.vm_program("mul")
    dw = jvm.prepare_device_witness(jvm.EraVM(jvm.assemble_code_words(prog), 16).run())
    return jvm.eval_constraints, dw, 16, 16


# the eight circuits of `parallel/cases.py`: name -> (JAX witness class,
# config class, the witness's field-element fields, its query batches)
_PRECOMPILE = dict(calls=JLogQueries, reads=JMemoryQueries, writes=JMemoryQueries)
_CIRCUITS = dict(
    demux_log_queue=("DemuxWitness", "DemuxConfig", FIELDS["demux"],
                     dict(queries=JLogQueries)),
    sort_decommittment_requests=(
        "DecommitSorterWitness", "DecommitSorterConfig", FIELDS["decommit"],
        dict(unsorted=JDecommitQueries, sorted=JDecommitQueries, result_items=JDecommitQueries)),
    linear_hasher=("LinearHasherWitness", "LinearHasherConfig", FIELDS["hasher"],
                   dict(queries=JLogQueries)),
    eip_4844=("EIP4844Witness", "EIP4844Config", (), {}),
    storage_application=("StorageApplicationWitness", "StorageApplicationConfig",
                         ("query_chain",), dict(queries=JLogQueries)),
    sha256_round_function=("Sha256RoundWitness", "Sha256RoundFunctionConfig",
                           ("call_chain", "mem_chain", "mem_order_encodings"), _PRECOMPILE),
    code_unpacker_sha256=("CodeUnpackerWitness", "CodeUnpackerConfig",
                          ("request_chain", "mem_chain"),
                          dict(requests=JDecommitQueries, writes=JMemoryQueries)),
    ecrecover=("EcrecoverWitness", "EcrecoverConfig", ("call_chain", "mem_chain"), _PRECOMPILE),
)


def _jax_circuit(name, c, w):
    """(eval_fn, witness, config, rows) of the JAX package on the port's
    witness `w` of circuit `name`, for the case `c` of `parallel/cases.py`."""
    witness_cls, config_cls, fields, queries = _CIRCUITS[name]
    module = importlib.import_module(f"zkevm_circuits_tpu.models.{name}")
    jw = to_jax(getattr(module, witness_cls), witness_to_numpy(w, fields), fields, queries)
    jcfg = getattr(module, config_cls)(**dataclasses.asdict(c.config))
    return module.eval_constraints, jw, jcfg, c.rows


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], np.asarray(want[key])), key


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    commit = ranks.start_worlds(ranks.commit_rank, (SHAPES,), tmp_path_factory.mktemp("commit"))
    auto_ = ranks.start_worlds(ranks.auto_rank, (), tmp_path_factory.mktemp("auto"))
    return ({d: f.result() for d, f in commit.items()},
            {d: f.result() for d, f in auto_.items()})


@pytest.mark.parametrize("world", ranks.WORLDS)
def test_sharded_commit_equals_jax(worlds, world):
    cols = ranks.commit_columns(SHAPES)
    for j, (c, (_, log_n)) in enumerate(zip(cols, SHAPES)):
        want = jax_commit(jgf.from_u64(gf.to_u64(c)), jstark.StarkParams(log_n=log_n),
                          _jmesh(world))
        for out in worlds[0][world]:
            got = out["trees"][j]
            assert np.array_equal(got["cap"], np.asarray(want["cap"].astype_u64()))
            assert np.array_equal(got["leaves"], np.asarray(want["leaves"].astype_u64()))
            assert len(got["levels"]) == len(want["levels"])
            for a, b in zip(got["levels"], want["levels"]):
                assert np.array_equal(a, np.asarray(b.astype_u64()))


@pytest.mark.parametrize("name", ranks.AUTO_CIRCUITS)
@pytest.mark.parametrize("world", ranks.WORLDS)
def test_eval_sharded_equals_jax(worlds, world, name):
    eval_fn, w, cfg, rows = _jax_auto_case(name)
    want = jauto.eval_sharded(eval_fn, w, cfg, _jmesh(world), rows)
    for out in worlds[1][world]:
        _equal(out[name]["honest"], want)


@pytest.fixture(scope="module")
def circuit_worlds(tmp_path_factory):
    worlds = ranks.start_worlds(ranks.circuits_rank, (), tmp_path_factory.mktemp("circuits"))
    return {d: f.result() for d, f in worlds.items()}


def _jax_equal(outs, name, which, want):
    for out in outs:
        got = out[name][which]
        _equal(got, want)
        for key in want:
            assert got[key].dtype == np.asarray(want[key]).dtype == np.bool_, key


@pytest.mark.parametrize("name", ranks.CIRCUIT_CASES)
@pytest.mark.parametrize("world", ranks.WORLDS)
def test_circuit_eval_sharded_equals_jax(circuit_worlds, world, name):
    c = ranks.circuit_case(name)
    for which, w in (("honest", c.witness),
                     ("tampered", cases.tamper(name, c.witness, c.rows // world))):
        eval_fn, jw, cfg, rows = _jax_circuit(name, c, w)
        want = jauto.eval_sharded(eval_fn, jw, cfg, _jmesh(world), rows)
        _jax_equal(circuit_worlds[world], name, which, want)


@pytest.mark.parametrize("world,name", ranks.EDGE_RUNS)
def test_circuit_eval_sharded_equals_jax_at_a_plan_edge(circuit_worlds, world, name):
    c, change = ranks.edge_case(name)
    circuit = ranks.EDGE_CASES[name].circuit
    for which, w in (("honest", c.witness), ("tampered", change(c.witness, -(-c.rows // world)))):
        eval_fn, jw, cfg, rows = _jax_circuit(circuit, c, w)
        want = jauto.eval_sharded(eval_fn, jw, cfg, _jmesh(world), rows)
        _jax_equal(circuit_worlds[world], name, which, want)


@pytest.mark.parametrize("world", ranks.WORLDS)
def test_vm_instances_equal_jax(worlds, world):
    prog = ranks.vm_program("xor")
    cycles = ranks.VM_INSTANCE_CYCLES
    dw = jvm.prepare_device_witness(jvm.EraVM(jvm.assemble_code_words(prog), cycles).run())
    for n_inst in sorted({2, world}):
        want = jvm.vm_eval_instances_sharded(dw, cycles // n_inst, _jmesh(world, n_inst))
        for out in worlds[1][world]:
            _equal(out["instances"][n_inst], want)
