"""Inputs and rank functions of the multi-rank CPU tests
(`tests/test_torch_parallel_*.py`).

The ranks are gloo processes spawned by
`zkevm_circuits_tpu_torch.parallel.mesh.run_world`; they import this module,
torch and the port, never JAX.  Every rank rebuilds its witnesses from the
same seeded inputs, so only small specs cross the process boundary, and
returns numpy arrays.  The test files build the JAX package's side from the
same inputs (`ram_tapes`, the row lists below).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from zkevm_circuits_tpu_torch.base_structures.log_query import LogQueries
from zkevm_circuits_tpu_torch.base_structures.memory_query import MemoryQueries
from zkevm_circuits_tpu_torch.isa import opcodes as isa
from zkevm_circuits_tpu_torch.isa import system_params as sp
from zkevm_circuits_tpu_torch.models import keccak256_round_function as kc
from zkevm_circuits_tpu_torch.models import log_sorter as ls
from zkevm_circuits_tpu_torch.models import ram_permutation as ram
from zkevm_circuits_tpu_torch.models import storage_validity as sv
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.parallel import auto, cases, mesh as meshlib
from zkevm_circuits_tpu_torch.parallel.prover import make_sharded_commit, sharded_commit_columns
from zkevm_circuits_tpu_torch.parallel.sharded import sharded_eval_constraints
from zkevm_circuits_tpu_torch.prover import pipeline, stark
from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints

from torch_test_policy import TIME_LIMIT_S

CPU = torch.device("cpu")
WORLDS = (2, 4)


def start_worlds(fn, args: tuple, init_dir) -> dict:
    """{world size: future of its ranks' results}: a gloo world of each size
    in WORLDS running fn, all at once, each rank on one thread."""
    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {d: pool.submit(meshlib.run_world, fn, d, CPU, args, TIME_LIMIT_S, 1, str(init_dir))
               for d in WORLDS}
    pool.shutdown(wait=False)
    return futures

# ---------------------------------------------------------------------------
# inputs shared with the JAX side
# ---------------------------------------------------------------------------


def ram_tapes(n_rows: int, seed: int = 0x5EED):
    """(unsorted, sorted) numpy tapes: a first cell written once, then cells
    each written and read back once, the pairs in sorted rows (1, 2), (3, 4),
    ..., so that a read opens every even block of rows and reads its
    previous row across a shard boundary."""
    rng = np.random.default_rng(seed)
    cells = 1 + n_rows // 2
    pages = np.sort(rng.integers(16, 1 << 20, size=cells, dtype=np.uint32))
    index = np.arange(cells, dtype=np.uint32) % 512
    values = rng.integers(0, 1 << 32, size=(cells, 8), dtype=np.uint32)
    cell = np.concatenate([[0], np.repeat(np.arange(1, cells), 2)])[:n_rows]
    is_read = np.concatenate([[False], np.tile([False, True], cells)])[:n_rows]
    ts = (np.arange(n_rows, dtype=np.uint32) * 7 + 16)
    sorted_t = dict(timestamp=ts, memory_page=pages[cell], index=index[cell],
                    rw_flag=~is_read, is_ptr=np.zeros(n_rows, bool), value=values[cell])
    perm = rng.permutation(n_rows)
    return {k: v[perm] for k, v in sorted_t.items()}, sorted_t


# the tampers of a ram witness at the boundary of the first two shards, each
# read across it: a sorted value at the first shard's last row (the read
# after it fails) and the chain state before the second shard's first row
# (the first shard's last transition lands on it); and the value of row 0, a
# write that no read follows, which the sharded check does not see (it
# re-derives no encoding: ROADMAP Queue 3)
RAM_TAMPERS = ("honest", "sorted_value", "before_state", "unchecked_value")
VALUE_TAMPERS = ("sorted_value", "unchecked_value")


def ram_tamper_row(case: str, n_rows: int, world: int) -> int:
    if case == "unchecked_value":
        return 0
    return n_rows // world - (case == "sorted_value")


def ram_witness(n_rows: int, limit: int, tamper: str = "honest", row: int = 0):
    unsorted_t, sorted_t = ram_tapes(n_rows)
    cfg = ram.RamPermutationConfig(limit=limit)
    w = ram.generate_witness_host_tapes(unsorted_t, sorted_t, cfg, device=CPU)
    if tamper in VALUE_TAMPERS:
        value = w.sorted.value.clone()
        value[row, 0] ^= 1
        w = dataclasses.replace(w, sorted=dataclasses.replace(w.sorted, value=value))
    elif tamper == "before_state":
        chain = w.chain_sorted.clone()
        chain[row, 9] ^= 1
        w = dataclasses.replace(w, chain_sorted=chain)
    return w, cfg


def log_sorter_rows():
    return [dict(address=1, key=i, read_value=0, written_value=i * 3, aux_byte=1,
                 rw_flag=True, rollback=False, is_service=False, shard_id=0,
                 tx_number_in_block=0, timestamp=10 * (i + 1)) for i in range(16)]


def ram_rows():
    return [dict(timestamp=100 + i, memory_page=7, index=i, rw_flag=True, is_ptr=False,
                 value=1000 + i) for i in range(16)]


def storage_rows():
    cells, rows = {}, []
    for i in range(16):
        addr, key = 0xAA + (i % 3), 5 + (i % 4)
        prev = cells.get((addr, key), 0)
        cells[(addr, key)] = 70 + i
        rows.append(dict(address=addr, key=key, read_value=prev, written_value=70 + i,
                         aux_byte=0, rw_flag=True, rollback=False, is_service=False,
                         shard_id=0, tx_number_in_block=0, timestamp=8 * (i + 2)))
    order = sorted(range(len(rows)), key=lambda i: (rows[i]["address"], rows[i]["key"], i))
    return rows, order


def keccak_inputs():
    memory = {(3, 0): bytes(range(32)), (3, 1): bytes(range(32, 64))}
    calls = [dict(address=sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS,
                  key=(40 << 32) | (5 << 64) | (3 << 128) | (3 << 160),
                  read_value=0, written_value=0, aux_byte=sp.PRECOMPILE_AUX_BYTE,
                  rw_flag=False, rollback=False, is_service=False, shard_id=0,
                  tx_number_in_block=0, timestamp=77)]
    return calls, memory


def vm_program(name: str):
    enc = isa.encode_instruction
    if name == "mul":  # tests/test_auto_sharding.py::test_vm2_auto_sharded
        return [enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=7, src1=0, dst0=1),
                enc(isa.MUL, src0=1, src1=1, dst0=2, dst1=3),
                enc(isa.RET, isa.RET_OK)]
    # tests/test_auto_sharding.py::test_vm_instance_sharded_eval
    return [enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=41, src1=0, dst0=1),
            enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=2),
            enc(isa.BINOP, isa.BINOP_XOR, src0=1, src1=2, dst0=3),
            enc(isa.RET, isa.RET_OK)]


def vm_witness(name: str, cycles: int):
    return vm.prepare_device_witness(
        vm.EraVM(vm.assemble_code_words(vm_program(name)), cycles).run(), device=CPU)


# the circuits of tests/test_auto_sharding.py: name -> (eval_fn, witness, config, rows)
def auto_case(name: str):
    if name == "log_sorter":
        q = LogQueries.from_lists(log_sorter_rows(), CPU)
        cfg = ls.LogSorterConfig(limit=16)
        return ls.eval_constraints, ls.generate_witness_jit(q, q, cfg), cfg, 16
    if name == "ram_permutation":
        q = MemoryQueries.from_lists(ram_rows(), CPU)
        cfg = ram.RamPermutationConfig(limit=16)
        return ram.eval_constraints, ram.generate_witness(q, q, cfg, backend="host"), cfg, 16
    if name == "storage_validity":
        rows, order = storage_rows()
        cfg = sv.StorageValidityConfig(limit=16)
        w = sv.generate_witness(LogQueries.from_lists(rows, CPU),
                                LogQueries.from_lists([rows[i] for i in order], CPU),
                                torch.tensor(order, dtype=torch.int64), cfg)
        return sv.eval_constraints, w, cfg, 16
    if name == "keccak256_round_function":
        calls, memory = keccak_inputs()
        cfg = kc.KeccakRoundFunctionConfig(max_blocks=8, max_reads=16)
        return kc.eval_constraints, kc.generate_witness(calls, memory, cfg, device=CPU), cfg, 8
    if name == "main_vm":
        return vm.eval_constraints, vm_witness("mul", 16), 16, 16
    raise KeyError(name)


AUTO_CIRCUITS = ("log_sorter", "ram_permutation", "storage_validity",
                 "keccak256_round_function", "main_vm")


def tamper_auto(name: str, w, row: int):
    """One changed value of the circuit's witness at run row `row`."""
    if name == "main_vm":
        regs = w["regs"].clone()
        regs[row, 0, 0] ^= 1
        return dict(w, regs=regs)
    if name == "keccak256_round_function":
        execute = w.block_execute.clone()
        execute[row] = ~execute[row]
        return dataclasses.replace(w, block_execute=execute)
    lhs = w.lhs.clone()
    lhs[row, 0] = gf.add(lhs[row, 0], torch.tensor(1))
    return dataclasses.replace(w, lhs=lhs)


def _np(res: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in res.items()}


# ---------------------------------------------------------------------------
# rank functions: fn(rank, world, device, *args)
# ---------------------------------------------------------------------------


def ram_sharded_rank(rank, world, dev, n_rows, limit):
    """The sharded ram check, honest and with each tamper."""
    mesh = meshlib.make_mesh(n_rows=world, device=dev)
    out = {}
    for case in RAM_TAMPERS:
        w, cfg = ram_witness(n_rows, limit, case, ram_tamper_row(case, n_rows, world))
        out[case] = _np(sharded_eval_constraints(mesh, w, cfg))
    return out


def commit_columns(shapes, seed: int = 7) -> list:
    """seeded canonical (m, 2^log_n) column groups, one per (m, log_n)."""
    rng = np.random.default_rng(seed)
    return [gf.from_u64(rng.integers(0, gf.MODULUS, size=(m, 1 << log_n), dtype=np.uint64), CPU)
            for m, log_n in shapes]


def commit_rank(rank, world, dev, shapes):
    """The sharded commit of `commit_columns(shapes)`, and the grand-product
    proof of a 2^8-row ram witness made through it."""
    mesh = meshlib.make_mesh(n_rows=world, device=dev)
    trees = []
    for cols, (_, log_n) in zip(commit_columns(shapes), shapes):
        params = stark.StarkParams(log_n=log_n)
        t = sharded_commit_columns(cols, params, mesh)
        trees.append(dict(cap=gf.to_u64(t["cap"]), leaves=gf.to_u64(t["leaves"]),
                          levels=[gf.to_u64(x) for x in t["levels"]]))
    w, _ = ram_witness(1 << 8, 1 << 5)
    trace, public = pipeline.permutation_trace(w)
    params = stark.StarkParams(log_n=int(trace.shape[1]).bit_length() - 1)
    proof = stark.prove(trace, pipeline.permutation_air(), params, public,
                        commit_fn=make_sharded_commit(mesh))
    ok = pipeline.verify_permutation_argument(proof, public, params)
    return dict(trees=trees, proof=proof_to_ints(proof), verified=bool(ok))


# main_vm in instances: the program and cycles of
# tests/test_auto_sharding.py::test_vm_instance_sharded_eval
VM_INSTANCE_CYCLES = 16


def vm_instances(world: int, dev) -> dict:
    """{n_inst: `vm_eval_instances_sharded` over an (n_inst, world / n_inst)
    mesh, one instance a member of "inst"}."""
    dw = vm_witness("xor", VM_INSTANCE_CYCLES)
    out = {}
    for n_inst in sorted({2, world}):
        mesh = meshlib.make_mesh(n_rows=world // n_inst, n_inst=n_inst, device=dev)
        out[n_inst] = _np(vm.vm_eval_instances_sharded(dw, VM_INSTANCE_CYCLES // n_inst, mesh))
    return out


def _recording(eval_fn, seen):
    """eval_fn, recording the leading size of every tensor of its window."""
    def wrapped(w, config, **kwargs):
        seen.append({k: int(v.shape[0]) for k, v in auto._fields_dict(w).items()
                     if isinstance(v, torch.Tensor) and v.dim()})
        return eval_fn(w, config, **kwargs)

    wrapped.shard_plan = eval_fn.shard_plan
    return wrapped


def auto_rank(rank, world, dev):
    """`auto.eval_sharded` on each circuit, honest and with one changed value
    at the first row of the second member, with the window sizes each eval
    received; and `vm_instances`."""
    mesh = meshlib.make_mesh(n_rows=world, device=dev)
    out = {"instances": vm_instances(world, dev)}
    for name in AUTO_CIRCUITS:
        eval_fn, w, cfg, rows = auto_case(name)
        seen = []
        honest = _np(auto.eval_sharded(_recording(eval_fn, seen), w, cfg, mesh, rows))
        tampered = _np(auto.eval_sharded(eval_fn, tamper_auto(name, w, rows // world), cfg,
                                         mesh, rows))
        out[name] = dict(honest=honest, tampered=tampered, window=seen[0])
    return out


# the eight circuits of `parallel/cases.py`, beside AUTO_CIRCUITS:
# name -> rows (ecrecover: calls, 512 steps each), each made from CASE_SEED
CIRCUIT_ROWS = dict(demux_log_queue=16, sort_decommittment_requests=16, linear_hasher=16,
                    eip_4844=16, storage_application=16, sha256_round_function=16,
                    code_unpacker_sha256=16, ecrecover=2)
CIRCUIT_CASES = tuple(CIRCUIT_ROWS)
CASE_SEED = 11


def circuit_case(name: str):
    return cases.case(name, CIRCUIT_ROWS[name], CASE_SEED, CPU)


def _last_step_before(w, row):
    """w with the accumulator after step row - 1 changed."""
    steps = dict(w.steps, acc_nx=w.steps["acc_nx"].clone())
    steps["acc_nx"][row - 1, 0] ^= 1
    return dataclasses.replace(w, steps=steps)


class Edge(NamedTuple):
    """a case at an edge of a plan: `rows` of `circuit`, run in `worlds`,
    and `change(w, row)`, given the first row of the second member, which
    residual `fails` catches."""
    circuit: str
    rows: int
    change: Callable
    fails: str
    worlds: tuple


EDGE_CASES = dict(
    # 3 calls (1,536 steps) over 4 members: blocks of 384 steps, so the
    # second member starts in the middle of a ladder, where its
    # `step_continuity` reads the previous step from the halo; the change
    # is to that step, the first member's last
    ecrecover_mid_ladder=Edge("ecrecover", 3, _last_step_before, "step_continuity", (4,)),
    # an `n` past the run and a wrong digest: the digest is read at the
    # run's last state, on one member, and fails there
    linear_hasher_n_past_run=Edge(
        "linear_hasher", 16, lambda w, row: dataclasses.replace(w, n=w.n + 1, digest=w.digest ^ 1),
        "digest", WORLDS),
)
EDGE_RUNS = [(world, name) for name, edge in EDGE_CASES.items() for world in edge.worlds]


def edge_case(name: str):
    """(the case, its change) of EDGE_CASES[name]."""
    edge = EDGE_CASES[name]
    return cases.case(edge.circuit, edge.rows, CASE_SEED, CPU), edge.change


def leaf_sizes(w) -> dict:
    """{field path: leading size} of every tensor leaf of a witness."""
    out = {}
    for name, value in auto._fields(w):
        if isinstance(value, torch.Tensor):
            if value.dim():
                out[name] = int(value.shape[0])
        elif isinstance(value, dict) or dataclasses.is_dataclass(value):
            out.update({f"{name}.{k}": v for k, v in leaf_sizes(value).items()})
    return out


def _recording_leaves(eval_fn, seen):
    """eval_fn, recording the leading size of every leaf of its window."""
    def wrapped(w, config, **kwargs):
        seen.append(leaf_sizes(w))
        return eval_fn(w, config, **kwargs)

    wrapped.shard_plan = eval_fn.shard_plan
    return wrapped


def circuits_rank(rank, world, dev):
    """`auto.eval_sharded` on each of the eight circuits, honest and with
    one changed value at the first row of the second member, with the
    window sizes each eval received; and on the EDGE_CASES of this world,
    honest and changed."""
    mesh = meshlib.make_mesh(n_rows=world, device=dev)
    out = {}
    for name in CIRCUIT_CASES:
        c = circuit_case(name)
        seen = []
        honest = _np(auto.eval_sharded(_recording_leaves(c.eval_fn, seen), c.witness, c.config,
                                       mesh, c.rows))
        tampered = _np(auto.eval_sharded(c.eval_fn, cases.tamper(name, c.witness, c.rows // world),
                                         c.config, mesh, c.rows))
        out[name] = dict(honest=honest, tampered=tampered, window=seen[0])
    for name in (name for d, name in EDGE_RUNS if d == world):
        c, change = edge_case(name)
        out[name] = {which: _np(auto.eval_sharded(c.eval_fn, w, c.config, mesh, c.rows))
                     for which, w in (("honest", c.witness),
                                      ("tampered", change(c.witness, -(-c.rows // world))))}
    return out


def failing_rank(rank, world, dev):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def sleeping_rank(rank, world, dev):
    import time

    time.sleep(120)
    return rank
