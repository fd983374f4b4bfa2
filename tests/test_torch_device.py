"""The port's device rule: an entry point that builds tensors from host data
runs on the card unless the caller names the CPU, and raises when it is
given no device and there is no card.  `torch.cuda.is_available` is patched
to False, so the tests hold on a machine with a card too.
"""

import numpy as np
import pytest
import torch

from torch_vm_programs import PROGRAMS, run_vm
from zkevm_circuits_tpu_torch.base_structures.decommit_query import DecommitQueries
from zkevm_circuits_tpu_torch.base_structures.log_query import LogQueries
from zkevm_circuits_tpu_torch.base_structures.memory_query import MemoryQueries
from zkevm_circuits_tpu_torch.models import ram_permutation as ram, vm
from zkevm_circuits_tpu_torch.ops import fri, gf, poseidon2, queues
from zkevm_circuits_tpu_torch.utils import convert, device
from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _ram_fields(w):
    q = lambda m: {k: getattr(m, k).numpy() for k in
                   ("timestamp", "memory_page", "index", "rw_flag", "is_ptr", "value")}
    out = {k: getattr(w, k).numpy().view(np.uint64) for k in
           ("enc_unsorted", "enc_sorted", "chain_unsorted", "chain_sorted", "challenges",
            "lhs", "rhs")}
    out.update(n=w.n, snapshot_length=w.snapshot_length, execute=w.execute.numpy(),
               nondet_count=w.nondet_count.numpy(), unsorted=q(w.unsorted), sorted=q(w.sorted))
    return out


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device(None)
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_default_device_is_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.default_device() == torch.device("cuda", 0)


def test_entry_points_raise_without_a_device_or_a_card(no_card):
    tapes = build_tapes_np(16)
    cfg = ram.RamPermutationConfig(limit=16)
    w = ram.generate_witness_host_tapes(*tapes, cfg, device="cpu")
    _, vm_w = run_vm(vm.NativeEraVM, PROGRAMS["conditional_jump_loop"])
    calls = [
        lambda: ram.generate_witness_host_tapes(*tapes, cfg),
        lambda: MemoryQueries.from_numpy(tapes[0]),
        lambda: MemoryQueries.zeros((2,)),
        lambda: MemoryQueries.from_lists([]),
        lambda: LogQueries.zeros((2,)),
        lambda: LogQueries.from_lists([dict(key=1)]),
        lambda: DecommitQueries.zeros((2,)),
        lambda: DecommitQueries.from_lists([dict(code_hash=1, page=2, timestamp=3)]),
        lambda: convert.witness_from_numpy(_ram_fields(w)),
        lambda: vm.prepare_device_witness(vm_w),
        lambda: convert.vm_witness_from_numpy(vm_w),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the same calls run when the CPU is named
    assert convert.witness_from_numpy(_ram_fields(w), device="cpu").lhs.device.type == "cpu"
    assert vm.prepare_device_witness(vm_w, device=torch.device("cpu"))["regs"].device.type == "cpu"


def test_state_constructors_raise_without_a_device_or_a_card(no_card):
    for call in (fri.Transcript, lambda: queues.empty_queue_state(12, (3,)),
                 lambda: poseidon2.empty_state((2,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    tr = fri.Transcript("cpu")
    tr.absorb(gf.ones((3,), "cpu"))
    assert tr.challenge_ext().c0.device.type == "cpu"
    q = queues.empty_queue_state(4, (2,), device="cpu")
    assert q.head.device.type == q.tail.device.type == q.length.device.type == "cpu"
    assert q.head.shape == (2, 4) and q.length.shape == (2,)
    assert poseidon2.empty_state((2,), torch.device("cpu")).shape == (2, 12)


def test_raw_field_constructors_keep_torchs_default_device(no_card):
    for x in (gf.zeros((2,)), gf.ones((2,)), gf.constant(5), gf.from_u64([1, 2]),
              gf.geometric(7, 4)):
        assert x.device.type == "cpu" and x.dtype == torch.int64


def test_generate_witness_follows_its_inputs(no_card):
    rows = [dict(timestamp=5 + i, memory_page=7, index=i, rw_flag=True, is_ptr=False, value=i)
            for i in range(3)]
    q = MemoryQueries.from_lists(rows, "cpu")
    w = ram.generate_witness(q, q, ram.RamPermutationConfig(limit=4), backend="host")
    assert w.lhs.device.type == "cpu" and w.n == 3
    with pytest.raises(ValueError):
        ram.generate_witness(q, q, ram.RamPermutationConfig(limit=4), backend="tpu")


def test_memory_thread_and_storage_entry_points_raise_without_a_device_or_a_card(no_card):
    """the witnesses of types 3, 5, 6, 7, 10 and eip_4844, and the hash ops'
    state constructors, follow the same rule"""
    from zkevm_circuits_tpu_torch.models import (
        code_unpacker_sha256 as cu, ecrecover as ecr, eip_4844 as e44,
        keccak256_round_function as kc, sha256_round_function as sh, storage_application as sa,
    )
    from zkevm_circuits_tpu_torch.ops import blake2s, sha256

    calls = [
        lambda: sh.generate_witness([], {}, sh.Sha256RoundFunctionConfig(2)),
        lambda: cu.generate_witness([], {}, cu.CodeUnpackerConfig(2)),
        lambda: kc.generate_witness([], {}, kc.KeccakRoundFunctionConfig(2, 2)),
        lambda: ecr.generate_witness([], {}, ecr.EcrecoverConfig(1)),
        lambda: sa.generate_witness([], sa.SparseStorageTree(), 1, sa.StorageApplicationConfig(2)),
        lambda: e44.generate_witness([], bytes(32), e44.EIP4844Config(2)),
        lambda: sha256.initial_state((2,)),
        lambda: blake2s.initial_state((2,)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    w = sh.generate_witness([], {}, sh.Sha256RoundFunctionConfig(2), device="cpu")
    assert w.mem_chain.device.type == w.round_execute.device.type == "cpu"
    assert sha256.initial_state((2,), device="cpu").shape == (2, 8)


def test_circuit_air_entry_points_raise_without_a_device_or_a_card(no_card):
    """the six circuit AIRs' trace builders and provers, which take host data,
    follow the same rule; their verifiers follow the proof"""
    from zkevm_circuits_tpu_torch.prover import (blake2s_air, demux_air, ecrecover_air,
                                                 horner_air, keccak_air, sha256_air)

    calls = [
        lambda: demux_air.demux_trace([]),
        lambda: demux_air.prove_demux([]),
        lambda: horner_air.fixed_cols(256, 1),
        lambda: sha256_air.build_sha256_trace(b"abc"),
        lambda: sha256_air.prove_sha256_blocks(np.zeros((1, 16), np.uint64)),
        lambda: keccak_air.build_keccak_trace(b"abc"),
        lambda: keccak_air.prove_keccak256(b""),
        lambda: blake2s_air.build_blake2s_trace([b"abc"]),
        lambda: ecrecover_air.fixed_cols(512),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    phase1, fixed, _, _, log_n = keccak_air.build_keccak_trace(b"abc", device="cpu")
    assert phase1.device.type == fixed.device.type == "cpu" and log_n == 5


def test_vm_and_verifier_air_entry_points_raise_without_a_device_or_a_card(no_card):
    """main_vm's trace builder, prover, debug residuals and type-1 writer,
    and the verifier AIR's fixed columns and trace, take host data and follow
    the same rule; the node proof follows its children, the verifiers the
    proof"""
    from zkevm_circuits_tpu_torch.prover import verifier_air as va
    from zkevm_circuits_tpu_torch.prover import vm_air
    from zkevm_circuits_tpu_torch.runtime import block

    v, w = run_vm(vm.EraVM, PROGRAMS["arith_families"])
    limit = PROGRAMS["arith_families"]["limit"]
    p = fri.FriParams(log_domain=5, log_blowup=2, num_queries=2, cap_log2=1)
    sched = va.build_schedule((p,))
    calls = [
        lambda: vm_air.fixed_tables(1 << 11),
        lambda: vm_air.vm_core_trace(w, limit),
        lambda: vm_air.prove_vm_core(w, limit),
        lambda: vm_air.debug_residuals(w, limit),
        lambda: block.vm_verdict(v, w, limit, None),
        lambda: va.fixed_columns(sched),
        lambda: va.build_verifier_trace([], (p,)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    phase1, fixed, log_n = vm_air.vm_core_trace(w, limit, device="cpu")
    assert phase1.device.type == fixed.device.type == "cpu" and log_n == 11
    assert va.fixed_columns(sched, "cpu").device.type == "cpu"


def test_block_and_chain_pick_the_card_and_raise_without_one(no_card, monkeypatch):
    """execute_block2, execute_block2_from_run and execute_chain raise before
    any work without a device or a card, and hand the circuits cuda:0 when
    there is one; run_scheduler with no compact forms follows the same rule"""
    from zkevm_circuits_tpu_torch.models import scheduler
    from zkevm_circuits_tpu_torch.runtime import block2, chain

    code = vm.assemble_code_words(PROGRAMS["arith_families"]["prog"])
    calls = [
        lambda: block2.execute_block2(code),
        lambda: block2.execute_block2_from_run(None, None, code),
        lambda: chain.execute_chain([{"code": code}]),
        lambda: scheduler.run_scheduler({}, {}, {}, (1, 2, 3, 4), b"\x00" * 32,
                                        scheduler.BlockPassthroughData(),
                                        scheduler.BlockMetaParameters(),
                                        scheduler.BlockAuxilaryOutput()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

    class Picked(Exception):
        pass

    def picked(*args, device=None, **kw):
        raise Picked(device)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(block2, "execute_block2_from_run", picked)
    monkeypatch.setattr(chain, "execute_block2", picked)
    for call in calls[:1] + calls[2:3]:
        with pytest.raises(Picked) as got:
            call()
        assert got.value.args[0] == torch.device("cuda", 0)


def test_multi_device_entry_points_raise_without_a_card(no_card, tmp_path):
    """The mesh, the world and the dry run pick the card by default and raise
    without one; a world of more ranks than cards raises; nothing gives way
    to gloo."""
    import torch_parallel_ranks as ranks
    from zkevm_circuits_tpu_torch import entry
    from zkevm_circuits_tpu_torch.parallel import mesh as meshlib

    rendezvous = str(tmp_path / "rendezvous")
    for call in (lambda: meshlib.make_mesh(), lambda: meshlib.init_world(0, 1, None, rendezvous),
                 lambda: meshlib.run_world(ranks.failing_rank, 1),
                 lambda: entry.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in (lambda: meshlib.init_world(0, 2, "cuda", rendezvous),
                 lambda: meshlib.run_world(ranks.failing_rank, 2, "cuda")):
        with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA cards"):
            call()


def test_a_cpu_mesh_is_a_gloo_mesh(tmp_path):
    import torch.distributed as dist

    from zkevm_circuits_tpu_torch.parallel import mesh as meshlib

    dev = meshlib.init_world(0, 1, "cpu", str(tmp_path / "rendezvous"))
    try:
        mesh = meshlib.make_mesh(device="cpu")
        assert dev == torch.device("cpu") and mesh.device == dev
        assert mesh.shape == {"inst": 1, "rows": 1}
        assert dist.get_backend() == "gloo"
        assert dist.get_backend(mesh.group("rows")) == dist.get_backend(mesh.group("inst")) == "gloo"
        with pytest.raises(RuntimeError, match="a cuda mesh needs a nccl world, not gloo"):
            meshlib.make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def test_a_failing_or_overrunning_rank_raises(tmp_path):
    """A rank's error comes back with its traceback; a rank that has not
    finished by the deadline is stopped and the world raises."""
    import time

    import torch_parallel_ranks as ranks
    from zkevm_circuits_tpu_torch.parallel import mesh as meshlib

    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*ValueError: rank 1 fails"):
        meshlib.run_world(ranks.failing_rank, 2, "cpu", deadline_s=60, threads=1,
                          init_dir=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0\] did not finish within 10 s"):
        meshlib.run_world(ranks.sleeping_rank, 1, "cpu", deadline_s=10, threads=1,
                          init_dir=str(tmp_path))
    assert time.monotonic() - t0 < 30
