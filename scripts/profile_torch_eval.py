"""Where the time goes in the torch port's two constraint evaluations, its
prove+verify, its fully proof-backed sorter argument and the block's log path,
on one CUDA card.

    python3 scripts/profile_torch_eval.py [log2_ram_rows] [log2_vm_cycles] [log2_prove_rows]
                                          [log2_sorter_full_rows] [log2_log_path_cycles]
                                          [log2_log_sorter_rows] [log2_memory_thread_cycles]
                                          [log2_blake2s_calls]

A size of 0 skips that part.  For ram_permutation.eval_constraints (default
2^20 rows, chain stride 512), vm.eval_constraints (default 2^16 cycles),
prove_sorter_argument (default 2^16 rows) and prove_sorter_full (default
2^16 rows in instances of 2^12, per-row chains) it prints: the steady wall time of
one evaluation without the profiler (host clock around a synchronize), then
from a torch.profiler window over one evaluation the window's wall time, the
number of device kernels, the device's busy time and share, the launches and
device time of each of the three Poseidon2 kernels (thread-per-state,
small-batch, fused chain) and of all of them, the device time of everything
else, and the ten kernels with the most device time.  For the ram evaluation
it also times the two chain recomputes alone (one call, as the evaluation
makes it), and the witness generation with the native host chains' share of
it.  For the sorter full argument it also times its parts one by one, as
prove_sorter_full runs them (the grand-product prove and verify, each
chain STARK's prove and verify), then the compact-commitment STARKs of the
instances and the recursion leaf check over them.  For the log path
(`runtime.block.log_path` after chip_smoke.py's log-heavy program for 2^16
cycles, instances of 2^12) it
prints each circuit's steady evaluation, one profiled window over all seven
evaluations and one over the linear hasher's alone, and the share of demux's
witness that turning the log rows into tensors takes; for the log sorter
(default 2^18 rows of chip_smoke.py's event tapes in instances of 2^16) the
witness with its native chains' share and a profiled evaluation.  The log
path part also profiles storage application's evaluation on the storage
sorter's survivors (`block.storage_application`).  For the memory thread
(`block.memory_thread` after chip_smoke.py's precompile-heavy program for
2^16 cycles, chip_smoke.MEM_LIMITS) it prints
each circuit's steady evaluation, one profiled window over all of them and
one each over the ecrecover, keccak and sha256 evaluations, then a profiled
eip_4844 evaluation of one 4096-element blob.  For the circuit STARKs (the
keccak AIR over a 4096-element blob's 126,976 bytes, 2^15 rows, and the
blake2s AIR over 2^13 seeded storage-shaped calls, 2^17 rows, by default) it
prints each prove's stages, timed on a second run (the LDE, the Merkle
commitments, the composition of the constraints, the OOD evaluation, the
DEEP codeword, FRI; each ended by a synchronize), the composition's share of
the prove, and a profiled window over one prove.  Every line carries the
card's name and power limit.  Needs a CUDA card.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zkevm_circuits_tpu_torch.base_structures.memory_query import (  # noqa: E402
    encode_memory_queries_np,
)
from zkevm_circuits_tpu_torch.isa import opcodes as isa  # noqa: E402
from zkevm_circuits_tpu_torch.models import ram_permutation as ram, vm  # noqa: E402
from zkevm_circuits_tpu_torch.ops import queues  # noqa: E402
from zkevm_circuits_tpu_torch.prover import pipeline  # noqa: E402
from zkevm_circuits_tpu_torch.prover import poseidon2_air as pa  # noqa: E402
from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp  # noqa: E402
from zkevm_circuits_tpu_torch.runtime import block, native  # noqa: E402
from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np  # noqa: E402


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def wall(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def profile(name, fn, card, reps=3):
    steady = wall(fn, reps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    rows = [(e.key, e.count, e.device_time_total / 1000.0)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.device_time_total > 0]
    busy = sum(r[2] for r in rows)
    kernels = sum(r[1] for r in rows)
    pos = [r for r in rows if "poseidon2" in r[0]]
    pos_ms = sum(r[2] for r in pos)
    by_kernel = "; ".join(
        f"{what} {sum(r[1] for r in pos if mark in r[0])} launches, "
        f"{sum(r[2] for r in pos if mark in r[0]):.2f} ms"
        for what, mark in (("thread-per-state", "permute_kernel"),
                           ("small-batch", "permute_small"), ("fused chain", "chain_segmented")))
    print(f"{name}: steady {1000 * steady:.1f} ms without the profiler; profiled window "
          f"{1000 * window:.1f} ms, {kernels} device kernels, device busy {busy:.1f} ms "
          f"({100 * busy / (1000 * window):.1f} % of the window, {100 * busy / (1000 * steady):.1f}"
          f" % of the steady wall); Poseidon2 kernels {sum(r[1] for r in pos)} launches, "
          f"{pos_ms:.2f} ms ({by_kernel}); every other kernel {busy - pos_ms:.2f} ms "
          f"[{card}]", flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"    {ms:9.2f} ms  {count:7d} x  {key[:100]}", flush=True)
    return steady


def timed(fn):
    """(result, seconds) of one call ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _stage_timers(spent):
    """Wrap the STARK's stages (`prover/stark.py`, `ops/fri.py:prove`) so that
    each call's seconds, ended by a synchronize, add up in `spent`; returns
    the function that takes the wrappers off."""
    import functools

    from zkevm_circuits_tpu_torch.ops import fri
    from zkevm_circuits_tpu_torch.prover import stark

    targets = [(stark, n) for n in ("_lde_rows", "_commit_rows", "_compose_rows",
                                    "_barycentric", "_deep_combine")] + [(fri, "prove")]
    saved = []
    for mod, name in targets:
        f = getattr(mod, name)

        def g(*a, _f=f, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _f(*a, **k)
            torch.cuda.synchronize()
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t0
            return out

        setattr(mod, name, functools.wraps(f)(g))
        saved.append((mod, name, f))

    def restore():
        for mod, name, f in saved:
            setattr(mod, name, f)
    return restore


def circuit_airs(log_calls, card):
    from zkevm_circuits_tpu_torch.prover import blake2s_air, keccak_air

    rng = np.random.default_rng(0xB1AC)
    blob = rng.bytes(4096 * 31)
    calls = [rng.bytes(64 if i % 3 else 40) for i in range(1 << log_calls)]
    for name, run in (("keccak AIR, 126,976 bytes", lambda: keccak_air.prove_keccak256(blob)),
                      (f"blake2s AIR, 2^{log_calls} calls",
                       lambda: blake2s_air.prove_blake2s_batch(calls))):
        profile(f"{name}, one prove", run, card, reps=1)
        spent = {}
        restore = _stage_timers(spent)
        try:
            (_, _, params), seconds = timed(run)
        finally:
            restore()
        staged = sum(spent.values())
        print(f"{name}: 2^{params.log_n} rows, prove {seconds:.3f} s (second run); stages "
              + "; ".join(f"{k} {v:.3f} s" for k, v in spent.items())
              + f"; the rest (trace builders, phase 2, transcript, openings) "
              f"{seconds - staged:.3f} s; the composition of the constraints "
              f"{100 * spent['_compose_rows'] / seconds:.1f} % of the prove [{card}]", flush=True)


def sorter_full(log_rows, card):
    n = 1 << log_rows
    cfg = ram.RamPermutationConfig(limit=min(n, 1 << 12))
    w, witness_s = timed(lambda: ram.generate_witness_host_tapes(*build_tapes_np(n), cfg))
    print(f"sorter full witness 2^{log_rows} rows, per-row chains: {witness_s:.3f} s [{card}]",
          flush=True)

    def prove_and_verify():
        if not pipeline.prove_sorter_full(w)[0]:
            raise RuntimeError("the sorter full proof did not verify")

    steady = profile(f"sorter full prove+verify 2^{log_rows} rows", prove_and_verify, card)

    # its parts one by one, as prove_sorter_full runs them
    (gp, public, gp_params), gp_prove = timed(lambda: pipeline.prove_permutation_argument(w))
    _, gp_verify = timed(lambda: pipeline.verify_permutation_argument(gp, public, gp_params))
    enc_u, enc_s, spec = pipeline._chain_absorbed_encodings(w)
    zeros = np.zeros(4, np.uint64)
    parts = [("grand product prove", gp_prove), ("grand product verify", gp_verify)]
    for side, enc, chain in (("unsorted", enc_u, w.chain_unsorted), ("sorted", enc_s, w.chain_sorted)):
        (proof, publics, params), prove_s = timed(lambda: pa.prove_queue_chain(
            enc[:n], zeros, spec, None, w.execute.device, chain))
        tail = publics.cpu().numpy().view(np.uint64)[4:16]
        _, verify_s = timed(lambda: pa.verify_queue_chain(proof, enc[:n], zeros, tail, spec, params))
        parts += [(f"chain {side} prove", prove_s), (f"chain {side} verify", verify_s)]
    total = sum(s for _, s in parts)
    print("sorter full parts, one by one: " + "; ".join(
        f"{what} {1000 * s:.1f} ms ({100 * s / total:.1f} %)" for what, s in parts)
        + f"; sum {1000 * total:.1f} ms against {1000 * steady:.1f} ms steady [{card}]", flush=True)

    forms = ram.instance_compact_forms(w, cfg)
    k = int(forms.start_flag.shape[0])
    carried, carried_s = timed(lambda: rp.make_carried_proofs(forms))
    types = torch.full((k,), 8, dtype=torch.int64, device=w.execute.device)
    res, leaf_s = timed(lambda: rp.leaf_layer_verify_starks(
        8, types, forms.commitment(), torch.ones(k, dtype=torch.bool, device=types.device),
        carried))
    if not all(bool(v.all()) for v in res.values()):
        raise RuntimeError("the leaf check failed")
    print(f"sorter full: {k} compact-commitment STARKs {carried_s:.3f} s "
          f"({1000 * carried_s / k:.1f} ms each), the leaf check over them {leaf_s:.3f} s "
          f"[{card}]", flush=True)
    enc0 = forms.encode()[0].cpu().numpy().view(np.uint64)

    def one_commitment():
        proof, c, final, params = pipeline.prove_compact_commitment(enc0, device=types.device)
        if not pipeline.verify_compact_commitment(proof, enc0, c, final, params):
            raise RuntimeError("the compact-commitment proof did not verify")

    profile("one compact-commitment prove+verify", one_commitment, card)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile is taken on the card")
    log_ram = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    log_vm = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    log_prove = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    log_sorter = int(sys.argv[4]) if len(sys.argv) > 4 else 16
    log_path_cycles = int(sys.argv[5]) if len(sys.argv) > 5 else 16
    log_sorter_rows = int(sys.argv[6]) if len(sys.argv) > 6 else 18
    log_mem_cycles = int(sys.argv[7]) if len(sys.argv) > 7 else 16
    log_blake_calls = int(sys.argv[8]) if len(sys.argv) > 8 else 13
    card = card_line()
    if log_ram:
        ram_eval(log_ram, card)
    if log_vm:
        vm_eval(log_vm, card)
    if log_prove:
        prove(log_prove, card)
    if log_sorter:
        sorter_full(log_sorter, card)
    if log_path_cycles:
        log_path_eval(log_path_cycles, card)
    if log_sorter_rows:
        log_sorter_eval(log_sorter_rows, card)
    if log_mem_cycles:
        memory_thread_eval(log_mem_cycles, card)
    if log_blake_calls:
        circuit_airs(log_blake_calls, card)


def log_path_eval(log_cycles, card):
    import chip_smoke
    from zkevm_circuits_tpu_torch.base_structures.log_query import LogQueries
    from zkevm_circuits_tpu_torch.models import demux_log_queue as dm
    from zkevm_circuits_tpu_torch.models import linear_hasher as lh
    from zkevm_circuits_tpu_torch.models import log_sorter as ls
    from zkevm_circuits_tpu_torch.models import sort_decommittment_requests as sd
    from zkevm_circuits_tpu_torch.models import storage_application as sa
    from zkevm_circuits_tpu_torch.models import storage_validity as sv

    cycles = 1 << log_cycles
    iterations = chip_smoke.LOG_PATH_ITERATIONS * cycles >> chip_smoke.LOG2_LOG_PATH_CYCLES
    limit = min(cycles, 1 << chip_smoke.LOG2_LOG_LIMIT)
    words, kw = chip_smoke.log_program(iterations)
    v = vm.NativeEraVM(words, cycles, **kw)
    w = v.run()
    out, _, _, _, counts = block.log_path(v, w, (limit, limit), None)
    dw = out["main_vm"][0]
    evals = {
        "main_vm": lambda: vm.eval_constraints(dw, cycles),
        "sort_decommittments": lambda: sd.eval_constraints(
            out["sort_decommittments"][0], sd.DecommitSorterConfig(limit)),
        "demux_log_queue": lambda: dm.eval_constraints(
            out["demux_log_queue"][0],
            dm.DemuxConfig(out["demux_log_queue"][0].execute.shape[0])),
        "storage_validity": lambda: sv.eval_constraints(
            out["storage_validity"][0], sv.StorageValidityConfig(limit)),
        "log_sorter_11": lambda: ls.eval_constraints(out["log_sorter_11"][0], ls.LogSorterConfig(limit)),
        "log_sorter_12": lambda: ls.eval_constraints(out["log_sorter_12"][0], ls.LogSorterConfig(limit)),
        "linear_hasher": lambda: lh.eval_constraints(
            out["linear_hasher"][0],
            lh.LinearHasherConfig(out["linear_hasher"][0].execute.shape[0])),
    }
    steady = {name: wall(fn) for name, fn in evals.items()}
    print(f"log path 2^{log_cycles} cycles {counts}: steady evaluations "
          + "; ".join(f"{name} {1000 * s:.1f} ms" for name, s in steady.items())
          + f"; sum {1000 * sum(steady.values()):.1f} ms [{card}]", flush=True)
    profile(f"log path, the {len(evals)} evaluations", lambda: [fn() for fn in evals.values()], card)
    profile("linear hasher eval", evals["linear_hasher"], card)
    aw, _, _, survivors = block.storage_application(
        out["storage_validity"][0], kw["storage"], None)
    acfg = sa.StorageApplicationConfig(aw.row_execute.shape[0])
    profile(f"storage application eval ({len(survivors)} queries, "
            f"{int(aw.row_execute.sum())} stage rows of {aw.row_execute.shape[0]})",
            lambda: sa.eval_constraints(aw, acfg), card)
    del aw
    logs = [dict(q) for q in v.log_tape]
    tensors, rows_s = timed(lambda: LogQueries.from_lists(logs))
    _, gen_s = timed(lambda: dm.generate_witness(tensors, dm.DemuxConfig(
        out["demux_log_queue"][0].execute.shape[0])))
    print(f"demux witness of {len(logs)} log rows: rows to tensors {rows_s:.3f} s, "
          f"generate_witness (7 native chains in one call) {gen_s:.3f} s [{card}]", flush=True)
    del out, dw
    torch.cuda.empty_cache()


def memory_thread_eval(log_cycles, card):
    import chip_smoke
    from zkevm_circuits_tpu_torch.models import code_unpacker_sha256 as cu
    from zkevm_circuits_tpu_torch.models import ecrecover as ecr
    from zkevm_circuits_tpu_torch.models import eip_4844 as e44
    from zkevm_circuits_tpu_torch.models import keccak256_round_function as kc
    from zkevm_circuits_tpu_torch.models import sha256_round_function as sh
    from zkevm_circuits_tpu_torch.models import sort_decommittment_requests as sd

    cycles = 1 << log_cycles
    iterations = chip_smoke.MEM_ITERATIONS * cycles >> chip_smoke.LOG2_MEM_CYCLES
    limits = tuple(min(cycles, x) for x in chip_smoke.MEM_LIMITS)
    words, kw, _ = chip_smoke.memory_program(iterations)
    v = vm.NativeEraVM(words, cycles, **kw)
    w = v.run()
    out, _, counts = block.memory_thread(v, w, kw["code_store"], limits, None)
    wit = {name: x[0] for name, x in out.items()}
    evals = {
        "main_vm": lambda: vm.eval_constraints(wit["main_vm"], cycles),
        "sort_decommittments": lambda: sd.eval_constraints(
            wit["sort_decommittments"], sd.DecommitSorterConfig(limits[2])),
        "code_unpacker": lambda: cu.eval_constraints(
            wit["code_unpacker"], cu.CodeUnpackerConfig(wit["code_unpacker"].round_execute.shape[0])),
        "keccak256": lambda: kc.eval_constraints(wit["keccak256"], kc.KeccakRoundFunctionConfig(
            wit["keccak256"].block_execute.shape[0], wit["keccak256"].reads.shape[0])),
        "sha256": lambda: sh.eval_constraints(
            wit["sha256"], sh.Sha256RoundFunctionConfig(wit["sha256"].round_execute.shape[0])),
        "ecrecover": lambda: ecr.eval_constraints(
            wit["ecrecover"], ecr.EcrecoverConfig(wit["ecrecover"].call_execute.shape[0])),
        "ram_permutation": lambda: ram.eval_constraints(
            wit["ram_permutation"], ram.RamPermutationConfig(limits[3])),
    }
    steady = {name: wall(fn) for name, fn in evals.items()}
    print(f"memory thread 2^{log_cycles} cycles {counts}: steady evaluations "
          + "; ".join(f"{name} {1000 * s:.1f} ms" for name, s in steady.items())
          + f"; sum {1000 * sum(steady.values()):.1f} ms [{card}]", flush=True)
    profile(f"memory thread, the {len(evals)} evaluations",
            lambda: [fn() for fn in evals.values()], card)
    for name in ("ecrecover", "keccak256", "sha256"):
        profile(f"{name} eval", evals[name], card)
    del out, wit, evals
    torch.cuda.empty_cache()
    cfg = e44.EIP4844Config()
    bw = e44.generate_witness(*chip_smoke.blob_inputs(cfg.elements, 100), cfg)
    profile(f"eip_4844 eval ({cfg.elements} elements)", lambda: e44.eval_constraints(bw, cfg), card)


def log_sorter_eval(log_rows, card):
    import chip_smoke
    from zkevm_circuits_tpu_torch.base_structures.log_query import encode_log_queries_np
    from zkevm_circuits_tpu_torch.models import log_sorter as ls

    tapes = chip_smoke.event_tapes((1 << log_rows) - 1, 18)
    cfg = ls.LogSorterConfig(limit=min(1 << log_rows, 1 << chip_smoke.LOG2_LOG_SORTER_LIMIT))
    w, witness_s = timed(lambda: ls.generate_witness_host_tapes(*tapes, cfg))
    enc = np.stack([encode_log_queries_np(**t) for t in tapes] * 2)[:3]
    t0 = time.perf_counter()
    native.narrow_chains(enc, None, np.zeros((3, 4), np.uint64))
    chains_s = time.perf_counter() - t0
    print(f"log sorter witness 2^{log_rows} rows: {witness_s:.3f} s, of which three native "
          f"narrow chains of the same length {chains_s:.3f} s [{card}]", flush=True)
    profile(f"log sorter eval 2^{log_rows} rows", lambda: ls.eval_constraints(w, cfg), card)
    del w
    torch.cuda.empty_cache()


def ram_eval(log_ram, card):
    n = 1 << log_ram
    cfg = ram.RamPermutationConfig(limit=n, chain_stride=512)
    tapes = build_tapes_np(n)
    t0 = time.perf_counter()
    w = ram.generate_witness_host_tapes(*tapes, cfg)
    torch.cuda.synchronize()
    witness_s = time.perf_counter() - t0
    enc = np.stack([encode_memory_queries_np(**t) for t in tapes])
    ex2 = np.ones((2, n), dtype=np.uint8)
    t0 = time.perf_counter()
    native.full_state_chains_strided(enc, ex2, np.zeros((2, 12), np.uint64), 512)
    chains_s = time.perf_counter() - t0
    print(f"ram witness 2^{log_ram} rows: {witness_s:.3f} s, of which the two native sponge "
          f"chains on the host {chains_s:.3f} s [{card}]", flush=True)
    steady = profile(f"ram eval 2^{log_ram} rows", lambda: ram.eval_constraints(w, cfg), card)
    chains = wall(lambda: queues.check_chains_segmented([
        (w.chain_unsorted, w.enc_unsorted, w.execute),
        (w.chain_sorted, w.enc_sorted, w.execute)]))
    print(f"ram eval 2^{log_ram} rows: the two segmented chain recomputes alone "
          f"{1000 * chains:.1f} ms of {1000 * steady:.1f} ms [{card}]", flush=True)
    del w
    torch.cuda.empty_cache()


def vm_eval(log_vm, card):
    enc = isa.encode_instruction
    loop = [
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=0xFFFF, src1=0, dst0=1),
        enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=1,
            flags=(1 << isa.SET_FLAGS_FLAG_IDX)
            | (1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES)),
        enc(isa.MUL, src0=1, src1=1, dst0=2, dst1=3),
        enc(isa.BINOP, isa.BINOP_XOR, src0=2, src1=1, dst0=4),
        enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=1, condition=isa.COND_NE),
        enc(isa.RET, isa.RET_OK),
    ]
    cycles = 1 << log_vm
    dw = vm.prepare_device_witness(vm.NativeEraVM(vm.assemble_code_words(loop), cycles).run())
    profile(f"main_vm eval 2^{log_vm} cycles", lambda: vm.eval_constraints(dw, cycles), card)
    del dw
    torch.cuda.empty_cache()


def prove(log_prove, card):
    rows = 1 << log_prove
    pw = ram.generate_witness_host_tapes(
        *build_tapes_np(rows), ram.RamPermutationConfig(limit=rows, chain_stride=512))

    def prove_and_verify():
        if not pipeline.prove_sorter_argument(pw)[0]:
            raise RuntimeError("the proof did not verify")

    profile(f"prove+verify 2^{log_prove} rows", prove_and_verify, card)


if __name__ == "__main__":
    main()
