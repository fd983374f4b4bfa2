"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. device: the card's name and power limit (nvidia-smi), then the build of
     the three CUDA Poseidon2 kernels (csrc/poseidon2.cu with
     csrc/poseidon2_coop.cuh) with the registers and spills ptxas reports for
     each and the build time;
  2. kernel parity: the thread-per-state kernel against the plain torch
     permutation on the card, bit for bit, on 2^16 random canonical states
     plus edge states and at the paths' batch sizes (2^18 leaf states, 2^17
     first tree level, 2^16 main_vm sponge states, 2^11 states), and against
     the native C++ permutation on 1,024 states; the lane-parallel small-batch
     kernel against both at 1, 5, 2,048 and SMALL_BATCH - 1 states plus the
     edge states; the kernels' and the plain version's times (CUDA events)
     beside their bounds;
  3. small-input reference: the ram_permutation proof at 2^8 rows made on
     the card must equal, as nested ints, the one made on the CPU;
  4. main path: the ram_permutation witness from build_tapes_np(2^16) and
     prove_sorter_argument twice, on the card; the kernel's launch count over
     this phase must be above 0; first and steady prove+verify seconds and
     rows/s;
  5. negative probe: a changed public final product must fail verification;
  6. ram eval, small: at 2^10 rows in two instances, the residuals and the
     instance compact forms computed on the card equal those computed on the
     CPU, key by key;
  7. ram eval, full width: a 2^20-row witness; on its chains the fused
     segmented-chain kernel against the step loop, bit for bit, at (64 x 16)
     with the plain permutation inside (there also against the port's own
     plain version on the CPU) and at (2,048 x 512), all rows executed
     and a tenth of them not, with the thread-per-state kernel inside, and its
     times at (2,048 x 512) and (4,096 x 512); the chain kernel as a sponge at
     the circuit STARKs' shapes (a transcript over 2 x 7,493 values, 2^7
     leaves of 7,493 columns, 2^13 of 279) against the absorb loop on the
     card, bit for bit, and both times; `eval_constraints` on the card
     (first run, then the mean of 3), all-true; witness seconds, rows/s,
     launches per evaluation of each kernel (the chain kernel above 0 and at
     most 2, the thread-per-state kernel not once a chain step), peak device
     memory; one changed limb of sorted.value must fail `encoding_sorted` at
     its row and nothing else; one changed lane of one inner row of enc_sorted
     must fail `check_chain_segmented` in that row's segment and in no other;
  8. main_vm, small: a 3-instruction program at limit 8, card residuals equal
     CPU residuals key by key;
  9. main_vm, full width: the benchmark loop (16,383 rounds, returning at
     cycle 65,534) through the native EraVM for 2^16 cycles and `vm.eval_constraints` on the card, all-true; host sim seconds,
     first and steady eval seconds, cycles/s, kernel launches per evaluation
     (above 0), peak device memory; one changed register limb must fail;
 10. sorter full, small: at 2^4 rows in two instances the fully proof-backed
     sorter argument (grand product and both sponge-chain STARKs), the
     instances' compact-commitment STARKs and a logUp proof over a 2^8-row
     range table, made on the card, equal those made on the CPU as nested ints;
 11. sorter full, full width: the ram_permutation witness from
     build_tapes_np(2^16) with per-row chains in 16 instances of 2^12 rows;
     prove_sorter_full once (prove+verify seconds, peak device memory; cut
     3 below), the 16 compact-commitment STARKs (make_carried_proofs, the
     sorter argument riding on the first) and the recursion leaf check of
     circuit type 8 against the queued commitments, all true; each kernel's
     launches over the path (the thread-per-state and the small-batch kernel
     above 0); negative probes: a changed tail fails verify_sorter_full, a
     changed enc_sorted limb fails the chain verifier, one changed carried
     proof fails its own leaf slot and no other;
 12. logUp, full width: a proof that 2^16 queries drawn by seed lie in the
     16-bit range table 0..2^16-1 (fixed columns on the card), first and
     steady prove+verify seconds and launches; the same proof checked against
     a changed table is rejected;
 13. log path, small: a log-heavy program (`log_program`: a bootloader loop of
     far calls into four callees that write and read storage, emit events and
     an L1 message every 2nd iteration and revert every 8th call) for 1,024
     cycles, then the block's log and decommit queues as the JAX package's
     block runtime wires them (`runtime.block.log_path`): main_vm and its
     instance compact forms, the decommit sorter, demux, the storage, events
     and L1 sorters and the linear hasher, in instances of 16, then storage
     application on the storage sorter's survivors
     (`block.storage_application`), on the card and on the CPU: every
     residual and compact form equal, all true, every handoff true, the L1
     digest equal to the host keccak, the tree's final root equal to one
     computed apart from the port's tree (`_replayed_root`: a plain recursion
     with hashlib's blake2s); the port's entry() on the card against the CPU;
 14. log path, full width: the same program for 2^16 cycles through the
     native EraVM, every circuit in instances of 2^12 (demux and the hasher
     one instance, storage application one of the next power of two of its
     stage rows), all residuals and handoffs true, the digest equal to the
     host keccak, the final root the replayed one; witness (with the tree's
     share), evaluation and compact-form seconds (once: cut 1) per
     circuit, the counts the program reaches, the Poseidon2 launches of the
     path; six negative probes (a storage written_value limb, a demux
     out-flag, two swapped sorted events, a keccak state lane, a VM
     instance's FSM boundary, a storage path sibling), each failing exactly
     the residuals and rows the JAX package fails (tests/test_torch_log_*.py,
     tests/test_torch_storage_application.py);
 15. log sorter, full width: seeded event tapes of 2^18 rows (one event in
     eight rolled back) through `generate_witness_host_tapes` in 4 instances
     of 2^16, witness seconds with the host chains' share, first and steady
     evaluation seconds, rows/s, compact forms, all true;
 16. memory thread, small: a precompile-heavy program (`memory_program`: a
     bootloader loop of far calls into eight worker callees that keccak-,
     sha256- and (every 8th) ecrecover-hash data of the bootloader heap
     through the three precompile contracts) for 1,024 cycles, then the
     block's memory thread as the JAX package's block runtime wires it
     (`block.memory_thread`): main_vm, the decommit sorter, the code
     unpacker, the keccak, sha256 and ecrecover circuits each continuing the
     memory queue, ram_permutation over the union; and eip_4844 at 16
     elements; on the card and on the CPU: every residual and compact form
     equal, all true, every handoff true, every precompile output the host's;
 17. memory thread, full width: the same program for 2^16 cycles (codes of
     2^9 + 1 words), the unpacker and sha256 in instances of 2^10 rounds,
     keccak of 2^9 blocks, ecrecover one instance, ram of 2^16 rows: all
     residuals and handoffs (`memory_thread_closes`: ram's unsorted tail is
     the ecrecover circuit's last memory state) true, every keccak, sha256 and
     ecrecover output the host's; witness, evaluation and compact-form seconds
     (once: cut 1) per circuit, the counts against their targets, the Poseidon2 launches,
     peak device memory; five negative probes (a sha256 round's state word, a
     keccak digest byte, a keccak instance's FSM boundary, an unpacked code
     word, an ecrecover ladder limb) failing where the JAX package fails
     (tests/test_torch_{sha256_circuits,keccak_round,ecrecover}.py);
 18. eip_4844: two blobs of 4,096 seeded elements, witness, evaluation and
     compact-form seconds, all true, both hashes equal to a host
     recomputation; a changed coefficient fails where the JAX package fails;
 19. circuit STARKs, small: the demux proof at the queries of
     tests/test_demux_air.py, the Horner proof at E = 8 and a one-block
     sha256 proof made on the card equal those made on the CPU as nested
     ints; the keccak, blake2s and ecrecover traces, phase-2 columns and
     constraint residuals on the card equal the CPU's, all zero;
 20. circuit STARKs, full width, through the verdict writers of
     `runtime/block.py` on the data of phases 14, 17 and 18: the demux proof
     over the log path's rows (type 4), a keccak proof of the L1 stream (13),
     the first blob's Horner proof and three keccak chains (255; cut 9),
     the ecrecover ladders of every call (7), a sha256 chain for each of the first 3
     unique unpacked codes (3; cut 6), the first 2 calls of the sha256 and
     keccak precompiles (6, 5; cuts 2, 7 and 8), the first 2^13 blake2s compressions
     of storage application (10); each proof made and verified on the card
     once (cut 5): rows x columns, prove and verify seconds, peak device
     memory,
     each kernel's launches, every verdict true; negative probes (a rerouted
     element, a wrong opening, a flipped digest byte or word, a changed
     message byte, a flipped scalar bit) each rejected;
 21. main_vm and node STARKs, small: the main_vm committed trace of the
     bench loop at 2^11 rows (its fixed, phase-1 and phase-2 columns and the
     constraint residuals, all zero) and the FRI-verifier node STARK over two
     compact-form children (a whole proof, as nested ints) made on the card
     equal those made on the CPU;
 22. main_vm and node STARKs, full width: the type-1 writer
     `block.vm_verdict` (`vm_air.prove_vm_core` / `verify_vm_core`, 2^17 x
     1,922) over phase 14's 2^16-cycle log-heavy run (its
     `debug_residuals` printed first; cut 4), `vm_code_reads_on_tape` against the
     run's memory tape; `node_prove_in_field` / `node_verify_in_field` over
     the 16 carried proofs of phase 11; each proof's rows x columns, prove
     and verify seconds, peak memory and launches; four negative probes (a
     forged boundary state, a forged code-read word, one child swapped for
     another carried proof, one bit of a child's opened pair) each rejected;
 23. the block, small: `block_program` (a bootloader loop that calls
     `log_program`'s callees and `memory_program`'s workers in turn) for
     1,024 cycles through `runtime.block2.execute_block2` (the Python EraVM),
     limits of 16, two blobs of 16 elements, the scheduler on, no proofs; on
     the card and on the CPU (a process of its own): every compact form per
     type, residual and handoff, the scheduler's checks, the content hash and
     the public input equal; ok, types 1..13, every precompile output the
     host's; `runtime.chain.execute_chain` over two such blocks that write
     two tags to one storage cell: the hashes threaded, the storage carried
     over, the aggregate equal on the card and on the CPU;
 24. the block, full width: `block_program` for 2^16 cycles through the
     native EraVM, then `execute_block2_from_run` at phases 14 and 17's
     instance sizes with the sorter STARKs (full chains), every compact
     commitment proven and leaf-checked, the in-field node of type 8 and the
     scheduler: the host sim, every stage's, proof's and the scheduler's
     seconds, each type's instances, peak memory and the Poseidon2 launches
     (each kernel above 0); every verdict, commitment verdict and scheduler
     check true, ok; four negative probes on the scheduler (one carried
     proof swapped between two instances, a derived-input lane, another
     previous block, a wrong node VK) each failing where it must;
 25. multi-device: `entry.dryrun_multichip` with one rank a card on every
     card of the machine (spawned processes, NCCL): the row-sharded ram
     check at 2^16 rows in 8 instances, the instances' compact forms over
     the mesh's "inst" axis, main_vm through `parallel.auto.eval_sharded` at
     2^14 cycles (a register tamper at a shard boundary caught) and through
     `vm_eval_instances_sharded` at 2^16 cycles in 16 instances, the
     sharded commit of phase 4's trace bit-identical to `_commit_columns`
     and the proof made through it verified; each of its phases prints a
     line from rank 0 (seconds, world size, rank 0's launches, the card);
     rank 0's sharded-commit proof must equal phase 4's proof as nested
     ints.  Its phase 3c runs the other eight circuits through
     `parallel.auto.eval_sharded` by their shard plans (demux at 2^15 rows,
     the decommit sorter at 2^12, the linear hasher over 2^12 queries, one
     4,096-element blob, storage application over 4,096 stage rows, sha256
     over 8,192 rounds, the code unpacker over 4,096, ecrecover over 32
     calls), each equal key for key to the unsharded evaluation, all true,
     and a change at the second member's first row caught: a line a
     circuit (seconds, rows, rank 0's launches).

Cuts of depth made so that phases 23-25 fit the script's time (on an H100
at 700 W the script took 596-698 s without them, 713 s with them and no
cut), in this order: (1) phases 14 and 17 run each stage once, not twice (first
and steady); (2) phase 20 proves the first 8 calls of types 5 and 6, not
16; (3) phase 11 proves the sorter argument once, without its steady
rerun; (4) for phase 25, phase 22 proves the main_vm STARK over the log
path's run only, not also over the bench loop (the same 2^17 x 1,922
shape); (5) phase 20 proves demux and the L1 keccak once, not twice (first
and steady); (6) phase 20 proves the sha256 chains of the first 3 unique
unpacked codes, not all 12 (one shape, 2^15 x 819); (7) phase 20 proves the
first 4 calls of types 5 and 6, not 8; (8) and (9) for phase 25's phase
3c, phase 20 proves the first 2 calls of types 5 and 6, not 4, and the
first blob's Horner proof and keccak chains, not both blobs'.  The script
took 687 and 717 s with cuts 1-4 (two runs), 647 and 716 s with cuts 1-5
and 6 codes (two runs on the same tree), 632.8 s with cuts 1-7.  Every
path is still driven.

Entry points are called without a device here: they must pick the card.
Then one JSON line with the three kernels' records (each one's time against
its bound, its launches on each path), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; without
a CUDA card the script stops before printing any result.
"""

import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

LOG2_ROWS = 16
LOG2_REF_ROWS = 8
LOG2_RAM_EVAL_ROWS = 20
LOG2_VM_CYCLES = 16
CHAIN_STRIDE = 512
EVAL_REPS = 3
LOG2_SORTER_ROWS = 16
LOG2_SORTER_LIMIT = 12
LOG2_SORTER_REF_ROWS = 4
LOG2_LOGUP_ROWS = 16
LOG2_LOGUP_REF_ROWS = 8
RAM_CIRCUIT_TYPE = 8  # ram_permutation in the block runtime's numbering
LOG2_LOG_PATH_CYCLES = 16
LOG_PATH_ITERATIONS = 1440  # about 45 cycles each: the bootloader returns before 2^16
LOG2_LOG_LIMIT = 12
LOG_PATH_SMALL_ITERATIONS = 18  # even iterations send an L1 message, iteration 8 reverts
L1_CADENCE = 2  # an L1 message every 2nd iteration
LOG_PATH_SMALL_CYCLES = 1024
LOG_PATH_SMALL_LIMIT = 16
LOG_CALLEE_BASE = 0x9000  # the four callees' kernel-space addresses
LOG2_LOG_SORTER_ROWS = 18
LOG2_LOG_SORTER_LIMIT = 16
LOG2_MEM_CYCLES = 16
MEM_ITERATIONS = 1650  # about 39 cycles each: the bootloader returns before 2^16
LOG2_CALLEE_CODE_WORDS = 9  # callee bytecodes of 2^9 + 1 words, a typical deployed contract
MEM_CALLEE_BASE = 0xA000  # the eight workers' kernel-space addresses
# the bootloader heap of the memory program, in words: the loop counter at 0,
# 2^10 random words of keccak payload, four pre-padded sha256 messages of each
# of 1..8 blocks, the signatures, four output words an iteration
MEM_DATA_WORD = 16
MEM_DATA_WORDS = 1 << 10
MEM_SHA_WORD = MEM_DATA_WORD + MEM_DATA_WORDS
MEM_SIG_WORD = MEM_SHA_WORD + 288
MEM_OUT_WORD = 1 << 13
KECCAK_LENGTHS = (64, 272, 136, 64, 544, 64, 408, 272)  # a worker's payload bytes
# instance sizes: unpacker and sha256 rounds, keccak blocks, decommit sorter rows, ram rows
MEM_LIMITS = (1 << 10, 1 << 9, 1 << 12, 1 << 16)
MEM_SMALL_ITERATIONS = 16  # iterations 8 and 16 recover a signer
MEM_SMALL_CYCLES = 1024
MEM_SMALL_LOG2_CODE_WORDS = 5
MEM_SMALL_LIMITS = (16, 4, 16, 256)
MEM_SMALL_BLOB = 16
PROBE_SLOT = 5
# the circuit STARKs: the small references' blob elements and FRI queries
# (the CPU side's plain permutations), the precompile calls proven a type
# (each call is a proof of its own), the storage paths' blake2s calls proven
# (all of them, ~952 k, would be 2^24 rows x 2,902 columns)
CIRCUIT_REF_BLOB = 8
CIRCUIT_REF_QUERIES = 4
CPU_REF_THREADS = 2  # the CPU references' torch threads, beside the card phases
PRECOMPILE_PROOF_CALLS = 2  # a proof a call (cuts 2, 7 and 8)
BLOB_PROOFS = 1  # of phase 18's two blobs (cut 9)
UNPACKER_PROOF_CODES = 3  # of 12 unique codes, one shape (cut 6)
# The bench loop's rounds (bench.py runs 0xFFFF): four cycles a round, so it
# returns at cycle 65,534 and its last rows are the skip rows of a finished
# run, which the main_vm AIR needs (ROADMAP Queue 3: a run cut at its cycle
# limit cannot be proven, in either package)
BENCH_LOOP_ITERATIONS = 16383
VM_REF_CYCLES = 1024  # the small main_vm reference: a 2^11-row trace
VM_REF_ITERATIONS = 254  # returns at cycle 1,018
VM_REF_CH = (0x1234567, 0x89ABCDEF, 0x2468ACE, 0x13579BDF, 0xFEDCBA9, 0x7654321, 0xC0FFEE)
BLAKE_PROOF_CALLS = 1 << 13
# the whole block: `block_program` rounds (about 72 cycles each), the small
# one returning at cycle 998 of 1,024, the full one at 64,571 of 2^16
BLOCK_SMALL_ITERATIONS = 14
BLOCK_SMALL_CYCLES = 1024
BLOCK_SMALL_LIMIT = 16
BLOCK_ITERATIONS = 900
BLOCK_TAG_KEY = 0x7FFF  # the bootloader's storage cell a chain's blocks overwrite
CHAIN_TAGS = (111, 222)

# The kernel's bound.  Work of one permutation, counted from csrc/poseidon2.cu:
# Goldilocks products: 8 full rounds x 12 lanes x 4 (x^7) + 22 partial rounds
# x (4 for x^7 + 12 for M_I); additions: 9 M_E x 62 + 96 full-round constants
# + 22 x (1 constant + 11 for the lane sum + 12 for M_I).  Least 32-bit integer
# instructions: a product is 4 wide multiply-adds and 4 carry adds for the 128
# bits, then 12 for the reduction (five 64-bit add/subs at 2 each, 2 to make
# it canonical); an addition is 6 (64-bit add, add of 2^32 - 1, compare-select).
# The card runs 132 SMs x 64 INT32 lanes each clock.  Bytes: 96 in, 96 out
# per state, over the HBM rate.
PRODUCTS_PER_STATE = 8 * 12 * 4 + 22 * (4 + 12)
ADDITIONS_PER_STATE = 9 * 62 + 8 * 12 + 22 * (1 + 11 + 12)
INT32_INSTR_PER_STATE = PRODUCTS_PER_STATE * 20 + ADDITIONS_PER_STATE * 6
INT32_LANES = 132 * 64
HBM_BYTES_PER_S = 3.35e12
BYTES_PER_STATE = 2 * 12 * 8
KERNEL_SOURCE = "zkevm_circuits_tpu_torch/csrc/poseidon2.cu"
COOP_SOURCE = "zkevm_circuits_tpu_torch/csrc/poseidon2_coop.cuh"
REPLACES = "zkevm_circuits_tpu/ops/poseidon2_pallas.py:89"


def _seconds(runs):
    """a stage's seconds, "first / steady" when it ran twice"""
    return " / ".join(f"{x:.4f}" for x in runs)


def _fail(msg):
    raise RuntimeError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def sm_clock_hz():
    """the card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def kernel_bound_ms(n_states, clock_hz):
    """(least ms for n_states permutations, what bounds it)."""
    ops_ms = 1000 * n_states * INT32_INSTR_PER_STATE / (INT32_LANES * clock_hz)
    bytes_ms = 1000 * n_states * BYTES_PER_STATE / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def chain_bound_ms(executed_rows, rows, segments, clock_hz):
    """(least ms for a segmented chain, what bounds it): one permutation for
    each executed row; each encoding (64 bytes) and execute byte read once, the
    boundary states read and the landing states written once."""
    ops_ms = 1000 * executed_rows * INT32_INSTR_PER_STATE / (INT32_LANES * clock_hz)
    bytes_ms = 1000 * (rows * 65 + (2 * segments + 1) * 96) / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def time_ms(fn, arg, reps):
    """mean ms per call over `reps` calls after two warm-up calls (CUDA events).
    The card is kept busy for some 10 ms before the first event, so that a
    small kernel's launches are all queued behind it and the events see the
    card's time, not the host's time to launch."""
    for _ in range(2):
        fn(arg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # torch's own spin kernel; an upgrade that drops it fails here
    start.record()
    for _ in range(reps):
        fn(arg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    diff = np.nonzero(a != b)
    if not diff[0].size:
        return 0
    return max(abs(int(x) - int(y)) for x, y in zip(a[diff], b[diff]))


def step_loop(boundaries, encodings, execute, permutation):
    """The segmented chain by one batched permutation a step: where every
    segment lands, (S, 12)."""
    segments = boundaries.shape[0] - 1
    enc = encodings.reshape(segments, -1, 8)
    run = execute.reshape(segments, -1)
    state = boundaries[:-1]
    for step in range(enc.shape[1]):
        new = permutation(torch.cat([enc[:, step], state[:, 8:]], dim=-1))
        state = torch.where(run[:, step, None], new, state)
    return state


def kernel_parity(dev, card, clock_hz):
    from zkevm_circuits_tpu_torch.ops import gf, poseidon2
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import SMALL_BATCH, permutation_cuda
    from zkevm_circuits_tpu_torch.runtime import native

    def thread_kernel(x):
        return permutation_cuda(x, route="thread")

    def small_kernel(x):
        return permutation_cuda(x, route="small")

    p = gf.MODULUS
    rng = np.random.default_rng(2026)
    edge = np.array([[0] * 12, [p - 1] * 12, [(1 << 32) - 1] * 12, [1 << 32] * 12,
                     [0, 1, p - 1, (1 << 32) - 1, 1 << 32, 2, 3, p - 2, 0, 1, 5, 7]],
                    dtype=np.uint64)
    states = np.concatenate([edge, rng.integers(0, p, size=(1 << 16, 12), dtype=np.uint64)])
    st = gf.from_u64(states, dev)
    got = permutation_cuda(st)
    torch.cuda.synchronize()
    got_np, plain_np = gf.to_u64(got), gf.to_u64(poseidon2.permutation_plain(st))
    err = max_abs_err(got_np, plain_np)
    if err:
        _fail(f"kernel != plain torch on {states.shape[0]} states (max |diff| {err})")
    if not np.array_equal(got_np[:1024], native.poseidon2_permute_batch(states[:1024])):
        _fail("kernel != native C++ permutation on 1024 states")
    if states.shape[0] < SMALL_BATCH:
        _fail(f"{states.shape[0]} states do not reach the thread-per-state kernel")
    print(f"parity: thread-per-state kernel == plain torch on {states.shape[0]} states (incl. "
          f"{len(edge)} edge), == native C++ on 1024 states", flush=True)

    record = None
    shapes = []
    for log_b, what in ((18, "leaf hashing"), (17, "first tree level"),
                        (LOG2_VM_CYCLES, "main_vm sponges, one state a cycle"),
                        (11, "below SMALL_BATCH: no path sends it this batch any more")):
        st = gf.from_u64(rng.integers(0, p, size=(1 << log_b, 12), dtype=np.uint64), dev)
        got_np = gf.to_u64(thread_kernel(st))
        plain_np = gf.to_u64(poseidon2.permutation_plain(st))
        torch.cuda.synchronize()
        err = max_abs_err(got_np, plain_np)
        if err:
            _fail(f"kernel != plain torch at 2^{log_b} states (max |diff| {err})")
        ms = time_ms(thread_kernel, st, 20)
        plain_ms = time_ms(poseidon2.permutation_plain, st, 3)
        bound_ms, bound_by = kernel_bound_ms(1 << log_b, clock_hz)
        print(f"timing: 2^{log_b} states ({what}): thread-per-state kernel {ms:.4f} ms, plain torch "
              f"{plain_ms:.4f} ms, {1000 * (1 << log_b) / ms / 1e6:.1f} M perm/s; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({INT32_INSTR_PER_STATE} int32 instructions a "
              f"state at {clock_hz / 1e6:.0f} MHz), {100 * bound_ms / ms:.1f} % of it reached; "
              f"library call: none [{card}]", flush=True)
        shapes.append(dict(states=1 << log_b, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms))
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    record["shapes"] = shapes

    # the lane-parallel small-batch kernel: the same bits as both
    small_err = 0
    for n in (1, 5, 2048, SMALL_BATCH - 1):
        raw = rng.integers(0, p, size=(n, 12), dtype=np.uint64)
        raw[: min(n, len(edge))] = edge[:n]
        st = gf.from_u64(raw, dev)
        got_np = gf.to_u64(small_kernel(st))
        torch.cuda.synchronize()
        small_err = max(small_err, max_abs_err(got_np, gf.to_u64(poseidon2.permutation_plain(st))),
                        max_abs_err(got_np, gf.to_u64(thread_kernel(st))))
        if small_err:
            _fail(f"small-batch kernel != plain torch or thread-per-state kernel at {n} states "
                  f"(max |diff| {small_err})")
    print(f"parity: small-batch kernel == plain torch == thread-per-state kernel at 1, 5, 2048 "
          f"and {SMALL_BATCH - 1} states (incl. the edge states)", flush=True)
    small = None
    small_shapes = []
    for log_b, what in ((11, "Merkle level, chain step of a narrow queue"),
                        (12, "Merkle level"), (0, "transcript sponge, challenge pull")):
        st = gf.from_u64(rng.integers(0, p, size=(1 << log_b, 12), dtype=np.uint64), dev)
        ms = time_ms(small_kernel, st, 20)
        plain_ms = time_ms(poseidon2.permutation_plain, st, 3)
        bound_ms, bound_by = kernel_bound_ms(1 << log_b, clock_hz)
        print(f"timing: 2^{log_b} states ({what}): small-batch kernel {ms:.4f} ms, plain torch "
              f"{plain_ms:.4f} ms; bound {bound_ms:.6f} ms by {bound_by}, "
              f"{100 * bound_ms / ms:.1f} % of it reached; library call: none [{card}]",
              flush=True)
        small_shapes.append(dict(states=1 << log_b, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms))
        if small is None:
            small = dict(max_abs_err=small_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
    small["shapes"] = small_shapes
    return record, small


def small_reference(dev):
    """The port's proof on the card equals its proof on the CPU (the CPU path
    is held byte-identical to the JAX package by tests/test_torch_ram_prover.py)."""
    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.prover import pipeline
    from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints
    from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np

    n = 1 << LOG2_REF_ROWS
    tapes = build_tapes_np(n)
    cfg = ram.RamPermutationConfig(limit=n, chain_stride=16)
    proofs = []
    for d in (None, torch.device("cpu")):  # None: the entry point picks the card
        w = ram.generate_witness_host_tapes(*tapes, cfg, device=d)
        if w.lhs.device.type != ("cpu" if d is not None else dev.type):
            _fail(f"witness made with device={d} lies on {w.lhs.device}")
        ok, proof, _, _ = pipeline.prove_sorter_argument(w)
        if not ok:
            _fail(f"2^{LOG2_REF_ROWS}-row proof on {d} did not verify")
        proofs.append(proof_to_ints(proof))
    if proofs[0] != proofs[1]:
        _fail(f"2^{LOG2_REF_ROWS}-row proof on the card differs from the CPU proof")
    print(f"reference: 2^{LOG2_REF_ROWS}-row proof on the card == proof on the CPU "
          f"({len(proofs[0]['fri']['query_indices'])} queries)", flush=True)


def main_path(dev, card):
    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.prover import pipeline
    from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np

    n = 1 << LOG2_ROWS
    tapes = build_tapes_np(n)
    cfg = ram.RamPermutationConfig(limit=n, chain_stride=CHAIN_STRIDE)
    torch.cuda.synchronize()
    KERNEL.reset_counts()
    t0 = time.perf_counter()
    w = ram.generate_witness_host_tapes(*tapes, cfg)
    torch.cuda.synchronize()
    witness_s = time.perf_counter() - t0
    for name in ("execute", "enc_unsorted", "enc_sorted", "chain_unsorted", "challenges",
                 "lhs", "rhs", "nondet_count"):
        if getattr(w, name).device.type != dev.type:
            _fail(f"witness field {name} is on {getattr(w, name).device}")
    seconds = []
    for run in ("first", "steady"):
        before = KERNEL.counts()
        t0 = time.perf_counter()
        ok, proof, public, params = pipeline.prove_sorter_argument(w)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if not ok:
            _fail(f"{run} prove+verify at 2^{LOG2_ROWS} rows did not verify")
        for name in ("permutation", "permutation_small"):
            if KERNEL.counts()[name] <= before[name]:
                _fail(f"{run} proof did not launch the {name} kernel")
    launches = KERNEL.counts()
    out = gf.to_u64(public)
    if out.shape != (pipeline.NUM_REPS,) or not np.array_equal(out, gf.to_u64(w.rhs[-1])):
        _fail("public final products do not match the witness's rhs")
    print(f"main path: witness 2^{LOG2_ROWS} rows {witness_s:.3f} s; prove+verify first "
          f"{seconds[0]:.3f} s ({n / seconds[0]:.1f} rows/s), steady {seconds[1]:.3f} s "
          f"({n / seconds[1]:.1f} rows/s); log_n={params.log_n} queries={params.num_queries}; "
          f"kernel launches over the witness and both proofs {launches} [{card}]", flush=True)
    return proof, public, params, launches


def negative_probe(proof, public, params):
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.prover import pipeline

    forged = public.clone()
    forged[0] = gf.add(forged[0], gf.ones((), forged.device))
    if pipeline.verify_permutation_argument(proof, forged, params):
        _fail("verification accepted a changed public final product")
    print("negative probe: changed public final product rejected", flush=True)


def _residuals_np(res):
    from zkevm_circuits_tpu_torch.utils.convert import residuals_to_numpy

    return residuals_to_numpy(res)


def _same_residuals(card_res, cpu_res, what):
    a, b = _residuals_np(card_res), _residuals_np(cpu_res)
    if list(a) != list(b):
        _fail(f"{what}: residual keys differ between the card and the CPU")
    for k in a:
        if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k]):
            _fail(f"{what}: residual {k} on the card differs from the CPU's")
    return a


def timed_evals(evaluate, kernel):
    """first and steady (mean of EVAL_REPS) seconds of `evaluate`, each ended by
    a synchronize; each kernel's launches over one evaluation; the residuals of
    the last one; peak device memory in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_counts()
    t0 = time.perf_counter()
    res = evaluate()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernel.counts()
    t0 = time.perf_counter()
    for _ in range(EVAL_REPS):
        res = evaluate()
    torch.cuda.synchronize()
    steady_s = (time.perf_counter() - t0) / EVAL_REPS
    if kernel.counts() != {k: (1 + EVAL_REPS) * v for k, v in launches.items()}:
        _fail(f"kernel launches per evaluation changed: {launches} then "
              f"{kernel.counts()} after {EVAL_REPS} more")
    if not sum(launches.values()):
        _fail("the evaluation launched no Poseidon2 kernel")
    return first_s, steady_s, launches, res, torch.cuda.max_memory_allocated()


def ram_eval_small(dev):
    """Residuals and instance compact forms on the card equal the CPU's."""
    import dataclasses

    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np

    n = 1 << 10
    tapes = build_tapes_np(n)
    cfg = ram.RamPermutationConfig(limit=n // 2, chain_stride=16)
    sides = []
    for d in (None, torch.device("cpu")):
        w = ram.generate_witness_host_tapes(*tapes, cfg, device=d)
        sides.append((ram.eval_constraints(w, cfg), ram.instance_compact_forms(w, cfg)))
    res = _same_residuals(sides[0][0], sides[1][0], "ram eval at 2^10 rows")
    if not all(v.all() for v in res.values()):
        _fail("ram eval at 2^10 rows: a residual is false")
    if sides[0][1].start_flag.device.type != dev.type:
        _fail("compact forms of a card witness are not on the card")
    for f in dataclasses.fields(sides[0][1]):
        a, b = (getattr(s[1], f.name).cpu() for s in sides)
        if a.shape != b.shape or not bool((a == b).all()):
            _fail(f"ram compact form field {f.name} on the card differs from the CPU's")
    commitments = gf.to_u64(sides[0][1].commitment())
    if commitments.shape != (2, 4) or not np.array_equal(
            commitments, gf.to_u64(sides[1][1].commitment())):
        _fail("ram instance commitments on the card differ from the CPU's")
    print(f"ram eval small: 2^10 rows, 2 instances: {len(res)} residuals and the compact "
          f"forms on the card == on the CPU, all true", flush=True)


def ram_witness_full(dev):
    """the 2^20-row witness on the card, its config and the seconds it took."""
    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np

    n = 1 << LOG2_RAM_EVAL_ROWS
    tapes = build_tapes_np(n)
    cfg = ram.RamPermutationConfig(limit=n, chain_stride=CHAIN_STRIDE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = ram.generate_witness_host_tapes(*tapes, cfg)
    torch.cuda.synchronize()
    witness_s = time.perf_counter() - t0
    if w.enc_sorted.device.type != dev.type or w.enc_sorted.shape != (n, 8):
        _fail(f"ram witness: enc_sorted {tuple(w.enc_sorted.shape)} on {w.enc_sorted.device}")
    if w.chain_sorted.shape != (n // CHAIN_STRIDE + 1, 12) or not bool(w.execute.all()):
        _fail("ram witness: boundary states or execute mask are not as expected")
    return w, cfg, witness_s


def chain_kernel_parity(w, card, clock_hz):
    """The fused chain kernel against the step loop on the witness's own chains,
    bit for bit, and its times at the evaluation's shape and at twice it."""
    from zkevm_circuits_tpu_torch.ops import gf, poseidon2, queues
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import chain_segmented_cuda, permutation_cuda

    def thread_kernel(x):
        return permutation_cuda(x, route="thread")

    def same(got, want, what):
        torch.cuda.synchronize()
        err = max_abs_err(gf.to_u64(got), gf.to_u64(want))
        if err:
            _fail(f"chain kernel != step loop {what} (max |diff| {err})")
        return err

    rng = np.random.default_rng(512)
    sorted_chain = (w.chain_sorted, w.enc_sorted, w.execute)
    unsorted_chain = (w.chain_unsorted, w.enc_unsorted, w.execute)
    segments = w.chain_sorted.shape[0] - 1
    rows = w.enc_sorted.shape[0]

    # (64 x 16) with about a tenth of the rows not executed, the plain permutation inside
    small = (w.chain_sorted[:65].contiguous(), w.enc_sorted[: 64 * 16].contiguous(),
             torch.from_numpy(rng.random(64 * 16) >= 0.1).to(w.execute.device))
    landing = chain_segmented_cuda([small])[0]
    err = same(landing, step_loop(*small, poseidon2.permutation_plain), "at (64 x 16)")
    # and the plain version the port itself runs on CPU tensors
    err = max(err, same(landing, queues.segment_landing_states_plain(*(x.cpu() for x in small)),
                        "at (64 x 16), the port's plain version on the CPU"))
    # the evaluation's shape: all rows executed (the landing states are the
    # witness's own boundaries), then a tenth of them not; both chains in one launch
    both = chain_segmented_cuda([unsorted_chain, sorted_chain])
    err = max(err, same(both[1], step_loop(*sorted_chain, thread_kernel),
                        f"at ({segments} x {CHAIN_STRIDE}), all executed"))
    err = max(err, same(both[0], w.chain_unsorted[1:], "against the witness's boundaries"))
    mixed = (w.chain_sorted, w.enc_sorted,
             torch.from_numpy(rng.random(rows) >= 0.1).to(w.execute.device))
    err = max(err, same(chain_segmented_cuda([mixed])[0], step_loop(*mixed, thread_kernel),
                        f"at ({segments} x {CHAIN_STRIDE}), a tenth not executed"))
    print(f"parity: chain kernel == step loop at (64 x 16) with the plain permutation == "
          f"queues.segment_landing_states_plain on the CPU, and at "
          f"({segments} x {CHAIN_STRIDE}) with the thread-per-state kernel, all rows executed "
          f"and {int((~mixed[2]).sum())} of {rows} not", flush=True)

    # twice the shape, for the timing only: both chains end to end
    double = (torch.cat([w.chain_unsorted[:-1], w.chain_sorted]),
              torch.cat([w.enc_unsorted, w.enc_sorted]), torch.cat([w.execute, w.execute]))
    record = None
    shapes = []
    for what, chains in ((f"one chain ({segments} x {CHAIN_STRIDE})", [sorted_chain]),
                         (f"both chains of the evaluation, one launch (2 x {segments} x "
                          f"{CHAIN_STRIDE})", [unsorted_chain, sorted_chain]),
                         (f"one chain ({2 * segments} x {CHAIN_STRIDE})", [double])):
        ms = time_ms(chain_segmented_cuda, chains, 20)
        plain_ms = time_ms(lambda cs: [step_loop(*c, thread_kernel) for c in cs], chains, 1)
        executed = sum(int(c[2].sum()) for c in chains)
        bound_ms, bound_by = chain_bound_ms(
            executed, sum(c[1].shape[0] for c in chains),
            sum(c[0].shape[0] - 1 for c in chains), clock_hz)
        print(f"timing: chain kernel, {what}: {ms:.4f} ms, the step loop through the "
              f"thread-per-state kernel {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
              f"({executed} permutations), {100 * bound_ms / ms:.1f} % of it reached; library "
              f"call: none [{card}]", flush=True)
        shapes.append(dict(what=what, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms))
        if len(chains) == 2:  # the shape the evaluation launches
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    record["shapes"] = shapes
    return record


def sponge_chain_shapes(dev, card, clock_hz):
    """The chain kernel at the sponge shapes the circuit STARKs give it
    (`poseidon2.hash_padded` over fewer than SMALL_BATCH states): one
    transcript absorbing a wide AIR's 2 x 7,493 OOD values, 2^7 leaves of
    7,493 columns, 2^13 leaves of 279.  Each against the absorb loop on the
    card (a small-batch launch an absorb) on the same inputs, bit for bit,
    and timed against it; `hash_padded` itself takes the chained route."""
    from zkevm_circuits_tpu_torch.ops import gf, poseidon2

    rng = np.random.default_rng(7493)
    shapes, err = [], 0
    for states, n, what in ((1, 4 + 2 * 7493, "the transcript over 2 x 7,493 OOD values"),
                            (1 << 7, 7493, "2^7 leaves of 7,493 columns"),
                            (1 << 13, 279, "2^13 leaves of 279 columns")):
        inputs = gf.from_u64(rng.integers(0, gf.MODULUS, size=(states, n), dtype=np.uint64), dev)
        state = poseidon2.apply_length_specialization(poseidon2.empty_state((states,), dev), n)
        chained = poseidon2.absorb_chained(inputs, state)
        loop = poseidon2.absorb_loop(inputs, state)
        err = max(err, max_abs_err(gf.to_u64(chained).ravel(), gf.to_u64(loop).ravel()))
        routed = poseidon2.hash_padded(inputs)
        if err or not torch.equal(routed, poseidon2.state_into_commitment(chained)):
            _fail(f"chain kernel as a sponge != the absorb loop, or hash_padded not chained, "
                  f"at {what} (max |diff| {err})")
        rounds = -(-n // poseidon2.RATE)
        ms = time_ms(lambda x: poseidon2.absorb_chained(x, state), inputs, 5)
        plain_ms = time_ms(lambda x: poseidon2.absorb_loop(x, state), inputs, 1)
        bound_ms, bound_by = chain_bound_ms(states * rounds, states * rounds, states, clock_hz)
        what = f"sponge: {what} ({states} x {rounds} absorbs)"
        print(f"timing: chain kernel, {what}: {ms:.4f} ms, the absorb loop through the "
              f"small-batch kernel {plain_ms:.4f} ms, equal bit for bit; bound {bound_ms:.4f} ms "
              f"by {bound_by}, {100 * bound_ms / ms:.1f} % of it reached [{card}]", flush=True)
        shapes.append(dict(what=what, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           max_abs_err=err))
    return shapes


def ram_eval_full(dev, card, w, cfg, witness_s):
    import dataclasses

    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.ops import queues
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL

    n = 1 << LOG2_RAM_EVAL_ROWS
    first_s, steady_s, launches, res, peak = timed_evals(
        lambda: ram.eval_constraints(w, cfg), KERNEL)
    if not 0 < launches["chain_segmented"] <= 2:
        _fail(f"ram eval launched the chain kernel {launches['chain_segmented']} times")
    if launches["permutation"] >= CHAIN_STRIDE:
        _fail(f"ram eval still launches the thread-per-state kernel once a chain step: "
              f"{launches['permutation']} launches")
    if launches["permutation_small"] <= 0:
        _fail("ram eval launched the small-batch kernel no time (the challenge pulls)")
    if any(v.device.type != dev.type for v in res.values()):
        _fail("ram eval: a residual is not on the card")
    bad = [k for k, v in res.items() if not bool(v.all())]
    if bad or not ram.all_ok(res):
        _fail(f"ram eval at 2^{LOG2_RAM_EVAL_ROWS} rows: residuals {bad} are false")
    if res["chain_sorted"].shape != (n // CHAIN_STRIDE,) or res["sort_order"].shape != (n,):
        _fail("ram eval: residual shapes are wrong")
    print(f"ram eval: witness 2^{LOG2_RAM_EVAL_ROWS} rows {witness_s:.3f} s "
          f"({n / witness_s:.1f} rows/s); eval_constraints first {first_s:.4f} s, steady "
          f"{steady_s:.4f} s ({n / steady_s:.1f} rows/s), {len(res)} residuals all true; kernel "
          f"launches per evaluation {launches}; peak device memory {peak / 2**20:.1f} MiB "
          f"[{card}]", flush=True)

    # negative probe on the chain call: one lane of one inner row of a segment
    row = 1234 * CHAIN_STRIDE + 77
    enc = w.enc_sorted.clone()
    enc[row, 3] ^= 1
    ok = queues.check_chain_segmented(w.chain_sorted, enc, w.execute)
    failing = torch.nonzero(~ok).flatten().tolist()
    if ok.shape != (n // CHAIN_STRIDE,) or failing != [row // CHAIN_STRIDE]:
        _fail(f"chain negative probe: expected segment {row // CHAIN_STRIDE} alone to fail, "
              f"got {failing[:8]}")
    print(f"chain negative probe: a changed lane of enc_sorted at row {row} fails segment "
          f"{row // CHAIN_STRIDE} and none of the other {ok.shape[0] - 1}", flush=True)
    del enc

    # negative probe: the stored encoding no longer matches the changed field
    row = n // 3
    value = w.sorted.value.clone()
    value[row, 4] ^= 1
    forged = dataclasses.replace(w, sorted=dataclasses.replace(w.sorted, value=value))
    res = _residuals_np(ram.eval_constraints(forged, cfg))
    bad = [k for k, v in res.items() if not v.all()]
    if bad != ["encoding_sorted"] or np.flatnonzero(~res["encoding_sorted"]).tolist() != [row]:
        _fail(f"ram negative probe: expected encoding_sorted false at row {row} only, got {bad}")
    print(f"ram negative probe: a changed limb of sorted.value at row {row} fails "
          f"encoding_sorted there and nothing else", flush=True)
    return launches


def _vm_programs(iterations=BENCH_LOOP_ITERATIONS):
    """(the 3-instruction program, the bench loop of `iterations` rounds)."""
    from zkevm_circuits_tpu_torch.isa import opcodes as isa

    enc = isa.encode_instruction
    small = [
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=41, src1=0, dst0=1),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=2),
        enc(isa.RET, isa.RET_OK),
    ]
    set_flags = 1 << isa.SET_FLAGS_FLAG_IDX
    swap = 1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES
    loop = [
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=iterations, src1=0, dst0=1),
        enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=1, flags=set_flags | swap),
        enc(isa.MUL, src0=1, src1=1, dst0=2, dst1=3),
        enc(isa.BINOP, isa.BINOP_XOR, src0=2, src1=1, dst0=4),
        enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=1, condition=isa.COND_NE),
        enc(isa.RET, isa.RET_OK),
    ]
    return small, loop


def vm_eval_small(dev):
    from zkevm_circuits_tpu_torch.models import vm

    limit = 8
    w = vm.NativeEraVM(vm.assemble_code_words(_vm_programs()[0]), limit).run()
    dw = vm.prepare_device_witness(w)
    if dw["regs"].device.type != dev.type:
        _fail(f"prepare_device_witness without a device put regs on {dw['regs'].device}")
    cpu = vm.prepare_device_witness(w, device="cpu")
    res = _same_residuals(vm.eval_constraints(dw, limit), vm.eval_constraints(cpu, limit),
                          "main_vm at limit 8")
    if not all(v.all() for v in res.values()):
        _fail("main_vm at limit 8: a residual is false")
    print(f"main_vm small: limit {limit}: {len(res)} residuals on the card == on the CPU, "
          f"all true", flush=True)


def vm_eval_full(dev, card):
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL

    n = 1 << LOG2_VM_CYCLES
    t0 = time.perf_counter()
    w = vm.NativeEraVM(vm.assemble_code_words(_vm_programs()[1]), n).run()
    sim_s = time.perf_counter() - t0
    dw = vm.prepare_device_witness(w)
    torch.cuda.synchronize()
    if dw["regs"].device.type != dev.type or dw["regs"].shape != (n + 1, 15, 8):
        _fail(f"main_vm witness: regs {tuple(dw['regs'].shape)} on {dw['regs'].device}")
    first_s, steady_s, launches, res, peak = timed_evals(
        lambda: vm.eval_constraints(dw, n), KERNEL)
    if launches["permutation"] <= 0:
        _fail("main_vm eval launched the thread-per-state kernel no time")
    bad = [k for k, v in res.items() if v.shape != (n,) or not bool(v.all())]
    if bad or not vm.all_ok(res):
        _fail(f"main_vm eval at 2^{LOG2_VM_CYCLES} cycles: residuals {bad} are false")
    print(f"main_vm eval: host sim 2^{LOG2_VM_CYCLES} cycles {sim_s:.3f} s; eval_constraints "
          f"first {first_s:.4f} s, steady {steady_s:.4f} s ({n / steady_s:.1f} cycles/s), "
          f"{len(res)} residuals all true; kernel launches per evaluation {launches}; peak "
          f"device memory {peak / 2**20:.1f} MiB [{card}]", flush=True)

    # negative probe: one limb of a register at a row after cycle 0
    forged = dict(dw)
    regs = dw["regs"].clone()
    regs[n // 2, 0, 0] ^= 1
    forged["regs"] = regs
    res = _residuals_np(vm.eval_constraints(forged, n))
    bad = [k for k, v in res.items() if not v.all()]
    if not bad:
        _fail("main_vm negative probe: a changed register limb was accepted")
    print(f"main_vm negative probe: a changed limb of r1 at row {n // 2} fails {bad}", flush=True)
    return launches


def _sorter_full_ints(full):
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints

    return dict(gp=proof_to_ints(full.gp_proof), gp_public=gf.to_u64(full.gp_public).tolist(),
                chain_u=proof_to_ints(full.chain_u[0]), chain_s=proof_to_ints(full.chain_s[0]),
                tails=[full.tail_u.tolist(), full.tail_s.tolist()], n_real=full.n_real)


def _range_lookup(log_rows, seed):
    """the 16-bit range check's table 0..2^log_rows - 1 and 2^log_rows queries
    drawn from it"""
    table = np.arange(1 << log_rows, dtype=np.uint64)[None]
    picks = np.random.default_rng(seed).integers(0, 1 << log_rows, size=1 << log_rows)
    return table, table[:, picks]


def _sorter_reference(d):
    """The sorter full proof, the carried compact-commitment proofs and a
    logUp proof at small sizes on device `d` (None: the card), as nested
    ints."""
    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.prover import logup, pipeline
    from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp
    from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints
    from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np

    n = 1 << LOG2_SORTER_REF_ROWS
    tapes = build_tapes_np(n)
    cfg = ram.RamPermutationConfig(limit=n // 2)
    table, queries = _range_lookup(LOG2_LOGUP_REF_ROWS, 8)
    w = ram.generate_witness_host_tapes(*tapes, cfg, device=d)
    ok, full = pipeline.prove_sorter_full(w)
    if not ok:
        _fail(f"2^{LOG2_SORTER_REF_ROWS}-row sorter full proof on {w.execute.device} "
              f"did not verify")
    carried = rp.make_carried_proofs(ram.instance_compact_forms(w, cfg))
    lproof, lparams = logup.prove_lookup(table, queries, device=d)
    if not logup.verify_lookup(lproof, table, lparams):
        _fail(f"2^{LOG2_LOGUP_REF_ROWS}-row logUp proof on {w.execute.device} did not verify")
    if full.gp_proof.q_cap.device.type != w.execute.device.type or \
            lproof.q_cap.device.type != w.execute.device.type:
        _fail(f"proofs made with device={d} lie elsewhere")
    return dict(sorter=_sorter_full_ints(full),
                carried=[proof_to_ints(cp.proof) for cp in carried],
                finals=[cp.final_state.tolist() for cp in carried],
                logup=proof_to_ints(lproof))


def sorter_full_small(dev, reference):
    """The sorter full proof, the carried compact-commitment proofs and a
    logUp proof made on the card equal those made on the CPU (the CPU side,
    from `start_cpu_references`, is held to the JAX package by
    tests/test_torch_sorter_full_slow.py)."""
    card = _sorter_reference(None)  # None: the entry points pick the card
    cpu = _cpu_reference(reference, "sorter")
    for key in card:
        if card[key] != cpu[key]:
            _fail(f"sorter full small: {key} made on the card differs from the CPU's")
    print(f"sorter full small: 2^{LOG2_SORTER_REF_ROWS} rows in 2 instances: the sorter full "
          f"proof (grand product + 2 chain STARKs), {len(card['carried'])} compact-commitment "
          f"proofs and the 2^{LOG2_LOGUP_REF_ROWS}-row logUp proof on the card == on the CPU "
          f"(the CPU's made in a process of its own)", flush=True)


def _leaf(forms, carried):
    from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp

    k = len(carried)
    dev = forms.start_flag.device
    types = torch.full((k,), RAM_CIRCUIT_TYPE, dtype=torch.int64, device=dev)
    res = rp.leaf_layer_verify_starks(RAM_CIRCUIT_TYPE, types, forms.commitment(),
                                      torch.ones(k, dtype=torch.bool, device=dev), carried)
    return {name: v.cpu().numpy() for name, v in res.items()}


def sorter_full_path(dev, card):
    """The fully proof-backed sorter argument at full width, its carried
    proofs and the recursion leaf check; returns what the probes need and
    each kernel's launches over the path."""
    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.prover import pipeline
    from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp
    from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np

    n = 1 << LOG2_SORTER_ROWS
    tapes = build_tapes_np(n)
    cfg = ram.RamPermutationConfig(limit=1 << LOG2_SORTER_LIMIT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = ram.generate_witness_host_tapes(*tapes, cfg)
    torch.cuda.synchronize()
    witness_s = time.perf_counter() - t0
    if w.chain_sorted.shape != (n + 1, 12) or w.chain_sorted.device.type != dev.type:
        _fail(f"sorter witness: chain_sorted {tuple(w.chain_sorted.shape)} on "
              f"{w.chain_sorted.device}, not a state a row on the card")

    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset_counts()
    t0 = time.perf_counter()
    ok, full = pipeline.prove_sorter_full(w)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    prove_launches = KERNEL.counts()
    peak = torch.cuda.max_memory_allocated()
    if not ok:
        _fail(f"sorter full proof at 2^{LOG2_SORTER_ROWS} rows did not verify")
    if full.n_real != n or not np.array_equal(full.tail_s, gf.to_u64(w.chain_sorted[n])) \
            or not np.array_equal(gf.to_u64(full.gp_public), gf.to_u64(w.lhs[-1])):
        _fail("sorter full proof: tails or final products are not the witness's")

    forms = ram.instance_compact_forms(w, cfg)
    k = int(forms.start_flag.shape[0])
    if k != n >> LOG2_SORTER_LIMIT:
        _fail(f"{k} instances, not {n >> LOG2_SORTER_LIMIT}")
    t0 = time.perf_counter()
    carried = rp.make_carried_proofs(forms, relation=(w, full))
    torch.cuda.synchronize()
    carried_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = _leaf(forms, carried)
    leaf_s = time.perf_counter() - t0
    launches = KERNEL.counts()
    bad = [name for name, v in res.items() if v.shape != (k,) or not v.all()]
    if bad:
        _fail(f"leaf check of the {k} carried proofs: {bad} not all true")
    for name in ("permutation", "permutation_small"):
        if launches[name] <= 0:
            _fail(f"the sorter full path launched the {name} kernel no time")

    print(f"sorter full: witness 2^{LOG2_SORTER_ROWS} rows, {k} instances of "
          f"2^{LOG2_SORTER_LIMIT}, per-row chains {witness_s:.3f} s; prove+verify (grand product "
          f"+ 2 chain STARKs of {n} rows, 262 + 1 columns, LDE 2^{LOG2_SORTER_ROWS + 2}) "
          f"{first_s:.3f} s ({n / first_s:.1f} rows/s); peak device "
          f"memory {peak / 2**20:.1f} MiB; kernel launches of a prove+verify {prove_launches}; "
          f"{k} compact-commitment STARKs {carried_s:.3f} s; leaf check of circuit type "
          f"{RAM_CIRCUIT_TYPE} (every proof verified, the sorter argument again on slot 0) "
          f"{leaf_s:.3f} s, all true; launches over the path {launches} [{card}]", flush=True)
    return w, full, forms, carried, launches


def sorter_full_probes(w, full, forms, carried):
    import dataclasses

    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.prover import pipeline
    from zkevm_circuits_tpu_torch.prover import poseidon2_air as pa

    p = np.uint64(gf.MODULUS)
    bad = dataclasses.replace(full, tail_u=(full.tail_u + np.uint64(1)) % p)
    if pipeline.verify_sorter_full(w, bad):
        _fail("verify_sorter_full accepted a changed unsorted tail")
    n_real = full.n_real
    enc = gf.to_u64(w.enc_sorted)[:n_real].copy()
    enc[n_real // 3, 3] ^= np.uint64(1)
    proof, params = full.chain_s
    if pa.verify_queue_chain(proof, enc, np.zeros(4, np.uint64), full.tail_s, pa.FULL, params):
        _fail("the chain verifier accepted a changed limb of enc_sorted")
    cp = carried[PROBE_SLOT]
    tz = np.array(cp.proof.ood["trace_z"], copy=True)
    tz[0] ^= np.uint64(1)
    forged = list(carried)
    forged[PROBE_SLOT] = dataclasses.replace(
        cp, proof=dataclasses.replace(cp.proof, ood=dict(cp.proof.ood, trace_z=tz)))
    res = _leaf(forms, forged)
    failing = np.flatnonzero(~res["proof_inputs"]).tolist()
    if failing != [PROBE_SLOT] or not res["type_match"].all() or not res["proof_vk"].all():
        _fail(f"leaf probe: expected slot {PROBE_SLOT} alone to fail, got {failing}")
    print(f"sorter full negative probes: a changed tail fails verify_sorter_full; a changed "
          f"limb of enc_sorted at row {n_real // 3} fails the chain verifier; a changed OOD "
          f"value of carried proof {PROBE_SLOT} fails its leaf slot and none of the other "
          f"{len(carried) - 1}", flush=True)


def logup_path(dev, card):
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.prover import logup

    table, queries = _range_lookup(LOG2_LOGUP_ROWS, 16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for run in ("first", "steady"):
        KERNEL.reset_counts()
        t0 = time.perf_counter()
        proof, params = logup.prove_lookup(table, queries)
        ok = logup.verify_lookup(proof, table, params)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if not ok:
            _fail(f"{run} logUp proof over the 2^{LOG2_LOGUP_ROWS}-row range table did not verify")
        if run == "first":
            launches = KERNEL.counts()
    if proof.caps[0].device.type != dev.type or len(proof.caps) != 3:
        _fail("the logUp proof's fixed, phase-1 and phase-2 trees are not on the card")
    other = table.copy()
    other[0, table.shape[1] // 3] ^= np.uint64(1)
    if logup.verify_lookup(proof, other, params):
        _fail("the logUp proof verified against a changed table")
    print(f"logup: 2^{LOG2_LOGUP_ROWS} queries in the 2^{LOG2_LOGUP_ROWS}-row range table, "
          f"prove+verify first {seconds[0]:.3f} s, steady {seconds[1]:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; kernel launches {launches}; a "
          f"changed table rejected [{card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# the block's log and decommit queues (runtime/block2.py:214-470 of the JAX
# package): a log-heavy EraVM run, then main_vm, its instances, the decommit
# sorter, demux, the storage, events and L1 sorters and the linear hasher
# ---------------------------------------------------------------------------


def log_program(iterations):
    """A bootloader loop of `iterations` far calls, each to one of four
    kernel-space callees (from the code store, one decommit request a call):
    the bootloader keeps its loop counter in storage key 0 and hands it to the
    callee in r3 (a system call keeps r3..r11); the callee writes two storage
    cells over 2^10 keys of its own address (2^12 cells over the four, so
    writes repeat), reads one of them and the cell it wrote four iterations
    before, emits four events, an L1 message on every L1_CADENCE-th iteration
    (every 2nd: the L1 target of 2^9 messages in 2^16 cycles), and reverts on
    every 8th call ((i + (i >> 4)) & 7 == 0, so that 1 in 8 of the L1
    messages is rolled back too).  About 45 cycles an iteration.  Returns
    (code words, EraVM keyword arguments)."""
    from zkevm_circuits_tpu_torch.isa import opcodes as isa
    from zkevm_circuits_tpu_torch.isa import system_params as sp
    from zkevm_circuits_tpu_torch.models import vm

    enc = isa.encode_instruction
    set_flags = 1 << isa.SET_FLAGS_FLAG_IDX
    swap = 1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES
    first = 1 << isa.FIRST_MESSAGE_FLAG_IDX

    def imm(v, dst):
        return enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=v, src1=0, dst0=dst)

    def addi(v, src, dst):
        return enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=v, src1=src, dst0=dst)

    def andi(v, src, dst, flags=0):
        return enc(isa.BINOP, isa.BINOP_AND, src_mode=isa.SRC_IMM, imm0=v, src1=src, dst0=dst,
                   flags=flags)

    def log(variant, src0, src1=0, dst0=0, flags=0):
        return enc(isa.LOG, variant, src0=src0, src1=src1, dst0=dst0, flags=flags)

    def words(prog):
        out = vm.assemble_code_words(prog)
        return out + [0] if len(out) % 2 == 0 else out  # Era bytecode: odd length

    def callee(c):
        prog = [
            imm(c, 11),
            imm(4, 10), enc(isa.SHIFT, isa.SHIFT_SHR, src0=3, src1=10, dst0=5),
            enc(isa.ADD, src0=5, src1=3, dst0=5), andi(7, 5, 5, set_flags),  # eq: reverts
            enc(isa.ADD, src0=3, src1=3, dst0=8), enc(isa.ADD, src0=8, src1=3, dst0=8),
            enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=12, src1=8, dst0=8, flags=swap),
            andi(0x3FF, 8, 8),                       # key 3(i - 4): this callee's last call
        ]
        fresh = len(prog) + 6
        prog += [
            enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=fresh, condition=isa.COND_EQ),
            addi(12, 8, 4), andi(0x3FF, 4, 4),      # keys 3i, 3i + 1 (mod 2^10)
            addi(1, 4, 6), andi(0x3FF, 6, 6),
        ]
        body = fresh + 2
        prog += [enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=body)]
        # a call that reverts writes cells nothing touches again (the EraVM
        # oracle does not undo a reverted write: ROADMAP Queue 3)
        prog += [addi(0x4000, 3, 4), addi(0x6000, 3, 6)]
        prog += [
            log(isa.LOG_STORAGE_WRITE, 4, 3),
            log(isa.LOG_STORAGE_WRITE, 6, 3),
            log(isa.LOG_STORAGE_READ, 6, dst0=7),
            log(isa.LOG_STORAGE_READ, 8, dst0=7),
            log(isa.LOG_EVENT, 4, 3, flags=first),
            log(isa.LOG_EVENT, 6, 7),
            log(isa.LOG_EVENT, 8, 11),
            log(isa.LOG_EVENT, 11, 3),
        ]
        skip = len(prog) + 3
        prog += [andi(L1_CADENCE - 1, 3, 9, set_flags),
                 enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=skip, condition=isa.COND_NE),
                 log(isa.LOG_TO_L1_MESSAGE, 4, 3)]
        revert = len(prog) + 3
        prog += [andi(7, 5, 5, set_flags),
                 enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=revert, condition=isa.COND_EQ),
                 enc(isa.RET, isa.RET_OK),
                 enc(isa.RET, isa.RET_REVERT)]
        return words(prog)

    prog = [
        log(isa.LOG_STORAGE_READ, 0, dst0=3),                    # the loop counter
        addi(1, 3, 3),
        log(isa.LOG_STORAGE_WRITE, 0, 3),
        andi(3, 3, 4), addi(LOG_CALLEE_BASE, 4, 4),              # one of four callees
        imm(1, 1), imm(248, 5), enc(isa.SHIFT, isa.SHIFT_SHL, src0=1, src1=5, dst0=1),
        imm(1, 6), imm(208, 5), enc(isa.SHIFT, isa.SHIFT_SHL, src0=6, src1=5, dst0=6),
        enc(isa.BINOP, isa.BINOP_OR, src0=1, src1=6, dst0=1),    # system call, 2^16 ergs
    ]
    cont = len(prog) + 1  # both returns, ok and revert, continue here
    prog += [enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=4, imm0=cont),
             log(isa.LOG_STORAGE_READ, 0, dst0=3),
             enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=iterations, src1=3, dst0=5,
                 flags=set_flags | swap),
             enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=0, condition=isa.COND_NE),
             enc(isa.RET, isa.RET_OK)]
    storage, code_store = {}, {}
    for c in range(4):
        code = callee(c)
        code_hash = (sp.CODE_HASH_VERSION_BYTE << 248) | (len(code) << 224) | (0xC0DE << 8) | c
        storage[(0, sp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, LOG_CALLEE_BASE + c)] = code_hash
        code_store[code_hash] = code
    return words(prog), dict(storage=storage, code_store=code_store)


def _bad(res):
    return [k for k, x in res.items() if not bool(x.all())]


def _forms_equal(a, b):
    if a is None or b is None:
        return a is b
    return all(bool((getattr(a, f.name).cpu() == getattr(b, f.name).cpu()).all())
               for f in dataclasses.fields(a))


def log_path_small(dev):
    """The log path at a small size on the card and on the CPU: every
    circuit's residuals and compact forms equal, all true; the port's entry()
    on the card gives the same verdicts as on the CPU."""
    from zkevm_circuits_tpu_torch import entry
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.runtime import block

    words, kw = log_program(LOG_PATH_SMALL_ITERATIONS)
    v = vm.NativeEraVM(words, LOG_PATH_SMALL_CYCLES, **kw)
    w = v.run()
    sides = [block.log_path(v, w, (LOG_PATH_SMALL_LIMIT, LOG_PATH_SMALL_LIMIT), d)
             for d in (None, torch.device("cpu"))]
    (card, card_h, card_d, want, counts), (cpu, cpu_h, cpu_d, _, _) = sides
    # type 10 on storage_validity's survivors, on both
    for (out, *_), d in zip(sides, (None, torch.device("cpu"))):
        aw, ares, aform, survivors = block.storage_application(out["storage_validity"][0],
                                                               kw["storage"], d)
        out["storage_application"] = (aw, ares, aform)
    root = bytes(np.asarray(card["storage_application"][0].roots[-1].cpu(), "<u4").tobytes())
    if root != _replayed_root(kw["storage"], survivors):
        _fail("log path small: the storage tree's final root is not the replayed root")
    _same_results(card, cpu, "log path small")
    for name in cpu:
        if name != "main_vm" and _first_tensor(card[name][0]).device.type != dev.type:
            _fail(f"log path small: the {name} witness is not on the card")
    if card_h != cpu_h or not all(card_h.values()) or card_d != cpu_d or card_d != want:
        _fail(f"log path small: handoffs {card_h} / {cpu_h}, digests equal "
              f"{card_d == cpu_d == want}")
    fn, (dw,) = entry.entry()
    cfn, (cdw,) = entry.entry(device="cpu")
    got, ref = fn(dw), cfn(cdw)
    if dw["regs"].device.type != dev.type or not torch.equal(got.cpu(), ref) or not bool(got.all()):
        _fail("entry() on the card does not give the CPU's verdicts, all true")
    print(f"log path small: {LOG_PATH_SMALL_CYCLES} cycles, instances of {LOG_PATH_SMALL_LIMIT}, "
          f"{counts}: {len(cpu)} circuits' residuals and compact forms on the card == on the CPU "
          f"(storage application over {len(survivors)} queries included), all true; handoffs "
          f"{sorted(card_h)} true; L1 digest == host keccak; the storage tree's final root == the "
          f"replayed root; entry() on the "
          f"card == on the CPU ({got.shape[0]} verdicts, all true)", flush=True)


def log_probes(out, limits):
    """The five negative probes on the full-width witnesses; each must fail
    exactly the residuals (and rows) that the JAX package fails on the same
    change (held on the CPU by tests/test_torch_log_*.py)."""
    from zkevm_circuits_tpu_torch.models import demux_log_queue as dm
    from zkevm_circuits_tpu_torch.models import linear_hasher as lh
    from zkevm_circuits_tpu_torch.models import log_sorter as ls
    from zkevm_circuits_tpu_torch.models import storage_validity as sv

    sorter_limit = limits[1]

    def expect(res, want, what):
        got = {k: torch.nonzero(~x.reshape(-1)).flatten().tolist()
               for k, x in res.items() if not bool(x.all())}
        if got != want:
            _fail(f"probe {what}: expected {want} to fail, got {got}")
        return got

    svw = out["storage_validity"][0]
    forged, want = probe_storage_written_value(svw)
    got1 = expect(sv.eval_constraints(forged, sv.StorageValidityConfig(limit=sorter_limit)),
                  want, "storage written_value")
    dmw = out["demux_log_queue"][0]
    forged, want = probe_demux_flag(dmw)
    got2 = expect(dm.eval_constraints(forged, dm.DemuxConfig(limit=dmw.execute.shape[0])),
                  want, "demux out-flag")
    ew = out["log_sorter_11"][0]
    forged, want = probe_swapped_events(ew, sorter_limit)
    got3 = expect(ls.eval_constraints(forged, ls.LogSorterConfig(limit=sorter_limit)),
                  want, "swapped events")
    hw = out["linear_hasher"][0]
    forged, want = probe_keccak_lane(hw)
    got4 = expect(lh.eval_constraints(forged, lh.LinearHasherConfig(limit=hw.execute.shape[0])),
                  want, "keccak lane")
    dw, _, forms = out["main_vm"]
    chain, want = probe_vm_boundary(dw, forms, limits[0])
    got5 = expect(chain, want, "VM FSM boundary")
    print(f"log path negative probes: storage written_value fails {got1}; demux out-flag fails "
          f"{got2}; swapped events fail {got3}; keccak lane fails {got4}; VM FSM boundary fails "
          f"{got5}", flush=True)


# --- the negative probes: each returns the changed input and what must fail
# (residual -> failing rows), the same rule the CPU tests hold to the JAX package


def probe_storage_written_value(w):
    """one limb of written_value of the first sorted storage write that is not
    a rollback: its encoding and the cell state it moves to no longer agree"""
    import dataclasses

    s = w.sorted
    row = int(torch.nonzero(w.execute & s.rw_flag & ~s.rollback)[0])
    value = s.written_value.clone()
    value[row, 0] ^= 1
    forged = dataclasses.replace(w, sorted=dataclasses.replace(s, written_value=value))
    return forged, {"encoding_sorted": [row], "cell_state_transitions": [row]}


def probe_demux_flag(w):
    """the out-flag of the first row routed to the events queue, cleared"""
    import dataclasses

    flags = dict(w.out_flags)
    row = int(torch.nonzero(flags["events"])[0])
    flags["events"] = flags["events"].clone()
    flags["events"][row] = False
    return dataclasses.replace(w, out_flags=flags), {
        "flags_events": [row], "chain_events": [row], "count_events": [row]}


def probe_swapped_events(w, limit):
    """two neighbouring sorted events swapped (a witness made from the
    mis-sorted tape): the second of them is out of order and nothing else"""
    import dataclasses

    from zkevm_circuits_tpu_torch.base_structures.log_query import LogQueries
    from zkevm_circuits_tpu_torch.models import log_sorter as ls

    s, n = w.sorted, w.n
    rb = s.rollback[:n].cpu().numpy()
    ts = s.timestamp[:n].cpu().numpy()
    row = next(r for r in range(1, n - 2)
               if not rb[r - 1: r + 3].any() and len(set(ts[r - 1: r + 3])) == 4)
    perm = torch.arange(n, device=s.timestamp.device)
    perm[row], perm[row + 1] = row + 1, row
    swapped = LogQueries(*[getattr(s, f.name)[:n][perm] for f in dataclasses.fields(LogQueries)])
    unsorted = LogQueries(*[getattr(w.unsorted, f.name)[:n] for f in dataclasses.fields(LogQueries)])
    forged = ls.generate_witness(unsorted, swapped, ls.LogSorterConfig(limit=limit))
    return forged, {"sort_order": [row + 1]}


def probe_keccak_lane(w):
    """one lane of the keccak state after the first block: the transitions
    into and out of it fail"""
    import dataclasses

    lo = w.state_lo.clone()
    lo[1, 3] ^= 1
    want = {"keccak_chain": [0, 1] if lo.shape[0] > 2 else [0]}
    if int(w.block_execute.sum()) == 1:  # the digest reads this state's lane 3
        want["digest"] = [0]
    return dataclasses.replace(w, state_lo=lo), want


def probe_vm_boundary(dw, forms, limit):
    """the hidden FSM input of instance 2 commits to a boundary state with a
    changed timestamp: the chaining fails between instances 1 and 2"""
    from zkevm_circuits_tpu_torch.models.vm import compact
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.utils import protocol

    enc = compact.encode_local_state(dw, [2 * limit])
    enc[0, 124] = gf.add(enc[0, 124], gf.ones((), enc.device))  # lane 124: the timestamp
    forged = forms.hidden_fsm_input_commitment.clone()
    forged[2] = protocol.commit_encoding(enc)[0]
    chain = protocol.check_instance_chaining(
        forms.start_flag, forms.completion_flag, forged, forms.hidden_fsm_output_commitment)
    return chain, {"fsm_handoff": [1]}


def log_path_full(dev, card):
    """Phase (a): the log-heavy program for 2^16 cycles through the native
    EraVM, then the block's log and decommit queues on the card, and the
    storage tree (type 10) on storage_validity's survivors."""
    from zkevm_circuits_tpu_torch.models import storage_application as sa
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.runtime import block

    n = 1 << LOG2_LOG_PATH_CYCLES
    words, kw = log_program(LOG_PATH_ITERATIONS)
    t0 = time.perf_counter()
    v = vm.NativeEraVM(words, n, **kw)
    w = v.run()
    sim_s = time.perf_counter() - t0
    limits = (1 << LOG2_LOG_LIMIT, 1 << LOG2_LOG_LIMIT)
    times = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset_counts()
    t0 = time.perf_counter()
    out, handoffs, digest, want, counts = block.log_path(v, w, limits, None, times)
    # type 10 on storage_validity's survivors
    aw, ares, aform, survivors = block.storage_application(
        out["storage_validity"][0], kw["storage"], None, times)
    out["storage_application"] = (aw, ares, aform)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = KERNEL.counts()
    peak = torch.cuda.max_memory_allocated()
    root = bytes(np.asarray(aw.roots[-1].cpu(), "<u4").tobytes())
    if root != _replayed_root(kw["storage"], survivors):
        _fail("storage application: the final root is not the replayed root")
    bad = {name: _bad(res) for name, (_, res, _) in out.items() if _bad(res)}
    if bad:
        _fail(f"log path at 2^{LOG2_LOG_PATH_CYCLES} cycles: residuals {bad} are false")
    if not all(handoffs.values()) or digest != want:
        _fail(f"log path: handoffs {handoffs}, L1 digest == host keccak: {digest == want}")
    forms = out["main_vm"][2]
    if forms.start_flag.shape[0] != n >> LOG2_LOG_LIMIT:
        _fail(f"main_vm: {forms.start_flag.shape[0]} instances, not {n >> LOG2_LOG_LIMIT}")
    for name in ("permutation", "permutation_small"):
        if launches[name] <= 0:
            _fail(f"the log path launched the {name} kernel no time")
    short = [k for k, need in (("storage", 1 << 13), ("events", 1 << 12), ("l1_messages", 1 << 9),
                               ("decommits", 1 << 10)) if counts[k] < need]
    rows = {name: int(x[0].execute.shape[0]) for name, x in out.items()
            if name not in ("main_vm", "storage_application")}
    print(f"log path: host sim 2^{LOG2_LOG_PATH_CYCLES} cycles {sim_s:.3f} s; counts {counts} "
          f"(below the targets: {short or 'none'}); rows a circuit {rows}; instances of "
          f"2^{LOG2_LOG_LIMIT}; seconds "
          + "; ".join(f"{k} {_seconds(x)}" for k, x in times.items())
          + f"; the whole path {path_s:.3f} s; all residuals true; handoffs {sorted(handoffs)} "
          f"true; L1 digest {digest.hex()[:16]}.. == host keccak over {counts['l1_survivors']} "
          f"survivors; Poseidon2 launches over the path {launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB [{card}]", flush=True)
    print(f"storage application: {len(survivors)} queries, {int(aw.row_execute.sum())} stage rows "
          f"of {aw.row_execute.shape[0]}; witness seconds {times['storage_application witness']} "
          f"of which the tree {times['storage_application tree']}; eval "
          f"{times['storage_application eval']}; compact form "
          f"{times['storage_application compact']} (its commitment "
          f"{aform.commitment()[0].tolist()}); final root == the replayed root (a plain "
          f"recursion over the snapshot's and the survivors' leaves) [{card}]", flush=True)
    log_probes(out, limits)
    forged, want = probe_storage_sibling(aw)
    got = _expect(sa.eval_constraints(forged, sa.StorageApplicationConfig(aw.row_execute.shape[0])),
                  want, "storage path sibling")
    print(f"storage application negative probe: a changed path sibling fails {got}", flush=True)
    # what the circuit STARKs of types 4, 10 and 13 prove
    stark_inputs = dict(log_rows=block.block_rows(v)["logs"], hw=out["linear_hasher"][0],
                        l1_hash=digest, aw=aw, vm=(v, w, n))
    return launches, stark_inputs


def event_tapes(n_rows, seed):
    """Seeded event tapes of `n_rows` rows: forward events with increasing
    timestamps, about one in eight followed (in the VM's order, at the end of
    its block of 64) by its rollback; returns (unsorted, sorted) column dicts."""
    from zkevm_circuits_tpu_torch.isa import system_params as sp

    rng = np.random.default_rng(seed)
    forward = n_rows * 8 // 9
    reverted = rng.random(forward) < 1 / 8
    while forward + int(reverted.sum()) > n_rows:
        reverted[np.flatnonzero(reverted)[-1]] = False
    ts = np.cumsum(rng.integers(1, 4, size=forward)).astype(np.uint32) + 1024
    order, rollback = [], []
    for start in range(0, forward, 64):
        block = np.arange(start, min(start + 64, forward))
        order += block.tolist() + block[reverted[block]][::-1].tolist()
        rollback += [False] * len(block) + [True] * int(reverted[block].sum())
    order, rollback = np.asarray(order), np.asarray(rollback)
    n = len(order)
    cols = dict(
        address=rng.integers(0, 1 << 32, size=(forward, 5), dtype=np.uint64).astype(np.uint32),
        key=rng.integers(0, 1 << 32, size=(forward, 8), dtype=np.uint64).astype(np.uint32),
        written_value=rng.integers(0, 1 << 32, size=(forward, 8), dtype=np.uint64).astype(np.uint32),
        tx_number_in_block=(np.arange(forward) // 256).astype(np.uint32),
        timestamp=ts,
    )
    unsorted = {k: v[order] for k, v in cols.items()}
    unsorted.update(
        read_value=np.zeros((n, 8), np.uint32),
        aux_byte=np.full(n, sp.EVENT_AUX_BYTE, np.uint32),
        rw_flag=np.ones(n, bool), rollback=rollback, is_service=np.zeros(n, bool),
        shard_id=np.zeros(n, np.uint32),
    )
    perm = np.lexsort((unsorted["rollback"], unsorted["timestamp"]))
    return unsorted, {k: v[perm] for k, v in unsorted.items()}


def log_sorter_full(dev, card):
    """Phase (b): the events sorter at 2^18 rows in 4 instances, from numpy
    tapes through the host pipeline, then its evaluation and compact forms."""
    from zkevm_circuits_tpu_torch.models import log_sorter as ls
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.runtime import native

    n_rows = (1 << LOG2_LOG_SORTER_ROWS) - 1
    unsorted, sorted_t = event_tapes(n_rows, 18)
    cfg = ls.LogSorterConfig(limit=1 << LOG2_LOG_SORTER_LIMIT)
    spent = []
    chains = native.narrow_chains

    def timed_chains(*args):
        t0 = time.perf_counter()
        try:
            return chains(*args)
        finally:
            spent.append(time.perf_counter() - t0)

    native.narrow_chains = timed_chains
    try:
        torch.cuda.synchronize()
        KERNEL.reset_counts()
        t0 = time.perf_counter()
        w = ls.generate_witness_host_tapes(unsorted, sorted_t, cfg)
        torch.cuda.synchronize()
        witness_s = time.perf_counter() - t0
        witness_launches = KERNEL.counts()
    finally:
        native.narrow_chains = chains
    total = w.execute.shape[0]
    if total != 1 << LOG2_LOG_SORTER_ROWS or w.enc_sorted.device.type != dev.type:
        _fail(f"log sorter witness: {total} rows on {w.enc_sorted.device}")
    first_s, steady_s, launches, res, peak = timed_evals(lambda: ls.eval_constraints(w, cfg), KERNEL)
    if _bad(res):
        _fail(f"log sorter at 2^{LOG2_LOG_SORTER_ROWS} rows: residuals {_bad(res)} are false")
    KERNEL.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forms = ls.instance_compact_forms(w, cfg)
    torch.cuda.synchronize()
    forms_s = time.perf_counter() - t0
    launches = {k: witness_launches[k] + launches[k] + v for k, v in KERNEL.counts().items()}
    if forms.start_flag.shape[0] != 1 << (LOG2_LOG_SORTER_ROWS - LOG2_LOG_SORTER_LIMIT):
        _fail(f"log sorter: {forms.start_flag.shape[0]} instances")
    print(f"log sorter: 2^{LOG2_LOG_SORTER_ROWS} rows ({w.n} executed, "
          f"{int(w.sorted.rollback.sum())} of them rollbacks, {int(w.result_count[-1])} "
          f"survivors), "
          f"{forms.start_flag.shape[0]} instances of 2^{LOG2_LOG_SORTER_LIMIT}; witness "
          f"{witness_s:.3f} s of which host chains {sum(spent):.3f} s; eval_constraints first "
          f"{first_s:.4f} s, steady {steady_s:.4f} s ({total / steady_s:.1f} rows/s), "
          f"{len(res)} residuals all true; compact forms {forms_s:.4f} s; kernel launches of the "
          f"witness, one evaluation and the compact forms {launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB [{card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# the block's memory thread (runtime/block2.py:257-381 of the JAX package): a
# precompile-heavy EraVM run, then the decommit sorter, the code unpacker,
# the keccak, sha256 and ecrecover circuits, each continuing the global
# memory queue, and ram_permutation over the union of their memory traffic
# ---------------------------------------------------------------------------


def _pad_code(words, n_words, constants=()):
    """a bytecode padded with zero words to `n_words` (odd), `constants`
    (index, value) placed in the padding, where SRC_CODE operands read them."""
    if len(words) > n_words - len(constants) or n_words % 2 == 0:
        raise ValueError(f"{len(words)} code words do not fit {n_words}")
    out = list(words) + [0] * (n_words - len(words))
    for idx, value in constants:
        if idx < len(words):
            raise ValueError(f"constant {idx} overlaps the code")
        out[idx] = value
    return out


def _mem_key(in_off=0, length=0, out_off=0, page=0, rounds=0):
    """a precompile ABI key: limbs [0] input offset, [1] input length, [2]
    output offset, [4] input page, [5] output page, [6] sha256 rounds."""
    return in_off | length << 32 | out_off << 64 | page << 128 | page << 160 | rounds << 192


def _sha_padded(message):
    """a message with sha256's padding, the input a pre-padded sha256 call takes."""
    bitlen = len(message) * 8
    padded = message + b"\x80" + b"\x00" * ((55 - len(message)) % 64)
    return padded + bitlen.to_bytes(8, "big")


def memory_program(iterations, seed=0, log2_code_words=LOG2_CALLEE_CODE_WORDS):
    """A bootloader loop of `iterations` far calls into one of eight worker
    callees (iteration i: worker i & 7, each from the code store, its code
    padded to 2^9 + 1 words, so that the unpacker has 257 rounds a worker);
    worker c keccak-hashes KECCAK_LENGTHS[c] bytes (64 bytes, the
    mapping-slot hash, up to 4 x 136) at an unaligned offset of a 2^10-word
    random region of the bootloader heap, sha256-hashes one of four
    pre-padded messages of c + 1 blocks, and worker 0 (every 8th iteration)
    recovers the signer of the next of the heap's signatures, one in 16 of
    them invalid (a high s, an x off the curve, r = 0).  A precompile call
    comes from the contract at its formal address: each worker far-calls the
    three precompile contracts (padded as well) with the call's ABI key in
    r3; every digest lands in an output region of the bootloader heap.  The
    bootloader keeps its loop counter in heap word 0, the workers take their
    256-bit constants from their own code page (SRC_CODE operands).  About
    39 cycles an iteration.

    `log2_code_words` sets the padding (2^9 on the card; the CPU tests take
    less).  Returns (code words, EraVM keyword arguments, host) where host
    holds what the program laid out: the heap as {word: value}, the
    signatures as (h, v, r, s) and the sha256 messages by their first word."""
    from zkevm_circuits_tpu_torch.isa import opcodes as isa
    from zkevm_circuits_tpu_torch.isa import system_params as sp
    from zkevm_circuits_tpu_torch.models import code_unpacker_sha256 as cu
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.ops import secp256k1 as ec

    enc = isa.encode_instruction
    set_flags = 1 << isa.SET_FLAGS_FLAG_IDX
    swap = 1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES
    page = sp.BOOTLOADER_HEAP_PAGE
    n_words = (1 << log2_code_words) + 1
    abi_slot, key_slot = n_words - 2, n_words - 3  # constants in the padding

    def imm(v, dst):
        return enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=v, src1=0, dst0=dst)

    def addi(v, src, dst):
        return enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=v, src1=src, dst0=dst)

    def andi(v, src, dst):
        return enc(isa.BINOP, isa.BINOP_AND, src_mode=isa.SRC_IMM, imm0=v, src1=src, dst0=dst)

    def code(slot, dst, src1=0):  # dst = code[slot] + src1
        return enc(isa.ADD, src_mode=isa.SRC_CODE, imm0=slot, src1=src1, dst0=dst)

    def shift(variant, src, amount_reg, dst):
        return enc(isa.SHIFT, variant, src0=src, src1=amount_reg, dst0=dst)

    def heap_read(dst):  # heap word 0
        return enc(isa.UMA, isa.UMA_HEAP_READ, src0=0, dst0=dst)

    def far_call(address, cont):
        return [imm(address, 4), enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=4, imm0=cont)]

    # the ABI of every far call: a system call (r3..r11 reach the callee) with 2^20 ergs
    abi = (1 << 248) | (1 << (192 + 20))
    # out words: 4 an iteration, keccak +0, sha256 +1, ecrecover +2 and +3
    out_base = MEM_OUT_WORD

    def worker(c):
        rounds = c + 1
        sha_base = MEM_SHA_WORD + 4 * rounds * (rounds - 1)  # four variants of 2R words
        consts = [(abi_slot, abi),
                  (key_slot, _mem_key(MEM_DATA_WORD * 32, KECCAK_LENGTHS[c], out_base, page)),
                  (key_slot - 1, _mem_key(sha_base, 0, out_base + 1, page, rounds)),
                  (key_slot - 2, _mem_key(MEM_SIG_WORD, 0, out_base + 2, page))]
        prog = [enc(isa.UMA, isa.UMA_HEAP_WRITE, src0=0, src1=3),  # keep i in heap word 0
                imm(66, 6)]
        # r7 = i << 66: the output word offset 4i, in limb 2
        prog += [shift(isa.SHIFT_SHL, 3, 6, 7)]
        # keccak: byte offset (41 i) & 0x3FFF into the data region
        prog += [enc(isa.MUL, src_mode=isa.SRC_IMM, imm0=41, src1=3, dst0=10, dst1=11),
                 andi(0x3FFF, 10, 10), code(key_slot, 10, 10),
                 enc(isa.ADD, src0=10, src1=7, dst0=3), code(abi_slot, 1)]
        prog += far_call(sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS, len(prog) + 2)
        # sha256: message variant (i >> 3) & 3, 2R words each
        prog += [heap_read(3), imm(3, 6), shift(isa.SHIFT_SHR, 3, 6, 10), andi(3, 10, 10),
                 enc(isa.MUL, src_mode=isa.SRC_IMM, imm0=2 * rounds, src1=10, dst0=10, dst1=11),
                 imm(66, 6), shift(isa.SHIFT_SHL, 3, 6, 7), code(key_slot - 1, 10, 10),
                 enc(isa.ADD, src0=10, src1=7, dst0=3), code(abi_slot, 1)]
        prog += far_call(sp.SHA256_PRECOMPILE_FORMAL_ADDRESS, len(prog) + 2)
        if c == 0:
            # ecrecover: signature i >> 3, 4 words each
            prog += [heap_read(3), imm(1, 6), shift(isa.SHIFT_SHR, 3, 6, 10),
                     andi(0xFFFC, 10, 10), imm(66, 6), shift(isa.SHIFT_SHL, 3, 6, 7),
                     code(key_slot - 2, 10, 10), enc(isa.ADD, src0=10, src1=7, dst0=3),
                     code(abi_slot, 1)]
            prog += far_call(sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS, len(prog) + 2)
        prog += [enc(isa.RET, isa.RET_OK)]
        return _pad_code(vm.assemble_code_words(prog), n_words, consts)

    precompile = [enc(isa.LOG, isa.LOG_PRECOMPILE_CALL, src0=3, src1=0), enc(isa.RET, isa.RET_OK)]
    storage, code_store = {}, {}

    def deploy(address, words):
        code_hash = cu.make_request(words, 0, 0)["code_hash"]
        storage[(0, sp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, address)] = code_hash
        code_store[code_hash] = words

    for c in range(8):
        deploy(MEM_CALLEE_BASE + c, worker(c))
    for k, address in enumerate((sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS,
                                 sp.SHA256_PRECOMPILE_FORMAL_ADDRESS,
                                 sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS)):
        deploy(address, _pad_code(vm.assemble_code_words(precompile), n_words, [(n_words - 1, k)]))

    boot_abi_slot = n_words - 2
    cont = 7
    boot = [heap_read(3), addi(1, 3, 3), enc(isa.UMA, isa.UMA_HEAP_WRITE, src0=0, src1=3),
            andi(7, 3, 4), addi(MEM_CALLEE_BASE, 4, 4), code(boot_abi_slot, 1),
            enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=4, imm0=cont),
            heap_read(3),
            enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=iterations, src1=3, dst0=5,
                flags=set_flags | swap),
            enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=0, condition=isa.COND_NE),
            enc(isa.RET, isa.RET_OK)]
    boot_words = _pad_code(vm.assemble_code_words(boot), n_words, [(boot_abi_slot, abi)])

    # the bootloader heap: random data, the pre-padded sha256 messages, the signatures
    rng = np.random.default_rng(seed)
    heap = {MEM_DATA_WORD + k: int.from_bytes(rng.bytes(32), "big") for k in range(MEM_DATA_WORDS)}
    sha_messages = {}
    for rounds in range(1, 9):
        for variant in range(4):
            msg = rng.bytes(64 * rounds - 9 - variant)
            padded = _sha_padded(msg)
            base = MEM_SHA_WORD + 4 * rounds * (rounds - 1) + 2 * rounds * variant
            sha_messages[base] = msg
            for j in range(2 * rounds):
                heap[base + j] = int.from_bytes(padded[32 * j: 32 * j + 32], "big")
    sigs = []
    for k in range(iterations // 8 + 2):
        h = int.from_bytes(rng.bytes(32), "big")
        r, s, recid = ec.sign(h, int(rng.integers(1, 1 << 62)), int(rng.integers(1, 1 << 62)))
        if k % 16 == 15:  # one in 16 fails: a high s, an x off the curve, r = 0
            kind = (k // 16) % 3
            if kind == 0:
                s, recid = ec.N - s, recid ^ 1
            elif kind == 1:
                while ec.lift_x(r, False) is not None:
                    r += 1
            else:
                r = 0
        sigs.append((h, recid, r, s))
        for j, value in enumerate(sigs[-1]):
            heap[MEM_SIG_WORD + 4 * k + j] = value
    return (boot_words, dict(storage=storage, code_store=code_store, bootloader_heap=heap),
            dict(heap=heap, sigs=sigs, sha_messages=sha_messages))


def block_program(iterations, seed=0, log2_code_words=LOG2_CALLEE_CODE_WORDS, tag=1):
    """The whole block's program: a bootloader loop of `iterations` rounds,
    round i (from 1) a far call into `log_program`'s callee i & 3 (storage
    writes and reads, four events, an L1 message every 2nd round, a revert
    every 8th call), then one into `memory_program`'s worker i & 7 (one call
    of the keccak and of the sha256 precompile, worker 0 one of ecrecover as
    well).  The loop counter lives in bootloader heap word 0, so a block that
    starts from another block's final storage runs the same rounds and
    writes the same cells again; after the loop the bootloader writes `tag`
    to its storage cell BLOCK_TAG_KEY and reads it back.  About 72 cycles a
    round: 2^16 cycles carry about half of `log_program`'s and half of
    `memory_program`'s traffic.  Returns (code words, EraVM keyword
    arguments, host) as `memory_program`."""
    from zkevm_circuits_tpu_torch.isa import opcodes as isa
    from zkevm_circuits_tpu_torch.models import code_unpacker_sha256 as cu
    from zkevm_circuits_tpu_torch.models import vm

    _, log_kw = log_program(iterations)
    _, mem_kw, host = memory_program(iterations, seed, log2_code_words)
    # the log callees under their real code hashes: the unpacker checks them
    storage, code_store = dict(mem_kw["storage"]), dict(mem_kw["code_store"])
    for key, code_hash in log_kw["storage"].items():
        code = log_kw["code_store"][code_hash]
        storage[key] = cu.make_request(code, 0, 0)["code_hash"]
        code_store[storage[key]] = code
    enc = isa.encode_instruction
    set_flags = 1 << isa.SET_FLAGS_FLAG_IDX
    swap = 1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES
    n_words = (1 << log2_code_words) + 1
    abi_slot = n_words - 2
    abi = (1 << 248) | (1 << (192 + 20))  # a system call with 2^20 ergs

    def heap_read(dst):
        return enc(isa.UMA, isa.UMA_HEAP_READ, src0=0, dst0=dst)

    def call(base, mask, cont):
        return [enc(isa.BINOP, isa.BINOP_AND, src_mode=isa.SRC_IMM, imm0=mask, src1=3, dst0=4),
                enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=base, src1=4, dst0=4),
                enc(isa.ADD, src_mode=isa.SRC_CODE, imm0=abi_slot, src1=0, dst0=1),
                enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=4, imm0=cont)]

    boot = [heap_read(3), enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=1, src1=3, dst0=3),
            enc(isa.UMA, isa.UMA_HEAP_WRITE, src0=0, src1=3)]
    boot += call(LOG_CALLEE_BASE, 3, len(boot) + 4)
    boot += [heap_read(3)]
    boot += call(MEM_CALLEE_BASE, 7, len(boot) + 4)
    boot += [heap_read(3),
             enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=iterations, src1=3, dst0=5,
                 flags=set_flags | swap),
             enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=0, condition=isa.COND_NE),
             enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=BLOCK_TAG_KEY, src1=0, dst0=2),
             enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=tag, src1=0, dst0=3),
             enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=2, src1=3),
             enc(isa.LOG, isa.LOG_STORAGE_READ, src0=2, dst0=4),
             enc(isa.RET, isa.RET_OK)]
    boot_words = _pad_code(vm.assemble_code_words(boot), n_words, [(abi_slot, abi)])
    return boot_words, dict(storage=storage, code_store=code_store,
                            bootloader_heap=mem_kw["bootloader_heap"]), host


def precompile_outputs(out, host):
    """Every keccak, sha256 and ecrecover output word of the memory thread
    against the host's `keccak256_ref`, `sha256_ref` and `secp256k1.recover`
    (low s only, the circuit's convention) on the payload the program laid
    out; returns the number of outputs checked, or fails."""
    from zkevm_circuits_tpu_torch.ops import secp256k1 as ec
    from zkevm_circuits_tpu_torch.ops.keccak import keccak256_ref
    from zkevm_circuits_tpu_torch.ops.sha256 import sha256_ref

    def value(limbs):
        return sum(int(x) << (32 * k) for k, x in enumerate(limbs.tolist()))

    def limbs(call):
        key = int(call["key"])
        return [(key >> (32 * k)) & 0xFFFFFFFF for k in range(8)]

    heap, sigs, sha_messages = host["heap"], host["sigs"], host["sha_messages"]
    checked = 0
    if "keccak256" in out:
        w = out["keccak256"][0]
        for ci in range(w.num_calls):
            off, length = limbs(_row(w.calls, ci))[:2]
            data = b"".join(heap.get(i, 0).to_bytes(32, "big")
                            for i in range(off // 32, (off + max(length, 1) - 1) // 32 + 1))
            want = keccak256_ref(data[off % 32: off % 32 + length])
            if value(w.writes.value[ci]) != int.from_bytes(want, "big"):
                _fail(f"keccak call {ci}: the circuit's digest is not the host keccak")
            checked += 1
    if "sha256" in out:
        w = out["sha256"][0]
        for ci in range(w.num_calls):
            digest = sha256_ref(sha_messages[limbs(_row(w.calls, ci))[0]])
            want = sum(int.from_bytes(digest[4 * k: 4 * k + 4], "little") << (32 * (7 - k))
                       for k in range(8))
            if value(w.writes.value[ci]) != want:
                _fail(f"sha256 call {ci}: the circuit's digest is not the host sha256")
            checked += 1
    if "ecrecover" in out:
        w = out["ecrecover"][0]
        for ci in range(w.num_calls):
            h, v, r, s = sigs[(limbs(_row(w.calls, ci))[0] - MEM_SIG_WORD) // 4]
            q = ec.recover(h, r, s, v & 0xFF) if s < (ec.N - 1) // 2 else None
            want = (1, ec.eth_address(q)) if q is not None else (0, 0)
            got = (value(w.writes.value[2 * ci]), value(w.writes.value[2 * ci + 1]))
            if got != want:
                _fail(f"ecrecover call {ci}: the circuit writes {got}, the host recovers {want}")
            checked += 2
    return checked


def _row(q, i):
    """row i of a query batch as a dict of python ints."""
    from zkevm_circuits_tpu_torch.runtime import block

    return block.soa_rows(q[i: i + 1], torch.ones(1, dtype=torch.bool))[0]


# ---------------------------------------------------------------------------
# storage application (runtime/block2.py:405-431): the storage tree after
# the log path's storage_validity
# ---------------------------------------------------------------------------


def _replayed_root(storage, survivors):
    """The root of the tree the survivors leave, computed apart from the
    port's tree: the leaves (the snapshot's nonzero rollup cells, indices from
    1 in key order, then each write of a fresh cell the next index, a write of
    a known cell keeping its index), hashed with hashlib's blake2s by a plain
    recursion over the leaf positions, with no node cache."""
    import hashlib

    def h(data):
        return hashlib.blake2s(data).digest()

    def position(address, key):  # path bit i of the derived key is bit i here
        return int.from_bytes(h(b"\x00" * 12 + address.to_bytes(20, "big")
                                + key.to_bytes(32, "big")), "little")

    leaves = {}
    for (shard, address, key), value in sorted(storage.items()):
        if shard == 0 and value != 0:
            leaves[position(address, key)] = (len(leaves) + 1, value)
    counter = len(leaves) + 1
    for q in survivors:
        if q["rw_flag"]:
            p = position(q["address"], q["key"])
            if p in leaves:
                leaves[p] = (leaves[p][0], q["written_value"])
            else:
                leaves[p] = (counter, q["written_value"])
                counter += 1
    empty = [h(bytes(40))]  # the leaf of index 0, value 0
    for _ in range(256):
        empty.append(h(empty[-1] + empty[-1]))

    def node(level, items):  # items: (position, leaf hash) under this node
        if not items:
            return empty[level]
        if level == 0:
            return items[0][1]
        left = [x for x in items if not x[0] >> (level - 1) & 1]
        right = [x for x in items if x[0] >> (level - 1) & 1]
        return h(node(level - 1, left) + node(level - 1, right))

    return node(256, [(p, h(i.to_bytes(8, "big") + v.to_bytes(32, "big")))
                      for p, (i, v) in leaves.items()])


def probe_storage_sibling(w):
    """one limb of a sibling at level 10 of the path of a read stage whose
    write stage follows: that level of the read row fails its parent, and the
    write row no longer carries the read row's path"""
    s = w.row_is_write_stage.cpu().numpy()
    row = int(np.flatnonzero(s)[0]) - 1
    path = w.row_path.clone()
    path[row, 10, 0] ^= 1
    return dataclasses.replace(w, row_path=path), {"merkle_path": [row], "write_same_path": [row + 1]}


# ---------------------------------------------------------------------------
# eip_4844 (runtime/block2.py:470-493, models/eip_4844.py:31): two blobs
# ---------------------------------------------------------------------------


def blob_inputs(elements, seed):
    """`elements` seeded random 31-byte chunks and a versioned hash."""
    rng = np.random.default_rng(seed)
    return [rng.bytes(31) for _ in range(elements)], rng.bytes(32)


def blob_host(chunks, versioned_hash):
    """(linear hash, output hash) recomputed on the host: keccak of the blob,
    z from keccak(linear hash || versioned hash), Horner over the chunks
    (highest degree first) mod the BLS12-381 scalar field."""
    from zkevm_circuits_tpu_torch.models.eip_4844 import BLS_FR
    from zkevm_circuits_tpu_torch.ops.keccak import keccak256_ref

    linear = keccak256_ref(b"".join(chunks))
    truncated = keccak256_ref(linear + versioned_hash)[16:]
    z = int.from_bytes(truncated, "big")
    y = 0
    for i, c in enumerate(chunks):
        y = (y + int.from_bytes(c, "little")) % BLS_FR
        if i != len(chunks) - 1:
            y = y * z % BLS_FR
    return linear, keccak256_ref(versioned_hash + truncated + y.to_bytes(32, "big"))


def probe_blob_coefficient(w):
    """one limb of one coefficient: its chunk and its Horner addition fail"""
    fe = w.fe.clone()
    fe[5, 0] ^= 1
    return dataclasses.replace(w, fe=fe), {"fe_from_chunks": [5], "horner_add": [5]}


# --- the memory thread's negative probes (held on the CPU to the JAX
# package's verdict by tests/test_torch_memory_thread.py)


def probe_sha256_state(w):
    """one word of the state after a round that is not its call's last: that
    compression and the next round's continuity fail"""
    ok = (w.round_execute & ~w.round_is_last).cpu().numpy()
    row = int(np.flatnonzero(ok)[0])
    after = w.state_after.clone()
    after[row, 0] ^= 1
    return dataclasses.replace(w, state_after=after), {
        "compress_transitions": [row], "state_continuity": [row + 1]}


def probe_keccak_digest(w):
    """one byte of one call's digest: its last block's extraction and its
    memory write fail"""
    call = w.num_calls - 1
    row = int(torch.nonzero(w.block_execute & w.block_is_last)[call])
    dig = w.digests.clone()
    dig[call, 0] ^= 1
    return dataclasses.replace(w, digests=dig), {
        "digest_extraction": [row], "write_value_is_digest": [call]}


def probe_code_word(w):
    """one limb of an unpacked code word: its block and its memory write fail"""
    row = int(w.round_execute.sum()) // 2
    word0 = w.word0.clone()
    word0[row, 3] ^= 1
    return dataclasses.replace(w, word0=word0), {"block_construction": [row], "write_word0": [row]}


def probe_ecrecover_ladder(w):
    """one limb of the accumulator after a step of the first running ladder
    that adds: that addition and the next step's continuity fail"""
    from zkevm_circuits_tpu_torch.models.ecrecover import BITS

    st = w.steps
    idx = torch.arange(w.step_execute.shape[0], device=w.step_execute.device)
    adds = w.step_execute & (st["bit"] == 1) & (st["acc_inf"] == 0) & (idx % BITS < BITS - 1)
    row = int(torch.nonzero(adds)[0])
    steps = dict(st)
    steps["acc_nx"] = st["acc_nx"].clone()
    steps["acc_nx"][row, 0] ^= 1
    return dataclasses.replace(w, steps=steps), {"add_steps": [row], "step_continuity": [row + 1]}


def probe_keccak_boundary(w, cfg, limit):
    """the hidden FSM input of keccak instance 2 commits to a boundary with a
    changed state lane: the chaining fails between instances 1 and 2"""
    from zkevm_circuits_tpu_torch.models import keccak256_round_function as kc
    from zkevm_circuits_tpu_torch.utils import protocol

    forms = kc.instance_compact_forms(w, cfg, limit)
    lo = w.state_lo.clone()
    lo[2 * limit, 0] ^= 1
    forged = kc.instance_compact_forms(dataclasses.replace(w, state_lo=lo), cfg, limit)
    fsm_in = forms.hidden_fsm_input_commitment.clone()
    fsm_in[2] = forged.hidden_fsm_input_commitment[2]
    chain = protocol.check_instance_chaining(forms.start_flag, forms.completion_flag, fsm_in,
                                             forms.hidden_fsm_output_commitment)
    return chain, {"fsm_handoff": [1]}


def _first_tensor(wit):
    return next(getattr(wit, f.name) for f in dataclasses.fields(wit)
                if isinstance(getattr(wit, f.name), torch.Tensor))


def _expect(res, want, what):
    got = {k: torch.nonzero(~x.reshape(-1)).flatten().tolist()
           for k, x in res.items() if not bool(x.all())}
    if got != want:
        _fail(f"probe {what}: expected {want} to fail, got {got}")
    return got


def memory_probes(out, limits):
    """The five negative probes of the memory thread on its witnesses, each
    failing exactly where the JAX package fails (tests/test_torch_memory_thread.py)."""
    from zkevm_circuits_tpu_torch.models import code_unpacker_sha256 as cu
    from zkevm_circuits_tpu_torch.models import ecrecover as ecr
    from zkevm_circuits_tpu_torch.models import keccak256_round_function as kc
    from zkevm_circuits_tpu_torch.models import sha256_round_function as sh

    got = {}
    w = out["sha256"][0]
    forged, want = probe_sha256_state(w)
    got["sha256 state word"] = _expect(sh.eval_constraints(
        forged, sh.Sha256RoundFunctionConfig(w.round_execute.shape[0])), want, "sha256 state")
    w = out["keccak256"][0]
    cfg = kc.KeccakRoundFunctionConfig(w.block_execute.shape[0], w.reads.shape[0])
    forged, want = probe_keccak_digest(w)
    got["keccak digest byte"] = _expect(kc.eval_constraints(forged, cfg), want, "keccak digest")
    chain, want = probe_keccak_boundary(w, cfg, limits[1])
    got["keccak FSM boundary"] = _expect(chain, want, "keccak FSM boundary")
    w = out["code_unpacker"][0]
    forged, want = probe_code_word(w)
    got["unpacked code word"] = _expect(cu.eval_constraints(
        forged, cu.CodeUnpackerConfig(w.round_execute.shape[0])), want, "code word")
    w = out["ecrecover"][0]
    forged, want = probe_ecrecover_ladder(w)
    got["ecrecover ladder limb"] = _expect(ecr.eval_constraints(
        forged, ecr.EcrecoverConfig(w.call_execute.shape[0])), want, "ecrecover ladder")
    return got


def _same_results(card, cpu, what):
    """every circuit's residuals and compact forms on the card equal the CPU's"""
    for name in cpu:
        if list(card[name][1]) != list(cpu[name][1]):
            _fail(f"{what}: {name} residual keys differ between the card and the CPU")
        for k, x in card[name][1].items():
            if not torch.equal(x.cpu(), cpu[name][1][k]):
                _fail(f"{what}: {name} residual {k} on the card differs from the CPU's")
        if not _forms_equal(card[name][2], cpu[name][2]):
            _fail(f"{what}: {name} compact forms on the card differ from the CPU's")
        if _bad(cpu[name][1]):
            _fail(f"{what}: {name} residuals {_bad(cpu[name][1])} are false")


def memory_thread_small(dev):
    """The memory thread and eip_4844 at small sizes on the card and on the
    CPU: every residual and compact form equal, all true, every handoff
    true, every precompile output the host's."""
    from zkevm_circuits_tpu_torch.models import eip_4844 as e44
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.runtime import block

    words, kw, host = memory_program(MEM_SMALL_ITERATIONS, 1, MEM_SMALL_LOG2_CODE_WORDS)
    v = vm.NativeEraVM(words, MEM_SMALL_CYCLES, **kw)
    w = v.run()
    sides = [block.memory_thread(v, w, kw["code_store"], MEM_SMALL_LIMITS, d)
             for d in (None, torch.device("cpu"))]
    (card, card_h, counts), (cpu, cpu_h, _) = sides
    _same_results(card, cpu, "memory thread small")
    if card_h != cpu_h or not all(card_h.values()):
        _fail(f"memory thread small: handoffs {card_h} / {cpu_h}")
    for name in card:
        wit = card[name][0]
        lead = wit["ts"] if name == "main_vm" else _first_tensor(wit)
        if lead.device.type != dev.type:
            _fail(f"memory thread small: the {name} witness is not on the card")
    checked = precompile_outputs(card, host)

    chunks, vh = blob_inputs(MEM_SMALL_BLOB, 7)
    cfg = e44.EIP4844Config(elements=MEM_SMALL_BLOB)
    blobs = []
    for d in (None, torch.device("cpu")):
        bw = e44.generate_witness(chunks, vh, cfg, device=d)
        blobs.append({"eip_4844": (bw, e44.eval_constraints(bw, cfg), e44.instance_compact_form(bw, cfg))})
    _same_results(blobs[0], blobs[1], "eip_4844 small")
    print(f"memory thread small: {MEM_SMALL_CYCLES} cycles, {counts}, instances of "
          f"{MEM_SMALL_LIMITS}: {len(cpu)} circuits' residuals and compact forms on the card == "
          f"on the CPU, all true; handoffs {sorted(card_h)} true; {checked} precompile outputs == "
          f"the host's; eip_4844 ({MEM_SMALL_BLOB} elements) on the card == on the CPU, all "
          f"true", flush=True)


def memory_thread_full(dev, card):
    """Phase (c): the precompile-heavy program for 2^16 cycles through the
    native EraVM, then the memory thread on the card."""
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.runtime import block

    n = 1 << LOG2_MEM_CYCLES
    words, kw, host = memory_program(MEM_ITERATIONS)
    t0 = time.perf_counter()
    v = vm.NativeEraVM(words, n, **kw)
    w = v.run()
    sim_s = time.perf_counter() - t0
    times = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset_counts()
    t0 = time.perf_counter()
    out, handoffs, counts = block.memory_thread(v, w, kw["code_store"], MEM_LIMITS, None, times)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = KERNEL.counts()
    peak = torch.cuda.max_memory_allocated()
    bad = {name: _bad(res) for name, (_, res, _) in out.items() if _bad(res)}
    if bad:
        _fail(f"memory thread at 2^{LOG2_MEM_CYCLES} cycles: residuals {bad} are false")
    if not all(handoffs.values()):
        _fail(f"memory thread: handoffs {handoffs}")
    checked = precompile_outputs(out, host)
    if launches["permutation"] + launches["permutation_small"] <= 0:
        _fail("the memory thread launched no Poseidon2 kernel")
    short = [k for k, need in (("keccak_blocks", 1 << 11), ("sha256_rounds", 1 << 11),
                               ("unpacker_rounds", 1 << 11), ("ecrecover_calls", 1 << 6))
             if counts.get(k, 0) < need]
    print(f"memory thread: host sim 2^{LOG2_MEM_CYCLES} cycles {sim_s:.3f} s; counts {counts} "
          f"(below the targets: {short or 'none'}); instances {MEM_LIMITS}; seconds "
          + "; ".join(f"{k} {_seconds(x)}" for k, x in times.items())
          + f"; the whole thread {path_s:.3f} s; all residuals true; handoffs {sorted(handoffs)} "
          f"true; {checked} precompile outputs == the host's keccak256 / sha256 / recover; "
          f"Poseidon2 launches over the thread {launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB [{card}]", flush=True)
    got = memory_probes(out, MEM_LIMITS)
    print("memory thread negative probes: " + "; ".join(f"{k} fails {x}" for k, x in got.items()),
          flush=True)
    # what the circuit STARKs of types 3, 5, 6 and 7 prove
    stark_inputs = dict(uw=out["code_unpacker"][0], sw=out["sha256"][0], kw=out["keccak256"][0],
                        ew=out["ecrecover"][0], kcalls=v.precompile_calls["keccak"],
                        memory=v.precompile_memory)
    return launches, stark_inputs


def eip_4844_full(dev, card):
    """Phase (d): two blobs of 4096 elements, the two a block may carry."""
    from zkevm_circuits_tpu_torch.models import eip_4844 as e44
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.runtime import block

    cfg = e44.EIP4844Config()
    times, hashes, blobs = {}, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset_counts()
    for b in range(2):
        chunks, vh = blob_inputs(cfg.elements, 100 + b)
        bw = block.stage(times, f"blob {b} witness", lambda: e44.generate_witness(chunks, vh, cfg),
                         2)
        blobs.append((bw, chunks, vh, cfg.elements))
        res = block.stage(times, f"blob {b} eval", lambda: e44.eval_constraints(bw, cfg), 2)
        block.stage(times, f"blob {b} compact", lambda: e44.instance_compact_form(bw, cfg), 2)
        if _bad(res) or bw.chunks.device.type != dev.type:
            _fail(f"eip_4844 blob {b}: residuals {_bad(res)} are false, or not on the card")
        got = (bytes(bw.linear_hash.cpu().tolist()), bytes(bw.output_hash.cpu().tolist()))
        if got != blob_host(chunks, vh):
            _fail(f"eip_4844 blob {b}: the hashes are not the host's")
        hashes.append(got[1].hex()[:16])
        if b == 0:
            forged, want = probe_blob_coefficient(bw)
            probe = _expect(e44.eval_constraints(forged, cfg), want, "eip_4844 coefficient")
    torch.cuda.synchronize()
    launches = KERNEL.counts()
    print(f"eip_4844: two blobs of {cfg.elements} elements; seconds first / steady "
          + "; ".join(f"{k} {_seconds(x)}" for k, x in times.items())
          + f"; all residuals true; linear and output hashes == the host's (output {hashes}); "
          f"a changed coefficient fails {probe}; Poseidon2 launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]", flush=True)
    return launches, blobs


def _air_residuals(air, cols, public, ch):
    """`air_common.residuals` of the columns as one u64 array, zero where
    every constraint holds."""
    from zkevm_circuits_tpu_torch.prover.air_common import residuals

    return np.concatenate([v.reshape(-1) for v in residuals(air, cols, public, ch).values()])


def _stark_params(log_n):
    """The small references' pinned params: few queries, so that the CPU
    side takes seconds."""
    from zkevm_circuits_tpu_torch.prover.stark import StarkParams

    return StarkParams(log_n=log_n, num_queries=CIRCUIT_REF_QUERIES)


def _circuit_reference(d):
    """The circuit STARKs at small sizes on device `d`: the demux proof at
    the queries of tests/test_demux_air.py, the Horner proof at E = 8 and a
    one-block sha256 proof (each verified), as nested ints; for keccak,
    blake2s and ecrecover (a CPU proof takes minutes) the traces with their
    phase-2 columns and the constraint residuals, as u64 arrays."""
    from zkevm_circuits_tpu_torch.isa import system_params as sp
    from zkevm_circuits_tpu_torch.models import ecrecover as ecr
    from zkevm_circuits_tpu_torch.models import eip_4844 as e44
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.ops import secp256k1 as ec
    from zkevm_circuits_tpu_torch.ops.keccak import keccak256_ref
    from zkevm_circuits_tpu_torch.prover import (blake2s_air, demux_air, ecrecover_air,
                                                 horner_air, keccak_air, sha256_air)
    from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints

    # tests/test_demux_air.py's stream: one element a family and a
    # porter-shard storage log (routes nowhere)
    base = dict(address=0x8002, rw_flag=True, rollback=False, is_service=False, shard_id=0)
    qs = [dict(base, key=5, read_value=1, written_value=2, aux_byte=sp.STORAGE_AUX_BYTE,
               tx_number_in_block=0, timestamp=21),
          dict(base, key=6, read_value=0, written_value=3, aux_byte=sp.EVENT_AUX_BYTE,
               is_service=True, tx_number_in_block=1, timestamp=25),
          dict(base, key=7, read_value=0, written_value=4, aux_byte=sp.L1_MESSAGE_AUX_BYTE,
               tx_number_in_block=1, timestamp=29)]
    qs += [dict(base, address=a, key=77 << 128, read_value=0, written_value=0, rw_flag=False,
                aux_byte=sp.PRECOMPILE_AUX_BYTE, tx_number_in_block=2, timestamp=33)
           for a in (sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS, sp.SHA256_PRECOMPILE_FORMAL_ADDRESS,
                     sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS)]
    qs.append(dict(base, key=9, read_value=0, written_value=1, aux_byte=sp.STORAGE_AUX_BYTE,
                   shard_id=1, tx_number_in_block=3, timestamp=37))
    chunks, vh = blob_inputs(5, 0x4844)
    blocks = np.random.default_rng(3).integers(0, 1 << 32, size=(1, 16), dtype=np.uint64)
    cfg = e44.EIP4844Config(elements=CIRCUIT_REF_BLOB)
    bw = e44.generate_witness(chunks, vh, cfg, device=d)
    pub = dict(E=cfg.elements, chunks=bw.chunks.cpu().numpy(),
               truncated=bw.truncated.cpu().numpy(), opening_be=bw.opening_be.cpu().numpy())
    runs = dict(
        demux=(lambda: demux_air.prove_demux(qs, _stark_params(8), device=d),
               lambda p, _, prm: demux_air.verify_demux(p, qs, prm)),
        horner=(lambda: horner_air.prove_horner(bw, cfg.elements, _stark_params(8), device=d),
                lambda p, _, prm: horner_air.verify_horner(p, pub, prm)),
        sha256=(lambda: sha256_air.prove_sha256_blocks(blocks, _stark_params(6), device=d),
                lambda p, dw, prm: sha256_air.verify_sha256_blocks(p, blocks, dw, prm)))
    got = {}
    for name, (prove_fn, verify_fn) in runs.items():
        out = prove_fn()
        if out[0].q_cap.device.type != d.type or not verify_fn(*out):
            _fail(f"{name} small proof on {d}: not on its device, or rejected")
        got[name] = proof_to_ints(out[0])

    # keccak, blake2s, ecrecover: traces, phase 2 and residuals
    h = int.from_bytes(keccak256_ref(b"zk block"), "big")
    r, s, recid = ec.sign(h, 0xC0FFEE, 0x12345)
    call = dict(address=0x1, key=(2 << 64) | (7 << 128) | (9 << 160), read_value=0,
                written_value=0, rw_flag=False, aux_byte=4, rollback=False, is_service=True,
                shard_id=0, tx_number_in_block=0, timestamp=100)
    mem = {(7, 0): h.to_bytes(32, "big"), (7, 1): recid.to_bytes(32, "big"),
           (7, 2): r.to_bytes(32, "big"), (7, 3): s.to_bytes(32, "big")}
    gamma = 0x1234567
    msgs = [b"\xaa" * 64, bytes(range(40))]
    for name, build, air in (
            ("keccak", lambda: keccak_air.build_keccak_trace(bytes(range(200)), device=d),
             keccak_air.keccak_air()),
            ("blake2s", lambda: blake2s_air.build_blake2s_trace(msgs, device=d),
             blake2s_air.blake2s_air())):
        phase1, fixed, digests, build_phase2, _ = build()
        t2 = build_phase2(None, (gamma,))
        rlc = (keccak_air.message_rlc(bytes(range(200)), gamma) if name == "keccak" else
               blake2s_air.batch_rlc(blake2s_air.records_from_calls(msgs, digests), gamma))
        pub = np.array(([] if name == "blake2s" else list(np.asarray(digests, np.uint64)))
                       + [rlc], np.uint64)
        cols = torch.cat([fixed, phase1, t2])
        got[name] = (gf.to_u64(cols), _air_residuals(air, cols, gf.from_u64(pub, d), (gamma,)))
    ew = ecr.generate_witness([call], mem, ecr.EcrecoverConfig(max_calls=1), device=d)
    fixed, phase1, _ = ecrecover_air.build_ecrecover_trace(ew, device=d)
    ch = (0x89ABCDEF, gamma)
    t2 = ecrecover_air._build_phase2(torch.cat([fixed, phase1]), ch)
    cp = ecrecover_air.calls_public_from_witness(ew)
    pub = gf.from_u64(np.array([ecrecover_air.records_rlc(ecrecover_air.ladder_records(cp),
                                                          gamma)], np.uint64), d)
    cols = torch.cat([fixed, phase1, t2])
    got["ecrecover"] = (gf.to_u64(cols), _air_residuals(ecrecover_air.ecrecover_air(), cols, pub,
                                                        ch))
    return got


def _cpu_references(conn, names):
    """The CPU sides of the small references `names`, in a process of their
    own (minutes of plain permutations): each result is sent when it is made,
    while the card phases run."""
    torch.set_num_threads(CPU_REF_THREADS)
    for name in names:
        try:
            conn.send((name, "ok", CPU_REFERENCES[name](torch.device("cpu"))))
        except Exception:  # the boundary of the child: the parent reports it
            conn.send((name, "error", traceback.format_exc()))
    conn.close()


def start_cpu_references(names):
    """Start the CPU side of the small references `names`, in this order, in
    a process of its own; the small phases read its results."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_cpu_references, args=(child, names), daemon=True)
    proc.start()
    child.close()
    return dict(proc=proc, conn=parent, names=names, started=time.perf_counter())


def _cpu_reference(reference, name):
    """The CPU side's result `name`, waiting for it."""
    got, status, value = reference["conn"].recv()
    if got != name or status != "ok":
        _fail(f"the CPU reference {got}: {status} {value if status != 'ok' else ''}")
    if name == reference["names"][-1]:
        reference["proc"].join()
    return value


def circuit_starks_small(dev, reference):
    """The circuit STARKs at small sizes, the card's against the CPU's (from
    `start_cpu_references`): the three small proofs equal as nested ints;
    the keccak, blake2s and ecrecover traces, phase-2 columns and residuals
    equal, the residuals all zero."""
    t0 = time.perf_counter()
    card = _circuit_reference(dev)
    card_s = time.perf_counter() - t0
    cpu = _cpu_reference(reference, "circuits")
    waited = time.perf_counter() - t0 - card_s
    for name in ("demux", "horner", "sha256"):
        if card[name] != cpu[name]:
            _fail(f"{name}: the small proof on the card differs from the CPU proof")
    for name in ("keccak", "blake2s", "ecrecover"):
        (cols_a, res_a), (cols_b, res_b) = card[name], cpu[name]
        if not np.array_equal(cols_a, cols_b) or not np.array_equal(res_a, res_b) or res_a.any():
            _fail(f"{name}: the card's trace, phase 2 or residuals differ from the CPU's, or "
                  f"a residual is not zero")
    print(f"circuit STARKs, small: demux (8 queries), Horner (E = {CIRCUIT_REF_BLOB}) and sha256 "
          f"(1 block) proofs on the card == on the CPU as nested ints "
          f"({CIRCUIT_REF_QUERIES} queries); keccak (2 blocks), blake2s (2 calls) and ecrecover "
          f"(1 call) traces, phase-2 columns and residuals on the card == on the CPU, all "
          f"residuals zero (the card's side {card_s:.1f} s; the CPU's in a process of its own "
          f"since {time.perf_counter() - reference['started']:.1f} s ago, waited for "
          f"{waited:.1f} s)", flush=True)


def _report(rec, card):
    """One proof's line: rows x columns, prove and verify seconds, peak
    memory, launches."""
    when = f"prove {rec['prove_s']:.3f} s, verify {rec['verify_s']:.3f} s"
    print(f"  {rec['name']}: {rec['rows']} x {rec['cols']} ({int(rec['rows']).bit_length() - 1}"
          f" log2 rows); {when}; peak {rec['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{rec['launches']}; verdict {rec['ok']} [{card}]", flush=True)


def _summary(name, recs, card):
    """One line for a run of same-shape proofs (per-call types 3, 5, 6)."""
    first, rest = recs[0], recs[1:] or recs[:1]
    sizes = sorted({r["rows"] for r in recs})
    launches = {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}
    print(f"  {name}: {len(recs)} proofs of {sizes} rows x {recs[0]['cols']}; the first prove "
          f"{first['prove_s']:.3f} s verify {first['verify_s']:.3f} s; the others prove "
          f"{min(r['prove_s'] for r in rest):.3f}-{max(r['prove_s'] for r in rest):.3f} s, verify "
          f"{min(r['verify_s'] for r in rest):.3f}-{max(r['verify_s'] for r in rest):.3f} s; "
          f"peak {max(r['peak_bytes'] for r in recs) / 2**30:.2f} GiB; launches {launches}; "
          f"verdicts all {all(r['ok'] for r in recs)} [{card}]", flush=True)


def circuit_starks_full(dev, card, log_in, mem_in, blobs):
    """Phase (e): the block's circuit STARKs at full width, through the
    verdict writers of `runtime/block.py`, on the data of phases (a), (c)
    and (d): demux over the log path's rows, keccak over the L1 stream, the
    first blob's Horner proof and three keccak chains (cut 9), the
    ecrecover ladders of every call, a sha256 chain per unique unpacked
    code, the first calls of the sha256 and keccak precompiles, the first
    2^13 blake2s compressions of storage application.  Each proof is made
    and verified on the card once (cut 5: the demux and L1 reruns dropped;
    the steady times are the later proofs of one shape: codes 1-2, call 1).
    Then a negative probe on each AIR."""
    from zkevm_circuits_tpu_torch.isa import system_params as sp
    from zkevm_circuits_tpu_torch.models import storage_application as sa
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.prover import (blake2s_air, demux_air, ecrecover_air,
                                                 horner_air, keccak_air, sha256_air)
    from zkevm_circuits_tpu_torch.runtime import block

    t_phase = time.perf_counter()
    KERNEL.reset_counts()
    verdicts, logs = {}, {}

    def write(key, fn):
        logs[key] = []
        fn(logs[key])

    write("demux", lambda lg: block.demux_verdict(log_in["log_rows"], None, verdicts, log=lg))
    write("l1", lambda lg: block.l1_verdict(log_in["hw"], log_in["l1_hash"], None, verdicts,
                                            log=lg))
    write("blobs", lambda lg: block.blob_verdict(blobs[:BLOB_PROOFS], None, verdicts, log=lg))
    write("ecrecover", lambda lg: block.ecrecover_verdict(mem_in["ew"], None, verdicts, log=lg))
    write("unpacker", lambda lg: block.code_unpacker_verdict(mem_in["uw"], None, verdicts,
                                                             limit=UNPACKER_PROOF_CODES, log=lg))
    write("sha256", lambda lg: block.sha256_verdict(mem_in["sw"], None, verdicts,
                                                    limit=PRECOMPILE_PROOF_CALLS, log=lg))
    write("keccak", lambda lg: block.keccak_verdict(mem_in["kw"], mem_in["kcalls"],
                                                    mem_in["memory"], None, verdicts,
                                                    limit=PRECOMPILE_PROOF_CALLS, log=lg))
    write("blake2s", lambda lg: block.storage_paths_verdict(log_in["aw"], None, verdicts,
                                                            limit=BLAKE_PROOF_CALLS, log=lg))
    torch.cuda.synchronize()
    launches = KERNEL.counts()
    phase_s = time.perf_counter() - t_phase
    print(f"circuit STARKs: verdicts {verdicts}; {sum(len(x) for x in logs.values())} proofs "
          f"made and verified on the card in {phase_s:.1f} s; Poseidon2 launches over the phase "
          f"{launches} [{card}]", flush=True)
    for key in ("demux", "l1", "ecrecover", "blake2s"):
        _report(logs[key][0], card)
    for rec in logs["blobs"]:
        _report(rec, card)
    _summary(f"sha256 (3), the first {UNPACKER_PROOF_CODES} unique codes", logs["unpacker"],
             card)
    _summary(f"sha256 (6), the first {PRECOMPILE_PROOF_CALLS} calls", logs["sha256"], card)
    _summary(f"keccak (5), the first {PRECOMPILE_PROOF_CALLS} calls", logs["keccak"], card)
    if not all(verdicts.values()) or sorted(verdicts) != [3, 4, 5, 6, 7, 10, 13, 255]:
        _fail(f"circuit STARKs: verdicts {verdicts}")
    for name in ("permutation", "permutation_small"):
        if launches[name] <= 0:
            _fail(f"the circuit STARKs launched the {name} kernel no time")

    # negative probes, each must verify false
    probes = {}
    rec = logs["demux"][0]
    rows = [dict(q) for q in log_in["log_rows"]]
    k = next(i for i, q in enumerate(rows) if q["aux_byte"] == sp.STORAGE_AUX_BYTE)
    rows[k] = dict(rows[k], aux_byte=sp.EVENT_AUX_BYTE)
    probes["a rerouted element (demux)"] = demux_air.verify_demux(rec["proof"], rows,
                                                                  rec["params"])
    bw, chunks, vh, E = blobs[0]
    horner = next(r for r in logs["blobs"] if r["name"].startswith("horner"))
    opening = bw.opening_be.cpu().numpy().copy()
    opening[-1] ^= 1
    data = list(chunks) + [b"\x00" * 31] * (E - len(chunks))
    probes["a wrong opening (Horner)"] = horner_air.verify_horner(
        horner["proof"], dict(E=E, chunks=np.array([list(c) for c in data], np.uint64),
                              truncated=bw.truncated.cpu().numpy(), opening_be=opening),
        horner["params"])
    rec = logs["l1"][0]
    stream = log_in["hw"].msg_bytes[:log_in["hw"].n].cpu().numpy().astype(np.uint8).tobytes()
    bad = bytearray(log_in["l1_hash"])
    bad[0] ^= 1
    probes["a flipped digest byte (keccak 13)"] = keccak_air.verify_keccak256(
        rec["proof"], stream, bytes(bad), rec["params"])
    rec = logs["unpacker"][0]
    uw = mem_in["uw"]
    sel = (uw.round_execute.cpu().numpy().astype(bool)
           & (uw.round_request.cpu().numpy() == 0))
    blocks = uw.block_words.cpu().numpy().astype(np.uint64)[sel]
    dig = uw.state_after.cpu().numpy().astype(np.uint64)[
        sel & uw.round_is_last.cpu().numpy().astype(bool)][-1].copy()
    dig[0] ^= 1
    probes["a flipped digest word (sha256 3)"] = sha256_air.verify_sha256_blocks(
        rec["proof"], blocks, dig, rec["params"])
    rec = logs["blake2s"][0]
    msgs, digs = sa.blake2s_calls(log_in["aw"])
    msgs, digs = list(msgs[:BLAKE_PROOF_CALLS]), digs[:BLAKE_PROOF_CALLS]
    msgs[7] = bytes([msgs[7][0] ^ 1]) + msgs[7][1:]
    probes["a changed message byte (blake2s)"] = blake2s_air.verify_blake2s_batch(
        rec["proof"], msgs, digs, rec["params"])
    rec = logs["ecrecover"][0]
    cp = ecrecover_air.calls_public_from_witness(mem_in["ew"])
    i = next(j for j, c in enumerate(cp) if c.get("active"))
    cp[i] = dict(cp[i], u2=cp[i]["u2"] ^ 1)
    probes["a flipped scalar bit (ecrecover)"] = ecrecover_air.verify_ecrecover(
        rec["proof"], cp, rec["params"])
    if any(probes.values()):
        _fail(f"circuit STARK negative probes: {probes}")
    print("circuit STARK negative probes, each rejected: " + "; ".join(probes), flush=True)
    return launches


class _CompactForms:
    """Two compact forms' encodings, as `make_carried_proofs` takes them."""

    def __init__(self, enc, d):
        self.enc, self.start_flag = enc, torch.zeros(enc.shape[0], dtype=torch.bool, device=d)

    def encode(self):
        from zkevm_circuits_tpu_torch.ops import gf

        return gf.from_u64(self.enc, self.start_flag.device)


def _vm_node_reference(d):
    """The main_vm trace of the bench loop at VM_REF_CYCLES (2^11 rows) with
    its phase-2 columns and constraint residuals, as u64 arrays (a whole
    CPU proof takes minutes), and the node STARK over two compact-form
    children, as nested ints, on device `d`."""
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp
    from zkevm_circuits_tpu_torch.prover import vm_air
    from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints

    w = vm.NativeEraVM(vm.assemble_code_words(_vm_programs(VM_REF_ITERATIONS)[1]),
                       VM_REF_CYCLES).run()
    phase1, fixed, log_n = vm_air.vm_core_trace(w, VM_REF_CYCLES, d)
    t2 = vm_air._build_phase2(torch.cat([fixed, phase1]), VM_REF_CH)
    s_in, s_out = vm_air.boundary_state_vectors(phase1)
    macc = vm_air.stream_rlc(vm_air.code_read_queries(w, VM_REF_CYCLES), VM_REF_CH[vm_air._MQ])
    pub = vm_air._boundary_publics(s_in, s_out, VM_REF_CH[vm_air._RLC], macc, d)
    cols = torch.cat([fixed, phase1, t2])
    got = dict(vm=(log_n, gf.to_u64(cols),
                   _air_residuals(vm_air.vm_core_air(), cols, pub, VM_REF_CH)))
    enc = np.random.default_rng(9).integers(0, gf.MODULUS, size=(2, 18), dtype=np.uint64)
    carried = rp.make_carried_proofs(_CompactForms(enc, d))
    node = rp.node_prove_in_field(carried)
    if node.vproof.q_cap.device.type != d.type or not rp.node_verify_in_field(node, carried):
        _fail(f"the small node proof on {d}: not on its device, or rejected")
    got["node"] = proof_to_ints(node.vproof)
    return got


def vm_node_starks_small(dev, reference):
    """The main_vm trace, phase 2 and residuals and the small node proof,
    the card's against the CPU's (from `start_cpu_references`)."""
    t0 = time.perf_counter()
    card = _vm_node_reference(dev)
    card_s = time.perf_counter() - t0
    cpu = _cpu_reference(reference, "vm_node")
    waited = time.perf_counter() - t0 - card_s
    (log_n, cols_a, res_a), (_, cols_b, res_b) = card["vm"], cpu["vm"]
    if log_n != 11 or not np.array_equal(cols_a, cols_b) or not np.array_equal(res_a, res_b) \
            or res_a.any():
        _fail("main_vm small: the card's trace, phase 2 or residuals differ from the CPU's, or "
              "a residual is not zero")
    if card["node"] != cpu["node"]:
        _fail("node small: the proof on the card differs from the CPU proof")
    print(f"main_vm and node STARKs, small: the main_vm trace of the bench loop at "
          f"{VM_REF_CYCLES} cycles (2^{log_n} x {cols_a.shape[0]}: fixed, phase 1, phase 2) and "
          f"its residuals on the card == on the CPU, all zero; the node STARK over two "
          f"compact-form children on the card == on the CPU as nested ints (the card's side "
          f"{card_s:.1f} s; the CPU's in a process of its own, waited for {waited:.1f} s)",
          flush=True)


def vm_node_starks_full(dev, card, log_vm, carried):
    """Phase 22: the type-1 writer (the main_vm committed-trace STARK) over
    the log path's 2^16-cycle run and the node STARK over the sorter's 16
    carried proofs, each made and verified on the card; then four negative
    probes.  Cut 4: the bench loop's proof of the same 2^17 x 1,922 shape
    is not made."""
    import dataclasses

    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.prover import poseidon2_air as pa
    from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp
    from zkevm_circuits_tpu_torch.prover import verifier_air as va
    from zkevm_circuits_tpu_torch.prover import vm_air
    from zkevm_circuits_tpu_torch.prover.stark import _fri_params
    from zkevm_circuits_tpu_torch.runtime import block

    t_phase = time.perf_counter()
    KERNEL.reset_counts()
    logs = dict(log_path=[], node=[])
    v, w, log_n_cycles = log_vm
    t0 = time.perf_counter()
    residuals = vm_air.debug_residuals(w, log_n_cycles)
    residuals_s = time.perf_counter() - t0
    verdicts = {}
    t0 = time.perf_counter()
    log_ok, on_tape = block.vm_verdict(v, w, log_n_cycles, None, verdicts, log=logs["log_path"])
    writer_s = time.perf_counter() - t0
    fri_ps = tuple(_fri_params(pa.chain_air(pa.FULL), cp.params) for cp in carried)
    node_air = va.verifier_air(va.build_schedule(fri_ps))
    nodes = []

    def node_prove():
        nodes.append(rp.node_prove_in_field(carried))
        return nodes[-1], nodes[-1].vparams

    node_ok = block._proved(logs["node"], f"node ({len(carried)} carried proofs)", node_air,
                            None, node_prove,
                            lambda node, _: rp.node_verify_in_field(node, carried))
    torch.cuda.synchronize()
    launches = KERNEL.counts()
    phase_s = time.perf_counter() - t_phase
    print(f"main_vm and node STARKs: the log path's {log_n_cycles}-cycle run: debug_residuals "
          f"{residuals or 'none failing'} ({residuals_s:.1f} s), type-1 writer {writer_s:.1f} s "
          f"(the tape check included), verdicts {verdicts}, vm_code_reads_on_tape {on_tape}; "
          f"the phase {phase_s:.1f} s; Poseidon2 launches over the phase {launches} [{card}]",
          flush=True)
    for key in ("log_path", "node"):
        _report(logs[key][0], card)
    if not (log_ok and on_tape and node_ok) or verdicts != {1: True}:
        _fail(f"main_vm / node STARKs: log path {log_ok}, on tape {on_tape}, node {node_ok}")
    for name in ("permutation", "permutation_small"):
        if launches[name] <= 0:
            _fail(f"the main_vm and node STARKs launched the {name} kernel no time")

    # negative probes, each must verify false
    probes = {}
    rec = logs["log_path"][0]
    proof, s_in, s_out, reads, params = rec["proof"], *rec["rest"]
    forged = s_out.copy()
    forged[-1] ^= np.uint64(1)
    probes["a forged final register limb (main_vm)"] = vm_air.verify_vm_core(
        proof, s_in, forged, reads, params)
    forged = reads.copy()
    forged[reads.shape[0] // 2, 3] ^= np.uint64(1)
    probes["a forged code-read word (main_vm)"] = vm_air.verify_vm_core(
        proof, s_in, s_out, forged, params)
    node = nodes[0]
    swapped = list(carried)
    swapped[PROBE_SLOT] = carried[PROBE_SLOT + 1]
    probes["a child swapped for another carried proof (node)"] = rp.node_verify_in_field(
        node, swapped)
    fps = [cp.proof.fri_proof for cp in carried]
    ops = [[dict(o) for o in q] for q in fps[PROBE_SLOT].openings]
    pair = np.asarray(ops[0][0]["pair"], np.uint64).copy()
    pair[0, 0] ^= np.uint64(1)
    ops[0][0]["pair"] = pair
    fps[PROBE_SLOT] = dataclasses.replace(fps[PROBE_SLOT], openings=ops)
    probes["one bit of a child's opened pair (node)"] = va.verify_fri_verification(
        node.vproof, fps, node.child_fri_params, node.vparams)
    if any(probes.values()):
        _fail(f"main_vm / node negative probes: {probes}")
    print("main_vm and node negative probes, each rejected: " + "; ".join(probes), flush=True)
    return launches


def _block_small_config():
    from zkevm_circuits_tpu_torch.runtime import block2

    lim = BLOCK_SMALL_LIMIT
    return block2.Block2Config(
        vm_limit=BLOCK_SMALL_CYCLES, vm_instance_limit=lim, sorter_limit=lim, hasher_limit=64,
        unpacker_rounds=lim, keccak_blocks=lim, sha_rounds=lim, ec_calls=1, storage_rows=256,
        ram_limit=lim)


def _block_values(res):
    """What phase 23 holds equal between the card and the CPU: every compact
    form per type, residual and handoff, the scheduler's checks in order, the
    content hash and the public input, as numpy and python values."""
    from zkevm_circuits_tpu_torch.ops import gf

    def arr(t):
        return gf.to_u64(t) if t.dtype == torch.int64 else t.cpu().numpy()

    sched = res.scheduler_result
    return dict(
        forms={t: [arr(getattr(cf, f.name)) for f in dataclasses.fields(cf)]
               for t, cf in sorted(res.compact_forms.items())},
        residuals={name: {k: x.cpu().numpy() for k, x in r.items()}
                   for name, r in res.residuals.items()},
        handoffs=dict(res.handoffs), checks=list(sched.checks.items()),
        content_hash=sched.block_content_hash, public_input=gf.to_u64(sched.public_input),
        ok=res.ok)


def _same_values(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _same_values(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_values(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _block_reference(d):
    """Phase 23 on `d`: the block program's 1,024 cycles through
    `execute_block2` (the Python EraVM) with two blobs, no proofs; then
    `execute_chain` over two such blocks that write CHAIN_TAGS to the same
    cell.  Returns the values held equal and, for the card's side, the
    results."""
    from zkevm_circuits_tpu_torch.runtime import block2, chain

    cfg = _block_small_config()
    words, kw, host = block_program(BLOCK_SMALL_ITERATIONS, 0, MEM_SMALL_LOG2_CODE_WORDS)
    blobs = [blob_inputs(MEM_SMALL_BLOB, 100 + b) for b in range(2)]
    res = block2.execute_block2(words, cfg, device=d, blobs=blobs, **kw)
    specs = [dict(code=block_program(BLOCK_SMALL_ITERATIONS, 0, MEM_SMALL_LOG2_CODE_WORDS, tag)[0],
                  code_store=kw["code_store"], bootloader_heap=kw["bootloader_heap"])
             for tag in CHAIN_TAGS]
    cr = chain.execute_chain(specs, cfg, initial_storage=kw["storage"], device=d)
    tag_writes = [[q["read_value"] for q in b.vm.log_tape
                   if q["rw_flag"] and q["key"] == BLOCK_TAG_KEY] for b in cr.blocks]
    values = dict(block=_block_values(res), chain=[_block_values(b) for b in cr.blocks],
                  content_hashes=cr.content_hashes, aggregate=cr.aggregated_input,
                  previous=[b.scheduler_inputs["previous_block_content_hash"] for b in cr.blocks],
                  tag_writes=tag_writes, chain_ok=cr.ok)
    return values, (res, cr, host)


def block_small(dev, reference):
    """Phase 23: the whole block at 1,024 cycles and a chain of two blocks,
    the card's against the CPU's (from `start_cpu_references`)."""
    t0 = time.perf_counter()
    card, (res, cr, host) = _block_reference(None)
    card_s = time.perf_counter() - t0
    cpu = _cpu_reference(reference, "block")
    waited = time.perf_counter() - t0 - card_s
    if not _same_values(card, cpu):
        diff = [k for k in card if not _same_values(card[k], cpu[k])]
        _fail(f"block small: the card's {diff} differ from the CPU's")
    if not res.ok or sorted(res.compact_forms) != list(range(1, 14)):
        _fail(f"block small: failing {res.failing()}, types {sorted(res.compact_forms)}")
    if res.compact_forms[8].start_flag.device.type != dev.type:
        _fail("block small: the compact forms are not on the card")
    outputs = precompile_outputs({k: (x,) for k, x in res.witnesses.items()}, host)
    if not card["chain_ok"] or card["previous"] != [b"\x00" * 32, card["content_hashes"][0]] \
            or card["tag_writes"] != [[0], [CHAIN_TAGS[0]]]:
        _fail(f"chain: ok {card['chain_ok']}, the hashes not threaded or the storage not "
              f"carried over (the tag cell's prior values {card['tag_writes']})")
    counts = {t: int(cf.start_flag.shape[0]) for t, cf in sorted(res.compact_forms.items())}
    print(f"block small: block_program({BLOCK_SMALL_ITERATIONS}) for {BLOCK_SMALL_CYCLES} cycles "
          f"through execute_block2 (the Python EraVM), limits of {BLOCK_SMALL_LIMIT}, two blobs of "
          f"{MEM_SMALL_BLOB}, the scheduler on, no proofs: instances a type {counts}; every compact "
          f"form, residual ({len(card['block']['residuals'])} circuits) and handoff "
          f"({len(res.handoffs)}), the {len(res.scheduler_result.checks)} scheduler checks, the "
          f"content hash and the public input on the card == on the CPU; ok, all true; "
          f"{outputs} precompile outputs the host's; execute_chain over two blocks: ok, the "
          f"second's previous hash the first's content hash, the tag cell's prior values "
          f"{card['tag_writes']} (the storage carried over), the aggregate "
          f"{card['aggregate'].hex()[:16]}.. on the card == on the CPU (the card's side "
          f"{card_s:.1f} s; the CPU's in a process of its own, waited for {waited:.1f} s)",
          flush=True)


def block_config():
    """Phase 24's configuration: phases 14 and 17's instance sizes, the
    sorter STARKs with their full chains, every compact commitment, the
    in-field node of type 8."""
    from zkevm_circuits_tpu_torch.runtime import block2

    return block2.Block2Config(
        vm_limit=1 << LOG2_VM_CYCLES, vm_instance_limit=1 << LOG2_LOG_LIMIT,
        sorter_limit=1 << LOG2_LOG_LIMIT, hasher_limit=1 << 10, unpacker_rounds=MEM_LIMITS[0],
        keccak_blocks=MEM_LIMITS[1], sha_rounds=MEM_LIMITS[0], ec_calls=1,
        storage_rows=1 << 12, ram_limit=MEM_LIMITS[3],
        prove_sorter_starks=True, prove_full_sorter_chains=True, prove_commitments=True,
        node_in_field_types=(RAM_CIRCUIT_TYPE,))


def block_probes(res):
    """Phase 24's negative probes on the scheduler's inputs; returns what
    each failed."""
    from zkevm_circuits_tpu_torch.models import scheduler
    from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp
    from zkevm_circuits_tpu_torch.runtime import block2

    inputs, honest = res.scheduler_inputs, res.scheduler_result

    def failing(**change):
        got = scheduler.run_scheduler(**dict(inputs, **change))
        return sorted(k for k, ok in got.checks.items() if not ok), got

    # one carried commitment proof swapped between two instances of a type
    t = min((k for k, c in res.carried.items() if len(c) > 1), key=lambda k: len(res.carried[k]))
    name = scheduler.CIRCUIT_TYPES[t]
    swapped = list(res.carried[t])
    swapped[0], swapped[1] = swapped[1], swapped[0]
    proof, leaf_ok = rp.node_slot_proof(t, res.compact_forms[t], swapped,
                                        inputs["leaf_params_by_type"][t], block2.NODE_VK)
    got1, _ = failing(node_proofs_by_type={**inputs["node_proofs_by_type"], t: proof})
    if leaf_ok or got1 != [f"{name}_node_proof"]:
        _fail(f"probe swapped carried proofs of type {t}: leaf {leaf_ok}, failing {got1}")
    # one lane of one type's derived input
    d = dict(inputs["derived_observable_inputs"])
    d[RAM_CIRCUIT_TYPE] = d[RAM_CIRCUIT_TYPE].clone()
    d[RAM_CIRCUIT_TYPE][3] ^= 1
    got2, _ = failing(derived_observable_inputs=d)
    if got2 != ["ram_validation_input_derivation"]:
        _fail(f"probe derived input lane: failing {got2}")
    # another previous block
    got3, other = failing(previous_block_content_hash=b"\x01" + b"\x00" * 31)
    if got3 or torch.equal(other.public_input, honest.public_input) \
            or other.block_content_hash != honest.block_content_hash:
        _fail(f"probe previous hash: failing {got3}, the public input unchanged")
    # a wrong node VK
    got4, _ = failing(node_vk_commitment=(1, 2, 3, 5))
    want = sorted(f"{scheduler.CIRCUIT_TYPES[k]}_node_proof" for k in res.compact_forms)
    if got4 != want:
        _fail(f"probe node VK: failing {got4}, not every node proof")
    return {f"carried proofs 0 and 1 of type {t} swapped": got1,
            "a derived-input lane of type 8": got2,
            "another previous block hash": "the public input changed, every check true",
            "a wrong node VK": f"all {len(got4)} *_node_proof"}


def block_full(dev, card):
    """Phase 24: the whole block at 2^16 cycles, from the native EraVM run
    to the scheduler's public input, with the sorter STARKs, every compact
    commitment proven and verified, the in-field node of type 8; then four
    negative probes on the scheduler."""
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.runtime import block2

    t_phase = time.perf_counter()
    n = 1 << LOG2_VM_CYCLES
    words, kw, host = block_program(BLOCK_ITERATIONS)
    t0 = time.perf_counter()
    v = vm.NativeEraVM(words, n, **kw)
    w = v.run()
    sim_s = time.perf_counter() - t0
    returned = int(np.argmax(np.asarray(w["cs_depth"]) == 0))
    blobs = [blob_inputs(4096, 100 + b) for b in range(2)]
    cfg = block_config()
    times = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset_counts()
    t0 = time.perf_counter()
    res = block2.execute_block2_from_run(
        v, w, words, cfg, storage=kw["storage"], code_store=kw["code_store"],
        bootloader_heap=kw["bootloader_heap"], blobs=blobs, times=times)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    launches = KERNEL.counts()
    peak = torch.cuda.max_memory_allocated()
    sched = res.scheduler_result
    if not res.ok or sorted(res.compact_forms) != list(range(1, 14)):
        _fail(f"block at 2^{LOG2_VM_CYCLES} cycles: failing {res.failing()}")
    if sorted(res.stark_verdicts) != [2, 8, 9, 11, 12] or not all(res.stark_verdicts.values()) \
            or sorted(res.commitment_verdicts) != list(range(1, 14)) \
            or not all(res.commitment_verdicts.values()) or not all(sched.checks.values()):
        _fail(f"block: sorter verdicts {res.stark_verdicts}, commitment verdicts "
              f"{res.commitment_verdicts}")
    for name, count in launches.items():
        if count <= 0:
            _fail(f"the block launched the {name} kernel no time")
    outputs = precompile_outputs({k: (x,) for k, x in res.witnesses.items()}, host)
    counts = {t: int(cf.start_flag.shape[0]) for t, cf in sorted(res.compact_forms.items())}
    stages = {k: x for k, x in times.items() if isinstance(x, list)}
    proofs = {k: x for k, x in times.items() if not isinstance(x, list)}
    calls = {k: len(c) for k, c in v.precompile_calls.items()}
    print(f"block: block_program({BLOCK_ITERATIONS}) for 2^{LOG2_VM_CYCLES} cycles through the "
          f"native EraVM (returned at cycle {returned}), host sim {sim_s:.3f} s; "
          f"{len(v.log_tape)} log rows, {len(v.decommit_tape)} decommits, precompile calls "
          f"{calls}, two blobs of 4,096; instances a type {counts} ({sum(counts.values())} in "
          f"all); the block {block_s:.3f} s; stage seconds "
          + "; ".join(f"{k} {x[0]:.4f}" for k, x in stages.items())
          + "; proofs and scheduler seconds "
          + "; ".join(f"{k} {x:.3f}" for k, x in proofs.items())
          + f"; every residual, handoff ({len(res.handoffs)}), sorter verdict "
          f"{sorted(res.stark_verdicts)}, commitment verdict (13 types) and scheduler check "
          f"({len(sched.checks)}) true, ok; {outputs} precompile outputs the host's; public input "
          f"{gf_ints(sched.public_input)}; Poseidon2 launches {launches}; peak device memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    t0 = time.perf_counter()
    probes = block_probes(res)
    print(f"block negative probes ({time.perf_counter() - t0:.2f} s): "
          + "; ".join(f"{k}: fails {x}" for k, x in probes.items())
          + f"; the phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def multichip(card, proof):
    """Phase 25: `entry.dryrun_multichip` with one rank a card on every card
    of the machine; its rank-0 sharded-commit proof must equal phase 4's
    single-device proof.  Returns rank 0's launches over the dry run."""
    from zkevm_circuits_tpu_torch import entry
    from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    out = entry.dryrun_multichip(world)
    seconds = time.perf_counter() - t0
    if out["proof"] != proof_to_ints(proof) or not out["proof_equal"]:
        _fail("multichip: the sharded-commit proof differs from phase 4's single-device proof")
    launches = {k: sum(r["launches"][k] for r in out["records"].values())
                for k in ("permutation", "permutation_small", "chain_segmented")}
    phases = "; ".join(f"{k} {r['seconds']:.3f} s" for k, r in out["records"].items())
    print(f"multichip: dryrun_multichip over {world} card(s), mesh {out['mesh']}, every phase "
          f"true, the rank-0 sharded-commit proof of 2^{LOG2_ROWS} rows equal to phase 4's "
          f"proof; phases {phases}; the whole dry run {seconds:.1f} s with the ranks' start; "
          f"rank-0 Poseidon2 launches {launches} [{card}]", flush=True)
    return launches


def gf_ints(t):
    from zkevm_circuits_tpu_torch.ops import gf

    return [int(x) for x in gf.to_u64(t)]


# the small references' CPU sides, by name (`start_cpu_references`)
CPU_REFERENCES = dict(sorter=_sorter_reference, circuits=_circuit_reference,
                      vm_node=_vm_node_reference, block=lambda d: _block_reference(d)[0])


def main():
    if not torch.cuda.is_available():
        _fail("no CUDA device: chip_smoke.py runs only on a GPU host")
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    clock_hz = sm_clock_hz()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from zkevm_circuits_tpu_torch.ops import poseidon2_cuda

    # the CPU sides of phases 10, 19, 21 and 23 run beside the card phases,
    # in two processes of their own
    reference = start_cpu_references(("sorter", "circuits", "vm_node"))
    block_reference = start_cpu_references(("block",))
    t0 = time.perf_counter()
    poseidon2_cuda.build(verbose=True)
    poseidon2_cuda.KERNEL.lib(dev)
    print(f"build: csrc/poseidon2.cu (with poseidon2_coop.cuh; the registers and spills of "
          f"its kernels are above) with nvcc {' '.join(poseidon2_cuda.NVCC_FLAGS)}, built and "
          f"loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    records = {}
    records["permutation"], records["permutation_small"] = kernel_parity(dev, card, clock_hz)
    small_reference(dev)
    proof, public, params, launches_prove = main_path(dev, card)
    negative_probe(proof, public, params)
    ram_eval_small(dev)
    w, cfg, witness_s = ram_witness_full(dev)
    records["chain_segmented"] = chain_kernel_parity(w, card, clock_hz)
    records["chain_segmented"]["shapes"] += sponge_chain_shapes(dev, card, clock_hz)
    launches_ram_eval = ram_eval_full(dev, card, w, cfg, witness_s)
    del w
    torch.cuda.empty_cache()
    vm_eval_small(dev)
    launches_vm_eval = vm_eval_full(dev, card)
    sorter_full_small(dev, reference)
    w, full, forms, carried, launches_sorter_full = sorter_full_path(dev, card)
    sorter_full_probes(w, full, forms, carried)
    del w, full, forms
    torch.cuda.empty_cache()
    launches_logup = logup_path(dev, card)
    log_path_small(dev)
    launches_log_path, log_inputs = log_path_full(dev, card)
    torch.cuda.empty_cache()
    launches_log_sorter = log_sorter_full(dev, card)
    torch.cuda.empty_cache()
    memory_thread_small(dev)
    launches_memory_thread, mem_inputs = memory_thread_full(dev, card)
    torch.cuda.empty_cache()
    launches_eip_4844, blobs = eip_4844_full(dev, card)
    circuit_starks_small(dev, reference)
    launches_circuit_starks = circuit_starks_full(dev, card, log_inputs, mem_inputs, blobs)
    log_vm = log_inputs["vm"]
    del log_inputs, mem_inputs, blobs
    torch.cuda.empty_cache()
    vm_node_starks_small(dev, reference)
    launches_vm_node_starks = vm_node_starks_full(dev, card, log_vm, carried)
    del log_vm, carried
    torch.cuda.empty_cache()
    block_small(dev, block_reference)
    launches_block = block_full(dev, card)
    torch.cuda.empty_cache()
    launches_multichip = multichip(card, proof)

    sources = dict(permutation=KERNEL_SOURCE, permutation_small=COOP_SOURCE,
                   chain_segmented=COOP_SOURCE)
    kernels = []
    for key, record in records.items():
        by_path = dict(launches_prove=launches_prove[key], launches_ram_eval=launches_ram_eval[key],
                       launches_vm_eval=launches_vm_eval[key],
                       launches_sorter_full=launches_sorter_full[key],
                       launches_logup=launches_logup[key],
                       launches_log_path=launches_log_path[key],
                       launches_log_sorter=launches_log_sorter[key],
                       launches_memory_thread=launches_memory_thread[key],
                       launches_eip_4844=launches_eip_4844[key],
                       launches_circuit_starks=launches_circuit_starks[key],
                       launches_vm_node_starks=launches_vm_node_starks[key],
                       launches_block=launches_block[key],
                       launches_multichip=launches_multichip[key])
        if not sum(by_path.values()):
            _fail(f"no path launched the {key} kernel")
        kernels.append(dict(name=f"poseidon2_{key}", route="cuda", source=sources[key],
                            replaces=REPLACES, launches=sum(by_path.values()), **by_path,
                            **record))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
