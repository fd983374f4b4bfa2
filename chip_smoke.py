"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. device: the card's name and power limit (nvidia-smi), then the build of
     the CUDA Poseidon2 kernel (csrc/poseidon2.cu) with its build time;
  2. kernel parity: the kernel against the plain torch permutation on the
     card, bit for bit, on 2^16 random canonical states plus edge states and
     at the main path's batch sizes (2^18 leaf states, 2^17 first tree
     level), and against the native C++ permutation on 1,024 states; the
     kernel's and the plain version's times at those sizes (CUDA events);
  3. small-input reference: the ram_permutation proof at 2^8 rows made on
     the card must equal, as nested ints, the one made on the CPU;
  4. main path: the ram_permutation witness from bench.build_tapes_np(2^16)
     and prove_sorter_argument twice, on the card; the kernel's launch
     count over this phase must be above 0; first and steady prove+verify
     seconds and rows/s;
  5. negative probe: a changed public final product must fail verification.

Then one JSON line with the kernel's record, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without a CUDA card the script stops before printing any result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

LOG2_ROWS = 16
LOG2_REF_ROWS = 8
CHAIN_STRIDE = 512


def _fail(msg):
    raise RuntimeError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def time_ms(fn, arg, reps):
    """mean ms per call over `reps` calls after two warm-up calls (CUDA events)."""
    for _ in range(2):
        fn(arg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def kernel_parity(dev, card):
    from zkevm_circuits_tpu_torch.ops import gf, poseidon2
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import permutation_cuda
    from zkevm_circuits_tpu_torch.runtime import native

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
    print(f"parity: kernel == plain torch on {states.shape[0]} states (incl. {len(edge)} edge), "
          f"== native C++ on 1024 states", flush=True)

    record = None
    for log_b, what in ((18, "leaf hashing"), (17, "first tree level")):
        st = gf.from_u64(rng.integers(0, p, size=(1 << log_b, 12), dtype=np.uint64), dev)
        got_np = gf.to_u64(permutation_cuda(st))
        plain_np = gf.to_u64(poseidon2.permutation_plain(st))
        torch.cuda.synchronize()
        err = max_abs_err(got_np, plain_np)
        if err:
            _fail(f"kernel != plain torch at 2^{log_b} states (max |diff| {err})")
        ms = time_ms(permutation_cuda, st, 20)
        plain_ms = time_ms(poseidon2.permutation_plain, st, 3)
        print(f"timing: 2^{log_b} states ({what}): kernel {ms:.4f} ms, plain torch "
              f"{plain_ms:.4f} ms, {1000 * (1 << log_b) / ms / 1e6:.1f} M perm/s [{card}]",
              flush=True)
        if record is None:
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return record


def small_reference(dev):
    """The port's proof on the card equals its proof on the CPU (the CPU path
    is held byte-identical to the JAX package by tests/test_torch_ram_prover.py)."""
    from bench import build_tapes_np
    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.prover import pipeline
    from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints

    n = 1 << LOG2_REF_ROWS
    tapes = build_tapes_np(n)
    cfg = ram.RamPermutationConfig(limit=n, chain_stride=16)
    proofs = []
    for d in (dev, torch.device("cpu")):
        w = ram.generate_witness_host_tapes(*tapes, cfg, device=d)
        ok, proof, _, _ = pipeline.prove_sorter_argument(w)
        if not ok:
            _fail(f"2^{LOG2_REF_ROWS}-row proof on {d} did not verify")
        proofs.append(proof_to_ints(proof))
    if proofs[0] != proofs[1]:
        _fail(f"2^{LOG2_REF_ROWS}-row proof on the card differs from the CPU proof")
    print(f"reference: 2^{LOG2_REF_ROWS}-row proof on the card == proof on the CPU "
          f"({len(proofs[0]['fri']['query_indices'])} queries)", flush=True)


def main_path(dev, card):
    from bench import build_tapes_np
    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL
    from zkevm_circuits_tpu_torch.prover import pipeline

    n = 1 << LOG2_ROWS
    tapes = build_tapes_np(n)
    cfg = ram.RamPermutationConfig(limit=n, chain_stride=CHAIN_STRIDE)
    torch.cuda.synchronize()
    KERNEL.launches = 0
    t0 = time.perf_counter()
    w = ram.generate_witness_host_tapes(*tapes, cfg, device=dev)
    torch.cuda.synchronize()
    witness_s = time.perf_counter() - t0
    for name in ("execute", "enc_unsorted", "enc_sorted", "chain_unsorted", "challenges",
                 "lhs", "rhs", "nondet_count"):
        if getattr(w, name).device.type != dev.type:
            _fail(f"witness field {name} is on {getattr(w, name).device}")
    seconds = []
    for run in ("first", "steady"):
        before = KERNEL.launches
        t0 = time.perf_counter()
        ok, proof, public, params = pipeline.prove_sorter_argument(w)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if not ok:
            _fail(f"{run} prove+verify at 2^{LOG2_ROWS} rows did not verify")
        if KERNEL.launches <= before:
            _fail(f"{run} proof launched the Poseidon2 kernel {KERNEL.launches - before} times")
    launches = KERNEL.launches
    out = gf.to_u64(public)
    if out.shape != (pipeline.NUM_REPS,) or not np.array_equal(out, gf.to_u64(w.rhs[-1])):
        _fail("public final products do not match the witness's rhs")
    print(f"main path: witness 2^{LOG2_ROWS} rows {witness_s:.3f} s; prove+verify first "
          f"{seconds[0]:.3f} s ({n / seconds[0]:.1f} rows/s), steady {seconds[1]:.3f} s "
          f"({n / seconds[1]:.1f} rows/s); log_n={params.log_n} queries={params.num_queries}; "
          f"kernel launches {launches} [{card}]", flush=True)
    return proof, public, params, launches


def negative_probe(proof, public, params):
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.prover import pipeline

    forged = public.clone()
    forged[0] = gf.add(forged[0], gf.ones((), forged.device))
    if pipeline.verify_permutation_argument(proof, forged, params):
        _fail("verification accepted a changed public final product")
    print("negative probe: changed public final product rejected", flush=True)


def main():
    if not torch.cuda.is_available():
        _fail("no CUDA device: chip_smoke.py runs only on a GPU host")
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from zkevm_circuits_tpu_torch.ops import poseidon2_cuda

    t0 = time.perf_counter()
    poseidon2_cuda.build(verbose=True)
    poseidon2_cuda.KERNEL.lib(dev)
    print(f"build: csrc/poseidon2.cu with nvcc {' '.join(poseidon2_cuda.NVCC_FLAGS)}, "
          f"built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    record = kernel_parity(dev, card)
    small_reference(dev)
    proof, public, params, launches = main_path(dev, card)
    negative_probe(proof, public, params)

    kernel = dict(
        name="poseidon2_permutation",
        route="cuda",
        source="zkevm_circuits_tpu_torch/csrc/poseidon2.cu",
        replaces="zkevm_circuits_tpu/ops/poseidon2_pallas.py:89",
        launches=launches,
        **record,
    )
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
