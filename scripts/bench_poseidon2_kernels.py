"""The Poseidon2 kernels of the torch port against each other, on one CUDA card.

    python3 scripts/bench_poseidon2_kernels.py

Builds csrc/poseidon2.cu (printing what ptxas reports for each kernel, and the
length of each kernel's machine code where cuobjdump is at hand), then

  1. checks that the kernels it times against each other give the same bits
     (each is held against its plain version by chip_smoke.py and the tests);
  2. times (CUDA events around 20 launches queued behind a busy card, after 2
     warm-ups) the permutation at 2^0 .. 2^16 states by the thread-per-state
     kernel and by the lane-parallel small-batch kernel: the crossover sets
     `SMALL_BATCH` (ops/poseidon2_cuda.py);
  3. times the chain kernel at (2,048 x 512) and (4,096 x 512): one chain, two
     chains in one launch, two launches on one stream, two launches on two
     streams;
  4. times a sponge over 2^0 .. 2^13 states of 1 .. 64 absorbs both ways:
     `poseidon2.absorb_chained` (one chain launch) and `poseidon2.absorb_loop`
     (a small-batch launch an absorb), wall-clock from the host as the prover
     sees it, after checking that they agree: the crossover sets
     `CHAIN_SPONGE_ROUNDS` (ops/poseidon2.py).

Every line carries the card's name and power limit.  Needs a CUDA card.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zkevm_circuits_tpu_torch.ops import gf, poseidon2, poseidon2_cuda  # noqa: E402
from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import (  # noqa: E402
    chain_segmented_cuda,
    permutation_cuda,
)

P = gf.MODULUS
REPS = 20


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps=REPS):
    """mean device ms a call: the card is kept busy for some 10 ms first, so that
    all `reps` calls are queued behind it and the host's time to launch them
    (more than a small kernel's own time) is not what the events see."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # torch's own spin kernel; no public name for it
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_chain(rng, segments, stride, dev, executed=1.0):
    boundaries = gf.from_u64(rng.integers(0, P, size=(segments + 1, 12), dtype=np.uint64), dev)
    encodings = gf.from_u64(rng.integers(0, P, size=(segments * stride, 8), dtype=np.uint64), dev)
    execute = torch.from_numpy(rng.random(segments * stride) < executed).to(dev)
    return boundaries, encodings, execute


def cross_check(dev, rng):
    """the kernels that are timed against each other give the same bits (each is
    held against its plain version by chip_smoke.py and the gpu tests)."""
    st = gf.from_u64(rng.integers(0, P, size=(2048, 12), dtype=np.uint64), dev)
    if not torch.equal(permutation_cuda(st, route="small"), permutation_cuda(st, route="thread")):
        raise RuntimeError("small-batch kernel != thread-per-state kernel")
    chain = random_chain(rng, 64, 16, dev, executed=0.8)
    (landing,) = chain_segmented_cuda([chain])
    if not torch.equal(chain_segmented_cuda([chain, chain])[1], landing):
        raise RuntimeError("chain kernel: two chains in a launch != one chain")
    print("cross-check: small-batch kernel == thread-per-state kernel at 2048 states; chain "
          "kernel the same with one and two chains a launch, at (64 x 16)", flush=True)


def time_permutation(dev, rng, card):
    print("permutation, ms a launch: states, thread-per-state, small-batch", flush=True)
    for log_n in range(0, 17):
        st = gf.from_u64(rng.integers(0, P, size=(1 << log_n, 12), dtype=np.uint64), dev)
        ms = [time_ms(lambda: permutation_cuda(st, route=route)) for route in ("thread", "small")]
        print(f"  2^{log_n}: {ms[0]:.4f} {ms[1]:.4f} [{card}]", flush=True)


def time_chain(dev, rng, card):
    side = torch.cuda.Stream()
    for segments in (2048, 4096):
        a = random_chain(rng, segments, 512, dev)
        b = random_chain(rng, segments, 512, dev)

        def two_streams():
            side.wait_stream(torch.cuda.current_stream())
            chain_segmented_cuda([a])
            with torch.cuda.stream(side):
                chain_segmented_cuda([b])
            torch.cuda.current_stream().wait_stream(side)

        one = time_ms(lambda: chain_segmented_cuda([a]))
        pair = time_ms(lambda: chain_segmented_cuda([a, b]))
        serial = time_ms(lambda: (chain_segmented_cuda([a]), chain_segmented_cuda([b])))
        streams = time_ms(two_streams)
        print(f"chain ({segments} x 512): one chain {one:.4f} ms; two chains in one launch "
              f"{pair:.4f} ms, in two launches on one stream {serial:.4f} ms, on two streams "
              f"{streams:.4f} ms [{card}]", flush=True)


def wall_ms(fn, reps=REPS):
    """mean host wall-clock ms a call, the card synchronized before and after."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / reps


def time_sponge(dev, rng, card):
    print("sponge, wall-clock ms a call: states, absorbs, chained (one chain launch), loop "
          "(a permutation launch an absorb), loop / chained", flush=True)
    for log_b in (0, 4, 8, 12, 13):
        for rounds in (1, 2, 4, 8, 16, 32, 64):
            inputs = gf.from_u64(rng.integers(0, P, size=(1 << log_b, 8 * rounds - 3),
                                              dtype=np.uint64), dev)
            state = poseidon2.apply_length_specialization(
                poseidon2.empty_state((1 << log_b,), dev), inputs.shape[-1])
            if not torch.equal(poseidon2.absorb_chained(inputs, state),
                               poseidon2.absorb_loop(inputs, state)):
                raise RuntimeError(f"chained sponge != loop at 2^{log_b} x {rounds}")
            chained = wall_ms(lambda: poseidon2.absorb_chained(inputs, state))
            loop = wall_ms(lambda: poseidon2.absorb_loop(inputs, state))
            print(f"  2^{log_b} x {rounds}: {chained:.4f} {loop:.4f} {loop / chained:.2f} "
                  f"[{card}]", flush=True)


def sass_counts():
    """machine instructions of each kernel, as cuobjdump lists them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: no cuobjdump on this machine, instruction counts not taken", flush=True)
        return
    text = subprocess.run([tool, "-sass", poseidon2_cuda.build()], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    name, counts = None, {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = 0
        elif name and line.startswith("/*") and line.endswith("*/") and ";" in line:
            counts[name] += 1
    for name, count in counts.items():
        print(f"sass: {name}: {count} instructions in the kernel's text", flush=True)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: these kernels run on the card only")
    dev = torch.device("cuda", 0)
    card = card_line()
    poseidon2_cuda.build(verbose=True)
    poseidon2_cuda.KERNEL.lib(dev)
    sass_counts()
    rng = np.random.default_rng(2026)
    cross_check(dev, rng)
    time_permutation(dev, rng, card)
    time_chain(dev, rng, card)
    time_sponge(dev, rng, card)
    print(f"in use: SMALL_BATCH = {poseidon2_cuda.SMALL_BATCH}, CHAIN_SPONGE_ROUNDS = "
          f"{poseidon2.CHAIN_SPONGE_ROUNDS} [{card}]", flush=True)


if __name__ == "__main__":
    main()
