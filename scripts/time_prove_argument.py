"""Time the grand-product prove+verify of the torch port found under a given
directory, on one CUDA card: to compare two checkouts (a parent and a
change) inside one machine, in turns.

    python3 scripts/time_prove_argument.py <checkout root> <label> [log2_rows] [runs]

Builds the ram_permutation witness from build_tapes_np(2^log2_rows) (default
16, chain stride 512), then runs prove_sorter_argument `runs` times (default
6), each ended by a synchronize, and prints the label and every run's
seconds on one line with the card's name and power limit.
"""

import os
import subprocess
import sys
import time


def main():
    root = os.path.abspath(sys.argv[1])
    label = sys.argv[2]
    log_rows = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    runs = int(sys.argv[4]) if len(sys.argv) > 4 else 6
    sys.path.insert(0, root)
    import torch

    import zkevm_circuits_tpu_torch
    from zkevm_circuits_tpu_torch.models import ram_permutation as ram
    from zkevm_circuits_tpu_torch.prover import pipeline
    from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np

    if not zkevm_circuits_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {zkevm_circuits_tpu_torch.__file__}, not the one under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this timing is taken on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    n = 1 << log_rows
    w = ram.generate_witness_host_tapes(
        *build_tapes_np(n), ram.RamPermutationConfig(limit=n, chain_stride=512))
    seconds = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = pipeline.prove_sorter_argument(w)[0]
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if not ok:
            raise RuntimeError("the proof did not verify")
    print(f"{label}: prove+verify 2^{log_rows} rows, s: "
          + " ".join(f"{s:.4f}" for s in seconds) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
