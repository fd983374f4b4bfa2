#!/usr/bin/env python3
"""The benchmark of zkevm_circuits_tpu_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json: set-up makes the cell's inputs from the seed
and has the program build its state (witness generation, the CUDA and native
builds on a checkout's first run) and warm every shape; then a closed loop
of units of work (checks or proofs, one in flight) for `--seconds`; then the
plain reference judges every answer of the window.  The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, with --trace 1 breakdown, and last the numbers compared with their
limits); the compared numbers are also the last lines of standard error.
With --trace 0 the metrics are the cell's end-to-end ones, with --trace 1
its per-layer ones, read from a torch.profiler trace of the window's first
TRACE_SECONDS and the benchmark's own spans.

Each unit is also timed on the card's clock (CUDA events recorded before its
first launch and after the copy of its answer), for tails shorter than a
host clock can time.  Exits non-zero with no result without enough CUDA
cards or when JAX or the JAX package was loaded (looked for once the window
has closed and again just before the result is printed).  A unit that
raises ends the window and makes the run not correct.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import guard, spec, trace as tr  # noqa: E402

TRACE_SECONDS = 10.0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             start: float, config=None, traffic=None) -> dict:
    """One run of a cell on `device`; the result object.  `config` and
    `traffic` stand in for the cell's files (the tests' small sizes)."""
    import torch

    cell = spec.cell(bench, cell_name)
    config = config or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    spans = {}
    runner = spec.runner(config["circuit"], traffic["entry"])(config, traffic, seed, device,
                                                             spans)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # starts the card's allocator
        torch.cuda.reset_peak_memory_stats(device)
    runner.setup()
    _sync(device)

    units, answers, failed, marks = [], [], 0, []

    def run_until(deadline: float) -> None:
        nonlocal failed
        while not failed and time.perf_counter() < deadline:
            t = time.perf_counter()
            if device.type == "cuda":  # the unit's span on the card's clock
                start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start_ev.record()
            try:
                with torch.profiler.record_function("bench.unit"):
                    rows, answer = runner.unit(len(units) + failed)
            except Exception:  # a unit that does not run is a failure of the run
                traceback.print_exc()
                failed += 1
                return
            if device.type == "cuda":
                end_ev.record()
                marks.append((start_ev, end_ev))
            units.append((time.perf_counter() - t, rows))
            answers.append(answer)

    counts, found = {}, None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark.lib import counters

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with counters.permutation_states(counts), profile(activities=activities) as prof:
            setup_s = time.perf_counter() - start
            t_start = time.perf_counter()
            with record_function(tr.WINDOW):
                run_until(t_start + min(seconds, TRACE_SECONDS))
                _sync(device)
        traced_units = len(units)
        found = tr.from_profiler(prof)
        del prof
    else:
        setup_s = time.perf_counter() - start
        t_start = time.perf_counter()
    run_until(t_start + seconds)
    _sync(device)
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    loaded = guard.loaded_forbidden()
    if loaded:
        raise SystemExit(f"forbidden modules loaded: {loaded}")

    ctx = dict(setup_s=setup_s, unit_s=[u[0] for u in units], unit_rows=[u[1] for u in units],
               unit_ms=[a.elapsed_time(b) for a, b in marks], window_s=window_s, spans=spans,
               work=getattr(runner, "work", {}), trace=found)
    if found is not None:
        from benchmark.lib import roofline

        ctx.update(traced_units=traced_units, **counts)
        if device.type == "cuda":
            ctx.update(sm_count=torch.cuda.get_device_properties(device).multi_processor_count,
                       clock_hz=roofline.max_sm_clock_hz())
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(bench, cell_name, kind):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    runner.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    compared = runner.judge(answers)
    print(f"reference and comparison {time.perf_counter() - t_judge:.3f} s; "
          f"{len(marks)} units timed on the card", file=sys.stderr)
    correct = not failed and bool(answers) and all(v <= lim for _, v, lim in compared)
    result = dict(correct=correct, attempted=len(units) + failed, failed=failed, metrics=metrics,
                  device=dict(platform="gpu" if device.type == "cuda" else device.type,
                              kind=torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu",
                              count=1, memory_peak_bytes=peak))
    if found is not None:
        result["device"].update(busy_s=found.busy_s, window_s=found.window_s)
        result["breakdown"] = tr.breakdown(found)
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), START)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    loaded = guard.loaded_forbidden()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
