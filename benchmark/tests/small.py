"""Sizes a CPU test run can hold, for every cell's configuration, and the
cells whose files are here but that BENCHMARK.json does not list."""

from benchmark.lib import spec

SMALL = {
    "ram_permutation": dict(rows=64, chain_stride=8),  # a proof of 2^6 rows
    "main_vm": dict(cycles=512, outer=[4, 8]),
}

# The proof cell, kept out of BENCHMARK.json while the prover is host-paced:
# its rate spreads too widely between runs for any bound to hold it.  Its
# runner, reference, control and metric readers stay; these are the entries
# that list it again, each end-to-end metric with a bound from its own runs.
PARKED = {
    "workloads": [
        {"name": "ram.prove-2p20", "config": "ram_permutation-2p20", "traffic": "prove_writes",
         "chips": 1,
         "why": "2^20 rows, proofs back to back over one resident witness (LDE 2^22): the prover, "
                "NTT, FRI and Merkle layers work; the check bypassed"},
    ],
    "end_to_end": [
        {"name": "prove_rows_per_s", "unit": "rows/s", "better": "higher",
         "source": "host_clock", "workloads": ["ram.prove-2p20"]},
    ],
    "per_layer": [
        dict(name=name, unit=unit, better=better, source=source, layer=layer,
             moves="prove_rows_per_s", workloads=["ram.prove-2p20"])
        for name, unit, better, source, layer in [
            ("device_idle_pct.prove", "%", "lower", "device_trace", "device"),
            ("p2_perm_roofline.prove", "%", "higher", "device_trace", "kernels"),
            ("prove_ms", "ms", "lower", "host_clock", "prover"),
            ("verify_ms", "ms", "lower", "host_clock", "prover"),
        ]
    ],
}


def bench() -> dict:
    """BENCHMARK.json with the parked cells and their metrics listed."""
    loaded = spec.load()
    return dict(loaded, **{k: loaded[k] + v for k, v in PARKED.items()})


def config(bench: dict, cell_name: str) -> dict:
    cfg = spec.config(bench, spec.cell(bench, cell_name)["config"])
    return dict(cfg, **SMALL[cfg["circuit"]])


# a window that holds a few units at these sizes on the CPU, by kind of work
SECONDS = {"check": 4.0, "prove": 12.0}
