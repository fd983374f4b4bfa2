"""A new configuration, cell or metric is found from new files alone, and
nothing the benchmark runs or its references import is JAX or the JAX
package (whole top-level names)."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.lib import guard, spec
from benchmark.tests import small

ROOT = spec.ROOT
BENCH = os.path.join(ROOT, "benchmark")


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for name in files:
            if name.endswith((".py", ".json")):
                path = os.path.join(base, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_config_cell_and_metric_from_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    (tmp_path / "benchmark" / "configs" / "ram_permutation-2p18.json").write_text(
        json.dumps(dict(circuit="ram_permutation", rows=1 << 18, chain_stride=512)))
    (tmp_path / "benchmark" / "traffic" / "check_once.json").write_text(
        json.dumps(dict(entry="check", instances=1, tampered=0, tampers=[])))
    (tmp_path / "benchmark" / "metrics" / "chain_ms.check.py").write_text(
        "def read(ctx):\n    return ctx['trace_ms']\n")
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="ram_permutation-2p18", source="https://example.org",
                                 file="benchmark/configs/ram_permutation-2p18.json",
                                 reduced=["rows"], why="a smaller trace"))
    bench["workloads"].append(dict(name="ram.check-once-2p18", config="ram_permutation-2p18",
                                   traffic="check_once", chips=1, why="the honest witness alone"))
    bench["per_layer"].append(dict(name="chain_ms.check", unit="ms", better="lower",
                                   source="device_trace", layer="kernels",
                                   moves="check_rows_per_s",
                                   workloads=["ram.check-once-2p18"]))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)

    loaded = spec.load(str(tmp_path))
    cell = spec.cell(loaded, "ram.check-once-2p18")
    assert spec.config(loaded, cell["config"], str(tmp_path))["rows"] == 1 << 18
    assert spec.traffic(cell["traffic"], str(tmp_path))["instances"] == 1
    assert spec.runner("ram_permutation", "check").__name__ == "Runner"
    names = [m["name"] for m in spec.metrics(loaded, "ram.check-once-2p18", "per_layer")]
    assert names == ["chain_ms.check"]
    assert spec.reader("chain_ms.check", str(tmp_path))(dict(trace_ms=1.5)) == 1.5
    # metrics without a cell list reach the new cell too
    assert "setup_s" in [m["name"] for m in spec.metrics(loaded, "ram.check-once-2p18",
                                                          "end_to_end")]
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before


def test_every_metric_and_cell_of_the_benchmark_has_its_files():
    bench = small.bench()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        assert spec.runner(cfg["circuit"], spec.traffic(w["traffic"])["entry"])


def test_forbidden_names_are_whole_top_level_names():
    assert guard.forbidden(["zkevm_circuits_tpu_torch.ops.gf", "torch", "numpy"]) == []
    assert guard.forbidden(["zkevm_circuits_tpu.ops.gf"]) == ["zkevm_circuits_tpu"]
    assert guard.forbidden(["jax._src.core", "jaxtyping", "flax"]) == ["flax", "jax"]
    assert guard.forbidden(["jaxlib"]) == ["jaxlib"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_nothing_of_the_program_or_jax():
    ref_dir = os.path.join(BENCH, "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            tops = {guard.top_level(m) for m in _imports(os.path.join(ref_dir, name))}
            assert not tops & {"zkevm_circuits_tpu_torch", "zkevm_circuits_tpu", "jax",
                               "jaxlib", "flax"}, name


def test_a_run_loads_no_jax_nor_the_jax_package():
    """every cell, the parked ones too, at small sizes on the CPU, in a
    process of their own: what run.py, the runners, the port and the
    references load."""
    code = f"""
import sys, time, torch
sys.path.insert(0, {ROOT!r})
from benchmark import run
from benchmark.lib import guard, spec
from benchmark.tests import small
from benchmark.tests import small
bench = small.bench()
for cell in [w["name"] for w in bench["workloads"]]:
    r = run.run_cell(bench, cell, 7, 0.1, False, torch.device("cpu"), time.perf_counter(),
                     config=small.config(bench, cell))
    assert r["correct"], r
assert "zkevm_circuits_tpu_torch" in sys.modules
print("FORBIDDEN", guard.forbidden(list(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
