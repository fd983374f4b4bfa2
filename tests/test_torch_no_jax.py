"""The torch port never imports jax, the JAX package or bench.py: every module
of zkevm_circuits_tpu_torch, and chip_smoke.py, is imported in a fresh
interpreter, and none of them may be in sys.modules afterwards."""

import os
import subprocess
import sys

import pytest

import zkevm_circuits_tpu_torch
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg_dir = os.path.dirname(zkevm_circuits_tpu_torch.__file__)
    mods = []
    for dirpath, _, files in os.walk(pkg_dir):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), _ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


# jax, the JAX package (even its modules that do not import jax) and bench.py
# must all be absent after the port's modules are imported
_FORBIDDEN_CHECK = (
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'zkevm_circuits_tpu', 'bench'))\n"
    "assert not bad, bad\n"
)


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "zkevm_circuits_tpu_torch.ops.poseidon2_cuda" in mods
    assert "zkevm_circuits_tpu_torch.prover.pipeline" in mods
    assert "zkevm_circuits_tpu_torch.models.vm.circuit" in mods
    assert "zkevm_circuits_tpu_torch.isa.opcodes" in mods
    for name in ("prover.poseidon2_air", "prover.recursion_proofs", "prover.logup",
                 "models.recursion", "ops.keccak", "models.vm.sim", "models.vm.compact",
                 "entry", "models.sort_decommittment_requests", "models.demux_log_queue",
                 "models.storage_validity", "models.log_sorter", "models.linear_hasher",
                 "ops.sha256", "ops.secp256k1", "ops.blake2s", "tables",
                 "models.precompile_common", "models.sha256_round_function",
                 "models.code_unpacker_sha256", "models.keccak256_round_function",
                 "models.ecrecover", "models.storage_application", "models.eip_4844",
                 "runtime.block", "prover.air_common", "prover.demux_air",
                 "prover.horner_air", "prover.sha256_air", "prover.keccak_air",
                 "prover.blake2s_air", "prover.ecrecover_air", "prover.vm_air",
                 "prover.verifier_air", "base_structures.vm_state", "models.scheduler",
                 "runtime.block2", "runtime.chain", "parallel", "parallel.mesh",
                 "parallel.sharded", "parallel.prover", "parallel.auto", "utils.shard_plan"):
        assert f"zkevm_circuits_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        + _FORBIDDEN_CHECK
    )
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_rank_helpers_of_the_parallel_tests_import_no_jax():
    """The ranks of the multi-rank tests import tests/torch_parallel_ranks.py."""
    code = "import sys; import torch_parallel_ranks\n" + _FORBIDDEN_CHECK
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_ROOT, os.path.join(_ROOT, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# the test files that the card runs with --noconftest (tests/conftest.py
# imports JAX); they import tests/torch_test_policy.py, as the gloo ranks do
GPU_TEST_MODULES = ("test_torch_chain_kernel", "test_torch_kernels", "test_torch_parallel_gpu")


@pytest.mark.parametrize("module", GPU_TEST_MODULES)
def test_gpu_test_modules_import_no_jax(module):
    code = f"import sys; import {module}\n" + _FORBIDDEN_CHECK
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_ROOT, os.path.join(_ROOT, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_no_jax():
    code = "import sys; import chip_smoke\n" + _FORBIDDEN_CHECK
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    """Without a card the smoke script fails and prints no result line."""
    code = ("import sys, torch, runpy; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['chip_smoke.py']; runpy.run_path('chip_smoke.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          env=dict(os.environ, PYTHONPATH=_ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout
