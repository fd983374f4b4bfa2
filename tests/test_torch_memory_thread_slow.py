"""The JAX block runtime's memory-union order against the port's, on one
short precompile program: chip_smoke.py's `memory_program` at two iterations
(two keccak and two sha256 calls, no ecrecover) through the JAX package's
`runtime/block2.py:execute_block2` itself, and through the port's
`runtime/block.py:memory_thread`.

`execute_block2` appends each precompile's executed reads, then all its
writes, to ram_permutation's union (block2.py:316-351), while each circuit's
memory chain absorbs a call's reads and then its write: with two calls of one
precompile its `memory_thread_closes` is false, and nothing else fails.  The
port hands the same rows in the chains' order, and its thread closes.

`slow`: the JAX block runtime takes about nine minutes on a CPU (its EraVM in
Python and thirteen circuits' XLA:CPU compiles).  Run it with
`python -m pytest tests/test_torch_memory_thread_slow.py -m slow`.
"""

import pytest
import torch

import chip_smoke
from zkevm_circuits_tpu.runtime import block2

from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.runtime import block
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

pytestmark = pytest.mark.slow

ITERATIONS = 2  # workers 1 and 2: a keccak and a sha256 call each
LOG2_CODE_WORDS = 4


def test_the_jax_block_runtime_does_not_close_the_thread_and_the_port_does():
    words, kw, _ = chip_smoke.memory_program(ITERATIONS, 2, LOG2_CODE_WORDS)
    cfg = block2.Block2Config(vm_limit=128, sorter_limit=32, unpacker_rounds=64,
                              keccak_blocks=16, keccak_reads=64, sha_rounds=16, ec_calls=1,
                              ram_limit=1024, run_scheduler=False)
    res = block2.execute_block2(words, cfg, storage=kw["storage"], code_store=kw["code_store"],
                                bootloader_heap=kw["bootloader_heap"])
    calls = {k: len(x) for k, x in res.vm.precompile_calls.items()}
    assert calls == {"keccak": 2, "sha256": 2, "ecrecover": 0}
    assert res.handoffs["memory_thread_closes"] is False
    assert res.failing() == ["handoff.memory_thread_closes"]

    v = vm.NativeEraVM(words, 128, **kw)
    w = v.run()
    out, handoffs, counts = block.memory_thread(v, w, kw["code_store"], (16, 16, 32, 1024),
                                                torch.device("cpu"))
    assert (counts["keccak_calls"], counts["sha256_calls"]) == (2, 2)
    assert handoffs["memory_thread_closes"] and all(handoffs.values())
    assert not {n: chip_smoke._bad(r) for n, (_, r, _) in out.items() if chip_smoke._bad(r)}
