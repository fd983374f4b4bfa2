"""The whole block in the torch port on the CPU (runtime/block2.py,
runtime/chain.py).

`execute_block2` over tests/torch_block_helpers.py's straight program (a
storage write and read, an event, an L1 message and one call of each
precompile) at `vm_limit=64` and limits of 16, no proofs: all 13 circuit
types have work and the block is ok; the JAX package's `run_scheduler`, fed
the port's compact forms, derived inputs, node proofs and aux output,
gives the port's checks and public input.  A changed row of the VM's memory
tape fails the block's memory thread, and input derivation from a heap the
VM did not start with fails main_vm's.  `execute_chain` over two blocks, the
second overwriting the first's storage cell: the content hashes threaded,
the storage carried over, and the interblock aggregate equal to the JAX
package's on the same public inputs, its masked slots included.
"""

import numpy as np
import pytest
import torch

from torch_block_helpers import jax_field, jax_scheduler_inputs, straight_block_program, u64
from zkevm_circuits_tpu.models import recursion as jrec
from zkevm_circuits_tpu.models import scheduler as jsched
from zkevm_circuits_tpu_torch.isa import opcodes as isa
from zkevm_circuits_tpu_torch.models import recursion, scheduler, vm
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.runtime import block, block2, chain
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = torch.device("cpu")
CONFIG = block2.Block2Config(vm_limit=64, vm_instance_limit=16, sorter_limit=16, hasher_limit=16,
                             unpacker_rounds=16, keccak_blocks=16, keccak_reads=16, sha_rounds=16,
                             ec_calls=1, storage_rows=16, ram_limit=16)
enc = isa.encode_instruction


@pytest.fixture(scope="module")
def run():
    words, kw = straight_block_program()
    return words, kw, block2.execute_block2(words, CONFIG, device=CPU, **kw)


def test_block_on_the_cpu(run):
    _, _, res = run
    assert res.ok, res.failing()
    assert sorted(res.compact_forms) == list(range(1, 14))
    assert int(res.compact_forms[1].start_flag.shape[0]) == 4  # 64 cycles in instances of 16
    assert res.handoffs["memory_thread_closes"] and len(res.handoffs) == 12
    assert {k: len(c) for k, c in res.vm.precompile_calls.items()} == dict(
        keccak=1, sha256=1, ecrecover=1)
    assert res.vm.cs_depth == 0 and res.l1_messages_hash is not None
    assert res.scheduler_inputs["required_types"] == set(range(1, 14))
    assert res.compact_forms[8].start_flag.device == CPU


def test_jax_scheduler_on_the_port_block(run):
    _, _, res = run
    jres = jsched.run_scheduler(**jax_scheduler_inputs(res.scheduler_inputs))
    assert list(jres.checks.items()) == list(res.scheduler_result.checks.items())
    np.testing.assert_array_equal(u64(jres.public_input), u64(res.scheduler_result.public_input))
    assert jres.block_content_hash == res.scheduler_result.block_content_hash


def test_derived_inputs_bind_the_bootloader_heap(run):
    """`derive_inputs` rebuilt from the run gives the block's derived inputs;
    rebuilt from a heap the VM did not start with, it fails main_vm's input
    derivation and nothing else"""
    words, kw, res = run
    v = vm.EraVM(words, CONFIG.vm_limit, **kw)
    w = v.run()
    out = {name: (x,) for name, x in res.witnesses.items()}
    derived, required = block2.derive_inputs(v, w, out, kw["storage"], kw["bootloader_heap"], 0,
                                             res.compact_forms)
    honest = res.scheduler_inputs["derived_observable_inputs"]
    assert required == set(honest) and all(torch.equal(derived[t], honest[t]) for t in honest)
    heap = {**kw["bootloader_heap"], 0: kw["bootloader_heap"][0] ^ 1}
    forged, _ = block2.derive_inputs(v, w, out, kw["storage"], heap, 0, res.compact_forms)
    got = scheduler.run_scheduler(**dict(res.scheduler_inputs, derived_observable_inputs=forged))
    assert [k for k, ok in got.checks.items() if not ok] == ["main_vm_input_derivation"]


def test_changed_memory_tape_row_fails(run):
    """one value of the VM's memory tape changed: ram_permutation's unsorted
    queue no longer ends where the memory thread does"""
    words, kw, res = run
    v = vm.EraVM(words, CONFIG.vm_limit, **kw)
    w = v.run()
    row = len(v.memory_tape) // 2
    v.memory_tape[row] = dict(v.memory_tape[row], value=v.memory_tape[row]["value"] ^ 1)
    done = {name: (res.witnesses[name], None, None) for name in ("main_vm", "sort_decommittments")}
    out, handoffs, _ = block.memory_thread(v, w, {**kw["code_store"], v.boot_code_hash: words},
                                           (16, 16, 16, 16), CPU, done=done,
                                           capacities=(16, 16, 16, 16), ec_calls=1)
    failing = [k for k, x in handoffs.items() if not x]
    failing += [f"ram_permutation.{k}" for k, x in out["ram_permutation"][1].items()
                if not bool(x.all())]
    assert failing and "memory_thread_closes" in failing


def _storage_block(key, value):
    return vm.assemble_code_words([
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=key, src1=0, dst0=2),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=value, src1=0, dst0=3),
        enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=2, src1=3),
        enc(isa.LOG, isa.LOG_STORAGE_READ, src0=2, dst0=4),
        enc(isa.RET, isa.RET_OK),
    ])


def test_chain_threads_hashes_storage_and_aggregate():
    cfg = block2.Block2Config(vm_limit=16, sorter_limit=16, ram_limit=64)
    cr = chain.execute_chain([{"code": _storage_block(5, 111)}, {"code": _storage_block(5, 222)}],
                             cfg, aggregator_capacity=4, device=CPU)
    assert cr.ok, [b.failing() for b in cr.blocks]
    assert len(cr.content_hashes) == 2 and cr.content_hashes[0] != cr.content_hashes[1]
    # block 2's public input binds block 1's content hash
    assert cr.blocks[1].scheduler_inputs["previous_block_content_hash"] == cr.content_hashes[0]
    # block 2's write to key 5 sees block 1's value as its prior value
    v2 = cr.blocks[1].vm
    writes = [q for q in v2.log_tape if q["rw_flag"] and q["key"] == 5]
    reads = [q for q in v2.log_tape if not q["rw_flag"] and q["key"] == 5]
    assert writes and writes[0]["read_value"] == 111 and reads[0]["read_value"] == 222
    # the aggregate equals the JAX package's, the masked slots included
    pis = [b.scheduler_result.public_input for b in cr.blocks]
    jpis = [jax_field(p) for p in pis]
    zeros = [jax_field(gf.zeros((4,), CPU))] * 2
    assert jrec.interblock_aggregate_keccak(jpis + zeros, [True, True, False, False]) \
        == cr.aggregated_input
    forged = [gf.from_u64(np.array([9, 9, 9, 9], np.uint64), CPU)] * 2
    jforged = [jax_field(p) for p in forged]
    for valid in ([True, True, False, False], [True, True, True, False]):
        assert recursion.interblock_aggregate_keccak(pis + forged, valid) == \
            jrec.interblock_aggregate_keccak(jpis + jforged, valid)
    assert recursion.interblock_aggregate_keccak(pis + forged, [True, True, False, False]) \
        == cr.aggregated_input
    assert recursion.interblock_aggregate_keccak(pis + forged, [True, True, True, False]) \
        != cr.aggregated_input
