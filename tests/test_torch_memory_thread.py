"""The block's memory thread in the torch port on the CPU: chip_smoke.py's
precompile program (`memory_program`, short codes and 16 iterations) through
the native EraVM, then `runtime.block.memory_thread` — main_vm, the decommit sorter,
the code unpacker on its result queue, the keccak, sha256 and ecrecover
circuits each continuing the memory queue, ram_permutation over the union —
as the JAX package's block runtime wires them (runtime/block2.py:257-381).

Every residual (main_vm's included) and handoff true, every precompile
output the host's, the five negative probes of the phase failing as
pinned; the JAX package's
circuits on the same tapes build the same witnesses, so the thread's states
are the JAX package's; and the JAX block runtime's union order (a circuit's
reads, then its writes) does not close the thread once a precompile is
called twice.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from torch_precompile_helpers import assert_same_witness
from zkevm_circuits_tpu.models import code_unpacker_sha256 as jcu
from zkevm_circuits_tpu.models import ecrecover as jec
from zkevm_circuits_tpu.models import keccak256_round_function as jkc
from zkevm_circuits_tpu.models import sha256_round_function as jsh

from zkevm_circuits_tpu_torch.base_structures.memory_query import encode_memory_queries_np
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.runtime import block, native
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = torch.device("cpu")
LIMITS = (8, 4, 16, 256)  # unpacker / sha256 rounds, keccak blocks, decommit rows, ram rows


@pytest.fixture(scope="module")
def run():
    words, kw, host = chip_smoke.memory_program(16, 2, 4)
    v = vm.NativeEraVM(words, 1024, **kw)
    w = v.run()
    out, handoffs, counts = block.memory_thread(v, w, kw["code_store"], LIMITS, CPU)
    return v, w, kw, host, out, handoffs, counts


def test_memory_thread_on_the_cpu(run):
    v, w, kw, host, out, handoffs, counts = run
    assert not {n: chip_smoke._bad(r) for n, (_, r, _) in out.items() if chip_smoke._bad(r)}
    assert all(handoffs.values()) and len(handoffs) == 6
    assert chip_smoke.precompile_outputs(out, host) == 16 + 16 + 2 * 2
    assert counts["keccak_calls"] == counts["sha256_calls"] == 16
    assert counts["ecrecover_calls"] == 2 and counts["unique_codes"] == 12
    assert counts["unpacker_rounds"] == 12 * 9
    assert "main_vm" in out  # the VM itself accepts the program's trace
    got = chip_smoke.memory_probes(out, LIMITS)
    assert set(got) == {"sha256 state word", "keccak digest byte", "keccak FSM boundary",
                        "unpacked code word", "ecrecover ladder limb"}


def test_the_jax_circuits_build_the_same_witnesses_on_the_same_tapes(run):
    """each JAX circuit from the same calls, memory and the port's thread
    state before it: the same witness, so the same thread"""
    v, w, kw, host, out, handoffs, counts = run
    uw = out["code_unpacker"][0]
    store = {**kw["code_store"], v.boot_code_hash: v.code_words}
    uniq = block.soa_rows(out["sort_decommittments"][0].result_items,
                            out["sort_decommittments"][0].result_add)
    vm_final = np.asarray(w["mem_q_state"][-1], np.uint64)
    jw = jcu.generate_witness(uniq, store, jcu.CodeUnpackerConfig(uw.round_execute.shape[0]),
                              mem_init_state=vm_final)
    assert_same_witness(uw, jw, ("request_chain", "mem_chain"))
    calls, memory = v.precompile_calls, v.precompile_memory
    thread = gf.to_u64(uw.mem_chain[-1])
    kw_ = out["keccak256"][0]
    jk = jkc.generate_witness(calls["keccak"], memory, jkc.KeccakRoundFunctionConfig(
        kw_.block_execute.shape[0], kw_.reads.shape[0]), mem_init_state=thread)
    assert_same_witness(kw_, jk, ("call_chain", "mem_chain", "mem_order_encodings"))
    sw = out["sha256"][0]
    js = jsh.generate_witness(calls["sha256"], memory, jsh.Sha256RoundFunctionConfig(
        sw.round_execute.shape[0]), mem_init_state=gf.to_u64(kw_.mem_chain[-1]))
    assert_same_witness(sw, js, ("call_chain", "mem_chain", "mem_order_encodings"))
    ew = out["ecrecover"][0]
    je = jec.generate_witness(calls["ecrecover"], memory, jec.EcrecoverConfig(2),
                              mem_init_state=gf.to_u64(sw.mem_chain[-1]))
    assert_same_witness(ew, je, ("call_chain", "mem_chain"))
    rw = out["ram_permutation"][0]
    assert np.array_equal(gf.to_u64(rw.chain_unsorted[rw.n]),
                          np.asarray(je.mem_chain[-1].astype_u64()))


def _tail(tapes):
    enc = encode_memory_queries_np(**tapes)
    n = enc.shape[0]
    states = native.full_state_chains(enc[None], np.ones((1, n), np.uint8),
                                      np.zeros((1, 12), np.uint64))
    return states[0, n]


def test_the_jax_union_order_does_not_close_the_thread(run):
    """block2.py:316-351 hands each precompile's executed reads, then its
    writes, to ram_permutation's union; the circuits' memory chains absorb a
    call's reads and then its write, so with 16 keccak and 16 sha256 calls the
    union's tail is not the thread's last state, while the order the port's
    wiring takes is (ROADMAP Queue 3)"""
    v, w, kw, host, out, handoffs, counts = run
    uw, kw_, sw, ew = (out[k][0] for k in ("code_unpacker", "keccak256", "sha256", "ecrecover"))
    n_k, n_s, n_e = kw_.num_calls, sw.num_calls, ew.num_calls
    parts = [[dict(r) for r in v.initial_mem_rows], v.memory_tape,
             (uw.writes, torch.nonzero(uw.write_execute).flatten()),
             (kw_.reads, torch.nonzero(kw_.read_execute).flatten()),
             (kw_.writes, torch.arange(n_k)),
             (sw.reads, torch.nonzero(sw.read_execute).flatten()), (sw.writes, torch.arange(n_s)),
             (ew.reads, torch.arange(4 * n_e)), (ew.writes, torch.arange(2 * n_e))]
    block2_order = block.memory_tapes(parts)
    rw = out["ram_permutation"][0]
    assert block2_order["timestamp"].shape[0] == rw.n
    last = gf.to_u64(ew.mem_chain[-1])
    assert not np.array_equal(_tail(block2_order), last)
    assert np.array_equal(gf.to_u64(rw.chain_unsorted[rw.n]), last)
    assert handoffs["memory_thread_closes"]
