"""`entry.dryrun_multichip` in a gloo world of two CPU ranks, at small sizes.

The dry run's phases as they run on the cards (a 2 x 1 mesh for the ram
check, the compact forms and main_vm, a 1 x 2 mesh for the eight circuits
of `parallel/cases.py` and the sharded commit), each checking itself: the
sharded ram check and main_vm all true, the boundary tamper caught, each
circuit's sharded residuals equal to its unsharded ones, all true, and a
tamper caught, the sharded commit bit-identical to `_commit_columns`, the
proof through it verified and equal to the single-device proof on rank 0.
The test waits for the world to end; only its time limit
(tests/torch_test_policy.py) bounds it.  Imports no JAX.
"""

from zkevm_circuits_tpu_torch import entry
from zkevm_circuits_tpu_torch.parallel import cases
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

SMALL = entry.DryrunSizes(log2_ram_rows=8, log2_ram_limit=5, log2_vm_auto=7, log2_vm_cycles=8,
                          log2_vm_limit=6, log2_prove_rows=6, chain_stride=16, bench_rounds=40,
                          demux_rows=16, decommit_rows=16, hasher_queries=16, blob_elements=16,
                          storage_rows=16, sha256_rounds=16, unpacker_rounds=16,
                          ecrecover_calls=1)
PHASES = sorted(["1", "2", "3a", "3b", "4a", "4b"] + [f"3c.{name}" for name in cases.CIRCUITS])


def test_dryrun_on_two_cpu_ranks():
    out = entry.dryrun_multichip(2, "cpu", SMALL)
    assert out["mesh"] == {"inst": 2, "rows": 1}
    assert out["proof_equal"] is True
    assert sorted(out["records"]) == PHASES
    assert [out["records"][f"3c.{name}"]["rows"] for name in cases.CIRCUITS] == [
        16, 16, 16, 16, 16, 16, 16, 512]
    assert out["card"] == "cpu"
