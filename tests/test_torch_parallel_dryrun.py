"""`entry.dryrun_multichip` in a gloo world of two CPU ranks, at small sizes.

The dry run's four phases as they run on the cards (a 2 x 1 mesh for the
ram check, the compact forms and main_vm, a 1 x 2 mesh for the sharded
commit), each checking itself: the sharded ram check and main_vm all true,
the boundary tamper caught, the sharded commit bit-identical to
`_commit_columns`, the proof through it verified and equal to the
single-device proof on rank 0.  The world is joined within
`torch_parallel_ranks.DEADLINE_S`.  Imports no JAX.
"""

import torch_parallel_ranks as ranks
from zkevm_circuits_tpu_torch import entry

SMALL = entry.DryrunSizes(log2_ram_rows=8, log2_ram_limit=5, log2_vm_auto=7, log2_vm_cycles=8,
                          log2_vm_limit=6, log2_prove_rows=6, chain_stride=16, bench_rounds=40)


def test_dryrun_on_two_cpu_ranks():
    out = entry.dryrun_multichip(2, "cpu", SMALL, deadline_s=ranks.DEADLINE_S)
    assert out["mesh"] == {"inst": 2, "rows": 1}
    assert out["proof_equal"] is True
    assert sorted(out["records"]) == ["1", "2", "3a", "3b", "4a", "4b"]
    assert out["card"] == "cpu"
