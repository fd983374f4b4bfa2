"""The multi-device dry run on the cards (`gpu`: skips without two cards).

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -m gpu -q

`entry.dryrun_multichip` with one rank a card on every card of the machine
(NCCL): its phases at the main path's widths (the eight circuits of
`parallel/cases.py` at the block cells' rows among them), the
sharded-commit proof equal to the single-device proof.  Imports no JAX.
"""

import pytest
import torch
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


@pytest.mark.gpu
def test_dryrun_multichip_on_every_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    from zkevm_circuits_tpu_torch import entry
    from zkevm_circuits_tpu_torch.parallel import cases

    out = entry.dryrun_multichip()
    assert out["proof_equal"] is True
    assert sorted(out["records"]) == sorted(["1", "2", "3a", "3b", "4a", "4b"]
                                            + [f"3c.{name}" for name in cases.CIRCUITS])
    launches = {k: sum(r["launches"][k] for r in out["records"].values())
                for k in ("permutation", "permutation_small")}
    assert all(v > 0 for v in launches.values()), launches
