"""The sharded STARK commit (`parallel/prover.py`) and `stark.prove(...,
commit_fn=)`: the port's gloo worlds of 2 and 4 ranks against the port's
single-device `_commit_columns` and proof.

Seeded columns of 2^8-2^10 rows, one group with a column count that is not
a multiple of the world size, give the same cap, leaves and levels as u64
on every rank; a grand-product proof of a 2^8-row ram witness made through
`make_sharded_commit` equals the single-device proof as nested ints and
verifies.  (The single-device commit and proof are held to the JAX
package's in tests/test_torch_prover_ops.py and test_torch_ram_prover.py;
the JAX package's own `sharded_commit_columns` takes minutes of XLA:CPU
compiles, and is compared in tests/test_torch_parallel_slow.py.)  Each
world is started once for the file and joined within
the time limit of the test that waits on it (tests/torch_test_policy.py).
"""

import numpy as np
import pytest

import torch_parallel_ranks as ranks
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import pipeline, stark
from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

SHAPES = ((8, 8), (5, 9), (3, 10))  # (columns, log2 rows); 5 and 3 split unevenly


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    worlds = ranks.start_worlds(ranks.commit_rank, (SHAPES,), tmp_path_factory.mktemp("worlds"))
    return {d: f.result() for d, f in worlds.items()}


@pytest.fixture(scope="module")
def single():
    """The single-device trees of the same columns, and the proof."""
    trees = [stark._commit_columns(cols, stark.StarkParams(log_n=log_n))
             for cols, (_, log_n) in zip(ranks.commit_columns(SHAPES), SHAPES)]
    w, _ = ranks.ram_witness(1 << 8, 1 << 5)
    proof, _, _ = pipeline.prove_permutation_argument(w)
    return trees, proof_to_ints(proof)


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("world", ranks.WORLDS)
def test_sharded_commit_is_the_single_device_tree(ranks_out, single, world, shape):
    want = single[0][shape]
    assert len(ranks_out[world]) == world
    for out in ranks_out[world]:
        got = out["trees"][shape]
        assert np.array_equal(got["cap"], gf.to_u64(want["cap"]))
        assert np.array_equal(got["leaves"], gf.to_u64(want["leaves"]))
        assert len(got["levels"]) == len(want["levels"])
        for a, b in zip(got["levels"], want["levels"]):
            assert np.array_equal(a, gf.to_u64(b))


@pytest.mark.parametrize("world", ranks.WORLDS)
def test_proof_through_the_sharded_commit_is_the_single_device_proof(ranks_out, single, world):
    for out in ranks_out[world]:
        assert out["verified"]
        assert out["proof"] == single[1]
