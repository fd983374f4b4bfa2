"""The recursion node's in-field proof (prover/recursion_proofs.py:
`node_prove_in_field`, `node_verify_in_field`) on the CPU, over two leaf
instances' compact-form commitment STARKs as children (the shape of
tests/test_verifier_air.py's last test): accepted, and rejected when one
child is swapped for another carried proof (the other child's, itself
valid).  The JAX package's node proof
over the same children is compared in tests/test_torch_vm_verifier_airs_slow.py.
"""

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


class CompactForms:
    """Stands in for a circuit's compact forms: `encode()` and the device."""

    def __init__(self, enc):
        self._enc = enc
        self.start_flag = torch.zeros(enc.shape[0], dtype=torch.bool)

    def encode(self):
        return gf.from_u64(self._enc, "cpu")


@pytest.fixture(scope="module")
def node():
    rng = np.random.default_rng(9)
    carried = rp.make_carried_proofs(CompactForms(
        rng.integers(0, gf.MODULUS, size=(2, 18), dtype=np.uint64)))
    return carried, rp.node_prove_in_field(carried)


def test_node_in_field_accepts_its_children(node):
    carried, proof = node
    assert proof.vproof.q_cap.device.type == "cpu"
    assert rp.node_verify_in_field(proof, carried)


def test_node_in_field_rejects_a_swapped_child(node):
    carried, proof = node
    assert not rp.node_verify_in_field(proof, [carried[1], carried[1]])
