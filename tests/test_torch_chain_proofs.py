"""The port's queue-chain STARK (prover/poseidon2_air.py) proven and verified
on the CPU, with the tamper cases of the JAX package's own chain tests
(tests/test_poseidon2_air.py): a changed final state, message or initial
state must be rejected, as the JAX verifier rejects them.

The proven final state is held against the native C++ sponge chain, exactly.
The JAX package's proofs of the same chains, and its verdicts on these same
tampers, are compared in test_torch_sorter_full_slow.py (a cold JAX chain
proof costs minutes of XLA:CPU compiles).
"""

import numpy as np
import pytest

from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import poseidon2_air as pa
from zkevm_circuits_tpu_torch.prover.stark import StarkParams
from zkevm_circuits_tpu_torch.runtime import native
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

PARAMS = {"narrow": StarkParams(log_n=3, log_blowup=2, num_queries=8, cap_log2=1),
          "full": StarkParams(log_n=3, log_blowup=2, num_queries=8, cap_log2=1)}


def _chain_case(name):
    rng = np.random.default_rng(0 if name == "narrow" else 1)
    if name == "narrow":
        enc = rng.integers(0, gf.MODULUS, size=(2, 20), dtype=np.uint64)
        init = np.zeros(4, np.uint64)
        spec, final = pa.NARROW, native.narrow_chain(enc, None, init)[-1]
    else:
        enc = rng.integers(0, gf.MODULUS, size=(8, 8), dtype=np.uint64)
        init = rng.integers(0, gf.MODULUS, size=4, dtype=np.uint64)
        spec = pa.FULL
        final = native.full_state_chain(enc, None, np.concatenate([np.zeros(8, np.uint64),
                                                                   init]))[-1]
    proof, publics, params = pa.prove_queue_chain(enc, init, spec, PARAMS[name], "cpu")
    return dict(enc=enc, init=init, spec=spec, final=final, proof=proof,
                pub=gf.to_u64(publics), params=params)


@pytest.fixture(scope="module")
def chains():
    return {name: _chain_case(name) for name in PARAMS}


@pytest.mark.parametrize("name", list(PARAMS))
def test_proven_final_state_is_the_sponge_chain(chains, name):
    c = chains[name]
    w = c["spec"].out_width
    np.testing.assert_array_equal(c["pub"][:4], c["init"])
    np.testing.assert_array_equal(c["pub"][4:4 + w], c["final"])
    assert c["pub"].shape == (c["spec"].num_public,)


def _wrong_final(c):
    bad = c["final"].copy()
    bad[0] ^= np.uint64(1)
    return c["enc"], c["init"], bad


def _wrong_message(c):
    enc = c["enc"].copy()
    enc[1, 7] ^= np.uint64(1)
    return enc, c["init"], c["final"]


def _wrong_init(c):
    init = c["init"].copy()
    init[1] = (int(init[1]) + 5) % gf.MODULUS
    return c["enc"], init, c["final"]


@pytest.mark.parametrize("tamper", [None, _wrong_final, _wrong_message, _wrong_init],
                         ids=["honest", "wrong_final", "wrong_message", "wrong_init"])
@pytest.mark.parametrize("name", list(PARAMS))
def test_chain_verdicts(chains, name, tamper):
    c = chains[name]
    enc, init, final = (c["enc"], c["init"], c["final"]) if tamper is None else tamper(c)
    verdict = pa.verify_queue_chain(c["proof"], enc, init, final, c["spec"], c["params"])
    assert verdict == (tamper is None)


def test_verify_rejects_a_misshapen_claim(chains):
    c = chains["full"]
    assert not pa.verify_queue_chain(c["proof"], c["enc"], c["init"], c["final"][:4],
                                     pa.FULL, c["params"])
