"""The port's ecrecover ladder AIR (prover/ecrecover_air.py) against the JAX
package, on the one signed call of tests/test_ecrecover_air.py.

Exact u64 equality with the JAX package for the trace (fixed and phase-1
columns), the phase-2 columns under given challenges, the plaintext claims
(`calls_public_from_witness`, `ladder_records`) and the record RLC, for the
JAX witness and for the port's own witness of the same call.  The port's
constraints vanish on the honest trace, on the CPU, and a flipped scalar bit
or a changed ladder limb makes them non-zero; the verifier's early returns
reject too many calls before any proof is read.  Whole proofs byte-identical
to the JAX package's are in tests/test_torch_circuit_airs_slow.py.
"""

import types

import numpy as np
import pytest
import torch

from torch_air_helpers import all_zero, composition_pair, u64
from zkevm_circuits_tpu.models import ecrecover as jecr
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops import secp256k1 as jec
from zkevm_circuits_tpu.prover import ecrecover_air as jair
from zkevm_circuits_tpu_torch.models import ecrecover as ecr
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.ops import secp256k1 as ec
from zkevm_circuits_tpu_torch.ops.keccak import keccak256_ref
from zkevm_circuits_tpu_torch.prover import ecrecover_air
from zkevm_circuits_tpu_torch.prover.air_common import residuals
from zkevm_circuits_tpu_torch.prover.stark import StarkParams
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CHALLENGES = [(0x1234567, 0x89ABCDEF), (gf.MODULUS - 1, 3)]
# the phase-2 columns (a Fermat inversion a byte cell) are built under one
CH = CHALLENGES[0]
PRIV = 0xC0FFEE


def signed_call():
    """tests/test_ecrecover_air.py's call: one signature over keccak("zk
    block"), its ABI in memory."""
    h = int.from_bytes(keccak256_ref(b"zk block"), "big")
    r, s, recid = ec.sign(h, PRIV, 0x12345)
    in_page, out_page = 7, 9
    key = (2 << 64) | (in_page << 128) | (out_page << 160)
    call = dict(address=0x1, key=key, read_value=0, written_value=0, rw_flag=False, aux_byte=4,
                rollback=False, is_service=True, shard_id=0, tx_number_in_block=0, timestamp=100)
    mem = {(in_page, 0): h.to_bytes(32, "big"), (in_page, 1): recid.to_bytes(32, "big"),
           (in_page, 2): r.to_bytes(32, "big"), (in_page, 3): s.to_bytes(32, "big")}
    return [call], mem


@pytest.fixture(scope="module")
def witnesses():
    calls, mem = signed_call()
    jw = jecr.generate_witness(calls, mem, jecr.EcrecoverConfig(max_calls=1))
    pw = ecr.generate_witness(calls, mem, ecr.EcrecoverConfig(max_calls=1), device="cpu")
    return jw, pw


@pytest.fixture(scope="module")
def jax_side(witnesses):
    jw = witnesses[0]
    fixed, phase1, log_n = jair.build_ecrecover_trace(jw)
    cols = jgf.concat([fixed, phase1], axis=0)
    cp = jair.calls_public_from_witness(jw)
    return dict(fixed=u64(fixed), phase1=u64(phase1), log_n=log_n, cp=cp,
                phase2=u64(jair._build_phase2(cols, CH)),
                rlc=[jair.records_rlc(jair.ladder_records(cp), ch[1]) for ch in CHALLENGES])


@pytest.fixture(scope="module")
def port_cols(witnesses):
    return ecrecover_air.build_ecrecover_trace(witnesses[1], device="cpu")


@pytest.fixture(scope="module")
def port_phase2(port_cols):
    fixed, phase1, _ = port_cols
    return ecrecover_air._build_phase2(torch.cat([fixed, phase1]), CH)


@pytest.mark.parametrize("which", ["jax_witness", "port_witness"])
def test_trace_matches_jax(jax_side, witnesses, port_cols, which):
    fixed, phase1, log_n = (port_cols if which == "port_witness"
                            else ecrecover_air.build_ecrecover_trace(witnesses[0], device="cpu"))
    assert log_n == jax_side["log_n"]
    np.testing.assert_array_equal(gf.to_u64(fixed), jax_side["fixed"])
    np.testing.assert_array_equal(gf.to_u64(phase1), jax_side["phase1"])


def test_phase2_matches_jax(jax_side, port_phase2):
    np.testing.assert_array_equal(gf.to_u64(port_phase2), jax_side["phase2"])


@pytest.mark.parametrize("k", range(len(CHALLENGES)))
def test_claims_and_record_rlc_match_jax(jax_side, witnesses, k):
    cp = ecrecover_air.calls_public_from_witness(witnesses[1])
    assert cp == jax_side["cp"]
    assert ecrecover_air.ladder_records(cp) == jair.ladder_records(jax_side["cp"])
    assert ecrecover_air.records_rlc(ecrecover_air.ladder_records(cp),
                                     CHALLENGES[k][1]) == jax_side["rlc"][k]
    # the claims recover the signer: acc1 + acc2 == priv G
    a1, a2 = cp[0]["acc1"], cp[0]["acc2"]
    q = jec.add(a1, a2) if a1 else a2
    assert jec.eth_address(q) == jec.eth_address(jec.mul(PRIV, (jec.GX, jec.GY)))


@pytest.mark.parametrize("tamper", ["none", "scalar_bit", "ladder_limb"])
def test_constraints_vanish_and_catch_tampering(witnesses, port_cols, port_phase2, tamper):
    """The tampered traces keep the honest phase-2 columns: the selector
    algebra and the limb identities fail on phase 1 alone."""
    fixed, phase1, _ = port_cols
    cp = ecrecover_air.calls_public_from_witness(witnesses[1])
    _, p1, _ = ecrecover_air.layout()
    bad = phase1.clone()
    if tamper == "scalar_bit":
        bad[p1.at("bit"), 5] ^= 1
    elif tamper == "ladder_limb":
        bad[p1.at("bnx_b", 3), 9] ^= 1
    pub = gf.from_u64(np.array([ecrecover_air.records_rlc(ecrecover_air.ladder_records(cp),
                                                          CH[1])], np.uint64))
    res = residuals(ecrecover_air.ecrecover_air(), torch.cat([fixed, bad, port_phase2]), pub, CH)
    assert all_zero(res) is (tamper == "none")


def test_flipped_scalar_bit_changes_the_claims_rlc(witnesses):
    """The verifier's public: a claim with one scalar bit flipped gives
    another record RLC (the honest trace cannot close on it)."""
    cp = ecrecover_air.calls_public_from_witness(witnesses[1])
    bad = [dict(cp[0], u1=cp[0]["u1"] ^ 1)]
    g = CH[1]
    assert (ecrecover_air.records_rlc(ecrecover_air.ladder_records(bad), g)
            != ecrecover_air.records_rlc(ecrecover_air.ladder_records(cp), g))


def test_verifier_early_returns(witnesses):
    cp = ecrecover_air.calls_public_from_witness(witnesses[1])
    # 2 * 256 rows a call must stay below the trace's rows
    assert not ecrecover_air.verify_ecrecover(None, cp * 2, StarkParams(log_n=10))
    two_caps = types.SimpleNamespace(caps=[None] * 2,
                                     q_cap=torch.zeros((2, 4), dtype=torch.int64))
    assert not ecrecover_air.verify_ecrecover(two_caps, cp, StarkParams(log_n=10))


def test_composition_matches_jax():
    """The constraints of the AIR, alpha-composed by the JAX prover's
    `_compose_rows` and by the port's, agree on random rows."""
    want, got = composition_pair(jair.ecrecover_air(), ecrecover_air.ecrecover_air(), seed=7)
    np.testing.assert_array_equal(got, want)
