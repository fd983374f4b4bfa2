"""The port's keccak, sha256 and blake2s AIRs (prover/keccak_air.py,
prover/sha256_air.py, prover/blake2s_air.py) against the JAX package.

Exact u64 equality with the JAX package for the phase-1 traces, the fixed
columns, the phase-2 column under one gamma and the digests: keccak on 1-
and 2-block messages, sha256 on 1- and 2-block messages and on raw blocks,
blake2s on a batch of 40- and 64-byte calls.  The plaintext RLCs (the
publics' last value) are equal under one gamma.  The port's constraints
vanish on the honest trace, on the CPU, and a flipped state bit makes them
non-zero.  The verifiers' early returns reject wrong lengths before any
proof is read.  Whole proofs byte-identical to the JAX package's are in
tests/test_torch_circuit_airs_slow.py.
"""

import hashlib
import types

import numpy as np
import pytest
import torch

from torch_air_helpers import all_zero, composition_pair, u64
from zkevm_circuits_tpu.prover import blake2s_air as jblake
from zkevm_circuits_tpu.prover import keccak_air as jkeccak
from zkevm_circuits_tpu.prover import sha256_air as jsha
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.ops.keccak import keccak256_ref
from zkevm_circuits_tpu_torch.prover import blake2s_air, keccak_air, sha256_air
from zkevm_circuits_tpu_torch.prover.air_common import residuals
from zkevm_circuits_tpu_torch.prover.stark import StarkParams
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

GAMMA = 0x1234567
MESSAGES = [b"abc", bytes(range(200))]  # 1 and 2 keccak blocks; 1 and 4 sha256 blocks
RAW_BLOCKS = np.random.default_rng(7).integers(0, 1 << 32, size=(2, 16), dtype=np.uint64)
BLAKE_CALLS = [b"\xaa" * 32 + b"\xbb" * 32, b"\x00" * 12 + b"\x11" * 20 + b"\x22" * 32,
               b"\x00" * 7 + b"\x01" + bytes(range(32)), bytes(range(64))]
CASES = ([("keccak", m) for m in range(len(MESSAGES))]
         + [("sha256", m) for m in range(len(MESSAGES))]
         + [("sha256_blocks", 0), ("blake2s", 0)])


def _build(pkg, kind, m, **kw):
    """(phase1, fixed, digests, build_phase2, log_n) of one case."""
    if kind == "keccak":
        return pkg[0].build_keccak_trace(MESSAGES[m], **kw)
    if kind == "sha256":
        return pkg[1].build_sha256_trace(MESSAGES[m], **kw)
    if kind == "sha256_blocks":
        return pkg[1].build_sha256_trace_blocks(RAW_BLOCKS, **kw)
    return pkg[2].build_blake2s_trace(BLAKE_CALLS, **kw)


JAX = (jkeccak, jsha, jblake)
PORT = (keccak_air, sha256_air, blake2s_air)


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for kind, m in CASES:
        phase1, fixed, digests, build_phase2, log_n = _build(JAX, kind, m)
        out[kind, m] = dict(phase1=u64(phase1), fixed=u64(fixed), digests=digests, log_n=log_n,
                            phase2=u64(build_phase2(None, (GAMMA,))))
    return out


@pytest.fixture(scope="module")
def port_side():
    out = {}
    for kind, m in CASES:
        phase1, fixed, digests, build_phase2, log_n = _build(PORT, kind, m, device="cpu")
        out[kind, m] = dict(phase1=phase1, fixed=fixed, digests=digests, log_n=log_n,
                            phase2=build_phase2(None, (GAMMA,)))
    return out


def _rlc(kind, m, pkg):
    if kind == "keccak":
        return pkg[0].message_rlc(MESSAGES[m], GAMMA)
    if kind == "sha256":
        return pkg[1].message_rlc(MESSAGES[m], GAMMA)
    if kind == "sha256_blocks":
        return pkg[1].blocks_rlc(RAW_BLOCKS, GAMMA)
    return pkg[2].batch_rlc(pkg[2].records_from_calls(BLAKE_CALLS, _blake_digests()), GAMMA)


def _blake_digests():
    return [hashlib.blake2s(c).digest() for c in BLAKE_CALLS]


def _air(kind):
    return {"keccak": keccak_air.keccak_air, "blake2s": blake2s_air.blake2s_air}.get(
        kind, sha256_air.sha256_air)()


def _public(kind, m, port):
    rlc = _rlc(kind, m, PORT)
    if kind == "blake2s":
        return gf.from_u64(np.array([rlc], np.uint64))
    return gf.from_u64(np.concatenate([np.asarray(port["digests"], np.uint64),
                                       np.array([rlc], np.uint64)]))


@pytest.mark.parametrize("kind,m", CASES)
def test_trace_matches_jax(jax_side, port_side, kind, m):
    j, p = jax_side[kind, m], port_side[kind, m]
    assert p["log_n"] == j["log_n"]
    np.testing.assert_array_equal(gf.to_u64(p["phase1"]), j["phase1"])
    np.testing.assert_array_equal(gf.to_u64(p["fixed"]), j["fixed"])
    np.testing.assert_array_equal(gf.to_u64(p["phase2"]), j["phase2"])
    if kind == "blake2s":
        assert p["digests"] == j["digests"] == _blake_digests()
    else:
        np.testing.assert_array_equal(np.asarray(p["digests"]), np.asarray(j["digests"]))


@pytest.mark.parametrize("kind,m", CASES)
def test_rlc_matches_jax(kind, m):
    assert _rlc(kind, m, PORT) == _rlc(kind, m, JAX)


def test_digests_match_host_hashes(port_side):
    for m, msg in enumerate(MESSAGES):
        words = port_side["keccak", m]["digests"]
        assert b"".join(int(w).to_bytes(4, "little") for w in words) == keccak256_ref(msg)
        words = port_side["sha256", m]["digests"]
        assert b"".join(int(w).to_bytes(4, "big") for w in words) == hashlib.sha256(msg).digest()


def _flip_state_bit(kind, phase1):
    """One bit of the round-input state at row 1 (mid-block)."""
    start = {"keccak": keccak_air._cols().A.start, "blake2s": blake2s_air._cols().v.start}.get(
        kind, sha256_air._cols().st["e"].start)
    bad = phase1.clone()
    bad[start + 3, 1] ^= 1
    return bad


@pytest.mark.parametrize("kind,m", CASES)
def test_constraints_vanish_and_catch_a_flipped_state_bit(port_side, kind, m):
    p = port_side[kind, m]
    air, pub = _air(kind), _public(kind, m, p)
    cols = torch.cat([p["fixed"], p["phase1"], p["phase2"]])
    assert all_zero(residuals(air, cols, pub, (GAMMA,)))
    bad = torch.cat([p["fixed"], _flip_state_bit(kind, p["phase1"]), p["phase2"]])
    assert not all_zero(residuals(air, bad, pub, (GAMMA,)))


NO_PROOF = types.SimpleNamespace(caps=[None] * 3)


def test_verifier_early_returns():
    """Wrong lengths are rejected before any part of the proof is read."""
    small = StarkParams(log_n=5)
    # keccak: a message longer than the trace's rounds
    assert not keccak_air.verify_keccak256(None, bytes(200), bytes(32), small)
    assert not keccak_air.verify_keccak256(types.SimpleNamespace(caps=[None] * 2), b"abc",
                                           bytes(32), small)
    assert not keccak_air.verify_keccak256(NO_PROOF, b"abc", bytes(31), small)
    # sha256: a digest of the wrong length, blocks of the wrong shape or
    # count, digest words of the wrong shape
    six = StarkParams(log_n=6)
    assert not sha256_air.verify_sha256(None, b"abc", bytes(31), six)
    assert not sha256_air.verify_sha256_blocks(None, RAW_BLOCKS[:, :15], np.zeros(8), six)
    assert not sha256_air.verify_sha256_blocks(None, RAW_BLOCKS, np.zeros(8), six)
    assert not sha256_air.verify_sha256_blocks(NO_PROOF, RAW_BLOCKS[:1], np.zeros(7), six)
    # blake2s: mismatched lists, no call, too many calls, a long message,
    # a short digest
    digs = _blake_digests()
    assert not blake2s_air.verify_blake2s_batch(None, BLAKE_CALLS, digs[:-1], six)
    assert not blake2s_air.verify_blake2s_batch(None, [], [], six)
    assert not blake2s_air.verify_blake2s_batch(None, BLAKE_CALLS * 2, digs * 2,
                                                StarkParams(log_n=5))
    assert not blake2s_air.verify_blake2s_batch(None, [bytes(65)], [digs[0]], six)
    assert not blake2s_air.verify_blake2s_batch(None, [b"x"], [digs[0][:31]], six)


@pytest.mark.parametrize("name", ["keccak", "sha256", "blake2s"])
def test_composition_matches_jax(name):
    """The constraints of each AIR, alpha-composed by the JAX prover's
    `_compose_rows` and by the port's, agree on random rows."""
    jair, air = dict(keccak=(jkeccak.keccak_air, keccak_air.keccak_air),
                     sha256=(jsha.sha256_air, sha256_air.sha256_air),
                     blake2s=(jblake.blake2s_air, blake2s_air.blake2s_air))[name]
    want, got = composition_pair(jair(), air(), seed=len(name))
    np.testing.assert_array_equal(got, want)
