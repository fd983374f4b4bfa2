"""The port's demux routing AIR and eip_4844 Horner AIR (prover/demux_air.py,
prover/horner_air.py) against the JAX package.

Exact u64 equality with the JAX package for the traces (fixed and phase-1
columns), the phase-2 columns under given challenges and the publics, on the
queries of tests/test_demux_air.py and on its E = 8 blob
(tests/test_horner_air.py); the alpha-composed constraints equal the JAX
prover's on random rows.  The port's constraints vanish on the honest trace
and not on a tampered one.  The port's proofs, made on the CPU at the JAX
tests' inputs and params, are the JAX proofs byte for byte (by digest: a
JAX proof costs minutes, and tests/test_torch_circuit_airs_slow.py makes the
JAX proofs anew and holds them to the digests).  The port's verifier accepts
them and rejects a rerouted element and a wrong opening, as the JAX
package's tamper tests pin.  The port proves in blocks as in one piece.
"""

import numpy as np
import pytest
import torch

from torch_air_helpers import all_zero, composition_pair, proof_digest, u64
from zkevm_circuits_tpu.models import eip_4844 as je44
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.prover import demux_air as jdemux
from zkevm_circuits_tpu.prover import horner_air as jhorner
from zkevm_circuits_tpu_torch.isa import system_params as sp
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import demux_air, horner_air
from zkevm_circuits_tpu_torch.prover.air_common import residuals
from zkevm_circuits_tpu_torch.utils.convert import proof_to_ints
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CHALLENGES = [(0x1234567, 0x89ABCDEF, 77), (5, 0, 1), (gf.MODULUS - 1, gf.MODULUS - 2, 3)]
E = 8


def queries():
    """tests/test_demux_air.py's stream: one element per family and a
    porter-shard storage log (routes nowhere)."""
    base = dict(address=0x8002, rw_flag=True, rollback=False, is_service=False, shard_id=0)
    qs = [dict(base, key=5, read_value=1, written_value=2, aux_byte=sp.STORAGE_AUX_BYTE,
               tx_number_in_block=0, timestamp=21),
          dict(base, key=6, read_value=0, written_value=3, aux_byte=sp.EVENT_AUX_BYTE,
               is_service=True, tx_number_in_block=1, timestamp=25),
          dict(base, key=7, read_value=0, written_value=4, aux_byte=sp.L1_MESSAGE_AUX_BYTE,
               tx_number_in_block=1, timestamp=29)]
    for addr in (sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS, sp.SHA256_PRECOMPILE_FORMAL_ADDRESS,
                 sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS):
        qs.append(dict(base, address=addr, key=77 << 128, read_value=0, written_value=0,
                       rw_flag=False, aux_byte=sp.PRECOMPILE_AUX_BYTE, tx_number_in_block=2,
                       timestamp=33))
    qs.append(dict(base, key=9, read_value=0, written_value=1, aux_byte=sp.STORAGE_AUX_BYTE,
                   shard_id=1, tx_number_in_block=3, timestamp=37))
    return qs


def blob_witness():
    """tests/test_horner_air.py's E = 8 blob (JAX witness)."""
    rng = np.random.default_rng(0x4844)
    chunks = [bytes(rng.integers(0, 256, 31, dtype=np.uint8)) for _ in range(5)]
    vh = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    return je44.generate_witness(chunks, vh, je44.EIP4844Config(elements=E))


@pytest.fixture(scope="module")
def jax_side():
    qs = queries()
    fixed, phase1, log_n = jdemux.demux_trace(qs)
    cols = jgf.concat([fixed, phase1], axis=0)
    demux = dict(fixed=u64(fixed), phase1=u64(phase1), log_n=log_n,
                 phase2=[u64(jdemux._build_phase2(cols, ch)) for ch in CHALLENGES],
                 publics=[jdemux.host_publics(qs, ch[1]) for ch in CHALLENGES])
    w = blob_witness()
    hf, hp, hpub, hlog = jhorner.horner_trace(w, E)
    hcols = jgf.concat([hf, hp], axis=0)
    fe = np.asarray(w.fe, np.uint64)[:E]
    horner = dict(fixed=u64(hf), phase1=u64(hp), publics=hpub, log_n=hlog,
                  phase2=[u64(jhorner._build_phase2(hcols, ch[:2])) for ch in CHALLENGES],
                  rlc=[jhorner.stream_rlc_host(fe, ch[1]) for ch in CHALLENGES])
    return dict(demux=demux, horner=horner, w=w)


@pytest.fixture(scope="module")
def demux_cols():
    fixed, phase1, log_n = demux_air.demux_trace(queries(), device="cpu")
    return fixed, phase1, log_n


@pytest.fixture(scope="module")
def horner_cols(jax_side):
    return horner_air.horner_trace(jax_side["w"], E, device="cpu")


def test_demux_trace_matches_jax(jax_side, demux_cols):
    fixed, phase1, log_n = demux_cols
    j = jax_side["demux"]
    assert log_n == j["log_n"]
    np.testing.assert_array_equal(gf.to_u64(fixed), j["fixed"])
    np.testing.assert_array_equal(gf.to_u64(phase1), j["phase1"])
    assert tuple(phase1.shape) == (demux_air.demux_air().num_cols, 1 << log_n)


@pytest.mark.parametrize("k", range(len(CHALLENGES)))
def test_demux_phase2_and_publics_match_jax(jax_side, demux_cols, k):
    fixed, phase1, _ = demux_cols
    got = demux_air._build_phase2(torch.cat([fixed, phase1]), CHALLENGES[k])
    np.testing.assert_array_equal(gf.to_u64(got), jax_side["demux"]["phase2"][k])
    np.testing.assert_array_equal(demux_air.host_publics(queries(), CHALLENGES[k][1]),
                                  jax_side["demux"]["publics"][k])


def _demux_residuals(fixed, phase1, qs, ch):
    t2 = demux_air._build_phase2(torch.cat([fixed, phase1]), ch)
    pub = gf.from_u64(demux_air.host_publics(qs, ch[1]))
    return residuals(demux_air.demux_air(), torch.cat([fixed, phase1, t2]), pub, ch)


def test_demux_constraints_vanish_and_catch_a_reroute(demux_cols):
    fixed, phase1, _ = demux_cols
    ch = CHALLENGES[0]
    assert all_zero(_demux_residuals(fixed, phase1, queries(), ch))
    # the storage element routed to the events queue instead
    _, p1, _ = demux_air.layout()
    bad = phase1.clone()
    bad[p1.at("flag", 0), 0] = 0
    bad[p1.at("flag", 1), 0] = 1
    assert not all_zero(_demux_residuals(fixed, bad, queries(), ch))


def test_horner_trace_matches_jax(jax_side, horner_cols):
    fixed, phase1, publics, log_n = horner_cols
    j = jax_side["horner"]
    assert log_n == j["log_n"]
    np.testing.assert_array_equal(gf.to_u64(fixed), j["fixed"])
    np.testing.assert_array_equal(gf.to_u64(phase1), j["phase1"])
    np.testing.assert_array_equal(publics, j["publics"])


@pytest.mark.parametrize("k", range(len(CHALLENGES)))
def test_horner_phase2_and_rlc_match_jax(jax_side, horner_cols, k):
    fixed, phase1, _, _ = horner_cols
    got = horner_air._build_phase2(torch.cat([fixed, phase1]), CHALLENGES[k][:2])
    np.testing.assert_array_equal(gf.to_u64(got), jax_side["horner"]["phase2"][k])
    fe = np.asarray(jax_side["w"].fe, np.uint64)[:E]
    assert horner_air.stream_rlc_host(fe, CHALLENGES[k][1]) == jax_side["horner"]["rlc"][k]


def test_horner_constraints_vanish_and_catch_a_wrong_step(jax_side, horner_cols):
    fixed, phase1, publics, _ = horner_cols
    ch = CHALLENGES[0][:2]

    def res(p1):
        t2 = horner_air._build_phase2(torch.cat([fixed, p1]), ch)
        pub = publics.copy()
        pub[-1] = horner_air.stream_rlc_host(np.asarray(jax_side["w"].fe, np.uint64)[:E], ch[1])
        return residuals(horner_air.horner_air(), torch.cat([fixed, p1, t2]),
                         gf.from_u64(pub), ch)

    assert all_zero(res(phase1))
    bad = phase1.clone()
    bad[horner_air.layout()[1].at("t_b", 0), 2] ^= 1  # one byte of t at step 2
    assert not all_zero(res(bad))


@pytest.mark.parametrize("name", ["demux", "horner"])
def test_composition_matches_jax(name):
    """The constraints of each AIR, alpha-composed by the JAX prover's
    `_compose_rows` and by the port's, agree on random rows."""
    jair = jdemux.demux_air() if name == "demux" else jhorner.horner_air()
    air = demux_air.demux_air() if name == "demux" else horner_air.horner_air()
    want, got = composition_pair(jair, air, seed=len(name))
    np.testing.assert_array_equal(got, want)


# sha256 of the JAX package's proofs as nested ints (`jax_proof_to_ints`), at
# the inputs and params of tests/test_demux_air.py and tests/test_horner_air.py
# (the JAX provers' default params): made by jdemux.prove_demux(queries()) and
# jhorner.prove_horner(blob_witness(), E).  tests/test_torch_circuit_airs_slow.py
# makes both JAX proofs anew and holds them to these digests; a JAX proof
# costs minutes, too long for the tier-1 tests.
JAX_PROOF_SHA256 = {
    "demux": "db80a3f77f581c24962dd95dc41925480208af8d56fbecb6058473a785716634",
    "horner": "ebd236191974f62f99fc2090e87f8795fdcaa4aea7d9b633fe1d676e043a5a14",
}


@pytest.fixture(scope="module")
def demux_proof():
    return demux_air.prove_demux(queries(), device="cpu")


@pytest.fixture(scope="module")
def horner_proof(jax_side):
    return horner_air.prove_horner(jax_side["w"], E, device="cpu")


@pytest.mark.parametrize("name", ["demux", "horner"])
def test_proof_identical_to_jax(name, request):
    """The port's proof, made on the CPU at the JAX package's own test inputs
    and params, is the JAX proof byte for byte."""
    proof, publics, params = request.getfixturevalue(f"{name}_proof")
    assert params.num_queries == 20 and params.log_blowup == 2
    assert proof_digest(proof_to_ints(proof)) == JAX_PROOF_SHA256[name]


def _rerouted():
    bad = queries()
    bad[0] = dict(bad[0], aux_byte=sp.EVENT_AUX_BYTE)
    return bad


@pytest.mark.parametrize("case,want", [("honest", True), ("rerouted", False)])
def test_demux_proof_verdicts(demux_proof, case, want):
    proof, publics, params = demux_proof
    qs = queries() if case == "honest" else _rerouted()
    assert demux_air.verify_demux(proof, qs, params) is want


@pytest.mark.parametrize("case,want", [("honest", True), ("opening", False)])
def test_horner_proof_verdicts(jax_side, horner_proof, case, want):
    proof, publics, params = horner_proof
    w = jax_side["w"]
    opening = np.asarray(w.opening_be).copy()
    if case == "opening":
        opening[7] ^= 1
    pub = dict(E=E, chunks=np.asarray(w.chunks), truncated=np.asarray(w.truncated),
               opening_be=opening)
    assert horner_air.verify_horner(proof, pub, params) is want


def test_demux_proof_in_blocks_is_the_same(demux_proof, demux_cols, monkeypatch):
    """The prover's column-block LDE, its row-block composition (the last
    block's next rows wrapping round the domain) and the byte lookup's
    inversion blocks, forced down to a few columns or rows, give the proof
    made in one piece."""
    from zkevm_circuits_tpu_torch.prover import air_common, stark

    proof, _, params = demux_proof
    log_n = demux_cols[2]
    N = 1 << (log_n + params.log_blowup)
    # the LDE in blocks of 64 columns, the composition of 279 columns in 8
    # blocks of N / 8 rows, the byte columns inverted 3 at a time
    monkeypatch.setattr(stark, "_WIDE_ELEMS", 64 * N)
    monkeypatch.setattr(air_common, "_INV_ELEMS", 3 << log_n)
    assert stark._block_rows(demux_air.demux_air().total_cols, stark._WIDE_ELEMS) == N // 8
    blocked, _, _ = demux_air.prove_demux(queries(), params, device="cpu")
    assert proof_to_ints(blocked) == proof_to_ints(proof)
