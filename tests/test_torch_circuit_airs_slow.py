"""Whole circuit-AIR proofs of the port against the JAX package, and the
block's verdict writers (runtime/block.py), on the CPU.  Marked `slow`:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_circuit_airs_slow.py -m slow

The JAX side runs under `numpy_jit()` (tests/torch_jaxpr_numpy.py): each of
its jitted functions is traced to its jaxpr and evaluated with numpy, since
XLA:CPU did not finish compiling the JAX prover for these AIRs within an
hour (tests/test_torch_jaxpr_numpy.py holds the evaluator to XLA).  A JAX
proof so made takes minutes, a port proof on the CPU 20 s (sha256) to
several minutes (keccak, blake2s, ecrecover) of plain Poseidon2
permutations.

For each of the six AIRs, on the small inputs of the JAX package's own AIR
tests and the JAX provers' own params: the port's proof equals the JAX
proof as nested ints (for demux and Horner also the digests that the tier-1
tests hold the port's proofs to), the port's verifier accepts the JAX
proof, the JAX verifier accepts it too, and each tamper case gets the same
(rejecting) verdict from both verifiers.  Then the verdict writers of types
3, 5, 6 and 7 on the memory thread of `chip_smoke.memory_program` (two
calls of each precompile) and of types 4, 13 and 255 on the log path of
`chip_smoke.log_program` and one small blob: every verdict true.
"""

import hashlib

import numpy as np
import pytest

from torch_air_helpers import jax_proof_to_ints, proof_digest
from test_torch_demux_horner_air import JAX_PROOF_SHA256
from torch_jaxpr_numpy import numpy_jit
from zkevm_circuits_tpu.models import ecrecover as jecr
from zkevm_circuits_tpu.prover import blake2s_air as jblake
from zkevm_circuits_tpu.prover import demux_air as jdemux
from zkevm_circuits_tpu.prover import ecrecover_air as jecair
from zkevm_circuits_tpu.prover import horner_air as jhorner
from zkevm_circuits_tpu.prover import keccak_air as jkeccak
from zkevm_circuits_tpu.prover import sha256_air as jsha
from zkevm_circuits_tpu_torch.isa import system_params as sp
from zkevm_circuits_tpu_torch.prover import (blake2s_air, demux_air, ecrecover_air, horner_air,
                                             keccak_air, sha256_air)
from zkevm_circuits_tpu_torch.utils.convert import proof_from_ints, proof_to_ints
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

pytestmark = pytest.mark.slow

E = 8
BLAKE_CALLS = [b"\xaa" * 32 + b"\xbb" * 32, b"\x00" * 12 + b"\x11" * 20 + b"\x22" * 32,
               b"\x00" * 7 + b"\x01" + bytes(range(32))]
RAW_BLOCKS = np.random.default_rng(7).integers(0, 1 << 32, size=(2, 16), dtype=np.uint64)


def _demux_queries():
    from test_torch_demux_horner_air import queries

    return queries()


def _blob():
    from test_torch_demux_horner_air import blob_witness

    w = blob_witness()
    return w, dict(E=E, chunks=np.asarray(w.chunks), truncated=np.asarray(w.truncated),
                   opening_be=np.asarray(w.opening_be))


def _ec_witness():
    from test_torch_ecrecover_air import signed_call

    return jecr.generate_witness(*signed_call(), jecr.EcrecoverConfig(max_calls=1))


def _flip(b: bytes, i: int = 0) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


def _case(name):
    """(port prove, JAX prove, port verify(proof, tamper), JAX verify(proof,
    tamper), tampers): each prove returns (proof, aux, params); a tamper
    name of None is the honest input."""
    if name == "demux":
        qs = _demux_queries()

        def inputs(t):
            bad = [dict(q) for q in qs]
            if t == "rerouted":
                bad[0]["aux_byte"] = sp.EVENT_AUX_BYTE
            elif t == "dropped":
                bad = bad[:-2]
            elif t == "value":
                bad[1]["written_value"] = 99
            return bad

        return (lambda: demux_air.prove_demux(qs, device="cpu"), lambda: jdemux.prove_demux(qs),
                lambda p, aux, prm, t: demux_air.verify_demux(p, inputs(t), prm),
                lambda p, aux, prm, t: jdemux.verify_demux(p, inputs(t), prm),
                ["rerouted", "dropped", "value"])
    if name == "horner":
        w, pub = _blob()

        def inputs(t):
            bad = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in pub.items()}
            field, idx = {"opening": ("opening_be", -1), "challenge": ("truncated", 0),
                          "blob": ("chunks", (0, 0))}.get(t, (None, None))
            if field is not None:
                bad[field] = np.asarray(bad[field]).copy()
                bad[field][idx] ^= 1
            return bad

        return (lambda: horner_air.prove_horner(w, E, device="cpu"),
                lambda: jhorner.prove_horner(w, E),
                lambda p, aux, prm, t: horner_air.verify_horner(p, inputs(t), prm),
                lambda p, aux, prm, t: jhorner.verify_horner(p, inputs(t), prm),
                ["opening", "challenge", "blob"])
    if name == "sha256":
        msg = b"abc"

        def inputs(aux, t):
            return (msg + b"?" if t == "message" else msg,
                    _flip(aux, 0) if t == "digest" else aux)

        return (lambda: sha256_air.prove_sha256(msg, device="cpu"), lambda: jsha.prove_sha256(msg),
                lambda p, aux, prm, t: sha256_air.verify_sha256(p, *inputs(aux, t), prm),
                lambda p, aux, prm, t: jsha.verify_sha256(p, *inputs(aux, t), prm),
                ["digest", "message"])
    if name == "sha256_blocks":
        def words(aux, t):
            w = np.asarray(aux, np.uint64).copy()
            if t == "digest":
                w[0] ^= np.uint64(1)
            return w

        return (lambda: sha256_air.prove_sha256_blocks(RAW_BLOCKS, device="cpu"),
                lambda: jsha.prove_sha256_blocks(RAW_BLOCKS),
                lambda p, aux, prm, t: sha256_air.verify_sha256_blocks(p, RAW_BLOCKS,
                                                                       words(aux, t), prm),
                lambda p, aux, prm, t: jsha.verify_sha256_blocks(p, RAW_BLOCKS, words(aux, t),
                                                                 prm),
                ["digest"])
    if name == "keccak":
        msg = b"zk"

        def inputs(aux, t):
            return (msg + b"!" if t == "message" else msg,
                    _flip(aux, 3) if t == "digest" else aux)

        return (lambda: keccak_air.prove_keccak256(msg, device="cpu"),
                lambda: jkeccak.prove_keccak256(msg),
                lambda p, aux, prm, t: keccak_air.verify_keccak256(p, *inputs(aux, t), prm),
                lambda p, aux, prm, t: jkeccak.verify_keccak256(p, *inputs(aux, t), prm),
                ["digest", "message"])
    if name == "blake2s":
        def inputs(aux, t):
            msgs, digs = list(BLAKE_CALLS), list(aux)
            if t == "digest":
                digs[1] = _flip(digs[1])
            elif t == "message":
                msgs[1] = _flip(msgs[1], 5)
            elif t == "dropped":
                msgs, digs = msgs[:-1], digs[:-1]
            return msgs, digs

        return (lambda: blake2s_air.prove_blake2s_batch(BLAKE_CALLS, device="cpu"),
                lambda: jblake.prove_blake2s_batch(BLAKE_CALLS),
                lambda p, aux, prm, t: blake2s_air.verify_blake2s_batch(p, *inputs(aux, t), prm),
                lambda p, aux, prm, t: jblake.verify_blake2s_batch(p, *inputs(aux, t), prm),
                ["digest", "message", "dropped"])
    w = _ec_witness()

    def claims(aux, t):
        cp = [dict(c) for c in aux]
        if t == "scalar_bit":
            cp[0]["u1"] ^= 1
        elif t == "output":
            cp[0]["acc2"] = (cp[0]["acc2"][0] ^ 1, cp[0]["acc2"][1])
        elif t == "base":
            cp[0]["R"] = (cp[0]["R"][0] ^ 1, cp[0]["R"][1])
        return cp

    return (lambda: ecrecover_air.prove_ecrecover(w, device="cpu"),
            lambda: jecair.prove_ecrecover(w),
            lambda p, aux, prm, t: ecrecover_air.verify_ecrecover(p, claims(aux, t), prm),
            lambda p, aux, prm, t: jecair.verify_ecrecover(p, claims(aux, t), prm),
            ["scalar_bit", "output", "base"])


AIRS = ["demux", "horner", "sha256", "sha256_blocks", "keccak", "blake2s", "ecrecover"]


@pytest.fixture(scope="module", params=AIRS)
def pair(request):
    prove, jprove, verify, jverify, tampers = _case(request.param)
    out = prove()
    with numpy_jit():
        jout = jprove()

    def jverify_numpy(*args):
        with numpy_jit():
            return jverify(*args)

    return dict(name=request.param, out=out, jout=jout, verify=verify, jverify=jverify_numpy,
                tampers=tampers)


def test_proof_identical_to_jax(pair):
    proof, aux, params = pair["out"]
    jproof, jaux, jparams = pair["jout"]
    assert params.log_n == jparams.log_n
    assert proof_to_ints(proof) == jax_proof_to_ints(jproof)
    if pair["name"] in JAX_PROOF_SHA256:
        assert proof_digest(jax_proof_to_ints(jproof)) == JAX_PROOF_SHA256[pair["name"]]
    if pair["name"] in ("demux", "horner"):
        np.testing.assert_array_equal(np.asarray(aux, np.uint64), np.asarray(jaux, np.uint64))
    elif pair["name"] == "ecrecover":
        assert aux == jaux
    elif pair["name"] == "sha256_blocks":
        np.testing.assert_array_equal(np.asarray(aux), np.asarray(jaux))
    else:
        assert aux == jaux
    if pair["name"] == "blake2s":
        assert aux == [hashlib.blake2s(m).digest() for m in BLAKE_CALLS]


def test_each_side_verifies_the_other(pair):
    """The port's verifier accepts the JAX proof, the JAX verifier the
    proof the port made (equal bytes: the JAX proof itself)."""
    proof, aux, params = pair["out"]
    jproof, jaux, jparams = pair["jout"]
    from_jax = proof_from_ints(jax_proof_to_ints(jproof), "cpu")
    assert pair["verify"](from_jax, aux, params, None)
    assert pair["verify"](proof, aux, params, None)
    assert pair["jverify"](jproof, jaux, jparams, None)


def test_tamper_verdicts_match_jax(pair):
    proof, aux, params = pair["out"]
    jproof, jaux, jparams = pair["jout"]
    for t in pair["tampers"]:
        got = pair["verify"](proof, aux, params, t)
        assert got == pair["jverify"](jproof, jaux, jparams, t), t
        assert not got, t


def test_memory_thread_verdict_writers():
    """Types 3, 5, 6 and 7 on the small memory thread of chip_smoke.py (two
    keccak, sha256 and ecrecover calls at least): every verdict true, merged
    into one dict as the JAX block runtime does."""
    import chip_smoke
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.runtime import block

    words, kw, _ = chip_smoke.memory_program(chip_smoke.MEM_SMALL_ITERATIONS,
                                             log2_code_words=chip_smoke.MEM_SMALL_LOG2_CODE_WORDS)
    v = vm.NativeEraVM(words, chip_smoke.MEM_SMALL_CYCLES, **kw)
    w = v.run()
    out, handoffs, counts = block.memory_thread(v, w, kw["code_store"],
                                                chip_smoke.MEM_SMALL_LIMITS, "cpu")
    assert all(handoffs.values())
    assert min(counts["keccak_calls"], counts["sha256_calls"], counts["ecrecover_calls"]) >= 2
    verdicts, log = {5: True}, []
    assert block.code_unpacker_verdict(out["code_unpacker"][0], "cpu", verdicts, limit=1, log=log)
    assert block.sha256_verdict(out["sha256"][0], "cpu", verdicts, limit=2, log=log)
    assert block.keccak_verdict(out["keccak256"][0], v.precompile_calls["keccak"],
                                v.precompile_memory, "cpu", verdicts, limit=2, log=log)
    assert block.ecrecover_verdict(out["ecrecover"][0], "cpu", verdicts, log=log)
    assert verdicts == {3: True, 5: True, 6: True, 7: True}
    assert len(log) == 6 and all(r["ok"] for r in log)
    # an earlier false verdict stays false (the AND-merge)
    verdicts[6] = False
    block.sha256_verdict(out["sha256"][0], "cpu", verdicts, limit=1)
    assert verdicts[6] is False


def test_log_path_and_blob_verdict_writers():
    """Types 4 and 13 on the small log path of chip_smoke.py, 10 on its
    storage application (the first calls), 255 on one small blob: every
    verdict true; types 4 and 255 are assigned, as the JAX block runtime
    does."""
    import chip_smoke
    from zkevm_circuits_tpu_torch.models import eip_4844 as e44
    from zkevm_circuits_tpu_torch.models import vm
    from zkevm_circuits_tpu_torch.runtime import block

    words, kw = chip_smoke.log_program(chip_smoke.LOG_PATH_SMALL_ITERATIONS)
    v = vm.NativeEraVM(words, chip_smoke.LOG_PATH_SMALL_CYCLES, **kw)
    w = v.run()
    limits = (chip_smoke.LOG_PATH_SMALL_LIMIT, chip_smoke.LOG_PATH_SMALL_LIMIT)
    out, handoffs, digest, want, _ = block.log_path(v, w, limits, "cpu")
    assert all(handoffs.values()) and digest == want
    aw, _, _, _ = block.storage_application(out["storage_validity"][0], kw["storage"], "cpu")
    verdicts = {4: False, 255: False}
    assert block.demux_verdict(block.block_rows(v)["logs"], "cpu", verdicts)
    assert block.l1_verdict(out["linear_hasher"][0], digest, "cpu", verdicts)
    assert block.storage_paths_verdict(aw, "cpu", verdicts, limit=4)
    chunks, vh = chip_smoke.blob_inputs(5, 0x4844)
    bw = e44.generate_witness(chunks, vh, e44.EIP4844Config(elements=E), device="cpu")
    assert block.blob_verdict([(bw, chunks, vh, E)], "cpu", verdicts)
    assert verdicts == {4: True, 10: True, 13: True, 255: True}
    # a wrong L1 hash gives a false verdict
    assert not block.l1_verdict(out["linear_hasher"][0], bytes(32), "cpu")
