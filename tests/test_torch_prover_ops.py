"""The torch prover substrate against the JAX package: NTT / intt / coset LDE,
Merkle levels and paths, GF(p^2), the Fiat-Shamir transcript, and a FRI
proof at log domain 8 with its tamper cases.

Same numpy inputs on both sides; tolerance exact (u64 equality, and the
same accept/reject verdict for every tampered proof).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zkevm_circuits_tpu.ops import fri as jfri
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops import gf2 as jgf2
from zkevm_circuits_tpu.ops import merkle as jmerkle
from zkevm_circuits_tpu.ops import ntt as jntt
from zkevm_circuits_tpu_torch.ops import fri, gf, gf2, merkle, ntt
from torch_jaxpr_numpy import numpy_jit
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _jax_side_on_numpy():
    """The JAX side runs as its jaxprs evaluated with numpy
    (tests/torch_jaxpr_numpy.py): the file takes a quarter less than on
    XLA:CPU."""
    with numpy_jit():
        yield


P = gf.MODULUS


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _ju64(x):
    return np.asarray(x.astype_u64(), np.uint64)


# ---------------------------------------------------------------------------
# NTT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n", [0, 1, 3, 8])
def test_ntt_intt_match_jax_and_ref(log_n):
    a = _rand(log_n, (2, 1 << log_n))
    fwd = gf.to_u64(ntt.ntt(gf.from_u64(a)))
    np.testing.assert_array_equal(fwd, _ju64(jntt.ntt_jit(jgf.from_u64(a))))
    assert [int(x) for x in fwd[0]] == jntt.ntt_ref([int(x) for x in a[0]])
    back = gf.to_u64(ntt.intt(gf.from_u64(fwd)))
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(back, _ju64(jntt.intt_jit(jgf.from_u64(fwd))))


@pytest.mark.parametrize("log_n,rate", [(4, 2), (6, 1), (8, 2)])
def test_lde_matches_jax(log_n, rate):
    a = _rand(10 + log_n, (3, 1 << log_n))
    got = gf.to_u64(ntt.lde(gf.from_u64(a), rate, 7))
    want = jax.jit(lambda x: jntt.lde(x, rate, 7))(jgf.from_u64(a))
    np.testing.assert_array_equal(got, _ju64(want))


def test_root_of_unity_matches():
    assert [ntt.root_of_unity(k) for k in range(33)] == [jntt.root_of_unity(k) for k in range(33)]


# ---------------------------------------------------------------------------
# Merkle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n,cap_log2,width", [(6, 1, 8), (5, 0, 1), (4, 2, 4)])
def test_merkle_levels_paths_match_jax(log_n, cap_log2, width):
    rows = _rand(20 + log_n, (1 << log_n, width))
    levels = merkle.tree_levels(merkle.hash_leaves(gf.from_u64(rows)), cap_log2)
    jlevels = jmerkle.tree_levels(jmerkle.hash_leaves(jgf.from_u64(rows)), cap_log2)
    assert len(levels) == len(jlevels)
    for ours, theirs in zip(levels, jlevels):
        np.testing.assert_array_equal(gf.to_u64(ours), _ju64(theirs))

    idx = np.array([0, 3, (1 << log_n) - 1, 5], np.int64)
    paths = fri.gather_paths(levels, idx)
    np.testing.assert_array_equal(paths, jfri.gather_paths(jlevels, idx))
    np.testing.assert_array_equal(fri.gather_rows(levels[0], idx),
                                  jfri.gather_rows(jlevels[0], idx))
    leaf = levels[0][torch.as_tensor(idx)]
    ok = merkle.verify_path(leaf, torch.as_tensor(idx), gf.from_u64(paths), levels[-1])
    assert ok.all()
    bad = paths.copy()
    bad[1, 0, 0] ^= np.uint64(1)
    ok = merkle.verify_path(leaf, torch.as_tensor(idx), gf.from_u64(bad), levels[-1])
    assert ok.tolist() == [True, False, True, True]
    jok = jmerkle.verify_path(jgf.from_u64(gf.to_u64(leaf)), jnp.asarray(idx.astype(np.uint32)),
                              jgf.from_u64(bad), jlevels[-1])
    assert np.asarray(jok).tolist() == ok.tolist()


# ---------------------------------------------------------------------------
# GF(p^2)
# ---------------------------------------------------------------------------


def _pair(seed, n=128):
    return _rand(seed, n), _rand(seed + 1, n)


@pytest.mark.parametrize("name", ["add", "sub", "mul", "square", "inv"])
def test_gf2_ops_match_jax_and_ref(name):
    a0, a1 = _pair(30)
    b0, b1 = _pair(32)
    a0[0] = a1[0] = 0  # inv(0) = 0 on both sides
    ta, tb = gf2.GF2(gf.from_u64(a0), gf.from_u64(a1)), gf2.GF2(gf.from_u64(b0), gf.from_u64(b1))
    ja = jgf2.GF2(jgf.from_u64(a0), jgf.from_u64(a1))
    jb = jgf2.GF2(jgf.from_u64(b0), jgf.from_u64(b1))
    if name in ("square", "inv"):
        ours, theirs = getattr(gf2, name)(ta), getattr(jgf2, name)(ja)
    else:
        ours, theirs = getattr(gf2, name)(ta, tb), getattr(jgf2, name)(ja, jb)
    np.testing.assert_array_equal(gf.to_u64(ours.c0), _ju64(theirs.c0))
    np.testing.assert_array_equal(gf.to_u64(ours.c1), _ju64(theirs.c1))
    if name == "mul":
        for i in range(8):
            want = jgf2.gf2_ref.mul((int(a0[i]), int(a1[i])), (int(b0[i]), int(b1[i])))
            assert (int(gf.to_u64(ours.c0)[i]), int(gf.to_u64(ours.c1)[i])) == want
    if name == "inv":
        for i in range(1, 8):
            want = jgf2.gf2_ref.inv((int(a0[i]), int(a1[i])))
            assert (int(gf.to_u64(ours.c0)[i]), int(gf.to_u64(ours.c1)[i])) == want


def test_gf2_from_base():
    a = _rand(40, 16)
    ours, theirs = gf2.from_base(gf.from_u64(a)), jgf2.from_base(jgf.from_u64(a))
    np.testing.assert_array_equal(gf.to_u64(ours.c0), _ju64(theirs.c0))
    np.testing.assert_array_equal(gf.to_u64(ours.c1), _ju64(theirs.c1))


# ---------------------------------------------------------------------------
# transcript and FRI
# ---------------------------------------------------------------------------


def test_transcript_matches_jax():
    ours, theirs = fri.Transcript("cpu"), jfri.Transcript()
    for seed, n in ((50, 8), (51, 3), (52, 17)):
        x = _rand(seed, n)
        ours.absorb(gf.from_u64(x))
        theirs.absorb(jgf.from_u64(x))
        a, b = ours.challenge_ext(), theirs.challenge_ext()
        assert int(gf.to_u64(a.c0)) == int(_ju64(b.c0)) and int(gf.to_u64(a.c1)) == int(_ju64(b.c1))
    assert ours.challenge_indices(1 << 20, 10) == theirs.challenge_indices(1 << 20, 10)


FRI_PARAMS = dict(log_domain=8, log_blowup=1, num_queries=10, final_poly_log_len=2, cap_log2=1)


def _codeword(log_domain=8, log_blowup=1, seed=7):
    n = 1 << log_domain
    rng = np.random.default_rng(seed)
    coeffs = [int(x) % P for x in rng.integers(0, 1 << 62, size=n >> log_blowup)]
    shifted = [c * pow(7, j, P) % P for j, c in enumerate(coeffs)] + [0] * (n - len(coeffs))
    return np.array(jntt.ntt_ref(shifted), np.uint64)


def _fri_ints(proof, caps_u64):
    return dict(
        caps=[c.tolist() for c in caps_u64],
        final_poly=np.asarray(proof.final_poly, np.uint64).tolist(),
        query_indices=[int(i) for i in proof.query_indices],
        openings=[[dict(pair=np.asarray(op["pair"], np.uint64).tolist(),
                        path=np.asarray(op["path"], np.uint64).tolist()) for op in q]
                  for q in proof.openings],
    )


@pytest.fixture(scope="module")
def fri_proofs():
    cw = _codeword()
    ours = fri.prove(gf.from_u64(cw), fri.FriParams(**FRI_PARAMS))
    theirs = jfri.prove(jgf.from_u64(cw), jfri.FriParams(**FRI_PARAMS))
    return ours, theirs


def test_fri_proof_identical_to_jax(fri_proofs):
    ours, theirs = fri_proofs
    assert len(ours.caps) == 6
    assert _fri_ints(ours, [gf.to_u64(c) for c in ours.caps]) == _fri_ints(
        theirs, [_ju64(c) for c in theirs.caps])


def _tamper_final_poly(p):
    p.final_poly = np.array(p.final_poly, copy=True)
    p.final_poly[0, 0] ^= np.uint64(1)


def _tamper_opening(p):
    p.openings[0][2]["pair"] = np.array(p.openings[0][2]["pair"], copy=True)
    p.openings[0][2]["pair"][0, 0] ^= np.uint64(1)


def _tamper_indices(p):
    p.query_indices = list(p.query_indices)
    p.query_indices[0] = (p.query_indices[0] + 1) % (1 << 7)


@pytest.mark.parametrize("tamper", [None, _tamper_final_poly, _tamper_opening, _tamper_indices],
                         ids=["honest", "final_poly", "opening", "query_indices"])
def test_fri_verdicts_match_jax(fri_proofs, tamper):
    ours, theirs = (copy.deepcopy(p) for p in fri_proofs)
    if tamper is not None:
        tamper(ours)
        tamper(theirs)
    verdict = fri.verify(ours, fri.FriParams(**FRI_PARAMS))
    assert verdict == jfri.verify(theirs, jfri.FriParams(**FRI_PARAMS))
    assert verdict == (tamper is None)


def test_fri_prover_refuses_high_degree_codeword():
    cw = np.random.default_rng(9).integers(0, P, size=256, dtype=np.uint64)
    with pytest.raises(ValueError, match="not low degree"):
        fri.prove(gf.from_u64(cw), fri.FriParams(**FRI_PARAMS))
