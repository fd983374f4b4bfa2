"""The port's recursion layer (models/recursion.py) and its leaves on real
STARKs (prover/recursion_proofs.py), against the JAX package.

The batched tree checks run on crafted batches (a recursion queue over random
commitments, proofs with wrong inputs, wrong keys and invalid bits, rows not
executed, a split with a broken glue) through both packages, and every
boolean must agree; the commitments they recompute agree exactly as u64.
The compact-commitment STARK and the carried proofs are proven on the CPU:
the proven commitment is the JAX package's `commit_encoding`, a changed
encoding or claim is rejected, and one changed carried proof fails its own
leaf slot and no other, as the JAX leaf layer does.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.models import recursion as jrec
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops import keccak as jkeccak
from zkevm_circuits_tpu.ops import poseidon2 as jposeidon2
from zkevm_circuits_tpu.ops import queues as jqueues
from zkevm_circuits_tpu.prover import recursion_proofs as jrp
from zkevm_circuits_tpu_torch.models import recursion as rec
from zkevm_circuits_tpu_torch.ops import gf, keccak, queues
from zkevm_circuits_tpu_torch.prover import pipeline
from zkevm_circuits_tpu_torch.prover import recursion_proofs as rp
from zkevm_circuits_tpu_torch.utils import protocol
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

N = 8
M = 4
LEAF_CAP = 2
NODE_VK = (31, 32, 33, 34)
LEAF_PARAMS = dict(circuit_type=8, basic_circuit_vk_commitment=(11, 12, 13, 14),
                   leaf_vk_commitment=(21, 22, 23, 24))


def _u64(x):
    return np.asarray(x.astype_u64(), np.uint64)


def _np(res):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in res.items()}


def _same(res, jres):
    a, b = _np(res), _np(jres)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def batch():
    """a recursion queue over random commitments (two rows not executed) and
    a proof batch with one wrong input, one invalid bit and one wrong key"""
    rng = np.random.default_rng(11)
    types = np.full(N, 8, np.uint64)
    types[5] = 9
    commitments = rng.integers(0, gf.MODULUS, size=(N, 4), dtype=np.uint64)
    execute = np.ones(N, bool)
    execute[[3, 6]] = False
    publics = commitments.copy()
    publics[1, 2] ^= np.uint64(1)
    valid = np.ones(N, bool)
    valid[2] = False
    vks = np.tile(np.array(LEAF_PARAMS["basic_circuit_vk_commitment"], np.uint64), (N, 1))
    vks[4, 0] += np.uint64(1)
    jchain = jrec.build_recursion_queue(jgf.from_u64(types), jgf.from_u64(commitments),
                                        jnp.asarray(execute))
    return dict(types=types, commitments=commitments, execute=execute, publics=publics,
                valid=valid, vks=vks, jchain=_u64(jchain))


def test_recursion_queue_matches_jax(batch):
    chain = rec.build_recursion_queue(gf.from_u64(batch["types"]),
                                      gf.from_u64(batch["commitments"]),
                                      torch.from_numpy(batch["execute"]))
    np.testing.assert_array_equal(gf.to_u64(chain), batch["jchain"])


@pytest.mark.parametrize("form", ["batch", "surrogates"])
def test_leaf_layer_check_matches_jax(batch, form):
    b = batch
    if form == "batch":
        proofs = rec.ProofBatch(gf.from_u64(b["publics"]), torch.from_numpy(b["valid"]),
                                gf.from_u64(b["vks"]))
        jproofs = jrec.ProofBatch(jgf.from_u64(b["publics"]), jnp.asarray(b["valid"]),
                                  jgf.from_u64(b["vks"]))
    else:
        proofs = [rec.ProofSurrogate(gf.from_u64(b["publics"][i]), bool(b["valid"][i]),
                                     gf.from_u64(b["vks"][i]) if i else None)
                  for i in range(N)]
        jproofs = [jrec.ProofSurrogate(jgf.from_u64(b["publics"][i]), bool(b["valid"][i]),
                                       jgf.from_u64(b["vks"][i]) if i else None)
                   for i in range(N)]
    vk = LEAF_PARAMS["basic_circuit_vk_commitment"]
    for ctype in (8, 9):
        res = rec.leaf_layer_check(ctype, gf.from_u64(b["types"]), gf.from_u64(b["commitments"]),
                                   torch.from_numpy(b["execute"]), proofs, vk)
        jres = jrec.leaf_layer_check(ctype, jgf.from_u64(b["types"]),
                                     jgf.from_u64(b["commitments"]), jnp.asarray(b["execute"]),
                                     jproofs, vk)
        _same(res, jres)
    assert not _np(res)["proof_inputs"].all()


def _states(chain, jchain, n):
    return (queues.QueueState(chain[0], chain[n], n),
            jqueues.QueueState(jchain[0], jchain[n], jnp.uint32(n)))


@pytest.mark.parametrize("glue", ["intact", "broken"])
def test_check_split_matches_jax(batch, glue):
    chain, jchain = gf.from_u64(batch["jchain"]), jgf.from_u64(batch["jchain"])
    parent, jparent = _states(chain, jchain, N)
    children = rec.split_queue_chain(chain, N, 4, [2, 4, 6])
    jchildren = jrec.split_queue_chain(jchain, N, 4, [2, 4, 6])
    if glue == "broken":
        children[1] = dataclasses.replace(children[1], head=children[2].head)
        jchildren[1] = jqueues.QueueState(jchildren[2].head, jchildren[1].tail,
                                          jchildren[1].length)
    res = rec.check_split(parent, children)
    _same(res, jrec.check_split(jparent, jchildren))
    assert bool(res["glue"]) == (glue == "intact")


@pytest.mark.parametrize("bad_child", [None, 1, 3])
def test_node_layer_check_matches_jax(batch, bad_child):
    chain, jchain = gf.from_u64(batch["jchain"]), jgf.from_u64(batch["jchain"])
    parent, jparent = _states(chain, jchain, N)
    lp, jlp = rec.RecursionLeafParameters(**LEAF_PARAMS), jrec.RecursionLeafParameters(**LEAF_PARAMS)
    splits = [2, 4, 4]  # child 2 is empty: its proof is not checked
    kids = rec.split_queue_chain(chain, N, M, splits)
    cms = [rec.leaf_input_commitment(lp, c) for c in kids]
    jkids = jrec.split_queue_chain(jchain, N, M, splits)
    jcms = [jrec.leaf_input_commitment(jlp, c) for c in jkids]
    for c, jc in zip(cms, jcms):
        np.testing.assert_array_equal(gf.to_u64(c), _u64(jc))
    proofs = [rec.ProofSurrogate(c, i != bad_child) for i, c in enumerate(cms)]
    jproofs = [jrec.ProofSurrogate(c, i != bad_child) for i, c in enumerate(jcms)]
    res = rec.node_layer_check(parent, chain, splits, M, LEAF_CAP, proofs, cms)
    _same(res, jrec.node_layer_check(jparent, jchain, splits, M, LEAF_CAP, jproofs, jcms))
    assert bool(res["children_proofs"]) == (bad_child is None)


@pytest.mark.parametrize("case", ["leaves", "nodes", "wrong_vk"])
def test_node_layer_verify_matches_jax(batch, case):
    chain, jchain = gf.from_u64(batch["jchain"]), jgf.from_u64(batch["jchain"])
    parent, jparent = _states(chain, jchain, N)
    lp, jlp = rec.RecursionLeafParameters(**LEAF_PARAMS), jrec.RecursionLeafParameters(**LEAF_PARAMS)
    bounds = np.array([0, 2, 4, 6, 8])
    leaf_cap = LEAF_CAP if case != "nodes" else 1  # 8 <= 2 * 4: the children are leaves
    heads, tails = chain[bounds[:-1]], chain[bounds[1:]]
    lengths = bounds[1:] - bounds[:-1]
    if case == "nodes":
        cms = rec.node_input_commitments_batched(8, lp, gf.from_u64(NODE_VK), heads, tails,
                                                 lengths)
        jcms = jrec.node_input_commitments_batched(8, jlp, jgf.from_u64(np.array(NODE_VK)),
                                                   jchain[bounds[:-1]], jchain[bounds[1:]],
                                                   lengths)
        vk = NODE_VK
    else:
        cms = rec.leaf_input_commitments_batched(lp, heads, tails, lengths)
        jcms = jrec.leaf_input_commitments_batched(jlp, jchain[bounds[:-1]],
                                                   jchain[bounds[1:]], lengths)
        vk = LEAF_PARAMS["leaf_vk_commitment"] if case == "leaves" else NODE_VK
    np.testing.assert_array_equal(gf.to_u64(cms), _u64(jcms))
    vks = np.tile(np.array(vk, np.uint64), (M, 1))
    proofs = rec.ProofBatch(cms, torch.ones(M, dtype=torch.bool), gf.from_u64(vks))
    jproofs = jrec.ProofBatch(jcms, jnp.ones(M, dtype=bool), jgf.from_u64(vks))
    res = rec.node_layer_verify(8, parent, chain, torch.from_numpy(bounds), leaf_cap, lp, NODE_VK,
                                proofs)
    _same(res, jrec.node_layer_verify(8, jparent, jchain, jnp.asarray(bounds), leaf_cap, jlp,
                                      NODE_VK, jproofs))
    assert bool(res["children_proofs"]) == (case != "wrong_vk")


@pytest.mark.parametrize("valid", [None, (True, False, True)])
def test_interblock_aggregate_keccak_matches_jax(batch, valid):
    pis = batch["commitments"][:3]
    got = rec.interblock_aggregate_keccak([gf.from_u64(p) for p in pis], valid)
    assert got == jrec.interblock_aggregate_keccak([jgf.from_u64(p) for p in pis], valid)


def test_compression_check_matches_jax(batch):
    c = batch["commitments"][0]
    for other, ok in ((c, True), (batch["commitments"][1], True), (c, False)):
        got = rec.compression_check(rec.ProofSurrogate(gf.from_u64(c), ok), gf.from_u64(other))
        want = jrec.compression_check(jrec.ProofSurrogate(jgf.from_u64(c), ok), jgf.from_u64(other))
        assert bool(got) == bool(want)


@pytest.mark.parametrize("data", [b"", b"abc", bytes(range(200)), b"\x07" * 136])
def test_keccak_copy_equals_the_original(data):
    assert keccak.keccak256_ref(data) == jkeccak.keccak256_ref(data)
    assert keccak.ROUND_CONSTANTS == jkeccak.ROUND_CONSTANTS and keccak.ROT == jkeccak.ROT


# ---------------------------------------------------------------------------
# compact-commitment STARKs carried into a leaf
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """two instances' compact forms from random parts, and their proofs"""
    rng = np.random.default_rng(3)
    parts = [gf.from_u64(rng.integers(0, gf.MODULUS, size=(2, k), dtype=np.uint64))
             for k in (6, 3, 5, 5)]
    forms = protocol.compact_form_from_parts(torch.tensor([True, False]),
                                             torch.tensor([False, True]), *parts)
    return forms, rp.make_carried_proofs(forms)


def test_compact_commitment_is_commit_encoding(carried):
    forms, cps = carried
    for k, cp in enumerate(cps):
        want = _u64(jposeidon2.hash_padded(jgf.from_u64(cp.encoding)))
        np.testing.assert_array_equal(cp.final_state[:4], want)
        np.testing.assert_array_equal(cp.final_state[:4], gf.to_u64(forms.commitment()[k]))


def test_commitment_vk_matches_jax():
    np.testing.assert_array_equal(gf.to_u64(rp.commitment_vk("cpu")), _u64(jrp.commitment_vk()))


def _forged_encoding(cp):
    enc = cp.encoding.copy()
    enc[5] ^= np.uint64(1)
    return enc, cp.final_state[:4]


def _forged_claim(cp):
    c = cp.final_state[:4].copy()
    c[0] = (int(c[0]) + 1) % gf.MODULUS
    return cp.encoding, c


@pytest.mark.parametrize("tamper", [_forged_encoding, _forged_claim],
                         ids=["encoding", "commitment"])
def test_compact_commitment_binds_plaintext_and_claim(carried, tamper):
    cp = carried[1][0]
    enc, commitment = tamper(cp)
    assert not pipeline.verify_compact_commitment(cp.proof, enc, commitment, cp.final_state,
                                                  cp.params)


def _leaf(forms, cps):
    k = len(cps)
    return rp.leaf_layer_verify_starks(8, gf.from_u64([8] * k), forms.commitment(),
                                       torch.ones(k, dtype=torch.bool), cps)


def test_leaf_layer_accepts_the_carried_proofs(carried):
    res = _np(_leaf(*carried))
    assert list(res) == ["type_match", "proof_inputs", "proof_vk"]
    assert all(v.all() for v in res.values())


def test_changed_carried_proof_fails_its_slot_only(carried):
    forms, cps = carried
    bad = copy.deepcopy(cps[1].proof)
    tz = np.array(bad.ood["trace_z"], copy=True)
    tz[0] ^= np.uint64(1)
    bad.ood = dict(bad.ood, trace_z=tz)
    res = _np(_leaf(forms, [cps[0], dataclasses.replace(cps[1], proof=bad)]))
    assert res["proof_inputs"].tolist() == [True, False]
    assert res["type_match"].all() and res["proof_vk"].all()
