"""The port's scheduler (models/scheduler.py) against the JAX package's on the
same inputs.

The inputs are made from a numpy seed and converted for each side: compact
forms of three types (main_vm in 2 chained instances, ram in 3, the L1
hasher in 1, their observable inputs the commitments of the derived inputs),
node proofs over the queued commitments, leaf parameters of every type, an
aux output with blob hashes, and a previous content hash.  The checks dict
must be equal key for key (in order), and the public input, the content
hash and every recursion queue state equal as u64, on the honest block and
on every rejection: a bad node VK, a proof with no VK, a wrong node public
input, a missing node proof, zkporter on, a required type skipped.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.models import recursion as jrec
from zkevm_circuits_tpu.models import scheduler as jsched
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops import queues as jqueues
from zkevm_circuits_tpu.utils import protocol as jprotocol
from zkevm_circuits_tpu_torch.models import recursion, scheduler
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover.recursion_proofs import VerifiedNodeProof
from zkevm_circuits_tpu_torch.utils import protocol
from zkevm_circuits_tpu_torch.utils.convert import compact_forms_from_numpy

from torch_block_helpers import jax_proof, u64 as _u64
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = torch.device("cpu")
NODE_VK = (31, 32, 33, 34)
INSTANCES = {1: 2, 8: 3, 13: 1}
DERIVED_LEN = {1: 39, 8: 27, 13: 9}


def _leaf_params(t):
    return dict(circuit_type=t, basic_circuit_vk_commitment=(5, 6, 7, 8),
                leaf_vk_commitment=(9, 10, 11, 12))


def _forms_fields(rng, k, obs_in):
    """k chained instances: the first starts, the last completes, each
    fsm output the next one's fsm input (masked as the protocol masks them)."""
    fsm = rng.integers(0, gf.MODULUS, size=(k + 1, 4), dtype=np.uint64)
    start = np.arange(k) == 0
    done = np.arange(k) == k - 1
    obs_out = rng.integers(0, gf.MODULUS, size=(k, 4), dtype=np.uint64)
    return dict(
        start_flag=start, completion_flag=done,
        observable_input_commitment=np.tile(obs_in, (k, 1)),
        observable_output_commitment=np.where(done[:, None], obs_out, 0).astype(np.uint64),
        hidden_fsm_input_commitment=np.where(start[:, None], 0, fsm[:k]).astype(np.uint64),
        hidden_fsm_output_commitment=np.where(done[:, None], 0, fsm[1:]).astype(np.uint64),
    )


def _jax_forms(fields):
    return jprotocol.ClosedFormInputCompactForm(
        jnp.asarray(fields["start_flag"]), jnp.asarray(fields["completion_flag"]),
        *[jgf.from_u64(fields[k]) for k in ("observable_input_commitment",
                                            "observable_output_commitment",
                                            "hidden_fsm_input_commitment",
                                            "hidden_fsm_output_commitment")])


@pytest.fixture(scope="module")
def inputs():
    """(port kwargs, JAX kwargs) of an honest block."""
    rng = np.random.default_rng(2024)
    derived = {t: rng.integers(0, gf.MODULUS, size=n, dtype=np.uint64)
               for t, n in DERIVED_LEN.items()}
    fields = {t: _forms_fields(rng, k, gf.to_u64(protocol.commit_encoding(
        gf.from_u64(derived[t], CPU)))) for t, k in INSTANCES.items()}
    forms = {t: compact_forms_from_numpy(f, CPU) for t, f in fields.items()}
    lp = {t: recursion.RecursionLeafParameters(**_leaf_params(t))
          for t in scheduler.SEQUENCE_OF_CIRCUIT_TYPES}
    vk = gf.from_u64(np.array(NODE_VK, np.uint64), CPU)
    proofs = {t: VerifiedNodeProof(scheduler.node_input_commitment(
        t, lp[t], NODE_VK, scheduler.recursion_queue_state(t, cf)), True, vk)
        for t, cf in forms.items()}
    blob = [rng.bytes(32) for _ in range(4)]
    common = dict(
        node_vk_commitment=NODE_VK,
        previous_block_content_hash=rng.bytes(32),
        block_data=None, block_meta=None, aux_output=None,
        required_types=set(INSTANCES),
    )
    port = dict(common, compact_forms_by_type=forms, node_proofs_by_type=proofs,
                leaf_params_by_type=lp,
                derived_observable_inputs={t: gf.from_u64(d, CPU) for t, d in derived.items()},
                block_data=scheduler.BlockPassthroughData(),
                block_meta=scheduler.BlockMetaParameters(bootloader_code_hash=int(rng.integers(
                    1 << 62)) << 190, default_aa_code_hash=int(rng.integers(1 << 62)) << 3),
                aux_output=scheduler.BlockAuxilaryOutput(
                    l1_messages_linear_hash=rng.bytes(32), eip4844_linear_hashes=tuple(blob[:2]),
                    eip4844_output_commitment_hashes=tuple(blob[2:])))
    jax = dict(common, compact_forms_by_type={t: _jax_forms(f) for t, f in fields.items()},
               node_proofs_by_type={t: jax_proof(p) for t, p in proofs.items()},
               leaf_params_by_type={t: jrec.RecursionLeafParameters(**_leaf_params(t))
                                    for t in jsched.SEQUENCE_OF_CIRCUIT_TYPES},
               derived_observable_inputs={t: jgf.from_u64(d) for t, d in derived.items()},
               block_data=jsched.BlockPassthroughData(),
               block_meta=jsched.BlockMetaParameters(**dataclasses.asdict(port["block_meta"])),
               aux_output=jsched.BlockAuxilaryOutput(**dataclasses.asdict(port["aux_output"])))
    return port, jax


def _assert_same(res, jres):
    assert list(res.checks.items()) == list(jres.checks.items())
    np.testing.assert_array_equal(_u64(res.public_input), _u64(jres.public_input))
    assert res.block_content_hash == jres.block_content_hash
    assert list(res.recursion_queue_states) == list(jres.recursion_queue_states)
    for t, qs in res.recursion_queue_states.items():
        jqs = jres.recursion_queue_states[t]
        np.testing.assert_array_equal(_u64(qs.head), _u64(jqs.head))
        np.testing.assert_array_equal(_u64(qs.tail), _u64(jqs.tail))
        assert int(qs.length) == int(np.asarray(jqs.length))


def test_honest_block_equal_to_jax(inputs):
    port, jax = inputs
    res = scheduler.run_scheduler(**port)
    jres = jsched.run_scheduler(**jax)
    assert scheduler.all_ok(res) and jsched.all_ok(jres), res.checks
    _assert_same(res, jres)
    assert {f"{scheduler.CIRCUIT_TYPES[t]}_input_derivation" for t in INSTANCES} <= set(res.checks)
    assert res.public_input.device == CPU


def test_node_input_commitment_and_content_hash(inputs):
    port, jax = inputs
    for t in INSTANCES:
        qs = scheduler.recursion_queue_state(t, port["compact_forms_by_type"][t])
        jqs = jqueues.QueueState(jgf.from_u64(gf.to_u64(qs.head)), jgf.from_u64(gf.to_u64(qs.tail)),
                                 jnp.uint32(qs.length))
        np.testing.assert_array_equal(
            _u64(scheduler.node_input_commitment(t, port["leaf_params_by_type"][t], NODE_VK, qs)),
            _u64(jsched.node_input_commitment(t, jax["leaf_params_by_type"][t], NODE_VK, jqs)))
    assert scheduler.block_content_hash(port["block_data"], port["block_meta"],
                                        port["aux_output"]) == jsched.block_content_hash(
        jax["block_data"], jax["block_meta"], jax["aux_output"])


REJECTIONS = {
    # (change to the kwargs of one side, the check that must fail)
    "bad_vk": (lambda kw, mk: dict(kw, node_proofs_by_type={
        t: dataclasses.replace(p, vk_commitment=mk([31, 32, 33, 35]))
        for t, p in kw["node_proofs_by_type"].items()}), "ram_validation_node_proof"),
    "vk_none": (lambda kw, mk: dict(kw, node_proofs_by_type={
        **kw["node_proofs_by_type"],
        8: dataclasses.replace(kw["node_proofs_by_type"][8], vk_commitment=None)}),
                "ram_validation_node_proof"),
    "wrong_public_input": (lambda kw, mk: dict(kw, node_proofs_by_type={
        **kw["node_proofs_by_type"],
        13: dataclasses.replace(kw["node_proofs_by_type"][13], public_input=mk([1, 2, 3, 4]))}),
                           "l1_messages_hasher_node_proof"),
    "missing_proof": (lambda kw, mk: dict(kw, node_proofs_by_type={
        t: p for t, p in kw["node_proofs_by_type"].items() if t != 1}), "main_vm_node_proof"),
    "zkporter_on": (lambda kw, mk: dict(kw, block_meta=dataclasses.replace(
        kw["block_meta"], zkporter_is_available=True)), "zkporter_disabled"),
    "required_type_skipped": (lambda kw, mk: dict(kw, compact_forms_by_type={
        t: f for t, f in kw["compact_forms_by_type"].items() if t != 13}),
                              "l1_messages_hasher_skipped"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejections_equal_to_jax(inputs, case):
    port, jax = inputs
    change, failing = REJECTIONS[case]
    res = scheduler.run_scheduler(**change(port, lambda v: gf.from_u64(np.array(v, np.uint64),
                                                                        CPU)))
    jres = jsched.run_scheduler(**change(jax, lambda v: jgf.from_u64(np.array(v, np.uint64))))
    assert not res.checks[failing]
    _assert_same(res, jres)
