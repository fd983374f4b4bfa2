"""Real STARK proofs at the recursion tree's leaves (the JAX package's
`prover/recursion_proofs.py`, on torch tensors).

Where the tree touches the base layer (ref
`src/recursion/leaf_layer/mod.rs:150-198`: pop query -> verify proof ->
enforce public input == queued commitment):

  * every circuit instance carries a `CarriedProof`: the sponge-chain STARK
    of `commitment = commit_encoding(compact_form)`
    (`pipeline.prove_compact_commitment`), optionally with the circuit's
    relation proof (the sorter full argument, `pipeline.prove_sorter_full`);
  * `leaf_layer_verify_starks` runs the real verifier per instance and
    EXTRACTS the public-input commitment from the proven publics, then runs
    the batched leaf checks of `models/recursion.py` on the verdicts.

The node level proves in-field that it verified its children's FRI query
phase (`node_prove_in_field`, prover/verifier_air.py).  The scheduler's
node-slot proof (`VerifiedNodeProof`, `scheduler_node_proof`) is built
through that leaf path: its validity is the verifiers' verdict.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import recursion
from ..models import scheduler as sched_mod
from ..ops import gf, queues
from . import pipeline
from . import poseidon2_air as pa
from . import verifier_air as va
from .stark import StarkParams, StarkProof, _fri_params


@dataclasses.dataclass
class CarriedProof:
    """One instance's proof bundle carried into a recursion leaf.

    `encoding` is PUBLIC data (the plaintext compact form the verifier
    recomputes the absorbed chunks and the message RLC from);
    `final_state` is the claimed final sponge state whose first 4 lanes are
    the commitment."""

    proof: StarkProof
    params: StarkParams
    encoding: np.ndarray      # (18,) u64 plaintext compact-form encoding
    final_state: np.ndarray   # (12,) u64
    # optional circuit-relation proof verified alongside:
    # (witness, SorterFullProof) for the grand-product families
    relation: Optional[Tuple[object, object]] = None


def commitment_vk(device=None) -> torch.Tensor:
    """(4,) VK commitment of the compact-form commitment STARK, on `device`
    (None: the card): the `basic_circuit_vk_commitment` a leaf pins."""
    # every compact form is 18 elements -> 3 FULL-spec chunks -> log_n = 3
    return pipeline.stark_vk_commitment(
        pa.chain_air(pa.FULL), StarkParams(log_n=3, log_blowup=2), device)


def make_carried_proofs(compact_forms,
                        relation: Optional[Tuple[object, object]] = None
                        ) -> List[CarriedProof]:
    """Prove every instance's ClosedFormInput commitment for one circuit
    type, on the forms' device, and bundle the proofs for the leaf layer.
    `relation` (shared by the type's instances) rides on the FIRST
    instance: one relation proof per circuit run."""
    dev = compact_forms.start_flag.device
    enc = gf.to_u64(compact_forms.encode())
    if enc.ndim == 1:
        enc = enc[None]
    out = []
    for k in range(enc.shape[0]):
        proof, _commitment, final_state, params = pipeline.prove_compact_commitment(
            enc[k], device=dev)
        out.append(CarriedProof(proof=proof, params=params, encoding=enc[k],
                                final_state=final_state,
                                relation=relation if k == 0 else None))
    return out


def verify_carried(cp: CarriedProof) -> Optional[np.ndarray]:
    """Run the real verifier; on success return the (4,) public-input
    commitment EXTRACTED from the proven publics (None on failure)."""
    commitment = np.asarray(cp.final_state[:4], np.uint64)
    ok = pipeline.verify_compact_commitment(cp.proof, cp.encoding, commitment,
                                            cp.final_state, cp.params)
    if ok and cp.relation is not None:
        witness, full = cp.relation
        ok = pipeline.verify_sorter_full(witness, full)
    return commitment if ok else None


def carried_to_batch(carried: Sequence[CarriedProof]) -> recursion.ProofBatch:
    """ProofBatch whose is_valid/public_input come from real verification:
    a failed proof yields public_input = 0 and is_valid = False, never the
    claimed values."""
    dev = carried[0].proof.q_cap.device
    publics, valid = [], []
    for cp in carried:
        extracted = verify_carried(cp)
        valid.append(extracted is not None)
        publics.append(np.zeros(4, np.uint64) if extracted is None else extracted)
    return recursion.ProofBatch(
        public_input=gf.from_u64(np.stack(publics), dev),
        is_valid=torch.tensor(valid, device=dev),
        vk_commitment=commitment_vk(dev).expand(len(carried), -1),
    )


def leaf_layer_verify_starks(
    circuit_type: int,
    queue_types: torch.Tensor,
    queue_commitments: torch.Tensor,
    execute: torch.Tensor,
    carried: Sequence[CarriedProof],
) -> Dict[str, torch.Tensor]:
    """The leaf layer on real proofs (ref leaf_layer/mod.rs:150-198): verify
    each queued instance's STARK, extract its public-input commitment, and
    run the batched leaf checks (type match, public input == queued
    commitment, VK pin) on the verifier-produced batch."""
    batch = carried_to_batch(carried)
    return recursion.leaf_layer_check(
        circuit_type, queue_types, queue_commitments, execute, batch,
        basic_vk_commitment=commitment_vk(queue_types.device),
    )


@dataclasses.dataclass
class NodeInFieldProof:
    """A node-level STARK proving the verification of its children's FRI
    query phase IN-FIELD (prover/verifier_air.py): "this node verified its
    children" as a provable statement.  The public-coin replay and the DEEP
    binding stay outer checks: `node_verify_in_field` runs them through the
    ordinary child verifier and demands the in-field proof as well."""

    vproof: StarkProof
    vparams: StarkParams
    child_fri_params: tuple


def node_prove_in_field(children: Sequence[CarriedProof]) -> NodeInFieldProof:
    """The node's verifier STARK over its children's FRI proofs, on their
    device.  Raises AssertionError if a child proof is invalid: a node
    cannot honestly claim to have verified a bad child."""
    fri_ps = tuple(_fri_params(pa.chain_air(pa.FULL), cp.params) for cp in children)
    vproof, _publics, vparams = va.prove_fri_verification(
        [cp.proof.fri_proof for cp in children], fri_ps)
    return NodeInFieldProof(vproof, vparams, fri_ps)


def node_verify_in_field(node: NodeInFieldProof, children: Sequence[CarriedProof]) -> bool:
    """Every child verifies under the ordinary verifier AND the in-field
    STARK proves the query-phase verification of EXACTLY these children's
    FRI proofs (the publics are rebuilt from the children, so a swapped or
    tampered child fails)."""
    for cp in children:
        if verify_carried(cp) is None:
            return False
    return va.verify_fri_verification(node.vproof, [cp.proof.fri_proof for cp in children],
                                      node.child_fri_params, node.vparams)


@dataclasses.dataclass
class VerifiedNodeProof:
    """A scheduler node-slot proof whose `is_valid` is the outcome of REAL
    verification — the leaf-layer STARK checks over every instance's
    carried commitment proof (+ its attached circuit-relation proof), and
    optionally the node's in-field FRI-verification STARK.  The scheduler
    consumes it duck-typed (public_input / is_valid / vk_commitment, ref
    scheduler/mod.rs:1026-1076)."""

    public_input: torch.Tensor          # (4,) node input commitment
    is_valid: bool
    vk_commitment: Optional[torch.Tensor] = None


def scheduler_node_proof(
    circuit_type: int,
    compact_forms,
    leaf_params,
    node_vk_commitment: tuple,
    relation: Optional[Tuple[object, object]] = None,
    extra_ok: bool = True,
    in_field: bool = False,
) -> Tuple[VerifiedNodeProof, List[CarriedProof], bool]:
    """Build one circuit type's scheduler node-slot proof THROUGH the leaf
    path, on the forms' device: prove every instance's compact-form
    commitment, verify each with the real verifier (relation proof attached
    to instance 0), run the batched leaf checks against the queued
    commitments, optionally prove the node's FRI verification in-field, and
    expose the node input commitment with the verified verdict.

    Returns (proof, carried, leaf_ok) — `leaf_ok` excludes `extra_ok` so
    callers can report the leaf verdict separately."""
    carried = make_carried_proofs(compact_forms, relation=relation)
    proof, leaf_ok = node_slot_proof(circuit_type, compact_forms, carried, leaf_params,
                                     node_vk_commitment, extra_ok, in_field)
    return proof, carried, leaf_ok


def node_slot_proof(
    circuit_type: int,
    compact_forms,
    carried: Sequence[CarriedProof],
    leaf_params,
    node_vk_commitment: tuple,
    extra_ok: bool = True,
    in_field: bool = False,
    times: Optional[dict] = None,
) -> Tuple[VerifiedNodeProof, bool]:
    """The part of `scheduler_node_proof` after the proofs are made: the
    leaf checks of `carried` against the queued commitments of
    `compact_forms`, the optional in-field node, and the slot proof.  With
    `times`, the seconds (each ended by a synchronize) of the leaf check (the
    carried proofs' verifications included) and of the node's prove and
    verify land under "leaf", "node prove" and "node verify".  Returns
    (proof, leaf_ok)."""
    dev = compact_forms.start_flag.device
    clock = functools.partial(pipeline._synced_clock, dev)
    t0 = clock()
    k = len(carried)
    types = torch.full((k,), circuit_type, dtype=torch.int64, device=dev)
    commitments = compact_forms.commitment().reshape((k, 4))
    execute = torch.ones(k, dtype=torch.bool, device=dev)
    checks = leaf_layer_verify_starks(circuit_type, types, commitments, execute, carried)
    leaf_ok = all(bool(v.all()) for v in checks.values())
    spent = {"leaf": clock() - t0}
    if in_field and leaf_ok:
        t0 = clock()
        node = node_prove_in_field(carried)
        t1 = clock()
        leaf_ok = leaf_ok and node_verify_in_field(node, carried)
        spent.update({"node prove": t1 - t0, "node verify": clock() - t1})
    if times is not None:
        times.update(spent)
    qchain = recursion.build_recursion_queue(types, commitments, execute)
    qs = queues.QueueState(gf.zeros((12,), dev), qchain[k], k)
    commitment = sched_mod.node_input_commitment(circuit_type, leaf_params,
                                                 node_vk_commitment, qs)
    proof = VerifiedNodeProof(
        public_input=commitment,
        is_valid=bool(leaf_ok) and bool(extra_ok),
        vk_commitment=gf.from_u64(np.array(node_vk_commitment, np.uint64), dev),
    )
    return proof, leaf_ok
