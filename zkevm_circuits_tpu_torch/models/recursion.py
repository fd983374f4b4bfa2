"""Recursion/aggregation layer: leaf, node, compression, interblock (the JAX
package's `models/recursion.py`, on torch tensors).

Reference parity: `src/recursion/` of era-zkevm_circuits:
`leaf_layer_recursion_entry_point` (leaf_layer/mod.rs:56-214),
`node_layer_recursion_entry_point` (node_layer/mod.rs:61-316 with
`split_queue_state_into_n` :261-316), `proof_compression_function`
(compression/mod.rs:42-121) and the interblock keccak aggregation
(interblock/keccak_aggregator.rs).  NUM_BASE_LAYER_CIRCUITS = 13,
VK_COMMITMENT_LENGTH = 4.

A RecursionQuery packs to 8 elements [circuit_type, c0..c3, 0, 0, 0] and
lives in a full-state (width 12) queue.  A proof is seen here through its
public-input commitment (4 lanes), a validity bit and the commitment to the
verifying key it was checked under; `prover/recursion_proofs.py` fills the
validity bits from real STARK verification.  Every check returns a dict of
bool tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import gf, queues
from ..ops.keccak import keccak256_ref
from ..ops.queues import QueueState
from ..utils import protocol
from ..utils.device import resolve_device

NUM_BASE_LAYER_CIRCUITS = 13
VK_COMMITMENT_LENGTH = 4
RECURSION_QUERY_PACKED_WIDTH = 8


def _as_tensor(v, device) -> torch.Tensor:
    """a field tensor, or python ints made one on `device`."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return gf.from_u64(np.array(v, dtype=np.uint64), device)


def encode_recursion_queries(circuit_type: torch.Tensor, commitments: torch.Tensor) -> torch.Tensor:
    """(n,) type + (n, 4) commitments -> (n, 8) encodings."""
    z = torch.zeros_like(circuit_type).unsqueeze(-1).expand(circuit_type.shape + (3,))
    return torch.cat([circuit_type.unsqueeze(-1), commitments, z], dim=-1)


def build_recursion_queue(circuit_type: torch.Tensor, commitments: torch.Tensor,
                          execute: torch.Tensor) -> torch.Tensor:
    """full-state queue chain over the recursion queries; returns (n+1, 12)
    on their device (the chain in the native runtime: one download, one
    upload, where a step loop would be a permutation a query)."""
    enc = encode_recursion_queries(circuit_type, commitments)
    return queues.simulate_chains(queues.FULL_STATE_WIDTH, [(enc, execute)])[0]


@dataclasses.dataclass
class ProofSurrogate:
    """A proof as the tree sees it.  `vk_commitment` records WHICH
    verification key the proof verifies under; a proof carrying no VK fails
    any VK-checked site."""

    public_input: torch.Tensor  # (4,)
    is_valid: bool
    vk_commitment: Optional[torch.Tensor] = None  # (4,)


@dataclasses.dataclass(frozen=True)
class ProofBatch:
    """Stacked proofs for the batched tree checks."""

    public_input: torch.Tensor  # (n, 4)
    is_valid: torch.Tensor  # (n,) bool
    vk_commitment: torch.Tensor  # (n, 4)


def stack_proofs(proofs: Sequence[ProofSurrogate]) -> ProofBatch:
    dev = proofs[0].public_input.device
    vks = [p.vk_commitment if p.vk_commitment is not None else gf.zeros((4,), dev)
           for p in proofs]
    return ProofBatch(
        public_input=torch.stack([p.public_input for p in proofs]),
        is_valid=torch.tensor([bool(p.is_valid) for p in proofs], device=dev),
        vk_commitment=torch.stack(vks),
    )


@dataclasses.dataclass(frozen=True)
class RecursionLeafParameters:
    """ref leaf_layer/input.rs:26-43: per-type leaf params commitment."""

    circuit_type: int
    basic_circuit_vk_commitment: tuple  # 4 ints
    leaf_vk_commitment: tuple  # 4 ints

    def encode(self, device=None) -> torch.Tensor:
        """(9,) on `device` (None: the card)."""
        vals = [self.circuit_type, *self.basic_circuit_vk_commitment, *self.leaf_vk_commitment]
        return gf.from_u64(np.array(vals, dtype=np.uint64), resolve_device(device))


def leaf_layer_check(
    circuit_type: int,
    queue_types: torch.Tensor,
    queue_commitments: torch.Tensor,
    execute: torch.Tensor,
    proofs,
    basic_vk_commitment=None,
) -> dict:
    """Leaf aggregation (ref leaf_layer/mod.rs:91-127, 150-204): every queued
    query's type must match; each claimed proof's public input must equal the
    queued commitment AND the proof must verify under the base-layer circuit
    VK the leaf pins; rows not executed pass.  `proofs` is a ProofBatch or a
    sequence of ProofSurrogate."""
    if not isinstance(proofs, ProofBatch):
        proofs = stack_proofs(proofs)
    dev = queue_types.device
    execute = execute.to(dev)
    type_ok = gf.equal(queue_types, gf.constant(circuit_type, dev)) | ~execute
    input_ok = (gf.equal(proofs.public_input, queue_commitments).all(-1)
                & proofs.is_valid) | ~execute
    out = {"type_match": type_ok, "proof_inputs": input_ok}
    if basic_vk_commitment is not None:
        expected_vk = _as_tensor(basic_vk_commitment, dev)
        out["proof_vk"] = gf.equal(proofs.vk_commitment, expected_vk).all(-1) | ~execute
    return out


def leaf_input_commitment(params: RecursionLeafParameters,
                          queue_state: QueueState) -> torch.Tensor:
    """commitment to RecursionLeafInput{params, queue_state}."""
    dev = queue_state.head.device
    enc = torch.cat([
        params.encode(dev),
        queue_state.head,
        queue_state.tail,
        torch.as_tensor(queue_state.length, dtype=torch.int64, device=dev).reshape(1),
    ])
    return protocol.commit_encoding(enc)


def split_queue_chain(chain: torch.Tensor, total_length, split_into: int,
                      split_points: Sequence[int]) -> List[QueueState]:
    """Split a materialized queue chain into consecutive sub-queue states
    (split_queue_state_into_n, node_layer/mod.rs:261-316): the caller gives
    the split points; `check_split` validates the gluing."""
    bounds = [0, *split_points, int(total_length)]
    if len(bounds) != split_into + 1:
        raise ValueError(f"{len(split_points)} split points do not make {split_into} parts")
    out = []
    for i in range(split_into):
        b0, b1 = bounds[i], bounds[i + 1]
        if b0 > b1:
            raise ValueError(f"split points must not decrease: {bounds}")
        out.append(QueueState(chain[b0], chain[b1], b1 - b0))
    return out


def check_split(parent: QueueState, children: List[QueueState]) -> dict:
    """Gluing invariants: heads chain tail-to-head, lengths sum, ends match."""
    dev = parent.head.device
    head_ok = gf.equal(children[0].head, parent.head).all()
    glue_ok = torch.ones((), dtype=torch.bool, device=dev)
    for a, b in zip(children[:-1], children[1:]):
        glue_ok = glue_ok & gf.equal(a.tail, b.head).all()
    tail_ok = gf.equal(children[-1].tail, parent.tail).all()
    total = sum(int(c.length) for c in children)
    len_ok = torch.tensor(total == int(parent.length), device=dev)
    return {"head": head_ok, "glue": glue_ok, "tail": tail_ok, "length": len_ok}


def node_layer_check(
    parent_state: QueueState,
    chain: torch.Tensor,
    split_points: Sequence[int],
    node_capacity: int,
    leaf_capacity: int,
    child_proofs: Sequence[ProofSurrogate],
    child_input_commitments: Sequence[torch.Tensor],
) -> dict:
    """Interior tree node (ref node_layer/mod.rs:135-249): split the queue,
    decide children-are-leaves by length <= leaf_capacity * node_capacity,
    verify each non-empty child's proof against its input commitment."""
    length = int(parent_state.length)
    children = split_queue_chain(chain, length, node_capacity, split_points)
    res = check_split(parent_state, children)
    dev = parent_state.head.device
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for child, proof, commitment in zip(children, child_proofs, child_input_commitments):
        if int(child.length) > 0:
            ok = ok & gf.equal(proof.public_input, commitment).all() & bool(proof.is_valid)
    res["children_proofs"] = ok
    res["children_are_leaves"] = torch.tensor(length <= leaf_capacity * node_capacity,
                                              device=dev)
    return res


def _params_enc_broadcast(params: RecursionLeafParameters, m: int, device) -> torch.Tensor:
    return params.encode(device).expand(m, -1)


def _lengths_col(lengths, m: int, device) -> torch.Tensor:
    return torch.as_tensor(lengths, dtype=torch.int64, device=device).reshape(m, 1)


def leaf_input_commitments_batched(params: RecursionLeafParameters, heads: torch.Tensor,
                                   tails: torch.Tensor, lengths) -> torch.Tensor:
    """(m, 4) leaf-input commitments: RecursionLeafInput{params,
    queue_state} committed per child (ref leaf_layer/input.rs)."""
    m = heads.shape[0]
    dev = heads.device
    enc = torch.cat([_params_enc_broadcast(params, m, dev), heads, tails,
                     _lengths_col(lengths, m, dev)], dim=-1)
    return protocol.commit_encoding(enc)


def node_input_commitments_batched(circuit_type: int, params: RecursionLeafParameters,
                                   node_vk_commitment: torch.Tensor, heads: torch.Tensor,
                                   tails: torch.Tensor, lengths) -> torch.Tensor:
    """(m, 4) node-input commitments: RecursionNodeInput{type, params,
    node_vk, queue_state} (ref node_layer/input.rs)."""
    m = heads.shape[0]
    dev = heads.device
    enc = torch.cat([
        torch.full((m, 1), int(circuit_type), dtype=torch.int64, device=dev),
        _params_enc_broadcast(params, m, dev),
        node_vk_commitment.to(dev).expand(m, -1),
        heads,
        tails,
        _lengths_col(lengths, m, dev),
    ], dim=-1)
    return protocol.commit_encoding(enc)


def node_layer_verify(
    circuit_type: int,
    parent_state: QueueState,
    chain: torch.Tensor,
    bounds: torch.Tensor,
    leaf_capacity: int,
    params: RecursionLeafParameters,
    node_vk_commitment,
    proofs: ProofBatch,
) -> dict:
    """Interior tree node, batched (ref node_layer/mod.rs:135-249 and
    :261-316): split the parent queue at `bounds` (an (m+1,) index vector
    into `chain`, bounds[0] == 0), decide children-are-leaves by
    length <= leaf_capacity * m, recompute every child's input commitment in
    both forms and select, and verify each non-empty child proof against the
    selected commitment AND the depth-appropriate VK (the leaf VK when the
    children are leaves, the node VK otherwise)."""
    dev = chain.device
    node_vk = _as_tensor(node_vk_commitment, dev)
    bounds = bounds.to(dev)
    m = bounds.shape[0] - 1
    heads = chain[bounds[:-1]]
    tails = chain[bounds[1:]]
    lengths = bounds[1:] - bounds[:-1]
    parent_len = torch.as_tensor(parent_state.length, dtype=torch.int64, device=dev)

    res = {
        "head": gf.equal(heads[0], parent_state.head).all(),
        "tail": gf.equal(tails[m - 1], parent_state.tail).all(),
        "glue": gf.equal(heads[1:], tails[:-1]).all(),
        "length": lengths.sum() == parent_len,
    }
    children_are_leaves = parent_len <= leaf_capacity * m
    leaf_cms = leaf_input_commitments_batched(params, heads, tails, lengths)
    node_cms = node_input_commitments_batched(circuit_type, params, node_vk, heads, tails,
                                              lengths)
    expected = torch.where(children_are_leaves, leaf_cms, node_cms)
    leaf_vk = _as_tensor(params.leaf_vk_commitment, dev)
    expected_vk = torch.where(children_are_leaves, leaf_vk, node_vk).expand(m, -1)
    row_ok = (gf.equal(proofs.public_input, expected).all(-1)
              & gf.equal(proofs.vk_commitment, expected_vk).all(-1)
              & proofs.is_valid)
    res["children_proofs"] = (row_ok | (lengths == 0)).all()
    res["children_are_leaves"] = children_are_leaves
    return res


def compression_check(proof: ProofSurrogate, expected_input: torch.Tensor) -> torch.Tensor:
    """ref compression/mod.rs:42-121: verify exactly one proof over a
    baked-in VK and re-expose its public input."""
    return gf.equal(proof.public_input, expected_input).all() & bool(proof.is_valid)


def interblock_aggregate_keccak(public_inputs: List[torch.Tensor],
                                valid: Optional[Sequence[bool]] = None) -> bytes:
    """ref interblock/keccak_aggregator.rs:5-96: keccak256 over the
    concatenated byte-decomposed public inputs (8 bytes big-endian per field
    element).  The aggregator has a FIXED slot capacity; `valid` marks the
    occupied slots, and an invalid slot's bytes are zeroed before absorption,
    so a forged trailing slot cannot alter the aggregate."""
    if valid is None:
        valid = [True] * len(public_inputs)
    data = bytearray()
    for pi, ok in zip(public_inputs, valid):
        for v in gf.to_u64(pi).reshape(-1):
            data += int(v).to_bytes(8, "big") if ok else b"\x00" * 8
    return keccak256_ref(bytes(data))
