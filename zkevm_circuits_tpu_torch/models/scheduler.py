"""scheduler — the block-level orchestrator circuit (the JAX package's
`models/scheduler.py`, on torch tensors).

Reference parity: `src/scheduler/` (`scheduler_function` mod.rs:105-1281,
`BaseLayerCircuitType` auxiliary.rs:29-44, block header
block_header/mod.rs:28-189).  Implemented here:

  * the 13-type circuit id map (CIRCUIT_TYPES below);
  * per-type instance-sequence enforcement: start/completion chaining,
    hidden-FSM handoff, observable-input equality across instances
    (mod.rs:575-789, 810-986 — via utils/protocol.check_instance_chaining);
  * per-instance compact-form commitments pushed as RecursionQuery{type,
    commitment} into per-type recursion queues (mod.rs:902-961);
  * node-layer proof check per type against the queue tail (skip when the
    queue is empty — proof-validity masking, mod.rs:1026-1076);
  * block content header: keccak(block_data) / keccak(block_meta) /
    keccak(aux_output) combined by a final keccak
    (block_header/mod.rs:142-189), and the scheduler's 4 public inputs =
    keccak(prev_hash || this_hash || node_vk_hash || leaf_params_hash)
    split into 4 x 8-byte field chunks (mod.rs:1237-1281).

This layer runs once a block over O(# instances) data: the commitments and
queues on the compact forms' device, the keccaks on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import gf, queues
from ..ops.keccak import keccak256_ref
from ..utils import protocol
from ..utils.device import resolve_device
from . import recursion

# BaseLayerCircuitType (ref scheduler/auxiliary.rs:29-44)
CIRCUIT_TYPES = {
    1: "main_vm",
    2: "code_decommittments_sorter",
    3: "code_decommitter",
    4: "log_demux",
    5: "keccak_round_function",
    6: "sha256_round_function",
    7: "ecrecover",
    8: "ram_validation",
    9: "storage_sorter",
    10: "storage_application",
    11: "events_sorter",
    12: "l1_messages_sorter",
    13: "l1_messages_hasher",
}
SEQUENCE_OF_CIRCUIT_TYPES = tuple(range(1, 14))  # ref mod.rs:79-93
NUM_SHARDS = 2  # rollup + porter (porter must be empty)


@dataclasses.dataclass
class BlockAuxilaryOutput:
    l1_messages_linear_hash: bytes = b"\x00" * 32
    rollup_state_diff_for_compression: bytes = b"\x00" * 32
    bootloader_heap_initial_content: bytes = b"\x00" * 32
    events_queue_state: bytes = b"\x00" * 32
    eip4844_linear_hashes: tuple = (b"\x00" * 32,) * 2
    eip4844_output_commitment_hashes: tuple = (b"\x00" * 32,) * 2

    def flattened(self) -> bytes:
        out = (
            self.l1_messages_linear_hash
            + self.rollup_state_diff_for_compression
            + self.bootloader_heap_initial_content
            + self.events_queue_state
        )
        for lh, oc in zip(self.eip4844_linear_hashes, self.eip4844_output_commitment_hashes):
            out += lh + oc
        return out


@dataclasses.dataclass
class PerShardState:
    enumeration_counter: int = 0
    state_root: bytes = b"\x00" * 32

    def flattened(self) -> bytes:
        return self.enumeration_counter.to_bytes(8, "big") + self.state_root


@dataclasses.dataclass
class BlockPassthroughData:
    per_shard_states: tuple = (PerShardState(), PerShardState())

    def flattened(self) -> bytes:
        return b"".join(s.flattened() for s in self.per_shard_states)


@dataclasses.dataclass
class BlockMetaParameters:
    zkporter_is_available: bool = False
    bootloader_code_hash: int = 0
    default_aa_code_hash: int = 0

    def flattened(self) -> bytes:
        return (
            bytes([int(self.zkporter_is_available)])
            + self.bootloader_code_hash.to_bytes(32, "big")
            + self.default_aa_code_hash.to_bytes(32, "big")
        )


def block_content_hash(
    data: BlockPassthroughData, meta: BlockMetaParameters, aux: BlockAuxilaryOutput
) -> bytes:
    """3 keccaks + combining keccak (ref block_header/mod.rs:142-189)."""
    h1 = keccak256_ref(data.flattened())
    h2 = keccak256_ref(meta.flattened())
    h3 = keccak256_ref(aux.flattened())
    return keccak256_ref(h1 + h2 + h3)


@dataclasses.dataclass
class SchedulerResult:
    checks: Dict[str, bool]
    recursion_queue_states: Dict[int, queues.QueueState]
    block_content_hash: bytes
    public_input: torch.Tensor  # (4,) scheduler public inputs


def recursion_queue_state(ctype: int, cf) -> queues.QueueState:
    """The recursion queue of one type's instances: RecursionQuery{type,
    commitment} pushed for every instance, all executed."""
    k = int(cf.start_flag.shape[0])
    dev = cf.start_flag.device
    qchain = recursion.build_recursion_queue(
        torch.full((k,), ctype, dtype=torch.int64, device=dev), cf.commitment(),
        torch.ones(k, dtype=torch.bool, device=dev))
    return queues.QueueState(gf.zeros((12,), dev), qchain[k], k)


def run_scheduler(
    compact_forms_by_type: Dict[int, protocol.ClosedFormInputCompactForm],
    node_proofs_by_type: Dict[int, recursion.ProofSurrogate],
    leaf_params_by_type: Dict[int, recursion.RecursionLeafParameters],
    node_vk_commitment: tuple,
    previous_block_content_hash: bytes,
    block_data: BlockPassthroughData,
    block_meta: BlockMetaParameters,
    aux_output: BlockAuxilaryOutput,
    derived_observable_inputs: Optional[Dict[int, torch.Tensor]] = None,
    required_types: Optional[set] = None,
    device=None,
) -> SchedulerResult:
    """Orchestrate one block: enforce the instance protocol per circuit type,
    fill the per-type recursion queues, check node proofs, produce the block
    commitment.

    `derived_observable_inputs` is the cross-circuit input-derivation glue
    (ref mod.rs:239-568): for each type, the scheduler's OWN assembly of
    that circuit's observable input from its predecessors' outputs (queue
    tails, threaded memory states, per-block data).  Its commitment must
    equal the observable-input commitment every instance of that type
    committed to — so a circuit cannot run on data that was not produced by
    its upstream producer.  `required_types` is the skip-invariant set (ref
    mod.rs:575-789): a type whose derived input shows nonempty work cannot
    be skipped.

    The work runs on the compact forms' device; with no forms at all, on
    `device` (None: the card)."""
    present = [cf for cf in compact_forms_by_type.values() if cf is not None]
    dev = present[0].start_flag.device if present else resolve_device(device)
    checks: Dict[str, bool] = {}
    # zkporter forbidden (ref mod.rs:139-150)
    checks["zkporter_disabled"] = not block_meta.zkporter_is_available

    queue_states: Dict[int, queues.QueueState] = {}
    for ctype in SEQUENCE_OF_CIRCUIT_TYPES:
        name = CIRCUIT_TYPES[ctype]
        cf = compact_forms_by_type.get(ctype)
        if cf is None or int(cf.start_flag.shape[0]) == 0:
            queue_states[ctype] = queues.empty_queue_state(12, device=dev)
            # empty-input => skip is legal; nonempty derived input => error
            checks[f"{name}_skipped"] = ctype not in (required_types or set())
            continue
        chain = protocol.check_instance_chaining(
            cf.start_flag,
            cf.completion_flag,
            cf.hidden_fsm_input_commitment,
            cf.hidden_fsm_output_commitment,
        )
        checks[f"{name}_chaining"] = all(bool(v.all()) for v in chain.values())
        # completion required at the end of the sequence (mod.rs:989)
        checks[f"{name}_finished"] = bool(cf.completion_flag[-1])
        obs = cf.observable_input_commitment
        checks[f"{name}_observable_input_consistent"] = bool((obs == obs[0]).all())
        if derived_observable_inputs and ctype in derived_observable_inputs:
            expected = protocol.commit_encoding(derived_observable_inputs[ctype].to(obs.device))
            checks[f"{name}_input_derivation"] = bool((obs == expected).all())
        queue_states[ctype] = recursion_queue_state(ctype, cf)

    # node-layer proof verification per type (skip empty queues)
    node_vk = gf.from_u64(np.array(node_vk_commitment, dtype=np.uint64), dev)
    for ctype in SEQUENCE_OF_CIRCUIT_TYPES:
        name = CIRCUIT_TYPES[ctype]
        qs = queue_states[ctype]
        if int(qs.length) == 0:
            continue
        proof = node_proofs_by_type.get(ctype)
        if proof is None:
            checks[f"{name}_node_proof"] = False
            continue
        expected = node_input_commitment(
            ctype, leaf_params_by_type[ctype], node_vk_commitment, qs
        )
        # the node proof must verify under THE node VK (ref mod.rs:1026-1076);
        # a proof carrying no VK commitment fails
        vk_ok = (proof.vk_commitment is not None
                 and bool(gf.equal(proof.vk_commitment.to(dev), node_vk).all()))
        checks[f"{name}_node_proof"] = vk_ok and bool(
            gf.equal(proof.public_input.to(dev), expected).all()) and bool(proof.is_valid)

    this_hash = block_content_hash(block_data, block_meta, aux_output)

    # final public input (ref mod.rs:1237-1281)
    leaf_params_hash = keccak256_ref(
        b"".join(
            gf.to_u64(leaf_params_by_type[t].encode(dev)).astype(">u8").tobytes()
            for t in SEQUENCE_OF_CIRCUIT_TYPES
            if t in leaf_params_by_type
        )
    )
    node_vk_hash = keccak256_ref(
        b"".join(int(v).to_bytes(8, "big") for v in node_vk_commitment)
    )
    final = keccak256_ref(
        previous_block_content_hash + this_hash + node_vk_hash + leaf_params_hash
    )
    # 4 public inputs = 4 x 8-byte BE chunks, reduced into Goldilocks
    chunks = [int.from_bytes(final[8 * i: 8 * i + 8], "big") % gf.MODULUS for i in range(4)]
    public_input = gf.from_u64(np.array(chunks, dtype=np.uint64), dev)

    return SchedulerResult(
        checks=checks,
        recursion_queue_states=queue_states,
        block_content_hash=this_hash,
        public_input=public_input,
    )


def node_input_commitment(
    circuit_type: int,
    leaf_params: recursion.RecursionLeafParameters,
    node_vk_commitment: tuple,
    queue_state: queues.QueueState,
) -> torch.Tensor:
    """commitment to RecursionNodeInput{type, leaf_params, node_vk, queue},
    on the queue state's device."""
    dev = queue_state.tail.device
    enc = torch.cat(
        [
            gf.constant(circuit_type, dev).reshape(1),
            leaf_params.encode(dev),
            gf.from_u64(np.array(node_vk_commitment, dtype=np.uint64), dev),
            queue_state.head,
            queue_state.tail,
            torch.as_tensor(queue_state.length, dtype=torch.int64, device=dev).reshape(1),
        ],
        dim=-1,
    )
    return protocol.commit_encoding(enc)


def all_ok(result: SchedulerResult) -> bool:
    return all(result.checks.values())
