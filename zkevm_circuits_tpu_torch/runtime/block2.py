"""Block driver v2 — the full 13-circuit block on the real-ISA EraVM (the
JAX package's `runtime/block2.py`, on torch tensors).

The era-zkevm_test_harness role over models/vm: run a bootloader program,
extract every tape, drive ALL consumer circuit types, check the
producer->consumer queue handoffs, and orchestrate the scheduler.

Dataflow (ref `src/scheduler/mod.rs:239-452`):

    VM(1) --decommit tape--> sorter(2) --unique--> code_unpacker(3)
    VM(1) --log tape-------> demux(4) --> keccak(5) sha256(6) ecrecover(7)
                                      --> storage sorter(9) --> application(10)
                                      --> events sorter(11)
                                      --> l1 sorter(12) --> linear hasher(13)
    memory queue threading (mod.rs:284-349):
        unpacker writes ++ VM memory tape ++ precompile reads/writes
        --> ram_permutation(8)

The circuits run through the paths of `runtime/block.py` (`log_path`,
`memory_thread`, `storage_application`) at the sizes of `Block2Config`,
and their STARKs through its verdict writers.  `execute_block2` runs the
Python EraVM, as the JAX package does, and hands the run to
`execute_block2_from_run`, which takes any run of the same tapes (the native
EraVM's, held bit-identical to the Python one).

Where the port differs from the JAX block runtime (ROADMAP Queue 3):

  * the memory union's order: each precompile circuit's rows reach
    ram_permutation in its memory chain's order (a call's reads, then its
    writes; `block._thread_order`), where the JAX runtime appends all its
    reads, then all its writes (block2.py:316-351).  With one call a
    precompile the two orders are the same rows in the same order; with two,
    the JAX runtime's `memory_thread_closes` is false on an honest block;
  * the code unpacker's sha256 chain proofs read the round's request from
    `round_request` (`block.code_unpacker_verdict`); the JAX runtime reads
    `round_call` (block2.py:732), a field the unpacker's witness does not
    have, so its type-3 verdict is never written;
  * the handoffs hold the port's paths' own checks as well
    (`vm_to_decommit_sorter`, `vm_to_demux`, `l1_sorter_to_hasher`,
    `decommit_sorter_to_unpacker`, `vm_to_unpacker`, `thread_to_*`) beside
    the JAX runtime's.

As in the JAX runtime, the verdicts of types 1, 4 and 255 are assigned and
the others AND-merged (block2.py:700, :806, :823).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base_structures.decommit_query import encode_decommit_query_ref
from ..base_structures.memory_query import encode_memory_queries_np
from ..isa import system_params as sp
from ..models import demux_log_queue as dm
from ..models import eip_4844 as e44
from ..models import recursion, scheduler
from ..models import vm as vm2
from ..ops import gf
from ..prover import pipeline
from ..prover import recursion_proofs as rp
from ..utils import protocol as proto
from ..utils.device import resolve_device
from . import block, native

NODE_VK = (1, 2, 3, 4)


@dataclasses.dataclass(frozen=True)
class Block2Config:
    """The block's instance sizes and proofs.  The code unpacker, keccak and
    sha256 run as ONE instance of `unpacker_rounds` / `keccak_blocks` (with
    `keccak_reads`) / `sha_rounds` rows when the block's need fits it, as the
    JAX runtime runs them (where the JAX runtime stops at a larger need, the
    port splits it into instances of those sizes, `block.memory_thread`)."""

    vm_limit: int = 64
    vm_instance_limit: Optional[int] = None  # default: one instance
    sorter_limit: int = 32
    hasher_limit: int = 8
    unpacker_rounds: int = 32
    keccak_blocks: int = 8
    keccak_reads: int = 16
    sha_rounds: int = 8
    ec_calls: int = 1
    storage_rows: int = 16
    ram_limit: int = 128
    run_scheduler: bool = True
    # prove every grand-product sorter's permutation argument with the real
    # coset-quotient STARK (prover/pipeline.py) and feed the VERIFIER's
    # verdict — not a witness claim — into the scheduler's node proofs
    prove_sorter_starks: bool = False
    # upgrade the sorter proofs to the FULL argument (grand product AND both
    # Poseidon2 queue-tail sponge chains, `prove_sorter_full`): the verifier
    # re-derives the Fiat-Shamir challenges from PROVEN tails instead of
    # trusting the witness's
    prove_full_sorter_chains: bool = False
    # prove every circuit instance's ClosedFormInput commitment — the value
    # the scheduler pushes into the per-type recursion queue (ref
    # fsm_input_output/mod.rs:281-326, scheduler/mod.rs:902-961) — with the
    # sponge-chain STARK, so the recursion tree's leaf publics are
    # proof-backed rather than recomputed by a trusting host
    prove_commitments: bool = False
    # circuit types whose scheduler node slot additionally carries the
    # node-level IN-FIELD FRI-verification STARK over its children
    # (prover/verifier_air.py via recursion_proofs.node_prove_in_field)
    node_in_field_types: tuple = ()
    # prove the hash-chain circuits' digests with committed-trace STARKs
    # (keccak_air / sha256_air): types 3 (unpacker sha256 chains), 5
    # (keccak256 precompile), 6 (sha256 precompile), 13 (linear_hasher), and
    # the eip_4844 blobs (255)
    prove_hash_chains: bool = False
    # prove the VM core relation set over a committed trace
    # (prover/vm_air.py; ref main_vm/cycle.rs:959-966 committed geometry) —
    # circuit type 1's verdict becomes verifier-produced
    prove_vm: bool = False
    # prove demux_log_queue's per-pop routing (type 4) with the committed
    # selector-certificate STARK (prover/demux_air.py; ref
    # demux_log_queue/mod.rs:279-310)
    prove_routing: bool = False
    # prove storage_application's blake2s Merkle path recomputations
    # (type 10) with the compression-chain STARK (prover/blake2s_air.py;
    # ref storage_application/mod.rs:390-400)
    prove_storage_paths: bool = False
    # prove ecrecover's secp256k1 recovery ladder relations (type 7) with
    # the nonnative-limb STARK (prover/ecrecover_air.py; ref
    # ecrecover/new_optimized.rs:870-1128)
    prove_ecrecover: bool = False


@dataclasses.dataclass
class Block2Result:
    residuals: Dict[str, dict]
    compact_forms: Dict[int, object]
    handoffs: Dict[str, bool]
    scheduler_result: Optional[scheduler.SchedulerResult]
    l1_messages_hash: Optional[bytes]
    vm: object  # the EraVM (tapes, final state) for inspection
    blob_compact_forms: list = dataclasses.field(default_factory=list)
    # circuit type -> verifier-produced STARK verdict for its grand-product
    # argument (only populated when Block2Config.prove_sorter_starks)
    stark_verdicts: Dict[int, bool] = dataclasses.field(default_factory=dict)
    # circuit type -> verifier verdict over ALL instance ClosedFormInput
    # commitment proofs (only populated when Block2Config.prove_commitments)
    commitment_verdicts: Dict[int, bool] = dataclasses.field(default_factory=dict)
    # what `run_scheduler` was called with (keyword -> value), to call it
    # again with one input changed
    scheduler_inputs: Optional[dict] = None
    # circuit type -> its instances' carried commitment proofs
    carried: Dict[int, list] = dataclasses.field(default_factory=dict)
    # circuit name -> its witness
    witnesses: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        for res in self.residuals.values():
            for v in res.values():
                if not bool(v.all()):
                    return False
        if not all(self.handoffs.values()):
            return False
        if self.scheduler_result is not None:
            return scheduler.all_ok(self.scheduler_result)
        return True

    def failing(self):
        out = []
        for circuit, res in self.residuals.items():
            for name, v in res.items():
                if not bool(v.all()):
                    out.append(f"{circuit}.{name}")
        out += [f"handoff.{k}" for k, v in self.handoffs.items() if not v]
        if self.scheduler_result is not None:
            out += [
                f"scheduler.{k}"
                for k, v in self.scheduler_result.checks.items()
                if not v
            ]
        return out


def leaf_params() -> Dict[int, recursion.RecursionLeafParameters]:
    """The leaf parameters of every type, as the JAX block runtime sets them."""
    return {t: recursion.RecursionLeafParameters(t, (5, 6, 7, 8), (9, 10, 11, 12))
            for t in scheduler.SEQUENCE_OF_CIRCUIT_TYPES}


def execute_block2(
    code: list,
    config: Block2Config = Block2Config(),
    *,
    storage=None,
    code_store=None,
    calldata=None,
    bootloader_heap=None,
    registers=None,
    default_aa_code_hash: int = 0,
    previous_block_content_hash: bytes = b"\x00" * 32,
    blobs=None,
    device=None,
    log: Optional[list] = None,
) -> Block2Result:
    """One block: the Python EraVM over `code` for `config.vm_limit` cycles,
    then `execute_block2_from_run` (`device`, None: the card, where the
    circuits and proofs run; `log` as there)."""
    device = resolve_device(device)
    # bootloader bytecode word-count must be odd (Era convention; the
    # versioned hash encodes it) — pad with a zero word
    code_words = list(code)
    if len(code_words) % 2 == 0:
        code_words.append(0)

    # ---------------- type 1: the VM ----------------
    v = vm2.EraVM(
        code_words,
        config.vm_limit,
        storage=storage,
        code_store=code_store,
        calldata=calldata,
        bootloader_heap=bootloader_heap,
        default_aa_code_hash=default_aa_code_hash,
    )
    for idx, val in (registers or {}).items():
        ptr = False
        if isinstance(val, tuple):
            val, ptr = val
        v.registers[idx - 1] = [val, ptr]
    w = v.run()
    return execute_block2_from_run(
        v, w, code_words, config, storage=storage, code_store=code_store,
        bootloader_heap=bootloader_heap, default_aa_code_hash=default_aa_code_hash,
        previous_block_content_hash=previous_block_content_hash, blobs=blobs, device=device,
        log=log)


def _qs_enc(head_width: int, tail: torch.Tensor, length) -> torch.Tensor:
    return proto.encode_queue_state_generic(gf.zeros((head_width,), tail.device), tail,
                                            int(length))


def _u32s(values, device) -> torch.Tensor:
    return torch.tensor([int(x) for x in values], dtype=torch.int64, device=device)


def _boot_states(v, bootloader_heap) -> tuple:
    """The VM's initial memory and decommit queue states recomputed from the
    driver's own pushes (the heap-init writes at timestamp 0, the
    bootloader's decommit), NOT from the VM witness: (memory state (12,) u64,
    its length, decommit state (12,) u64, its length)."""
    st12 = np.zeros(12, np.uint64)
    hp = sp.BOOTLOADER_BASE_PAGE + 2
    for i, val in sorted((bootloader_heap or {}).items()):
        e = encode_memory_queries_np(
            np.array([0], np.uint32), np.array([hp], np.uint32),
            np.array([i], np.uint32), np.array([True], bool), np.array([False], bool),
            np.array([[(val >> (32 * k)) & 0xFFFFFFFF for k in range(8)]], np.uint32),
        )[0]
        st12 = st12.copy()
        st12[:8] = e
        st12 = native.poseidon2_permute(st12)
    mem0 = st12
    st12 = np.zeros(12, np.uint64)
    st12[:8] = np.array(encode_decommit_query_ref(dict(
        code_hash=v.boot_code_hash, page=sp.BOOTLOADER_CODE_PAGE, is_first=True, timestamp=1,
    )), np.uint64)[:8]
    return mem0, len(bootloader_heap or {}), native.poseidon2_permute(st12), 1


def derive_inputs(v, w, out: dict, storage, bootloader_heap, default_aa_code_hash: int,
                  forms: dict) -> tuple:
    """The scheduler's input derivation (ref scheduler/mod.rs:239-568;
    block2.py:493-687): the scheduler's OWN assembly of every circuit's
    observable input from its predecessors' outputs, which `run_scheduler`
    commits and holds equal to each instance's observable-input commitment.

    `v`, `w` the VM run; `out` the circuits' results (name -> (witness,
    residuals, forms)) of `block.log_path` and `block.memory_thread`;
    `storage` the block's initial storage; `forms` the compact forms by
    type.  Returns (derived: type -> encoding, required types)."""
    dw = out["main_vm"][0]
    dev = dw["ts"].device
    mem0, mem0_len, dec0, dec0_len = _boot_states(v, bootloader_heap)
    out_states = dm.output_queue_states(out["demux_log_queue"][0])
    derived: Dict[int, torch.Tensor] = {}

    aa = [(default_aa_code_hash >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    derived[1] = torch.cat([
        _u32s([0] + aa, dev),  # zkporter off
        gf.from_u64(np.asarray(v.block_rollback_tail, np.uint64), dev),
        gf.from_u64(mem0, dev), _u32s([mem0_len], dev),
        gf.from_u64(dec0, dev), _u32s([dec0_len], dev),
    ])

    cw = out["sort_decommittments"][0]
    total_cw = cw.execute.shape[0]
    # type 2: unsorted side = the VM's committed decommit-queue output
    derived[2] = torch.cat([
        _qs_enc(12, dw["dec_q_state"][-1], dw["dec_q_len"][-1]),
        _qs_enc(12, cw.chain_sorted[total_cw], cw.n),
    ])
    # type 3: requests = sorter-2's deduplicated RESULT queue; memory =
    # threaded from the VM's committed final memory state
    thread = gf.from_u64(np.asarray(w["mem_q_state"][-1], np.uint64), dev)
    derived[3] = torch.cat([
        _qs_enc(12, cw.result_chain[total_cw + 1], cw.result_count[total_cw]),
        _qs_enc(12, thread, 0),
    ])
    # type 4: the VM's committed final log queue
    derived[4] = _qs_enc(4, dw["log_fwd_tail"][-1], dw["log_fwd_len"][-1])
    # types 5 / 6 / 7: the demuxed call queue, memory threaded from the
    # previous circuit's last state
    thread = out["code_unpacker"][0].mem_chain[-1]
    for ctype, name, qname in ((5, "keccak256", "keccak"), (6, "sha256", "sha256"),
                               (7, "ecrecover", "ecrecover")):
        if name in out:
            derived[ctype] = torch.cat([
                _qs_enc(4, out_states[qname].tail, out_states[qname].length),
                _qs_enc(12, thread, 0),
            ])
            thread = out[name][0].mem_chain[-1]
    # type 8: unsorted = the threaded global queue's final state
    rw = out["ram_permutation"][0]
    derived[8] = torch.cat([
        _qs_enc(12, thread, rw.n),
        _qs_enc(12, rw.chain_sorted[rw.n], rw.n),
        _u32s([len(v.initial_mem_rows)], dev),
    ])
    if "storage_validity" in out:
        svw = out["storage_validity"][0]
        total_sv = svw.execute.shape[0]
        derived[9] = torch.cat([
            _u32s([0], dev),
            _qs_enc(4, out_states["rollup_storage"].tail, out_states["rollup_storage"].length),
            _qs_enc(4, svw.chain_sorted[total_sv], svw.n),
        ])
        # independently rebuilt initial root/counter (the PRIOR state the
        # scheduler itself trusts), not the circuit's claim
        tree, counter = block.storage_tree(storage or {})
        derived[10] = torch.cat([
            _u32s([0], dev),
            _u32s(np.frombuffer(tree.root(), "<u4"), dev),
            _u32s([counter & 0xFFFFFFFF, counter >> 32], dev),
            _qs_enc(4, svw.result_chain[total_sv + 1], svw.result_count[total_sv]),
        ])
    for ctype, qname in ((11, "events"), (12, "l1_messages")):
        if f"log_sorter_{ctype}" not in out:
            continue
        sw = out[f"log_sorter_{ctype}"][0]
        total_ls = sw.execute.shape[0]
        derived[ctype] = torch.cat([
            _qs_enc(4, out_states[qname].tail, out_states[qname].length),
            _qs_enc(4, sw.chain_sorted[total_ls], sw.n),
        ])
    if "log_sorter_12" in out and 13 in forms:
        sw = out["log_sorter_12"][0]
        total_ls = sw.execute.shape[0]
        derived[13] = _qs_enc(4, sw.result_chain[total_ls + 1], sw.result_count[total_ls])
    return derived, set(derived.keys())


def _timed(times, name, device, fn):
    """fn(); with `times`, its seconds (ended by a synchronize) under `name`."""
    if times is None:
        return fn()
    block._sync(device)
    t0 = time.perf_counter()
    result = fn()
    block._sync(device)
    times[name] = time.perf_counter() - t0
    return result


# the circuit names of `block.log_path` / `block.memory_thread` by type
_CIRCUITS = {2: "sort_decommittments", 3: "code_unpacker", 4: "demux_log_queue",
             5: "keccak256", 6: "sha256", 7: "ecrecover", 8: "ram_permutation",
             9: "storage_validity", 10: "storage_application", 11: "log_sorter_11",
             12: "log_sorter_12", 13: "linear_hasher"}


def execute_block2_from_run(
    v,
    w: dict,
    code_words: list,
    config: Block2Config = Block2Config(),
    *,
    storage=None,
    code_store=None,
    bootloader_heap=None,
    default_aa_code_hash: int = 0,
    previous_block_content_hash: bytes = b"\x00" * 32,
    blobs=None,
    device=None,
    times: Optional[dict] = None,
    log: Optional[list] = None,
) -> Block2Result:
    """The block after its VM run: `v` the EraVM (Python or native) after
    `run()` over `code_words` for `config.vm_limit` cycles with the same
    storage, code store and heap, `w` its witness dict.  `device` (None: the
    card) is where the circuits and proofs run.  With `times` (a dict) the
    seconds land there: each circuit's stages under their names, the proofs
    under "sorter stark <t> prove" / "verify", "commitments <t> prove" /
    "leaf", "node <t> prove" / "verify", and "input derivation",
    "scheduler"; `log` (a list) takes a record of every circuit STARK the
    verdict writers make."""
    device = resolve_device(device)
    residuals: Dict[str, dict] = {}
    forms: Dict[int, object] = {}
    handoffs: Dict[str, bool] = {}

    # ---------------- type 1 and the log path: 2, 4, 9, 11, 12, 13 --------
    inst = config.vm_instance_limit or config.vm_limit
    out, log_handoffs, l1_hash, _, _ = block.log_path(
        v, w, (inst, config.sorter_limit), device, times,
        demux_limit=config.sorter_limit, hasher_limit=config.hasher_limit, skip_empty=True)
    handoffs.update(log_handoffs)
    _, vm_res, forms[1] = out["main_vm"]
    residuals["main_vm"] = {k: x for k, x in vm_res.items() if not k.startswith("protocol_")}
    residuals["main_vm_protocol"] = {k[len("protocol_"):]: x for k, x in vm_res.items()
                                     if k.startswith("protocol_")}

    # optional committed-trace STARK for the VM core relation set: the
    # type-1 verdict the scheduler consumes becomes the VERIFIER's
    stark_verdicts: Dict[int, bool] = {}
    if config.prove_vm:
        _, handoffs["vm_code_reads_on_tape"] = block.vm_verdict(
            v, w, config.vm_limit, device, stark_verdicts, log=log)

    # ---------------- the memory thread: 3, 5, 6, 7, 8 ----------------
    store = dict(code_store or {})
    store[v.boot_code_hash] = list(code_words)
    capacities = (config.unpacker_rounds, config.keccak_blocks, config.keccak_reads,
                  config.sha_rounds)
    limits = (config.unpacker_rounds, config.keccak_blocks, config.sorter_limit,
              config.ram_limit)
    mem_out, mem_handoffs, _ = block.memory_thread(
        v, w, store, limits, device, times, done=out, capacities=capacities,
        ec_calls=config.ec_calls)
    out.update(mem_out)
    handoffs.update(mem_handoffs)

    # ---------------- type 10: storage application ----------------
    if "storage_validity" in out:
        aw, ares, aform, _ = block.storage_application(
            out["storage_validity"][0], storage or {}, device, times, config.storage_rows)
        out["storage_application"] = (aw, ares, aform)

    for t, name in _CIRCUITS.items():
        if name in out:
            residuals[name] = out[name][1]
            forms[t] = out[name][2]
    witnesses = {name: x[0] for name, x in out.items()}

    # ---------------- eip_4844 blob circuits (scheduler 4844 hooks) --------
    # the reference scheduler binds up to 2 blob proofs into the aux output
    # (BlockAuxilaryOutput.eip4844_*_hashes, ref block_header + mod.rs hooks)
    blob_linear_hashes = [b"\x00" * 32, b"\x00" * 32]
    blob_output_hashes = [b"\x00" * 32, b"\x00" * 32]
    blob_forms, blob_ws = [], []
    if blobs:
        assert len(blobs) <= 2
        for bi, (chunks, vh) in enumerate(blobs):
            bcfg = e44.EIP4844Config(elements=max(len(chunks), 1))
            bw = block.stage(times, f"eip_4844_{bi} witness",
                             lambda: e44.generate_witness(chunks, vh, bcfg, device=device))
            blob_ws.append((bw, chunks, vh, bcfg.elements))
            residuals[f"eip_4844_{bi}"] = block.stage(
                times, f"eip_4844_{bi} eval", lambda: e44.eval_constraints(bw, bcfg))
            blob_forms.append(block.stage(times, f"eip_4844_{bi} compact",
                                          lambda: e44.instance_compact_form(bw, bcfg)))
            blob_linear_hashes[bi] = bytes(bw.linear_hash.cpu().tolist())
            blob_output_hashes[bi] = bytes(bw.output_hash.cpu().tolist())

    # ------- scheduler input-derivation (ref scheduler/mod.rs:239-568) -----
    derived, required = _timed(times, "input derivation", device, lambda: derive_inputs(
        v, w, out, storage, bootloader_heap, default_aa_code_hash, forms))

    # -------- real STARK proofs for the grand-product arguments ----------
    # one coset-quotient STARK per sorter family (types 2/8/9/11/12): the
    # proven public values are the final grand products the circuit's
    # completion check compares (ref utils.rs:81-137), and the verdict that
    # reaches the scheduler below is the VERIFIER's, not a witness claim
    gp_witnesses = {t: out[_CIRCUITS[t]][0] for t in (2, 8, 9, 11, 12) if _CIRCUITS[t] in out}
    relation_proofs = {}  # {type: (witness, SorterFullProof)} for the leaves
    if config.prove_sorter_starks:
        for t in sorted(gp_witnesses):
            if config.prove_full_sorter_chains:
                spent = {} if times is not None else None
                ok, full = pipeline.prove_sorter_full(gp_witnesses[t], times=spent)
                if spent is not None:
                    times[f"sorter stark {t} prove"] = spent["prove"]
                    times[f"sorter stark {t} verify"] = spent["verify"]
                # carried into the recursion leaves: the leaf verdict then
                # covers the circuit RELATION, not only the commitment sponge
                relation_proofs[t] = (gp_witnesses[t], full)
            else:
                ok = _timed(times, f"sorter stark {t} prove", device,
                            lambda: pipeline.prove_sorter_argument(gp_witnesses[t])[0])
            stark_verdicts[t] = ok

    # ------ the circuit STARKs of types 3, 5, 6, 13, 255, 4, 10, 7 -------
    if config.prove_hash_chains:
        if 5 in forms:
            block.keccak_verdict(out["keccak256"][0], v.precompile_calls["keccak"],
                                 v.precompile_memory, device, stark_verdicts, log=log)
        if 6 in forms:
            block.sha256_verdict(out["sha256"][0], device, stark_verdicts, log=log)
        if 3 in forms:
            block.code_unpacker_verdict(out["code_unpacker"][0], device, stark_verdicts, log=log)
        if 13 in forms and l1_hash is not None:
            block.l1_verdict(out["linear_hasher"][0], l1_hash, device, stark_verdicts, log=log)
        # eip_4844 blobs (type 255): the three keccak chains — blob linear
        # hash, the z-challenge digest, and the output commitment — and the
        # Horner evaluation (ref eip_4844/mod.rs:157-242)
        if blob_ws:
            block.blob_verdict(blob_ws, device, stark_verdicts, log=log)
    if config.prove_routing:
        block.demux_verdict(block.block_rows(v)["logs"], device, stark_verdicts, log=log)
    if config.prove_storage_paths and 10 in forms:
        block.storage_paths_verdict(out["storage_application"][0], device, stark_verdicts,
                                    log=log)
    if config.prove_ecrecover and 7 in forms:
        block.ecrecover_verdict(out["ecrecover"][0], device, stark_verdicts, log=log)

    # ------------- leaf-layer verification + scheduler node slots --------
    # Every type's slot is built THROUGH the leaf path: instance commitment
    # STARKs (+ the sorter relation proof attached to instance 0) are
    # verified by the real leaf layer, optionally the node's FRI
    # verification is proven in-field, and the scheduler consumes the
    # resulting VerifiedNodeProof (`recursion_proofs.scheduler_node_proof`,
    # here in its two steps, so that the carried proofs stay with the result)
    lp = leaf_params()
    commitment_verdicts: Dict[int, bool] = {}
    node_proofs: Dict[int, rp.VerifiedNodeProof] = {}
    carried: Dict[int, List[rp.CarriedProof]] = {}
    if config.prove_commitments:
        for t in sorted(forms):
            carried[t] = _timed(times, f"commitments {t} prove", device,
                                lambda: rp.make_carried_proofs(forms[t],
                                                               relation=relation_proofs.get(t)))
            spent = {} if times is not None else None
            node_proofs[t], commitment_verdicts[t] = rp.node_slot_proof(
                t, forms[t], carried[t], lp[t], NODE_VK, extra_ok=stark_verdicts.get(t, True),
                in_field=t in config.node_in_field_types, times=spent)
            if spent is not None:
                times[f"commitments {t} leaf"] = spent["leaf"]
                for k in ("node prove", "node verify"):
                    if k in spent:
                        times[f"node {t} {k.split()[1]}"] = spent[k]

    # ---------------- the scheduler ----------------
    sched = sched_inputs = None
    if config.run_scheduler:
        def run():
            proofs = {}
            for t, cf in forms.items():
                if t in node_proofs:
                    proofs[t] = node_proofs[t]
                    continue
                # proofs disabled by config: expose the same commitment shape
                # with the available verdicts (True-defaulting, as the JAX runtime)
                proofs[t] = rp.VerifiedNodeProof(
                    scheduler.node_input_commitment(t, lp[t], NODE_VK,
                                                    scheduler.recursion_queue_state(t, cf)),
                    stark_verdicts.get(t, True),
                    vk_commitment=gf.from_u64(np.array(NODE_VK, dtype=np.uint64), device),
                )
            inputs = dict(
                compact_forms_by_type=forms,
                node_proofs_by_type=proofs,
                leaf_params_by_type=lp,
                node_vk_commitment=NODE_VK,
                derived_observable_inputs=derived,
                required_types=required,
                previous_block_content_hash=previous_block_content_hash,
                block_data=scheduler.BlockPassthroughData(),
                block_meta=scheduler.BlockMetaParameters(
                    bootloader_code_hash=v.boot_code_hash,
                    default_aa_code_hash=default_aa_code_hash,
                ),
                aux_output=scheduler.BlockAuxilaryOutput(
                    l1_messages_linear_hash=l1_hash or b"\x00" * 32,
                    eip4844_linear_hashes=tuple(blob_linear_hashes),
                    eip4844_output_commitment_hashes=tuple(blob_output_hashes),
                ),
            )
            return scheduler.run_scheduler(**inputs, device=device), inputs

        sched, sched_inputs = _timed(times, "scheduler", device, run)

    return Block2Result(
        residuals=residuals,
        compact_forms=forms,
        handoffs=handoffs,
        scheduler_result=sched,
        l1_messages_hash=l1_hash,
        vm=v,
        blob_compact_forms=blob_forms,
        stark_verdicts=stark_verdicts,
        commitment_verdicts=commitment_verdicts,
        scheduler_inputs=sched_inputs,
        carried=carried,
        witnesses=witnesses,
    )
