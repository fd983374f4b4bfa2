"""Conversions at the port's edges: u64 numpy <-> field tensors (`from_u64`,
`to_u64`, the field layer's own), a witness built from plain numpy fields,
and a proof as nested python ints.

`witness_from_numpy` takes the fields of a ram_permutation witness as
numpy arrays (field elements as u64) so that a witness made elsewhere (for
instance by the JAX package) can be fed to the port's prover;
`vm_witness_from_numpy` does the same for a main_vm witness dict;
`proof_to_ints` turns a `StarkProof` (any number of column trees) into
nested lists of ints and `proof_from_ints` turns such nested ints back into
a `StarkProof` on a device, so that a proof made elsewhere (the JAX
package's, as the tests write it out) goes to the port's verifiers;
`residuals_to_numpy` turns a residual dict into numpy arrays, so that both
compare with `==`.

The log and decommit circuits' witnesses (`decommit_sorter_witness_from_numpy`,
`demux_witness_from_numpy`, `storage_validity_witness_from_numpy`,
`log_sorter_witness_from_numpy`, `linear_hasher_witness_from_numpy`), the
memory-thread and storage-tree circuits' (`code_unpacker_witness_from_numpy`,
`keccak_round_witness_from_numpy`, `sha256_round_witness_from_numpy`,
`ecrecover_witness_from_numpy`, `storage_application_witness_from_numpy`,
`eip_4844_witness_from_numpy`) and a batch of compact forms
(`compact_forms_from_numpy`, the VM's included) are built the same way from a
dict of numpy arrays with the JAX witness's field names: field elements as
u64, u32 values as any integer dtype, flags as bool, a batch of queries as a
dict of its columns, the dict-valued fields as dicts, the counts as ints.
`witness_to_numpy` is the inverse, field elements as u64 and the rest as
int64 / bool, so that two witnesses compare by value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base_structures.decommit_query import DecommitQueries
from ..base_structures.log_query import LogQueries
from ..base_structures.memory_query import MemoryQueries
from ..models import demux_log_queue, linear_hasher, log_sorter, sort_decommittment_requests
from ..models import storage_validity
from ..models import (code_unpacker_sha256, ecrecover, eip_4844, keccak256_round_function,
                      sha256_round_function, storage_application)
from ..models.ram_permutation import RamPermutationWitness
from ..models.vm.circuit import prepare_device_witness as vm_witness_from_numpy  # noqa: F401
from ..ops import fri, gf
from ..ops.gf import from_u64, to_u64  # noqa: F401  u64 numpy <-> field tensors
from ..prover.stark import StarkProof
from .device import resolve_device
from .protocol import ClosedFormInputCompactForm


def witness_from_numpy(fields: dict, device=None) -> RamPermutationWitness:
    """fields: n, snapshot_length (ints); execute (N,) bool; unsorted and
    sorted as dicts of {timestamp, memory_page, index, rw_flag, is_ptr,
    value}; enc_unsorted, enc_sorted, chain_unsorted, chain_sorted,
    challenges, lhs, rhs (u64 arrays); nondet_count (N,) ints.  `device` None
    is the card (`utils.device.default_device`)."""
    device = resolve_device(device)

    def field(name):
        return gf.from_u64(np.asarray(fields[name], np.uint64), device)

    return RamPermutationWitness(
        n=int(fields["n"]),
        execute=torch.from_numpy(np.array(fields["execute"], bool)).to(device),
        unsorted=MemoryQueries.from_numpy(fields["unsorted"], device),
        sorted=MemoryQueries.from_numpy(fields["sorted"], device),
        enc_unsorted=field("enc_unsorted"),
        enc_sorted=field("enc_sorted"),
        chain_unsorted=field("chain_unsorted"),
        chain_sorted=field("chain_sorted"),
        challenges=field("challenges"),
        lhs=field("lhs"),
        rhs=field("rhs"),
        nondet_count=torch.from_numpy(np.array(fields["nondet_count"], np.int64)).to(device),
        snapshot_length=int(fields["snapshot_length"]),
    )


def _tensor(value, device, field: bool) -> torch.Tensor:
    arr = np.asarray(value)
    if field:
        return gf.from_u64(arr.astype(np.uint64), device)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(device)
    return torch.from_numpy(arr.astype(np.int64)).to(device)


_COUNTS = ("n", "num_calls", "num_requests", "num_queries")
_QUERY_TYPES = (LogQueries, DecommitQueries, MemoryQueries)


def _from_numpy(cls, fields: dict, device, field_names=(), query_names=(), queries=LogQueries):
    """A witness dataclass from numpy fields: the counts (`n`, `num_calls`,
    ...) ints, the `query_names` batches of `queries` from their column dicts
    (`query_names` a dict of name -> query class where they differ), the
    `field_names` (or the dict fields they name) field elements, the rest u32
    or bool tensors."""
    device = resolve_device(device)
    if not isinstance(query_names, dict):
        query_names = {name: queries for name in query_names}
    out = {}
    for f in dataclasses.fields(cls):
        v, is_field = fields[f.name], f.name in field_names
        if f.name in _COUNTS:
            out[f.name] = int(v)
        elif f.name in query_names:
            out[f.name] = query_names[f.name].from_numpy(v, device)
        elif isinstance(v, dict):
            out[f.name] = {k: _tensor(x, device, is_field) for k, x in v.items()}
        else:
            out[f.name] = _tensor(v, device, is_field)
    return cls(**out)


_CHAINS = ("chain_unsorted", "chain_sorted", "challenges", "lhs", "rhs", "result_chain")


def decommit_sorter_witness_from_numpy(fields: dict, device=None):
    """fields of a `sort_decommittment_requests.DecommitSorterWitness`;
    `device` None is the card."""
    return _from_numpy(sort_decommittment_requests.DecommitSorterWitness, fields, device,
                       _CHAINS + ("enc_unsorted", "enc_sorted"),
                       ("unsorted", "sorted", "result_items"), DecommitQueries)


def demux_witness_from_numpy(fields: dict, device=None):
    """fields of a `demux_log_queue.DemuxWitness` (out_flags, out_chains and
    out_counts as dicts by queue name); `device` None is the card."""
    return _from_numpy(demux_log_queue.DemuxWitness, fields, device,
                       ("encodings", "input_chain", "out_chains"), ("queries",))


def storage_validity_witness_from_numpy(fields: dict, device=None):
    """fields of a `storage_validity.StorageValidityWitness` (cell_states as a
    dict of its columns); `device` None is the card."""
    return _from_numpy(storage_validity.StorageValidityWitness, fields, device,
                       _CHAINS + ("enc_unsorted_ext", "enc_sorted_ext"),
                       ("unsorted", "sorted", "push_items"))


def log_sorter_witness_from_numpy(fields: dict, device=None):
    """fields of a `log_sorter.LogSorterWitness`; `device` None is the card."""
    return _from_numpy(log_sorter.LogSorterWitness, fields, device,
                       _CHAINS + ("enc_unsorted", "enc_sorted"),
                       ("unsorted", "sorted", "result_items"))


def linear_hasher_witness_from_numpy(fields: dict, device=None):
    """fields of a `linear_hasher.LinearHasherWitness` (keccak lanes as u32
    halves); `device` None is the card."""
    return _from_numpy(linear_hasher.LinearHasherWitness, fields, device,
                       ("encodings", "input_chain"), ("queries",))


def sha256_round_witness_from_numpy(fields: dict, device=None):
    """fields of a `sha256_round_function.Sha256RoundWitness`; `device` None
    is the card."""
    return _from_numpy(sha256_round_function.Sha256RoundWitness, fields, device,
                       ("call_chain", "mem_chain", "mem_order_encodings"),
                       dict(calls=LogQueries, reads=MemoryQueries, writes=MemoryQueries))


def code_unpacker_witness_from_numpy(fields: dict, device=None):
    """fields of a `code_unpacker_sha256.CodeUnpackerWitness`; `device` None
    is the card."""
    return _from_numpy(code_unpacker_sha256.CodeUnpackerWitness, fields, device,
                       ("request_chain", "mem_chain"),
                       dict(requests=DecommitQueries, writes=MemoryQueries))


def keccak_round_witness_from_numpy(fields: dict, device=None):
    """fields of a `keccak256_round_function.KeccakRoundWitness` (keccak lanes
    as u32 halves); `device` None is the card."""
    return _from_numpy(keccak256_round_function.KeccakRoundWitness, fields, device,
                       ("call_chain", "mem_chain", "mem_order_encodings"),
                       dict(calls=LogQueries, reads=MemoryQueries, writes=MemoryQueries))


def ecrecover_witness_from_numpy(fields: dict, device=None):
    """fields of an `ecrecover.EcrecoverWitness` (scalars, points and steps
    as dicts of limb and flag columns); `device` None is the card."""
    return _from_numpy(ecrecover.EcrecoverWitness, fields, device, ("call_chain", "mem_chain"),
                       dict(calls=LogQueries, reads=MemoryQueries, writes=MemoryQueries))


def storage_application_witness_from_numpy(fields: dict, device=None):
    """fields of a `storage_application.StorageApplicationWitness`; `device`
    None is the card."""
    return _from_numpy(storage_application.StorageApplicationWitness, fields, device,
                       ("query_chain",), ("queries",))


def eip_4844_witness_from_numpy(fields: dict, device=None):
    """fields of an `eip_4844.EIP4844Witness`; `device` None is the card."""
    return _from_numpy(eip_4844.EIP4844Witness, fields, device)


def compact_forms_from_numpy(fields: dict, device=None) -> ClosedFormInputCompactForm:
    """A batch of ClosedFormInput compact forms from its six fields (the flags
    bool, the commitments u64); `device` None is the card."""
    return _from_numpy(ClosedFormInputCompactForm, fields, device, (
        "observable_input_commitment", "observable_output_commitment",
        "hidden_fsm_input_commitment", "hidden_fsm_output_commitment"))


def witness_to_numpy(witness, field_names) -> dict:
    """A port witness (or compact form) as numpy: the `field_names` (and the
    dict fields they name) as u64, other tensors as int64 or bool, query
    batches as dicts of columns, `n` as an int."""

    def arr(t, field):
        return gf.to_u64(t) if field else t.detach().cpu().numpy()

    out = {}
    for f in dataclasses.fields(witness):
        v, is_field = getattr(witness, f.name), f.name in field_names
        if isinstance(v, _QUERY_TYPES):
            out[f.name] = {q.name: arr(getattr(v, q.name), False) for q in dataclasses.fields(v)}
        elif isinstance(v, dict):
            out[f.name] = {k: arr(x, is_field) for k, x in v.items()}
        elif isinstance(v, torch.Tensor):
            out[f.name] = arr(v, is_field)
        else:
            out[f.name] = v
    return out


def residuals_to_numpy(residuals: dict) -> dict:
    """A residual dict of bool tensors as a dict of numpy bool arrays."""
    return {k: v.detach().cpu().numpy() for k, v in residuals.items()}


def _ints(a) -> list:
    if isinstance(a, torch.Tensor):
        a = gf.to_u64(a)
    return np.asarray(a, np.uint64).tolist()


def proof_to_ints(proof: StarkProof) -> dict:
    """A StarkProof as nested python ints and lists."""
    f = proof.fri_proof
    return dict(
        caps=[_ints(c) for c in proof.caps],
        q_cap=_ints(proof.q_cap),
        ood=dict(
            trace_z=_ints(proof.ood["trace_z"]),
            trace_wz=_ints(proof.ood["trace_wz"]),
            q_z=int(proof.ood["q_z"]),
        ),
        fri=dict(
            caps=[_ints(c) for c in f.caps],
            final_poly=_ints(f.final_poly),
            query_indices=[int(i) for i in f.query_indices],
            openings=[
                [dict(pair=_ints(op["pair"]), path=_ints(op["path"])) for op in per_query]
                for per_query in f.openings
            ],
        ),
        trace_openings=[
            {
                tag: dict(
                    rows=[_ints(r) for r in op["rows"]],
                    paths=[_ints(p) for p in op["paths"]],
                    q_row=_ints(op["q_row"]),
                    q_path=_ints(op["q_path"]),
                    index=int(op["index"]),
                )
                for tag, op in entry.items()
            }
            for entry in proof.trace_openings
        ],
    )


def proof_from_ints(d: dict, device=None) -> StarkProof:
    """The inverse of `proof_to_ints`: caps become field tensors on `device`
    (None: the card), everything else numpy u64 and python ints, as `prove`
    makes them."""
    device = resolve_device(device)
    openings = [
        {
            tag: dict(
                rows=[_u64(r) for r in op["rows"]],
                paths=[_u64(p, (4,)) for p in op["paths"]],
                q_row=_u64(op["q_row"]),
                q_path=_u64(op["q_path"], (4,)),
                index=int(op["index"]),
            )
            for tag, op in entry.items()
        }
        for entry in d["trace_openings"]
    ]
    return StarkProof(
        caps=[_cap(c, device) for c in d["caps"]],
        q_cap=_cap(d["q_cap"], device),
        ood=dict(trace_z=_u64(d["ood"]["trace_z"]), trace_wz=_u64(d["ood"]["trace_wz"]),
                 q_z=int(d["ood"]["q_z"])),
        fri_proof=fri_proof_from_ints(d["fri"], device),
        trace_openings=openings,
    )


def _u64(a, shape_tail=None) -> np.ndarray:
    arr = np.asarray(a, np.uint64)
    return arr.reshape((-1,) + shape_tail) if shape_tail else arr


def _cap(c, device) -> torch.Tensor:
    return gf.from_u64(_u64(c, (4,)), device)


def fri_proof_from_ints(f: dict, device=None) -> fri.FriProof:
    """A FriProof from nested ints (the "fri" part of `proof_to_ints`, or
    a JAX FriProof pulled to numpy): caps as field tensors on `device`
    (None: the card), pairs and paths numpy u64."""
    device = resolve_device(device)
    return fri.FriProof(
        caps=[_cap(c, device) for c in f["caps"]],
        final_poly=_u64(f["final_poly"]),
        query_indices=[int(i) for i in f["query_indices"]],
        openings=[[dict(pair=_u64(op["pair"]), path=_u64(op["path"], (4,))) for op in per_query]
                  for per_query in f["openings"]],
    )
