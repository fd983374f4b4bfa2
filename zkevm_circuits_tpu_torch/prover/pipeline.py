"""Circuit -> STARK pipeline (the JAX package's `prover/pipeline.py`).

The grand-product argument: the NUM_REPETITIONS = 2 challenge-compressed
factor streams over the unsorted and sorted element encodings, their running
products, product equality at the end and the final products as PUBLIC
values, proven by the STARK in `prover/stark.py`.

The fully proof-backed sorter argument (`prove_sorter_full`): the grand
product plus Poseidon2 sponge-chain STARKs (`prover/poseidon2_air.py`) of
both queue tails, whose proven tails the verifier re-derives the
Fiat-Shamir challenges from.  The ClosedFormInput commitment proofs
(`prove_compact_commitment`): the padded commitment sponge proven as a
full-state chain, the per-instance public input the recursion leaves check.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import recursion
from ..ops import gf, poseidon2, queues
from ..utils import challenges as chal
from ..utils.device import resolve_device
from . import poseidon2_air as pa
from .stark import AirSpec, StarkParams, StarkProof, prove, verify

NUM_REPS = chal.DEFAULT_NUM_REPETITIONS  # 2


@functools.lru_cache(maxsize=1)
def permutation_air() -> AirSpec:
    """AIR of the two-repetition permutation argument.

    Columns: [f_u0, f_u1, f_s0, f_s1, lhs0, lhs1, rhs0, rhs1]: the masked
    factors of row i and the running products including row i.
    Transitions (degree 2): acc[i+1] = acc[i] * f[i+1].
    First row: acc[0] = f[0].  Last row: lhs == rhs and lhs == public.
    """

    def constraints(cur, nxt, ch):
        vals = []
        for r in range(NUM_REPS):
            vals.append(gf.sub(nxt[..., 4 + r], gf.mul(cur[..., 4 + r], nxt[..., r])))
            vals.append(gf.sub(nxt[..., 6 + r], gf.mul(cur[..., 6 + r], nxt[..., 2 + r])))
        return vals

    def first_row(row, public, ch):
        vals = []
        for r in range(NUM_REPS):
            vals.append(gf.sub(row[..., 4 + r], row[..., r]))
            vals.append(gf.sub(row[..., 6 + r], row[..., 2 + r]))
        return vals

    def last_row(row, public, ch):
        vals = []
        for r in range(NUM_REPS):
            vals.append(gf.sub(row[..., 4 + r], row[..., 6 + r]))
            vals.append(gf.sub(row[..., 4 + r], public[r]))
        return vals

    return AirSpec(
        num_cols=4 * NUM_REPS,
        max_degree=2,
        constraints=constraints,
        first_row=first_row,
        last_row=last_row,
        num_public=NUM_REPS,
    )


def sorter_encodings(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(enc_unsorted, enc_sorted) of a sorter witness: plain names, or the
    timestamp-extended `*_ext` names of storage_validity."""
    enc_u = getattr(w, "enc_unsorted", None)
    if enc_u is None:
        enc_u = w.enc_unsorted_ext
    enc_s = getattr(w, "enc_sorted", None)
    if enc_s is None:
        enc_s = w.enc_sorted_ext
    return enc_u, enc_s


def grand_product_trace(enc_unsorted: torch.Tensor, enc_sorted: torch.Tensor,
                        challenges: torch.Tensor, execute: torch.Tensor):
    """(8, m) trace and (2,) public final products.  Factors are re-derived
    from the committed encodings and challenges with padding rows masked to
    1; rows are padded with factor 1 to a power of two m."""
    f_u = chal.masked_factors(chal.grand_product_factors(enc_unsorted, challenges), execute)
    f_s = chal.masked_factors(chal.grand_product_factors(enc_sorted, challenges), execute)
    n = f_u.shape[0]
    m = 1 << max((n - 1).bit_length(), 1)
    if m != n:
        pad = gf.ones((m - n, NUM_REPS), f_u.device)
        f_u = torch.cat([f_u, pad])
        f_s = torch.cat([f_s, pad])
    ones = gf.ones((NUM_REPS,), f_u.device)
    lhs = chal.product_accumulate(f_u, ones)
    rhs = chal.product_accumulate(f_s, ones)
    trace = torch.cat([f_u, f_s, lhs, rhs], dim=1).T.contiguous()  # (8, m)
    return trace, lhs[m - 1]


def permutation_trace(w):
    enc_u, enc_s = sorter_encodings(w)
    return grand_product_trace(enc_u, enc_s, w.challenges, w.execute)


def prove_permutation_argument(
    w, params: Optional[StarkParams] = None
) -> Tuple[StarkProof, torch.Tensor, StarkParams]:
    trace, public = permutation_trace(w)
    if params is None:
        params = StarkParams(log_n=int(trace.shape[1]).bit_length() - 1)
    return prove(trace, permutation_air(), params, public), public, params


def verify_permutation_argument(proof: StarkProof, public: torch.Tensor,
                                params: StarkParams) -> bool:
    return verify(proof, permutation_air(), params, public)


def prove_sorter_argument(w, params: Optional[StarkParams] = None):
    """Prove and verify a sorter's grand-product argument end to end.

    Returns (verdict, proof, public, params); the verdict is the verifier's
    outcome AND the check that the proven final products equal the
    witness's committed final grand products."""
    proof, public, params = prove_permutation_argument(w, params)
    ok = verify_permutation_argument(proof, public, params)
    committed = gf.to_u64(w.lhs[-1])
    ok = bool(ok) and bool(np.array_equal(committed, gf.to_u64(public)))
    return ok, proof, public, params


# ---------------------------------------------------------------------------
# Fully proof-backed sorter argument: grand product + both queue-tail chains
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SorterFullProof:
    """One sorter family's permutation argument with no trusted
    recomputation of sponge work: `chain_u`/`chain_s` are the sponge-chain
    STARKs binding each queue tail to the plaintext element encodings, `gp`
    the grand-product STARK whose publics are the final products.  The
    verifier re-derives the challenges from the PROVEN tails."""

    gp_proof: StarkProof
    gp_public: torch.Tensor
    gp_params: StarkParams
    chain_u: Optional[Tuple[StarkProof, StarkParams]]
    chain_s: Optional[Tuple[StarkProof, StarkParams]]
    tail_u: np.ndarray  # (4,) or (12,) proven final tail/state, unsorted side
    tail_s: np.ndarray
    n_real: int


def _chain_absorbed_encodings(w) -> Tuple[np.ndarray, np.ndarray, pa.ChainSpec]:
    """Plaintext encodings each side's sponge chain absorbs, and the
    ChainSpec.  storage_validity's unsorted chain absorbs the RAW LogQuery
    encodings while its grand product runs over the timestamped extension,
    so the raw side is recomputed from the stored queries."""
    width = w.chain_unsorted.shape[-1]
    spec = pa.FULL if width == queues.FULL_STATE_WIDTH else pa.NARROW
    enc_u = getattr(w, "enc_unsorted", None)
    if enc_u is None:
        from ..base_structures.log_query import encode_log_queries

        enc_u = encode_log_queries(w.unsorted)
        enc_s = w.enc_sorted_ext
    else:
        enc_s = w.enc_sorted
    return gf.to_u64(enc_u), gf.to_u64(enc_s), spec


def _per_row_chains(w):
    """The witness's chains, which must hold every state: (N + 1, W) each."""
    total = int(w.execute.shape[0])
    for name in ("chain_unsorted", "chain_sorted"):
        if getattr(w, name).shape[0] != total + 1:
            raise ValueError(
                f"{name} holds {getattr(w, name).shape[0]} states, not one a row "
                f"({total + 1}): the full sorter proof needs a witness made without "
                "chain_stride")
    return w.chain_unsorted, w.chain_sorted


def _synced_clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def prove_sorter_full(w, gp_params: Optional[StarkParams] = None,
                      chain_params: Optional[StarkParams] = None,
                      times: Optional[dict] = None) -> Tuple[bool, SorterFullProof]:
    """Prove + verify a sorter's COMPLETE argument (chains and products), on
    the witness's device.  A full-state chain's trace takes its states from
    the witness's own per-row chain.  With `times`, the prove and verify
    seconds (each ended by a synchronize) land under "prove" and "verify"."""
    t0 = _synced_clock(w.execute.device)
    chain_u_states, chain_s_states = _per_row_chains(w)
    n_real = int(w.execute.sum())
    tail_u = gf.to_u64(chain_u_states[n_real])
    tail_s = gf.to_u64(chain_s_states[n_real])

    gp_proof, gp_public, gp_params = prove_permutation_argument(w, gp_params)

    chain_u = chain_s = None
    if n_real > 0:
        enc_u, enc_s, spec = _chain_absorbed_encodings(w)
        dev = w.execute.device
        init4 = np.zeros(4, dtype=np.uint64)
        full = spec is pa.FULL
        pu, _, pru = pa.prove_queue_chain(
            enc_u[:n_real], init4, spec, chain_params, dev,
            chain_u_states[: n_real + 1] if full else None)
        ps, _, prs = pa.prove_queue_chain(
            enc_s[:n_real], init4, spec, chain_params, dev,
            chain_s_states[: n_real + 1] if full else None)
        chain_u, chain_s = (pu, pru), (ps, prs)

    proof = SorterFullProof(gp_proof, gp_public, gp_params, chain_u, chain_s,
                            tail_u, tail_s, n_real)
    t1 = _synced_clock(w.execute.device)
    ok = verify_sorter_full(w, proof)
    if times is not None:
        times.update(prove=t1 - t0, verify=_synced_clock(w.execute.device) - t1)
    return ok, proof


def verify_sorter_full(w, full: SorterFullProof) -> bool:
    """The verifier side: chain proofs against plaintext encodings, FS
    challenge re-derivation from the PROVEN tails, factor recomputation,
    grand-product proof, and the final-product cross-check."""
    n_real = full.n_real
    width = w.chain_unsorted.shape[-1]
    dev = w.execute.device
    lhs_final = gf.to_u64(w.lhs[-1])

    if n_real == 0:
        # empty queues: tails must be the trivial state and products 1
        return bool((full.tail_u == 0).all() and (full.tail_s == 0).all()
                    and (lhs_final == 1).all() and (gf.to_u64(w.rhs[-1]) == 1).all())

    if full.chain_u is None or full.chain_s is None:
        return False
    enc_u, enc_s, spec = _chain_absorbed_encodings(w)
    init4 = np.zeros(4, dtype=np.uint64)
    for (proof, params), enc, tail in ((full.chain_u, enc_u, full.tail_u),
                                       (full.chain_s, enc_s, full.tail_s)):
        if not pa.verify_queue_chain(proof, enc[:n_real], init4, tail, spec, params):
            return False

    # Fiat-Shamir: the challenges derive from the PROVEN tails
    gp_enc_u, _ = sorter_encodings(w)
    num_ch = int(gp_enc_u.shape[-1]) + 1
    zeros = gf.zeros((width,), dev)
    fs = chal.produce_fs_challenges(
        queues.QueueState(zeros, gf.from_u64(full.tail_u, dev), n_real),
        queues.QueueState(zeros, gf.from_u64(full.tail_s, dev), n_real),
        num_ch, NUM_REPS)
    if not torch.equal(fs, w.challenges):
        return False

    # grand product over the re-derived factors, publics = final products
    if not verify(full.gp_proof, permutation_air(), full.gp_params, full.gp_public):
        return False
    return bool(np.array_equal(lhs_final, gf.to_u64(full.gp_public)))


# ---------------------------------------------------------------------------
# ClosedFormInput commitment proofs
# ---------------------------------------------------------------------------


def _commitment_chunks(encoding_u64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(chunks, init_capacity) reproducing `poseidon2.hash_padded` with
    length specialization: zero-pad to a rate multiple, replacement-absorb
    from the empty state whose LAST capacity lane carries the pre-padding
    length."""
    enc = np.asarray(encoding_u64, np.uint64).reshape(-1)
    n = enc.shape[0]
    if n == 0:
        raise ValueError("empty encodings are not committed through the sponge")
    padded = n + (-n) % poseidon2.RATE
    chunks = np.zeros((max(padded, poseidon2.RATE) // poseidon2.RATE, poseidon2.RATE),
                      np.uint64)
    chunks.reshape(-1)[:n] = enc
    init = np.array([0, 0, 0, n % gf.MODULUS], dtype=np.uint64)
    return chunks, init


def prove_compact_commitment(encoding_u64: np.ndarray,
                             params: Optional[StarkParams] = None, device=None):
    """STARK proof that `commitment = commit_encoding(encoding)`, on
    `device` (None: the card): the padded sponge is a full-state chain
    seeded from the length-specialized empty state.  Returns
    (proof, commitment (4,) u64, final_state (12,) u64, params); the
    commitment is the final state's first 4 lanes."""
    chunks, init = _commitment_chunks(encoding_u64)
    proof, publics, params = pa.prove_queue_chain(chunks, init, pa.FULL, params, device)
    final_state = gf.to_u64(publics)[4:16].copy()
    return proof, final_state[:4].copy(), final_state, params


def verify_compact_commitment(proof: StarkProof, encoding_u64: np.ndarray,
                              commitment_u64: np.ndarray,
                              final_state_u64: np.ndarray,
                              params: StarkParams) -> bool:
    """Verifier side: rebuild the padded chunks from the PLAINTEXT compact
    form, check the chain proof against them, and bind the claimed
    commitment to the proven final state's rate lanes."""
    chunks, init = _commitment_chunks(encoding_u64)
    final_state = np.asarray(final_state_u64, np.uint64)
    commitment = np.asarray(commitment_u64, np.uint64)
    # a scalar / length-1 claim would broadcast in the equality below
    if final_state.shape != (12,) or commitment.shape != (4,):
        return False
    if not np.array_equal(commitment, final_state[:4]):
        return False
    return bool(pa.verify_queue_chain(proof, chunks, init, final_state, pa.FULL, params))


def prove_instance_commitments(compact_forms) -> Tuple[bool, list]:
    """Prove EVERY instance's ClosedFormInput commitment for one circuit
    type (the leading axis of the batched compact forms), on their device.
    Returns (all_ok, proofs), proofs[k] = (proof, commitment, final_state,
    params)."""
    dev = compact_forms.start_flag.device
    enc = gf.to_u64(compact_forms.encode())
    want = gf.to_u64(compact_forms.commitment())
    if enc.ndim == 1:
        enc, want = enc[None], want[None]
    ok = True
    proofs = []
    for k in range(enc.shape[0]):
        proof, commitment, final_state, params = prove_compact_commitment(enc[k], device=dev)
        good = verify_compact_commitment(proof, enc[k], commitment, final_state, params)
        ok &= bool(good) and bool(np.array_equal(commitment, want[k]))
        proofs.append((proof, commitment, final_state, params))
    return ok, proofs


def stark_vk_commitment(air: AirSpec, params: StarkParams, device=None) -> torch.Tensor:
    """(4,) Poseidon2 commitment to the STARK verifier's parameters, on
    `device` (None: the card): a proof only counts under the key it was
    checked with."""
    ident = np.array(
        [air.num_cols, air.max_degree, air.num_public, params.log_n,
         params.log_blowup, params.num_queries, params.cap_log2,
         params.coset_shift % gf.MODULUS],
        dtype=np.uint64,
    )
    return poseidon2.hash_padded(gf.from_u64(ident, resolve_device(device)))[:4]


def as_recursion_proof(
    proof: StarkProof,
    air: AirSpec,
    params: StarkParams,
    public: torch.Tensor,
    public_input_commitment: torch.Tensor,
) -> recursion.ProofSurrogate:
    """Adapter into the aggregation tree: `is_valid` is the REAL verifier
    verdict, `vk_commitment` pins the verifying key."""
    ok = verify(proof, air, params, public)
    return recursion.ProofSurrogate(
        public_input=public_input_commitment,
        is_valid=bool(ok),
        vk_commitment=stark_vk_commitment(air, params, proof.q_cap.device),
    )
