"""Circuit -> STARK pipeline: the ram_permutation grand-product argument.

The NUM_REPETITIONS = 2 challenge-compressed factor streams over the
unsorted and sorted memory-query encodings, their running products, product
equality at the end and the final products as PUBLIC values, proven by the
STARK in `prover/stark.py` (the JAX package's `prover/pipeline.py`).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import gf
from ..utils import challenges as chal
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
