"""FRI low-degree argument over Goldilocks with GF(p^2) challenges.

The JAX package's `ops/fri.py` on torch tensors.  The codeword lifts to
GF(p^2); each layer is Merkle-committed with leaf i = [a0, a1, b0, b1] (the
fold pair v(x), v(-x)), then folded by a transcript challenge beta:

    v'(x^2) = (v(x) + v(-x)) / 2  +  beta * (v(x) - v(-x)) / (2x)

with -x_i = x_{i + n/2} on the coset shift * <w>.  The transcript is a
Poseidon2 sponge whose 4-lane state stays on the device of the proof;
python ints are pulled only where host logic needs them (query positions,
rejection sampling).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from . import gf, gf2, merkle, ntt, poseidon2
from .gf import MODULUS
from .gf2 import GF2


@dataclasses.dataclass(frozen=True)
class FriParams:
    log_domain: int          # evaluation-domain size 2^log_domain
    log_blowup: int = 1      # degree bound = 2^(log_domain - log_blowup)
    num_queries: int = 20
    final_poly_log_len: int = 2
    cap_log2: int = 1
    coset_shift: int = gf.MULTIPLICATIVE_GENERATOR


@dataclasses.dataclass
class FriProof:
    caps: List[torch.Tensor]      # per-layer Merkle caps (2^cap, 4)
    final_poly: np.ndarray        # (2, final_len) u64 GF2 coefficients
    query_indices: List[int]
    # per query, per layer: dict(pair=(2, 2) u64, path=(depth, 4) u64)
    openings: List[List[dict]]


# ---------------------------------------------------------------------------
# transcript
# ---------------------------------------------------------------------------


class Transcript:
    """Fiat-Shamir sponge over Poseidon2 with a 4-lane state on `device`
    (None: the card, or an error without one)."""

    def __init__(self, device=None):
        self._state = gf.zeros((4,), resolve_device(device))

    def absorb(self, lanes: torch.Tensor):
        flat = lanes.reshape(-1).to(self._state.device)
        self._state = poseidon2.hash_padded(torch.cat([self._state, flat]), True)

    def _squeeze(self):
        self._state = poseidon2.hash_padded(self._state, False)

    def challenge_ext(self) -> GF2:
        self._squeeze()
        return GF2(self._state[0], self._state[1])

    def challenge_indices(self, bound: int, count: int) -> List[int]:
        """`count` indices in [0, bound), four per squeeze."""
        out: List[int] = []
        while len(out) < count:
            self._squeeze()
            lanes = gf.to_u64(self._state)
            out.extend(int(v) % bound for v in lanes[: count - len(out)])
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


_HALF = pow(2, MODULUS - 2, MODULUS)


def _fold(v: GF2, beta: GF2, log_n: int, shift: int) -> GF2:
    """One fold: (n,) GF2 codeword -> (n/2,)."""
    half = (1 << log_n) // 2
    dev = v.c0.device
    a = GF2(v.c0[:half], v.c1[:half])          # v(x)
    b = GF2(v.c0[half:], v.c1[half:])          # v(-x)
    w_inv = pow(ntt.root_of_unity(log_n), MODULUS - 2, MODULUS)
    s_inv = pow(shift, MODULUS - 2, MODULUS)
    # 1/(2x) for the first-half points x_i = shift * w^i
    half_x_inv = gf.mul_const(gf.geometric(w_inv, half, dev), s_inv * _HALF % MODULUS)
    even = GF2(gf.mul_const(gf.add(a.c0, b.c0), _HALF),
               gf.mul_const(gf.add(a.c1, b.c1), _HALF))
    diff = gf2.sub(a, b)
    odd = GF2(gf.mul(diff.c0, half_x_inv), gf.mul(diff.c1, half_x_inv))
    return gf2.add(even, gf2.mul(beta, odd))


def _layer_leaves(v: GF2) -> torch.Tensor:
    """leaf i = [a0, a1, b0, b1] of the fold pair -> (n/2, 4)."""
    half = v.c0.shape[-1] // 2
    return torch.stack([v.c0[:half], v.c1[:half], v.c0[half:], v.c1[half:]], dim=-1)


def _eval_poly_ext(coeffs: np.ndarray, x: int) -> tuple:
    """Horner evaluation of GF2 coefficients (2, L) at a base-field x."""
    c0 = c1 = 0
    for j in range(coeffs.shape[1] - 1, -1, -1):
        c0 = (c0 * x + int(coeffs[0, j])) % MODULUS
        c1 = (c1 * x + int(coeffs[1, j])) % MODULUS
    return c0, c1


def _coset_coeffs(evals, shift):
    """evaluations on shift * H -> the polynomial's own coefficients."""
    coeffs = ntt.intt_ref(evals)
    s_inv = pow(shift, MODULUS - 2, MODULUS)
    return [c * pow(s_inv, i, MODULUS) % MODULUS for i, c in enumerate(coeffs)]


def gather_rows(arr: torch.Tensor, idx) -> np.ndarray:
    """rows `idx` of an (n, ...) tensor as numpy u64 (one gather, one pull)."""
    index = torch.as_tensor(np.asarray(idx, np.int64), device=arr.device)
    return gf.to_u64(arr[index])


def gather_paths(levels, idx) -> np.ndarray:
    """Merkle sibling paths of leaves `idx`: (k, depth, 4) u64."""
    idx = np.asarray(idx, np.int64)
    depth = len(levels) - 1
    if depth == 0:
        return np.zeros((idx.shape[0], 0, 4), np.uint64)
    sibs = []
    cur = idx
    for d in range(depth):
        index = torch.as_tensor(cur ^ 1, device=levels[d].device)
        sibs.append(levels[d][index])
        cur = cur >> 1
    return gf.to_u64(torch.stack(sibs, dim=1))


def commit_layer(v: GF2, cap_log2: int) -> dict:
    levels = merkle.tree_levels(merkle.hash_leaves(_layer_leaves(v)), cap_log2)
    return dict(values=v, levels=levels, cap=levels[-1])


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def prove(codeword: torch.Tensor, params: FriParams,
          tr: Optional[Transcript] = None) -> FriProof:
    """codeword: (n,) base-field evaluations on the coset shift * H."""
    n = 1 << params.log_domain
    if tuple(codeword.shape) != (n,):
        raise ValueError(f"codeword must have shape ({n},), got {tuple(codeword.shape)}")
    v = gf2.from_base(codeword)
    shift = params.coset_shift
    log_n = params.log_domain
    if tr is None:
        tr = Transcript(codeword.device)

    layers = []
    while log_n > params.final_poly_log_len:
        layer = commit_layer(v, params.cap_log2)
        layers.append(layer)
        tr.absorb(layer["cap"])
        beta = tr.challenge_ext()
        v = _fold(v, beta, log_n, shift)
        shift = shift * shift % MODULUS
        log_n -= 1

    # final polynomial coefficients; an honest codeword leaves the high ones 0
    final_deg_len = 1 << max(params.final_poly_log_len - params.log_blowup, 0)
    c0 = _coset_coeffs([int(x) for x in gf.to_u64(v.c0)], shift)
    c1 = _coset_coeffs([int(x) for x in gf.to_u64(v.c1)], shift)
    if any(c0[final_deg_len:]) or any(c1[final_deg_len:]):
        raise ValueError("codeword not low degree")
    final = np.zeros((2, final_deg_len), dtype=np.uint64)
    final[0] = c0[:final_deg_len]
    final[1] = c1[:final_deg_len]
    tr.absorb(gf.from_u64(final.reshape(-1), codeword.device))

    indices = tr.challenge_indices(1 << (params.log_domain - 1), params.num_queries)

    Q = params.num_queries
    pos = np.asarray(indices, np.int64)
    per_layer = []
    for li, layer in enumerate(layers):
        nl = 1 << (params.log_domain - li)
        i = pos % (nl // 2)
        vl = layer["values"]
        rows = torch.stack([vl.c0, vl.c1], dim=-1)  # (nl, 2)
        vals = gather_rows(rows, np.concatenate([i, i + nl // 2]))  # (2Q, 2)
        per_layer.append((vals, gather_paths(layer["levels"], i)))
        pos = i
    openings = [
        [dict(pair=np.stack([vals[q], vals[Q + q]]), path=paths[q])
         for vals, paths in per_layer]
        for q in range(Q)
    ]
    return FriProof(
        caps=[layer["cap"] for layer in layers],
        final_poly=final,
        query_indices=indices,
        openings=openings,
    )


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


def _merkle_check(leaves: torch.Tensor, idxs: torch.Tensor, paths: torch.Tensor,
                  cap: torch.Tensor) -> torch.Tensor:
    return merkle.verify_path(merkle.hash_leaves(leaves), idxs, paths, cap).all()


def verify(proof: FriProof, params: FriParams) -> bool:
    n_layers = params.log_domain - params.final_poly_log_len
    if len(proof.caps) != n_layers:
        return False
    dev = proof.caps[0].device if proof.caps else None
    tr = Transcript(dev)
    betas = []
    for cap in proof.caps:
        tr.absorb(cap)
        b = tr.challenge_ext()
        betas.append((int(gf.to_u64(b.c0)), int(gf.to_u64(b.c1))))
    tr.absorb(gf.from_u64(np.asarray(proof.final_poly).reshape(-1), dev))
    expect_idx = tr.challenge_indices(1 << (params.log_domain - 1), params.num_queries)
    if expect_idx != list(proof.query_indices):
        return False

    # Merkle authentication: one batched check per layer over all queries
    Q = params.num_queries
    layer_oks = []
    for li in range(n_layers):
        nl = 1 << (params.log_domain - li)
        depth = params.log_domain - li - 1 - params.cap_log2
        leaves = np.zeros((Q, 4), np.uint64)
        paths = np.zeros((Q, depth, 4), np.uint64)
        idxs = np.zeros(Q, np.int64)
        for q, idx in enumerate(proof.query_indices):
            pos = idx
            for ll in range(li):
                pos = pos % ((1 << (params.log_domain - ll)) // 2)
            op = proof.openings[q][li]
            pair = np.asarray(op["pair"], dtype=np.uint64)
            leaves[q] = [pair[0, 0], pair[0, 1], pair[1, 0], pair[1, 1]]
            path = np.asarray(op["path"], np.uint64)
            if path.shape != (depth, 4):
                return False
            paths[q] = path
            idxs[q] = pos % (nl // 2)
        layer_oks.append(_merkle_check(
            gf.from_u64(leaves, dev), torch.as_tensor(idxs, device=dev),
            gf.from_u64(paths, dev), proof.caps[li]))
    if layer_oks and not bool(torch.stack(layer_oks).all()):
        return False

    roots = {}
    for q, idx in enumerate(proof.query_indices):
        pos = idx
        shift = params.coset_shift
        prev_fold = None
        for li in range(n_layers):
            log_nl = params.log_domain - li
            nl = 1 << log_nl
            i = pos % (nl // 2)
            pair = np.asarray(proof.openings[q][li]["pair"], dtype=np.uint64)
            a = (int(pair[0, 0]), int(pair[0, 1]))
            b = (int(pair[1, 0]), int(pair[1, 1]))
            # the previous fold must reappear at its position in this layer
            if prev_fold is not None and (a if pos < nl // 2 else b) != prev_fold:
                return False
            if log_nl not in roots:
                roots[log_nl] = ntt.root_of_unity(log_nl)
            x = shift * pow(roots[log_nl], i, MODULUS) % MODULUS
            x_inv = pow(x, MODULUS - 2, MODULUS)
            beta = betas[li]
            even = [(a[k] + b[k]) * _HALF % MODULUS for k in range(2)]
            odd = [(a[k] - b[k]) * _HALF % MODULUS * x_inv % MODULUS for k in range(2)]
            bo0 = (beta[0] * odd[0] + gf2.W_NONRESIDUE * beta[1] * odd[1]) % MODULUS
            bo1 = (beta[0] * odd[1] + beta[1] * odd[0]) % MODULUS
            prev_fold = ((even[0] + bo0) % MODULUS, (even[1] + bo1) % MODULUS)
            shift = shift * shift % MODULUS
            pos = i
        # the last fold equals the final polynomial at its coset point
        log_f = params.final_poly_log_len
        if log_f not in roots:
            roots[log_f] = ntt.root_of_unity(log_f)
        x = shift * pow(roots[log_f], pos, MODULUS) % MODULUS
        if _eval_poly_ext(np.asarray(proof.final_poly), x) != prev_fold:
            return False
    return True
