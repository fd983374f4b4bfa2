"""Two-phase coset-quotient STARK with DEEP-ALI, on torch tensors.

The protocol of the JAX package's `prover/stark.py`, for every AIR form:
fixed (verifier-known) columns, phase-1 columns, phase-2 columns built from
the challenges, transition and row constraints (or the folded `compose_row`
and the public-aware `compose_row_pub` / `constraints_pub`), affine
first/last-row constraints and public values.

  1. LDE every column group to the coset D = shift * <W> of size
     N = n * blowup and Merkle-commit its rows: [fixed_cap,] cap_1.
  2. ch = FS([fixed_cap,] cap_1), drawn BEFORE the public vector is absorbed
     (publics may depend on the challenges); the phase-2 columns are built
     from (trace, ch) and committed -> cap_2.
  3. alpha = FS(..., public, cap_2).  The quotient
       Q = [sum_k a^k C_k] / Z_trans + [sum_k a^k R_k] / (x^n - 1)
           + [sum_j a^j F_j] / (x - 1) + [sum_j a^j L_j] / (x - w^(n-1))
     is evaluated pointwise on D over the rows [fixed | phase1 | phase2]
     (the next row at x is the LDE rolled by `blowup`) and committed -> q_cap.
  4. OOD: z = FS(...) off H and off D; the prover sends every column at z
     and w z and Q(z); the verifier recomputes the composition from the
     claimed row pair at z and demands it equal Q(z).
  5. DEEP: lambda = FS(OOD values); the FRI codeword is
       E(x) = [A(x) - A(z) + l^(2m) (Q(x) - Q(z))] / (x - z)
              + l^m [A(x) - A(wz)] / (x - wz),   A = sum_i l^i T_i.
  6. FRI on E; at each FRI query the verifier opens every tree's row and Q,
     recomputes E and checks it against FRI's layer-0 pair.  The verifier
     recomputes the fixed cap from the plaintext fixed columns.

Everything large stays on the device of the trace; the transcript, the
query positions and the openings pass through python ints and numpy.  The
DEEP combination and the OOD evaluation run over bounded blocks of the
domain (`_BLOCK_ELEMS`); the LDE goes a block of columns at a time and the
quotient a block of rows at a time (`_WIDE_ELEMS`), so that an AIR of
thousands of columns fits the card.  Each tree keeps its LDE once, as the
row-major leaves.  None of this changes a value.  The soundness discussion
is in the JAX module's docstring.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import fri, gf, merkle, ntt
from ..ops.fri import Transcript
from ..ops.gf import MODULUS

# elements of one (rows, columns) block of the wide passes over the domain:
# bounds their temporaries (a field product makes about a dozen of its size)
_BLOCK_ELEMS = 1 << 22
# elements of one (columns, domain) block of the LDE and of one (rows,
# columns) block of the quotient: an AIR at most this wide over its domain
# goes through in one piece
_WIDE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True, eq=False)
class AirSpec:
    """Callables receive row views (batch, total_cols) over the concatenated
    columns [fixed | phase1 | phase2] and `ch`, the (num_challenges,)
    challenge tensor; `alpha` and `a_pow` are python ints:

      constraints(cur, nxt, ch)                  -> [(batch,) ...] transitions
      row_constraints(cur, ch)                   -> [...]          every row
      first_row(row, public, ch)                 -> [...]          row 0, affine
      last_row(row, public, ch)                  -> [...]          row n-1, affine
      compose_row(cur, ch, alpha, a_pow)         -> (alpha-weighted row sum, a_pow')
      compose_row_pub(cur, public, ch, alpha, a_pow), constraints_pub(cur, nxt, public, ch):
          the same with the public vector, used in place of compose_row /
          constraints when set.

    `num_fixed_cols` columns are verifier-known data whose cap the verifier
    recomputes; a list entry may be one constraint or a group with one
    leading axis."""

    num_cols: int
    max_degree: int
    constraints: Callable
    row_constraints: Optional[Callable] = None
    first_row: Optional[Callable] = None
    last_row: Optional[Callable] = None
    num_public: int = 0
    num_phase2_cols: int = 0
    num_challenges: int = 0
    num_fixed_cols: int = 0
    compose_row: Optional[Callable] = None
    compose_row_pub: Optional[Callable] = None
    constraints_pub: Optional[Callable] = None

    @property
    def total_cols(self) -> int:
        return self.num_fixed_cols + self.num_cols + self.num_phase2_cols


@dataclasses.dataclass(frozen=True)
class StarkParams:
    log_n: int
    log_blowup: int = 2     # 2^log_blowup >= max_degree
    num_queries: int = 20
    cap_log2: int = 1
    coset_shift: int = gf.MULTIPLICATIVE_GENERATOR


@dataclasses.dataclass
class StarkProof:
    caps: List[torch.Tensor]   # [fixed cap?, phase-1 cap, phase-2 cap?]
    q_cap: torch.Tensor        # cap of the quotient evaluations on D
    # {"trace_z": (m,) u64, "trace_wz": (m,) u64, "q_z": int}, m = total_cols
    ood: dict
    fri_proof: fri.FriProof
    # per query: {tag: {"rows": [(m_t,) u64 per tree], "paths": [(d, 4) u64],
    #                   "q_row": (1,) u64, "q_path": (d, 4) u64, "index": j}}
    # for tag in ("cur", "cur_pair"), the two halves of a FRI leaf pair
    trace_openings: List[dict]

    @property
    def trace_cap(self) -> torch.Tensor:
        """the phase-1 cap when the AIR has no fixed columns."""
        return self.caps[0]


def _fri_params(air: AirSpec, params: StarkParams) -> fri.FriParams:
    # quotient degree < max((d-1)n, n-1): tighten FRI by ceil(log2(d-1)) folds
    extra = (air.max_degree - 2).bit_length() if air.max_degree > 2 else 0
    log_blowup = params.log_blowup - extra
    if log_blowup < 1:
        raise ValueError("blowup too small for this constraint degree")
    return fri.FriParams(
        log_domain=params.log_n + params.log_blowup,
        log_blowup=log_blowup,
        num_queries=params.num_queries,
        cap_log2=params.cap_log2,
        coset_shift=params.coset_shift,
    )


def _batch_inv(vals: Sequence[int]) -> List[int]:
    """Montgomery batch inversion of python ints (one pow for the list)."""
    pref = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % MODULUS
    inv = pow(pref[-1], MODULUS - 2, MODULUS)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pref[i] * inv % MODULUS
        inv = inv * vals[i] % MODULUS
    return out


def _block_rows(num_cols: int, elems: int = _BLOCK_ELEMS) -> int:
    """rows of one block of a (rows, num_cols) pass: a power of two."""
    return 1 << max((elems // max(num_cols, 1)).bit_length() - 1, 0)


def _domain_points(log_N: int, shift: int, device) -> torch.Tensor:
    """(N,) points of shift * <W_N> in natural order."""
    return gf.mul_const(gf.geometric(ntt.root_of_unity(log_N), 1 << log_N, device), shift)


def _zerofier_invs(xs: torch.Tensor, n: int, last: int, xn: torch.Tensor):
    """(1/Z_trans, 1/(x^n - 1), 1/(x - 1), 1/(x - last)) at points xs (all
    off H); xn = xs^n."""
    zn_inv = gf.inv(gf.sub(xn, gf.ones((), xs.device)))
    x_m_last = gf.sub(xs, gf.constant(last, xs.device))
    first_inv = gf.inv(gf.sub(xs, gf.ones((), xs.device)))
    return gf.mul(x_m_last, zn_inv), zn_inv, first_inv, gf.inv(x_m_last)


def _domain_zerofiers(params: StarkParams, xs: torch.Tensor):
    """inverse zerofiers over the whole LDE domain.  x^n on the coset takes
    only `blowup` values: (shift W^i)^n = shift^n (W^n)^(i mod blowup)."""
    n = 1 << params.log_n
    blowup = 1 << params.log_blowup
    last = pow(ntt.root_of_unity(params.log_n), n - 1, MODULUS)
    sn = pow(params.coset_shift, n, MODULUS)
    xn = gf.mul_const(gf.geometric(ntt.root_of_unity(params.log_blowup), blowup, xs.device), sn)
    return _zerofier_invs(xs, n, last, xn.repeat(n))


def _alpha_powers(alpha: int, k: int, device) -> torch.Tensor:
    """[alpha^0 .. alpha^(k-1)]."""
    pows = [1]
    for _ in range(k - 1):
        pows.append(pows[-1] * alpha % MODULUS)
    return gf.from_u64(pows, device)


def _alpha_sum(vals: List[torch.Tensor], alpha: int, a_pow: int):
    """(sum_k alpha^k * a_pow * vals[k], next a_pow); each entry is one
    constraint with the batch shape, or a group with leading axes."""
    if not vals:
        return None, a_pow
    rows = []
    for v in vals:
        v = gf.canonicalize(v)
        rows.append(v.reshape((-1,) + tuple(v.shape[-1:])) if v.dim() > 1 else v.unsqueeze(0))
    stacked = torch.cat(rows)  # (k, batch)
    k = stacked.shape[0]
    w = gf.mul_const(_alpha_powers(alpha, k, stacked.device), a_pow)
    acc = gf.sum_mod(gf.mul(stacked, w.unsqueeze(-1)), dim=0)
    return acc, pow(alpha, k, MODULUS) * a_pow % MODULUS


def _compose_rows(cur, nxt, public, ch, alpha: int, zt_inv, zn_inv, first_inv, last_inv,
                  air: AirSpec) -> torch.Tensor:
    """The quotient at a batch of (cur, nxt) row pairs, given the inverse
    zerofiers at their points; shared by the prover and the verifier."""
    if air.constraints_pub is not None:
        t_vals = air.constraints_pub(cur, nxt, public, ch)
    else:
        t_vals = air.constraints(cur, nxt, ch)
    t_acc, a_pow = _alpha_sum(t_vals, alpha, 1)
    comp = gf.mul(t_acc, zt_inv)
    r_acc = None
    if air.compose_row_pub is not None:
        r_acc, a_pow = air.compose_row_pub(cur, public, ch, alpha, a_pow)
    elif air.compose_row is not None:
        r_acc, a_pow = air.compose_row(cur, ch, alpha, a_pow)
    elif air.row_constraints is not None:
        r_acc, a_pow = _alpha_sum(air.row_constraints(cur, ch), alpha, a_pow)
    if r_acc is not None:
        comp = gf.add(comp, gf.mul(r_acc, zn_inv))
    if air.first_row is not None:
        f_acc, a_pow = _alpha_sum(air.first_row(cur, public, ch), alpha, a_pow)
        comp = gf.add(comp, gf.mul(f_acc, first_inv))
    if air.last_row is not None:
        l_acc, a_pow = _alpha_sum(air.last_row(cur, public, ch), alpha, a_pow)
        comp = gf.add(comp, gf.mul(l_acc, last_inv))
    return comp


def _barycentric(vals: torch.Tensor, z: int, log_N: int, shift: int) -> torch.Tensor:
    """Evaluate the degree < N polynomial given by `vals` (..., N) on the
    coset shift * <W_N> at an off-domain point z:
        P(z) = (z^N - shift^N) / (N shift^N) * sum_i vals_i x_i / (z - x_i).
    A (m, N) `vals` goes in blocks of rows."""
    N = 1 << log_N
    xs = _domain_points(log_N, shift, vals.device)
    weights = gf.mul(xs, gf.inv(gf.sub(gf.constant(z, vals.device), xs)))
    if vals.dim() == 1:
        s = gf.dot_mod(vals, weights)
    else:
        step = max(_BLOCK_ELEMS // N, 1)
        s = torch.cat([gf.dot_mod(vals[i:i + step], weights)
                       for i in range(0, vals.shape[0], step)])
    sN = pow(shift, N, MODULUS)
    factor = (pow(z, N, MODULUS) - sN) * pow(N * sN % MODULUS, MODULUS - 2, MODULUS)
    return gf.mul_const(s, factor % MODULUS)


def _ood_point(tr: Transcript, log_n: int, log_blowup: int, shift: int) -> int:
    """z from the transcript, rejecting z in H (z^n = 1) or in D."""
    n = 1 << log_n
    N = n << log_blowup
    sN = pow(shift, N, MODULUS)
    while True:
        z = int(gf.to_u64(tr.challenge_ext().c0))
        if pow(z, n, MODULUS) != 1 and pow(z, N, MODULUS) != sN:
            return z


def _deep_combine(rows, q_vals, lpows, lam_m: int, lam_2m: int, a_z, a_wz,
                  q_z: int, inv_xz, inv_xwz) -> torch.Tensor:
    """E at a batch of points: rows (k, m), q_vals (k,), inv_x* (k,)."""
    A = gf.sum_mod(gf.mul(rows, lpows), dim=-1)
    dev = rows.device
    t1 = gf.add(gf.sub(A, a_z),
                gf.mul_const(gf.sub(q_vals, gf.constant(q_z, dev)), lam_2m))
    t2 = gf.mul_const(gf.sub(A, a_wz), lam_m)
    return gf.add(gf.mul(t1, inv_xz), gf.mul(t2, inv_xwz))


def _lambda_weights(lam: int, m: int, device):
    pows = _alpha_powers(lam, m, device)
    lam_m = pow(lam, m, MODULUS)
    return pows, lam_m, lam_m * lam_m % MODULUS


def _commit_rows(leaves: torch.Tensor, params: StarkParams) -> dict:
    levels = merkle.tree_levels(merkle.hash_leaves(leaves), params.cap_log2)
    return dict(cap=levels[-1], leaves=leaves, levels=levels)


def _lde_rows(cols: torch.Tensor, params: StarkParams) -> torch.Tensor:
    """The (N, m) row-major LDE of an (m, n) column group, a block of
    columns at a time."""
    m, n = cols.shape
    N = n << params.log_blowup
    step = max(_WIDE_ELEMS // N, 1)
    out = torch.empty((N, m), dtype=cols.dtype, device=cols.device)
    for i in range(0, m, step):
        out[:, i:i + step] = ntt.lde(cols[i:i + step], params.log_blowup, params.coset_shift).T
    return out


def _commit_columns(cols: torch.Tensor, params: StarkParams) -> dict:
    """LDE + row-Merkle commitment of an (m, n) column group: a tree dict
    {cap, leaves, levels} that `prove` takes as its `phase1_tree`; the
    leaves are the LDE rows."""
    return _commit_rows(_lde_rows(cols, params), params)


def _domain_rows(trees, start: int, stop: int) -> torch.Tensor:
    """LDE rows [start, stop) of every tree side by side: (rows, m), the
    range wrapping around the domain."""
    N = trees[0]["leaves"].shape[0]
    if stop > N:
        return torch.cat([_domain_rows(trees, start, N), _domain_rows(trees, 0, stop - N)])
    if len(trees) == 1:
        return trees[0]["leaves"][start:stop]
    return torch.cat([t["leaves"][start:stop] for t in trees], dim=1)


def _ch_ints(tr: Transcript, air: AirSpec) -> Tuple[int, ...]:
    return tuple(int(gf.to_u64(tr.challenge_ext().c0)) for _ in range(air.num_challenges))


def challenges_from_cap(cap1: torch.Tensor, air: AirSpec,
                        fixed_cap: Optional[torch.Tensor] = None):
    """The challenge round: (ch ints, transcript) from FS([fixed_cap,] cap_1),
    BEFORE the public vector is absorbed, so that public values may depend
    on the challenges (the message RLC of `poseidon2_air`); alpha, drawn
    after the publics, still binds them."""
    tr = Transcript(cap1.device)
    if fixed_cap is not None:
        tr.absorb(fixed_cap)
    tr.absorb(cap1)
    return _ch_ints(tr, air), tr


def _absorb_public(tr: Transcript, public: Optional[torch.Tensor], air: AirSpec):
    if air.num_public:
        if public is None or tuple(public.shape) != (air.num_public,):
            raise ValueError(f"the AIR takes {air.num_public} public values")
        tr.absorb(public)


def prove(trace: torch.Tensor, air: AirSpec, params: StarkParams,
          public: Optional[torch.Tensor] = None,
          build_phase2: Optional[Callable] = None,
          fixed_cols: Optional[torch.Tensor] = None,
          phase1_tree: Optional[dict] = None,
          commit_fn: Optional[Callable] = None) -> StarkProof:
    """Prove that the (num_cols, n) trace satisfies `air` with `public`.

    `build_phase2(cols, ch_ints) -> (num_phase2_cols, n)` builds the
    challenge-derived columns (required iff the AIR has them); `cols` is
    [fixed | phase1].  `fixed_cols` (num_fixed_cols, n) is the verifier-known
    data (required iff the AIR has it).  `phase1_tree` is the caller's own
    `_commit_columns(trace, params)` when it already made it (a public that
    depends on the challenges needs the phase-1 cap first); the proof is the
    same either way.  `commit_fn(cols, params)` replaces `_commit_columns`
    for the column groups (`parallel/prover.py:make_sharded_commit` gives
    the same tree dict, so the proof is the same bytes)."""
    n = 1 << params.log_n
    if tuple(trace.shape) != (air.num_cols, n):
        raise ValueError(f"trace must be {(air.num_cols, n)}, got {tuple(trace.shape)}")
    if (1 << params.log_blowup) < air.max_degree:
        raise ValueError("blowup below the constraint degree")
    dev = trace.device
    blowup = 1 << params.log_blowup
    N = n * blowup
    log_N = params.log_n + params.log_blowup

    commit = commit_fn or _commit_columns
    trees = []
    fixed_cap = None
    groups = [trace]  # the column groups in the order of the rows
    if air.num_fixed_cols:
        if fixed_cols is None or tuple(fixed_cols.shape) != (air.num_fixed_cols, n):
            raise ValueError(f"the AIR takes fixed columns of shape {(air.num_fixed_cols, n)}")
        trees.append(commit(fixed_cols, params))
        fixed_cap = trees[0]["cap"]
        groups.insert(0, fixed_cols)
    trees.append(phase1_tree if phase1_tree is not None else commit(trace, params))
    ch, tr = challenges_from_cap(trees[-1]["cap"], air, fixed_cap)
    _absorb_public(tr, public, air)
    if air.num_phase2_cols:
        if build_phase2 is None:
            raise ValueError("the AIR has phase-2 columns: build_phase2 is required")
        t2 = build_phase2(groups[0] if len(groups) == 1 else torch.cat(groups), ch)
        if tuple(t2.shape) != (air.num_phase2_cols, n):
            raise ValueError(f"build_phase2 gave {tuple(t2.shape)}, "
                             f"not {(air.num_phase2_cols, n)}")
        trees.append(commit(t2, params))
        tr.absorb(trees[-1]["cap"])
        groups.append(t2)

    alpha = int(gf.to_u64(tr.challenge_ext().c0))
    xs = _domain_points(log_N, params.coset_shift, dev)
    zerofiers = _domain_zerofiers(params, xs)
    ch_t = gf.from_u64(np.array(ch, dtype=np.uint64), dev)
    # the next row at x is the LDE row `blowup` further on
    m = air.total_cols
    step = min(_block_rows(m, _WIDE_ELEMS), N)
    quotient = torch.cat([
        _compose_rows(_domain_rows(trees, i, i + step),
                      _domain_rows(trees, i + blowup, i + step + blowup), public, ch_t,
                      alpha, *(zf[i:i + step] for zf in zerofiers), air)
        for i in range(0, N, step)])
    q_tree = _commit_rows(quotient.unsqueeze(-1), params)
    tr.absorb(q_tree["cap"])

    # OOD round: every column at z and w z, the quotient at z
    z = _ood_point(tr, params.log_n, params.log_blowup, params.coset_shift)
    wz = z * ntt.root_of_unity(params.log_n) % MODULUS
    trace_z = torch.cat([_barycentric(g, z, params.log_n, 1) for g in groups])
    trace_wz = torch.cat([_barycentric(g, wz, params.log_n, 1) for g in groups])
    q_z = _barycentric(quotient, z, log_N, params.coset_shift)
    ood = dict(trace_z=gf.to_u64(trace_z), trace_wz=gf.to_u64(trace_wz),
               q_z=int(gf.to_u64(q_z)))
    tr.absorb(torch.cat([trace_z, trace_wz, q_z.reshape(1)]))
    lam = int(gf.to_u64(tr.challenge_ext().c0))

    # DEEP codeword over the whole LDE domain, a block of rows at a time
    lpows, lam_m, lam_2m = _lambda_weights(lam, m, dev)
    a_z, a_wz = gf.dot_mod(trace_z, lpows), gf.dot_mod(trace_wz, lpows)
    inv_xz = gf.inv(gf.sub(xs, gf.constant(z, dev)))
    inv_xwz = gf.inv(gf.sub(xs, gf.constant(wz, dev)))
    step = min(_block_rows(m), N)
    deep = torch.cat([
        _deep_combine(_domain_rows(trees, i, i + step), quotient[i:i + step], lpows, lam_m,
                      lam_2m, a_z, a_wz, ood["q_z"], inv_xz[i:i + step], inv_xwz[i:i + step])
        for i in range(0, N, step)])
    fproof = fri.prove(deep, _fri_params(air, params))

    # openings: the queried rows and paths of every tree, pulled once each
    idx = np.asarray(fproof.query_indices, np.int64)
    flat_idx = np.concatenate([idx, idx + N // 2])  # (2Q,)
    gathered = [(fri.gather_rows(t["leaves"], flat_idx), fri.gather_paths(t["levels"], flat_idx))
                for t in trees + [q_tree]]
    Q = len(fproof.query_indices)
    openings = []
    for qi in range(Q):
        entry = {}
        for tag, k in (("cur", qi), ("cur_pair", Q + qi)):
            entry[tag] = dict(
                rows=[g[0][k] for g in gathered[:-1]],
                paths=[g[1][k] for g in gathered[:-1]],
                q_row=gathered[-1][0][k],
                q_path=gathered[-1][1][k],
                index=int(flat_idx[k]),
            )
        openings.append(entry)
    return StarkProof(caps=[t["cap"] for t in trees], q_cap=q_tree["cap"], ood=ood,
                      fri_proof=fproof, trace_openings=openings)


def verify(proof: StarkProof, air: AirSpec, params: StarkParams,
           public: Optional[torch.Tensor] = None,
           fixed_cols: Optional[torch.Tensor] = None) -> bool:
    n = 1 << params.log_n
    N = n << params.log_blowup
    Q = params.num_queries
    has_fixed = 1 if air.num_fixed_cols else 0
    widths = [air.num_fixed_cols] * has_fixed + [air.num_cols] + (
        [air.num_phase2_cols] if air.num_phase2_cols else [])
    n_trees = len(widths)
    if len(proof.caps) != n_trees or len(proof.trace_openings) != Q:
        return False
    if air.num_public and (public is None or tuple(public.shape) != (air.num_public,)):
        return False
    dev = proof.q_cap.device
    m = air.total_cols
    ood_z = np.asarray(proof.ood["trace_z"], np.uint64)
    ood_wz = np.asarray(proof.ood["trace_wz"], np.uint64)
    q_z = int(proof.ood["q_z"]) % MODULUS
    if ood_z.shape != (m,) or ood_wz.shape != (m,):
        return False
    fixed_cap = None
    if has_fixed:
        # the fixed cap belongs to the verifying key: recompute it from the
        # plaintext columns
        if fixed_cols is None or tuple(fixed_cols.shape) != (air.num_fixed_cols, n):
            return False
        want = _commit_columns(fixed_cols.to(dev), params)["cap"]
        if not torch.equal(want, proof.caps[0]):
            return False
        fixed_cap = proof.caps[0]
    ch, tr = challenges_from_cap(proof.caps[has_fixed], air, fixed_cap)
    _absorb_public(tr, public, air)
    if air.num_phase2_cols:
        tr.absorb(proof.caps[-1])
    alpha = int(gf.to_u64(tr.challenge_ext().c0))
    tr.absorb(proof.q_cap)
    z = _ood_point(tr, params.log_n, params.log_blowup, params.coset_shift)
    w = ntt.root_of_unity(params.log_n)
    wz = z * w % MODULUS
    tr.absorb(gf.from_u64(np.concatenate([ood_z, ood_wz, [np.uint64(q_z)]]), dev))
    lam = int(gf.to_u64(tr.challenge_ext().c0))

    # OOD constraint check: the composition of the claimed row pair at z
    z_t = gf.from_u64([z], dev)
    zerofiers = _zerofier_invs(
        z_t, n, pow(w, n - 1, MODULUS), gf.from_u64([pow(z, n, MODULUS)], dev))
    comp = _compose_rows(
        gf.from_u64(ood_z[None, :], dev), gf.from_u64(ood_wz[None, :], dev), public,
        gf.from_u64(np.array(ch, dtype=np.uint64), dev), alpha, *zerofiers, air)
    if int(gf.to_u64(comp)[0]) != q_z:
        return False

    if not fri.verify(proof.fri_proof, _fri_params(air, params)):
        return False

    # openings must sit at the FRI query positions with the right shapes
    rows = [[] for _ in range(n_trees)]
    paths = [[] for _ in range(n_trees)]
    q_rows, q_paths, flat_idx = [], [], []
    for q in range(Q):
        idx = proof.fri_proof.query_indices[q]
        for tag, j in (("cur", idx), ("cur_pair", idx + N // 2)):
            op = proof.trace_openings[q][tag]
            if int(op["index"]) != j or len(op["rows"]) != n_trees or len(op["paths"]) != n_trees:
                return False
            q_row = np.asarray(op["q_row"], np.uint64)
            if q_row.shape != (1,):
                return False
            for t in range(n_trees):
                row = np.asarray(op["rows"][t], np.uint64)
                if row.shape != (widths[t],):
                    return False
                rows[t].append(row)
                paths[t].append(np.asarray(op["paths"][t], np.uint64))
            q_rows.append(q_row)
            q_paths.append(np.asarray(op["q_path"], np.uint64))
            flat_idx.append(j)

    idx_t = torch.as_tensor(np.array(flat_idx, np.int64), device=dev)
    rows_t = [gf.from_u64(np.stack(r), dev) for r in rows]  # (2Q, m_t) each
    q_rows_t = gf.from_u64(np.stack(q_rows), dev)           # (2Q, 1)
    oks = [fri._merkle_check(rows_t[t], idx_t, gf.from_u64(np.stack(paths[t]), dev),
                             proof.caps[t]) for t in range(n_trees)]
    oks.append(fri._merkle_check(q_rows_t, idx_t, gf.from_u64(np.stack(q_paths), dev),
                                 proof.q_cap))
    if not bool(torch.stack(oks).all()):
        return False

    # the DEEP combination at the opened points must equal FRI's layer 0
    w_big = ntt.root_of_unity(params.log_n + params.log_blowup)
    xs = [params.coset_shift * pow(w_big, j, MODULUS) % MODULUS for j in flat_idx]
    lpows, lam_m, lam_2m = _lambda_weights(lam, m, dev)
    ev = _deep_combine(
        torch.cat(rows_t, dim=1), q_rows_t[:, 0], lpows, lam_m, lam_2m,
        gf.dot_mod(gf.from_u64(ood_z, dev), lpows), gf.dot_mod(gf.from_u64(ood_wz, dev), lpows),
        q_z,
        gf.from_u64(_batch_inv([(x - z) % MODULUS for x in xs]), dev),
        gf.from_u64(_batch_inv([(x - wz) % MODULUS for x in xs]), dev),
    )
    ev_np = gf.to_u64(ev).reshape(Q, 2)
    for q in range(Q):
        pair = np.asarray(proof.fri_proof.openings[q][0]["pair"], np.uint64)
        for half in range(2):
            if int(pair[half, 0]) != int(ev_np[q, half]) or int(pair[half, 1]) != 0:
                return False
    return True
