"""Plain reference verifier of the grand-product STARK of ram_permutation.

The AIR (8 columns, degree 2, 2 public values): columns
[f_u0, f_u1, f_s0, f_s1, lhs0, lhs1, rhs0, rhs1], the masked factors of a
row and the running products including it;
  transitions  lhs_r[i+1] = lhs_r[i] * f_u_r[i+1], rhs_r[i+1] = rhs_r[i] * f_s_r[i+1]
  first row    lhs_r = f_u_r, rhs_r = f_s_r
  last row     lhs_r = rhs_r, lhs_r = public_r

The protocol is a coset-quotient STARK with DEEP-ALI and FRI over GF(p^2)
(x^2 = 7), as the program proves it:
  1. the trace's LDE on shift * <W_N> is row-Merkle-committed: cap_1;
  2. a Poseidon2 transcript absorbs cap_1 and the publics and squeezes alpha;
     absorbs the quotient's cap, squeezes the OOD point z (off H and D);
     absorbs trace(z), trace(wz), Q(z) and squeezes lambda;
  3. the composition of the claimed rows at z, over the zerofiers, is Q(z);
  4. FRI (its own transcript) on E(x) = [A(x) - A(z) + l^2m (Q(x) - Q(z))] /
     (x - z) + l^m [A(x) - A(wz)] / (x - wz), A = sum_i l^i T_i; at every
     query the opened rows and Q, authenticated against their caps, give E,
     which is FRI's layer-0 pair.
Merkle leaves are length-specialised sponge hashes of the rows; a node is
the permutation of [left, right, 0, 0, 0, 0], lanes 0..3.

Python ints, with the reference Poseidon2 (plain torch) for the hashes, all
Merkle paths of a proof one level at a time in one batch.  It imports
nothing of the program; it reads the program's proof only to judge it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import poseidon2 as p2

P = (1 << 64) - (1 << 32) + 1
GENERATOR = 7
NONRESIDUE = 7
REPS = 2
COLS = 8
FINAL_POLY_LOG_LEN = 2
HALF = pow(2, P - 2, P)


def _ints(x) -> list:
    """a tensor or array of u64 values as python ints (flat)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy().view(np.uint64)
    return [int(v) for v in np.asarray(x, dtype=np.uint64).reshape(-1)]


def _nodes(cap) -> list:
    """a cap's nodes as lists of 4 ints."""
    flat = _ints(cap)
    return [flat[i:i + 4] for i in range(0, len(flat), 4)]


def root(log_n: int) -> int:
    return pow(GENERATOR, (P - 1) >> log_n, P)


def inv(a: int) -> int:
    return pow(a, P - 2, P)


def _lanes(values: list) -> torch.Tensor:
    return torch.tensor([v - (1 << 64) if v >> 63 else v for v in values], dtype=torch.int64)


def hash_rows(rows: list, length_specialize: bool = True) -> list:
    """the 4-lane sponge hash of each row (lists of ints, one length)."""
    n = len(rows[0])
    x = torch.stack([_lanes(r) for r in rows])
    state = torch.zeros((len(rows), p2.WIDTH), dtype=torch.int64)
    if length_specialize:
        state[:, p2.WIDTH - 1] = n
    pad = (-n) % p2.RATE
    if pad:
        x = torch.cat([x, torch.zeros((len(rows), pad), dtype=torch.int64)], dim=1)
    for i in range(0, x.shape[1], p2.RATE):
        state = p2.absorb(state, x[:, i:i + p2.RATE])
    return [_ints(s[:4]) for s in state]


class Transcript:
    def __init__(self):
        self.state = [0, 0, 0, 0]

    def absorb(self, values: list):
        self.state = hash_rows([self.state + list(values)])[0]

    def squeeze(self) -> list:
        self.state = hash_rows([self.state], length_specialize=False)[0]
        return self.state

    def challenge(self) -> int:
        return self.squeeze()[0]

    def challenge_ext(self) -> tuple:
        s = self.squeeze()
        return s[0], s[1]

    def indices(self, bound: int, count: int) -> list:
        out = []
        while len(out) < count:
            out.extend(v % bound for v in self.squeeze()[:count - len(out)])
        return out


def merkle_ok(checks: list) -> bool:
    """checks: [(leaf digest, index, path [[4 ints] x depth], cap [[4 ints]])];
    whether every path leads to its cap node.  One batched permutation a
    level over all paths that reach it."""
    cur = [list(c[0]) for c in checks]
    depth = max((len(c[2]) for c in checks), default=0)
    for d in range(depth):
        live = [k for k, c in enumerate(checks) if len(c[2]) > d]
        states = []
        for k in live:
            sib = [int(v) for v in checks[k][2][d]]
            left, right = (sib, cur[k]) if (checks[k][1] >> d) & 1 else (cur[k], sib)
            states.append(_lanes(left + right + [0, 0, 0, 0]))
        out = p2.permute(torch.stack(states))
        for k, s in zip(live, out):
            cur[k] = _ints(s[:4])
    return all(cur[k] == [int(v) for v in c[3][c[1] >> len(c[2])]]
               for k, c in enumerate(checks))


def _compose(cur: list, nxt: list, public: list, alpha: int, z: int, n: int, w: int) -> int:
    vals_t, vals_f, vals_l = [], [], []
    for r in range(REPS):
        vals_t += [(nxt[4 + r] - cur[4 + r] * nxt[r]) % P,
                   (nxt[6 + r] - cur[6 + r] * nxt[2 + r]) % P]
        vals_f += [(cur[4 + r] - cur[r]) % P, (cur[6 + r] - cur[2 + r]) % P]
        vals_l += [(cur[4 + r] - cur[6 + r]) % P, (cur[4 + r] - public[r]) % P]
    a_pow = 1
    accs = []
    for vals in (vals_t, vals_f, vals_l):
        acc = 0
        for v in vals:
            acc = (acc + v * a_pow) % P
            a_pow = a_pow * alpha % P
        accs.append(acc)
    zn_inv = inv((pow(z, n, P) - 1) % P)
    x_m_last = (z - pow(w, n - 1, P)) % P
    return (accs[0] * x_m_last % P * zn_inv + accs[1] * inv((z - 1) % P)
            + accs[2] * inv(x_m_last)) % P


def _fri_ok(fp, log_domain: int, log_blowup: int, queries: int, cap_log2: int,
            shift: int) -> bool:
    layers = log_domain - FINAL_POLY_LOG_LEN
    if len(fp.caps) != layers:
        return False
    tr = Transcript()
    betas = []
    for cap in fp.caps:
        tr.absorb(_ints(cap))
        betas.append(tr.challenge_ext())
    final = np.asarray(fp.final_poly, dtype=np.uint64)
    if final.shape != (2, 1 << max(FINAL_POLY_LOG_LEN - log_blowup, 0)):
        return False
    tr.absorb(_ints(final))
    if tr.indices(1 << (log_domain - 1), queries) != [int(i) for i in fp.query_indices]:
        return False
    checks = []
    for q, idx in enumerate(fp.query_indices):
        if len(fp.openings[q]) != layers:
            return False
        pos, sh, prev = int(idx), shift, None
        for li in range(layers):
            log_nl = log_domain - li
            half = 1 << (log_nl - 1)
            i = pos % half
            op = fp.openings[q][li]
            pair = np.asarray(op["pair"], dtype=np.uint64)
            path = np.asarray(op["path"], dtype=np.uint64)
            if pair.shape != (2, 2) or path.shape != (log_nl - 1 - cap_log2, 4):
                return False
            a, b = (int(pair[0, 0]), int(pair[0, 1])), (int(pair[1, 0]), int(pair[1, 1]))
            checks.append((a + b, i, path.tolist(), _nodes(fp.caps[li])))
            if prev is not None and (a if pos < half else b) != prev:
                return False
            x_inv = inv(sh * pow(root(log_nl), i, P) % P)
            even = [(a[k] + b[k]) * HALF % P for k in range(2)]
            odd = [(a[k] - b[k]) * HALF % P * x_inv % P for k in range(2)]
            beta = betas[li]
            prev = ((even[0] + beta[0] * odd[0] + NONRESIDUE * beta[1] * odd[1]) % P,
                    (even[1] + beta[0] * odd[1] + beta[1] * odd[0]) % P)
            sh = sh * sh % P
            pos = i
        x = sh * pow(root(FINAL_POLY_LOG_LEN), pos, P) % P
        at = [0, 0]
        for j in range(final.shape[1] - 1, -1, -1):
            at = [(at[k] * x + int(final[k, j])) % P for k in range(2)]
        if tuple(at) != prev:
            return False
    leaves = hash_rows([c[0] for c in checks])
    return merkle_ok([(h,) + c[1:] for h, c in zip(leaves, checks)])


def verify(proof, public, log_n: int, log_blowup: int, queries: int, cap_log2: int,
           shift: int = GENERATOR) -> bool:
    """whether the program's proof (its fields read as they are) proves the
    grand product with these public final products and parameters."""
    n = 1 << log_n
    N = n << log_blowup
    public = _ints(public)
    if len(proof.caps) != 1 or len(public) != REPS or len(proof.trace_openings) != queries:
        return False
    ood_z, ood_wz = _ints(proof.ood["trace_z"]), _ints(proof.ood["trace_wz"])
    q_z = int(proof.ood["q_z"]) % P
    if len(ood_z) != COLS or len(ood_wz) != COLS:
        return False
    cap1, q_cap = _ints(proof.caps[0]), _ints(proof.q_cap)
    tr = Transcript()
    tr.absorb(cap1)
    tr.absorb(public)
    alpha = tr.challenge()
    tr.absorb(q_cap)
    while True:
        z = tr.challenge()
        if pow(z, n, P) != 1 and pow(z, N, P) != pow(shift, N, P):
            break
    w = root(log_n)
    wz = z * w % P
    tr.absorb(ood_z + ood_wz + [q_z])
    lam = tr.challenge()
    if _compose(ood_z, ood_wz, public, alpha, z, n, w) != q_z:
        return False
    fp = proof.fri_proof
    if not _fri_ok(fp, log_n + log_blowup, log_blowup, queries, cap_log2, shift):
        return False

    caps = [_nodes(proof.caps[0]), _nodes(proof.q_cap)]
    depth = log_n + log_blowup - cap_log2
    lam_pows = [pow(lam, i, P) for i in range(COLS)]
    lam_m = pow(lam, COLS, P)
    a_z = sum(l * v for l, v in zip(lam_pows, ood_z)) % P
    a_wz = sum(l * v for l, v in zip(lam_pows, ood_wz)) % P
    w_big = root(log_n + log_blowup)
    rows, checks, evals = [], [], []
    for q in range(queries):
        idx = int(fp.query_indices[q])
        for tag, j in (("cur", idx), ("cur_pair", idx + N // 2)):
            op = proof.trace_openings[q][tag]
            if int(op["index"]) != j or len(op["rows"]) != 1 or len(op["paths"]) != 1:
                return False
            row, q_row = _ints(op["rows"][0]), _ints(op["q_row"])
            paths = [np.asarray(op["paths"][0], np.uint64), np.asarray(op["q_path"], np.uint64)]
            if len(row) != COLS or len(q_row) != 1 or any(p.shape != (depth, 4) for p in paths):
                return False
            rows += [row, q_row]
            checks += [(j, paths[0].tolist(), caps[0]), (j, paths[1].tolist(), caps[1])]
            x = shift * pow(w_big, j, P) % P
            A = sum(l * v for l, v in zip(lam_pows, row)) % P
            t1 = (A - a_z + lam_m * lam_m % P * (q_row[0] - q_z)) % P
            t2 = lam_m * (A - a_wz) % P
            evals.append((t1 * inv((x - z) % P) + t2 * inv((x - wz) % P)) % P)
        for half in range(2):
            pair = np.asarray(fp.openings[q][0]["pair"], dtype=np.uint64)
            if (int(pair[half, 0]), int(pair[half, 1])) != (evals[2 * q + half], 0):
                return False
    digests = hash_rows(rows[0::2]), hash_rows(rows[1::2])
    leaf = [d for pair in zip(*digests) for d in pair]
    return merkle_ok([(h,) + c for h, c in zip(leaf, checks)])
