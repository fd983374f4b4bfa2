"""ecrecover ladder AIR (the JAX package's `prover/ecrecover_air.py`, on
torch tensors): a STARK of the secp256k1 double-and-add ladders of circuit
type 7 (ref `src/ecrecover/new_optimized.rs:870-1128`).

One row per scalar bit per ladder, 512 rows a call (u1 G, then u2 R):

  per row (committed u16 limbs as bytes, logUp byte-range-checked):
    base doubling      2 lam y + qb P == 3 x x + qa P,
                       lam^2 + qd P == x' + 2x + qc P,
                       lam x + qf P == lam x' + y' + y + qe P
    conditional add    (bit & !inf): the chord-law identities binding
                       (acc, base, a_lam, acc') with their own quotients
    selector algebra   s_set = bit inf, s_add = bit (1 - inf),
                       inf' = inf (1 - bit); copy / set rules for acc'
  transitions          base(next) = base'(cur), acc(next) = acc'(cur),
                       inf(next) = inf'(cur) within a ladder
  record stream        one phase-2 accumulator absorbs, per ladder, the
                       base point's bytes (first row), each scalar bit,
                       and (inf', the output's bytes) at the last row; the
                       verifier recomputes it from the plaintext per-call
                       claims.  Public: [final racc].

Scalar derivation, curve membership of R, the exception flags, the final
add, the address keccak and the ABI / memory binding stay with the
evaluator (models/ecrecover.py), as in the JAX package.

The constraints are the JAX module's in the same order; each identity's
carry chain is one group over its 33 positions, the limb products one
gather of anti-diagonals (air_common.conv).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import gf, secp256k1 as ec
from ..ops.gf import MODULUS
from ..utils.device import resolve_device
from .air_common import (Reg, byte_lookup_columns, byte_lookup_rows, carries_t, carry_chain,
                         challenge, conv, grp, host, limbs_t, linear_scan, lookup_diff)
from .stark import (AirSpec, StarkParams, StarkProof, _commit_columns, challenges_from_cap,
                    prove, verify)

BITS = 256
NL = 16        # value limbs
NQ = 17        # quotient limbs
N_POS = 33     # carry positions per identity
BIAS = 1 << 23
P_LIMBS = [(ec.P >> (16 * j)) & 0xFFFF for j in range(NL)]
NUM_PUBLIC = 1

_VALS = ["bx", "by", "ax", "ay", "bnx", "bny", "anx", "any"]
_DQ = ["dqa", "dqb", "dqc", "dqd", "dqe", "dqf"]
_AQ = ["aqa", "aqb", "aqc", "aqd", "aqe", "aqf"]
_NAMES = dict(bx="base_x", by="base_y", ax="acc_x", ay="acc_y", bnx="base_nx", bny="base_ny",
              anx="acc_nx", any="acc_ny", dl="d_lam", al="a_lam",
              **{q: q[0] + "_q" + q[2] for q in _DQ + _AQ})


@functools.lru_cache(maxsize=1)
def layout() -> Tuple[Reg, Reg, Reg]:
    fx = Reg()
    fx.add("t_byte"); fx.add("f_l0"); fx.add("f_ll")
    p1 = Reg()
    # flags first: the pad full-row copy starts AFTER ll (pad/fl/ll carry
    # unmasked fixed bindings of their own)
    p1.add("pad"); p1.add("fl"); p1.add("ll")
    p1.add("bit"); p1.add("inf"); p1.add("ninf")
    p1.add("s_set"); p1.add("s_add")
    for nm in _VALS:
        p1.add(nm + "_b", 2 * NL)
    p1.add("dl_b", 2 * NL)
    for nm in _DQ:
        p1.add(nm + "_b", 2 * NQ)
    p1.add("al_b", 2 * NL)
    for nm in _AQ:
        p1.add(nm + "_b", 2 * NQ)
    for nm in ("dc1", "dc2", "dc3", "ac1", "ac2", "ac3"):
        p1.add(nm + "_b", 3 * N_POS)
    p1.add("m_byte")
    p2 = Reg()
    p2.add("inv_qb", p1.index["m_byte"][0] - p1.index["bx_b"][0])
    p2.add("inv_tb")
    p2.add("lacc")
    p2.add("racc")
    return fx, p1, p2


_BQ0 = layout()[1].index["bx_b"][0]                 # first byte-query col
_N_BYTE_Q = layout()[1].index["m_byte"][0] - _BQ0   # all committed bytes

# the three doubling and three addition identities: terms ('pp', A, B,
# coef) limb products, ('qp', Q, coef) quotient times P, ('lin', A, coef)
_DOUBLE = [
    [("pp", "dl", "by", 2), ("qp", "dqb", 1), ("pp", "bx", "bx", -3), ("qp", "dqa", -1)],
    [("pp", "dl", "dl", 1), ("qp", "dqd", 1), ("lin", "bnx", -1), ("lin", "bx", -2),
     ("qp", "dqc", -1)],
    [("pp", "dl", "bx", 1), ("qp", "dqf", 1), ("pp", "dl", "bnx", -1), ("lin", "bny", -1),
     ("lin", "by", -1), ("qp", "dqe", -1)],
]
_ADD = [
    [("pp", "al", "bx", 1), ("lin", "ay", 1), ("qp", "aqb", 1), ("pp", "al", "ax", -1),
     ("lin", "by", -1), ("qp", "aqa", -1)],
    [("pp", "al", "al", 1), ("qp", "aqd", 1), ("lin", "anx", -1), ("lin", "ax", -1),
     ("lin", "bx", -1), ("qp", "aqc", -1)],
    [("pp", "al", "ax", 1), ("qp", "aqf", 1), ("pp", "al", "anx", -1), ("lin", "any", -1),
     ("lin", "ay", -1), ("qp", "aqe", -1)],
]


def _position_sums(terms, limbs, p_limbs) -> torch.Tensor:
    """(batch, N_POS) position sums of one identity's terms; `limbs(name)`
    gives a (batch, k) limb tensor."""
    acc = None
    for t in terms:
        if t[0] == "pp":
            x = conv(limbs(t[1]), limbs(t[2]), N_POS)
        elif t[0] == "qp":
            x = conv(limbs(t[1]), p_limbs, N_POS)
        else:
            a = limbs(t[1])
            x = torch.cat([a, torch.zeros_like(a[..., :1]).expand(
                tuple(a.shape[:-1]) + (N_POS - a.shape[-1],))], dim=-1)
        x = gf.mul_const(x, t[-1] % MODULUS)
        acc = x if acc is None else gf.add(acc, x)
    return acc


@functools.lru_cache(maxsize=1)
def ecrecover_air() -> AirSpec:
    fx, p1, p2 = layout()
    F, P1 = fx.n, p1.n

    def at(nm, j=0):
        return F + p1.at(nm, j)

    def at2(nm, j=0):
        return F + P1 + p2.at(nm, j)

    def byte_terms(row):
        return (row[..., F + _BQ0:F + _BQ0 + _N_BYTE_Q],
                row[..., at2("inv_qb"):at2("inv_qb") + _N_BYTE_Q], row[..., at2("inv_tb")])

    def identity(out, row, terms, carry_nm, mask=None):
        def limbs(nm):
            return limbs_t(row, at(nm + "_b"), NQ if nm in _DQ or nm in _AQ else NL)

        M = _position_sums(terms, limbs, gf.from_u64(P_LIMBS, row.device))
        rel, fin = carry_chain(M, carries_t(row, at(carry_nm + "_b"), N_POS), BIAS)
        if mask is not None:
            rel = gf.mul(mask.unsqueeze(-1), rel)
            fin = gf.mul(mask, fin)
        out.append(grp(rel))
        out.append(fin)

    def row_constraints(cur, ch):
        one = torch.ones_like(cur[..., 0])
        pad, fl, ll = cur[..., at("pad")], cur[..., at("fl")], cur[..., at("ll")]
        bit, inf, ninf = cur[..., at("bit")], cur[..., at("inf")], cur[..., at("ninf")]
        s_set, s_add = cur[..., at("s_set")], cur[..., at("s_add")]
        live = gf.sub(one, pad)
        # booleanity of the 8 flag columns
        flags = cur[..., F:F + 8]
        out = [grp(gf.mul(flags, gf.sub(flags, torch.ones_like(flags))))]
        # flag bindings (unmasked: pads force fl = ll = 0)
        out.append(gf.sub(fl, gf.mul(live, cur[..., fx.at("f_l0")])))
        out.append(gf.sub(ll, gf.mul(live, cur[..., fx.at("f_ll")])))
        # selector algebra
        out.append(gf.sub(s_set, gf.mul(bit, inf)))
        out.append(gf.sub(s_add, gf.mul(bit, gf.sub(one, inf))))
        out.append(gf.sub(ninf, gf.mul(inf, gf.sub(one, bit))))
        # ladder start: acc at infinity; infinity coords pinned to zero
        out.append(gf.mul(fl, gf.sub(inf, one)))
        ac = cur[..., at("ax_b"):at("ax_b") + 4 * NL]
        out.append(grp(gf.mul(inf.unsqueeze(-1), ac)))
        # acc' copy / set rules (bytewise, affine under the masks)
        an = cur[..., at("anx_b"):at("anx_b") + 4 * NL]
        bs = cur[..., at("bx_b"):at("bx_b") + 4 * NL]
        out.append(grp(gf.mul(gf.sub(one, bit).unsqueeze(-1), gf.sub(an, ac))))
        out.append(grp(gf.mul(s_set.unsqueeze(-1), gf.sub(an, bs))))
        # base doubling (every row; zero rows vanish), then the chord add
        # masked by s_add
        for terms, cn in zip(_DOUBLE, ("dc1", "dc2", "dc3")):
            identity(out, cur, terms, cn)
        for terms, cn in zip(_ADD, ("ac1", "ac2", "ac3")):
            identity(out, cur, terms, cn, mask=s_add)
        qb, invb, inv_tb = byte_terms(cur)
        out += byte_lookup_rows(qb, invb, inv_tb, cur[..., fx.at("t_byte")],
                                cur[..., at("m_byte")], ch[0])
        return out

    def constraints(cur, nxt, ch):
        one = torch.ones_like(cur[..., 0])
        pad_c, pad_n = cur[..., at("pad")], nxt[..., at("pad")]
        fl_c, ll_c = cur[..., at("fl")], cur[..., at("ll")]
        # pad monotone; pads start only at a ladder boundary
        out = [gf.mul(pad_c, gf.sub(one, pad_n)),
               gf.mul(gf.sub(pad_n, pad_c), gf.sub(one, nxt[..., fx.at("f_l0")]))]
        # pad full-row copy (flags pad/fl/ll excluded: own bindings)
        span = slice(at("bit"), F + P1)
        out.append(grp(gf.mul(pad_n.unsqueeze(-1), gf.sub(nxt[..., span], cur[..., span]))))
        # within-ladder state threading
        cn = gf.mul(gf.sub(one, pad_n), gf.sub(one, nxt[..., at("fl")]))
        w = 4 * NL
        d = torch.cat([gf.sub(nxt[..., at("bx_b"):at("bx_b") + w],
                              cur[..., at("bnx_b"):at("bnx_b") + w]),
                       gf.sub(nxt[..., at("ax_b"):at("ax_b") + w],
                              cur[..., at("anx_b"):at("anx_b") + w])], dim=-1)
        out.append(grp(gf.mul(cn.unsqueeze(-1), d)))
        out.append(gf.mul(cn, gf.sub(nxt[..., at("inf")], cur[..., at("ninf")])))
        # ---- record stream (phase 2) ----
        G, contrib = _record_step(cur, F, challenge(ch, 1))
        out.append(gf.sub(nxt[..., at2("racc")], gf.add(gf.mul(cur[..., at2("racc")], G),
                                                        contrib)))
        # logUp accumulator transition
        _, invb, inv_tb = byte_terms(nxt)
        out.append(gf.sub(gf.sub(nxt[..., at2("lacc")], cur[..., at2("lacc")]),
                          lookup_diff(invb, inv_tb)))
        return out

    def first_row(row, public, ch):
        _, invb, inv_tb = byte_terms(row)
        return [row[..., at("pad")], row[..., at2("racc")],
                gf.sub(row[..., at2("lacc")], lookup_diff(invb, inv_tb))]

    def last_row(row, public, ch):
        return [gf.sub(row[..., at2("racc")], public[0]), row[..., at2("lacc")]]

    return AirSpec(
        num_cols=P1,
        max_degree=3,
        constraints=constraints,
        row_constraints=row_constraints,
        first_row=first_row,
        last_row=last_row,
        num_public=NUM_PUBLIC,
        num_fixed_cols=fx.n,
        num_phase2_cols=p2.n,
        num_challenges=2,
    )


def _record_step(rows: torch.Tensor, F: int, gamma: int):
    """The record accumulator's step at each row, racc' = racc G + contrib:
    G = 1 + live (g - 1) + fl (g^65 - g) + ll (g^66 - g); contrib = bit on a
    live row that is not a ladder's last, plus the base bytes at g^64..g^1
    on its first row, plus g^65 bit + g^64 inf' + the output bytes at
    g^63..g^0 on its last."""
    _, p1, _ = layout()

    def col(nm):
        return rows[..., F + p1.at(nm)]

    dev = rows.device
    one = torch.ones_like(col("pad"))
    pad, fl, ll, bit = col("pad"), col("fl"), col("ll"), col("bit")
    live = gf.sub(one, pad)
    gp = [pow(gamma, k, MODULUS) for k in range(67)]
    G = gf.add(one, gf.mul_const(live, gp[1] - 1))
    G = gf.add(G, gf.mul_const(fl, gp[65] - gp[1]))
    G = gf.add(G, gf.mul_const(ll, gp[66] - gp[1]))
    contrib = gf.mul(gf.sub(live, ll), bit)
    s0, s1 = F + p1.at("bx_b"), F + p1.at("anx_b")
    w_fl = gf.from_u64(np.array(gp[64:0:-1], np.uint64), dev)
    contrib = gf.add(contrib, gf.mul(fl, gf.dot_mod(rows[..., s0:s0 + 4 * NL], w_fl)))
    w_ll = gf.from_u64(np.array(gp[63::-1], np.uint64), dev)
    ll_sum = gf.add(gf.mul_const(bit, gp[65]), gf.mul_const(col("ninf"), gp[64]))
    ll_sum = gf.add(ll_sum, gf.dot_mod(rows[..., s1:s1 + 4 * NL], w_ll))
    return G, gf.add(contrib, gf.mul(ll, ll_sum))


def fixed_cols(n: int, device=None) -> torch.Tensor:
    """The fixed columns on `device` (None: the card)."""
    r = np.arange(n)
    return gf.from_u64(np.stack([(r % 256).astype(np.uint64),
                                 (r % BITS == 0).astype(np.uint64),
                                 (r % BITS == BITS - 1).astype(np.uint64)]),
                       resolve_device(device))


def _bytes_rows(limbs: np.ndarray) -> np.ndarray:
    """(R, nl) u16 -> (R, 2 nl) bytes [lo0, hi0, ...]."""
    out = np.empty((limbs.shape[0], 2 * limbs.shape[1]), np.int64)
    out[:, 0::2] = limbs & 0xFF
    out[:, 1::2] = (limbs >> 8) & 0xFF
    return out


def _ident_carries(terms, st: dict) -> np.ndarray:
    """(R, N_POS) carries of the telescoped position sums of one identity
    (must close at 0); st maps the short names to (R, k) int64 limbs."""
    R = next(iter(st.values())).shape[0]
    M = np.zeros((R, N_POS), np.int64)
    for t in terms:
        if t[0] == "pp":
            A, B = st[t[1]], st[t[2]]
            for a in range(A.shape[1]):
                M[:, a:a + B.shape[1]] += t[3] * A[:, a:a + 1] * B
        elif t[0] == "qp":
            Q = st[t[1]]
            for a in range(Q.shape[1]):
                M[:, a:a + NL] += t[2] * Q[:, a:a + 1] * np.asarray(P_LIMBS, np.int64)[None]
        else:
            A = st[t[1]]
            M[:, :A.shape[1]] += t[2] * A
    out = np.zeros((R, N_POS), np.int64)
    prev = np.zeros(R, np.int64)
    for j in range(N_POS):
        curv = M[:, j] + prev
        assert (curv % (1 << 16) == 0).all(), f"identity not divisible at {j}"
        curv >>= 16
        out[:, j] = curv
        prev = curv
    assert (prev == 0).all(), "identity does not close"
    return out


def _carry_bytes_rows(vals: np.ndarray) -> np.ndarray:
    """(R, N_POS) carries -> (R, 3 N_POS) biased bytes."""
    b = vals + BIAS
    assert (b >= 0).all() and (b < (1 << 24)).all(), "carry out of range"
    out = np.empty((vals.shape[0], 3 * N_POS), np.int64)
    out[:, 0::3] = b & 0xFF
    out[:, 1::3] = (b >> 8) & 0xFF
    out[:, 2::3] = b >> 16
    return out


def build_ecrecover_trace(w, device=None):
    """(fixed, phase1, log_n) from an EcrecoverWitness's step columns (the
    port's or the JAX package's), the columns on `device` (None: the
    card)."""
    device = resolve_device(device)
    fx, p1, p2 = layout()
    st_raw = {k: host(v).astype(np.int64) for k, v in w.steps.items()}
    R = st_raw["bit"].shape[0]
    assert R % (2 * BITS) == 0
    n = 1 << max(8, R.bit_length())  # >= R + 1 (at least one pad row)
    rows = np.zeros((n, p1.n), np.uint32)

    bit, inf, ninf = st_raw["bit"], st_raw["acc_inf"], st_raw["acc_ninf"]
    rows[:R, p1.at("bit")] = bit
    rows[:R, p1.at("inf")] = inf
    rows[:R, p1.at("ninf")] = ninf
    rows[:R, p1.at("s_set")] = bit * inf
    rows[:R, p1.at("s_add")] = bit * (1 - inf)
    rows[:R, p1.at("fl")] = np.arange(R) % BITS == 0
    rows[:R, p1.at("ll")] = np.arange(R) % BITS == BITS - 1
    st = {short: st_raw[full] for short, full in _NAMES.items()}
    for short in st:
        rows[:R, p1.sl(short + "_b")] = _bytes_rows(st[short])

    # carry chains (add identities only on s_add rows; zeroed elsewhere)
    for terms, cn in zip(_DOUBLE, ("dc1", "dc2", "dc3")):
        rows[:R, p1.sl(cn + "_b")] = _carry_bytes_rows(_ident_carries(terms, st))
    sadd = (bit * (1 - inf))[:, None]
    masked = dict(st)
    for k in ("ax", "ay", "anx", "any", "al", "bx", "by"):
        masked[k] = st[k] * sadd
    for terms, cn in zip(_ADD, ("ac1", "ac2", "ac3")):
        rows[:R, p1.sl(cn + "_b")] = _carry_bytes_rows(_ident_carries(terms, masked))
    # pad rows: replicate the last live row, then fix the flags
    rows[R:] = rows[R - 1]
    rows[R:, p1.at("pad")] = 1
    rows[R:, p1.at("fl")] = 0
    rows[R:, p1.at("ll")] = 0
    # byte multiplicities
    counts = np.bincount(rows[:, _BQ0:_BQ0 + _N_BYTE_Q].reshape(-1), minlength=256)
    rows[:, p1.at("m_byte")] = 0
    rows[:256, p1.at("m_byte")] = counts
    phase1 = (torch.from_numpy(rows.view(np.int32)).to(device).to(torch.int64)
              & 0xFFFFFFFF).T.contiguous()
    return fixed_cols(n, device), phase1, n.bit_length() - 1


def _build_phase2(trace: torch.Tensor, ch_ints) -> torch.Tensor:
    """The phase-2 columns from [fixed | phase1] (m, n)."""
    fx, p1, _ = layout()
    F = fx.n
    inv_qb, inv_tb, lacc = byte_lookup_columns(trace[F + _BQ0:F + _BQ0 + _N_BYTE_Q],
                                               trace[fx.at("t_byte")],
                                               trace[F + p1.at("m_byte")], int(ch_ints[0]))
    # racc BEFORE the row, absorbed per the AIR's rule
    G, contrib = _record_step(trace.T, F, int(ch_ints[1]))
    after = linear_scan(G, contrib)
    racc = torch.cat([torch.zeros_like(after[:1]), after[:-1]])
    return torch.cat([inv_qb, torch.stack([inv_tb, lacc, racc])])


# ---------------------------------------------------------------------------
# verifier-side record recomputation (plaintext claims)
# ---------------------------------------------------------------------------


def _point_bytes(x: int, y: int) -> List[int]:
    out = []
    for v in (x, y):
        for j in range(NL):
            limb = (v >> (16 * j)) & 0xFFFF
            out += [limb & 0xFF, limb >> 8]
    return out


def ladder_records(calls_public: Sequence[dict]) -> List[dict]:
    """calls_public: per trace call slot (padded dummy calls included):
    {active: bool, u1, u2: int, R: (x, y) | None, acc1: (x, y) | None,
     acc2: (x, y) | None}, the claims the evaluator separately binds to the
    ABI words.  Returns one record dict per ladder, in trace order."""
    records = []
    for cp in calls_public:
        if not cp.get("active", False):
            records += [dict(base=(0, 0), bits=[0] * BITS, inf=1, out=(0, 0)) for _ in range(2)]
            continue
        for scalar, base, acc in ((cp["u1"], (ec.GX, ec.GY), cp["acc1"]),
                                  (cp["u2"], cp["R"], cp["acc2"])):
            records.append(dict(base=base, bits=[(scalar >> i) & 1 for i in range(BITS)],
                                inf=int(acc is None), out=acc if acc is not None else (0, 0)))
    return records


def records_rlc(records: Sequence[dict], gamma: int) -> int:
    a = 0
    for rec in records:
        for v in (_point_bytes(*rec["base"]) + list(rec["bits"]) + [rec["inf"]]
                  + _point_bytes(*rec["out"])):
            a = (a * gamma + int(v)) % MODULUS
    return a


def calls_public_from_witness(w) -> List[dict]:
    """The per-call plaintext claims of an EcrecoverWitness (the port's or
    the JAX package's).  Deterministic in the witness; the evaluator binds
    the same values to the ABI / memory tape (models/ecrecover.py
    eval_constraints)."""
    u1s, u2s = host(w.scalars["u1"]), host(w.scalars["u2"])
    exe = host(w.step_execute)
    bx, by = host(w.steps["base_x"]), host(w.steps["base_y"])
    pts = {k: host(w.points[k]) for k in ("acc1x", "acc1y", "acc2x", "acc2y")}

    def ival(limbs):
        return sum(int(v) << (16 * j) for j, v in enumerate(limbs))

    out = []
    for ci in range(u1s.shape[0]):
        if not bool(exe[ci * 2 * BITS]):
            out.append(dict(active=False))
            continue
        u1, u2 = ival(u1s[ci]), ival(u2s[ci])
        # R.x may be rx + n (the x_overflow branch): read the committed
        # ladder base of the second ladder instead; the evaluator binds it
        r2 = ci * 2 * BITS + BITS
        out.append(dict(active=True, u1=u1, u2=u2, R=(ival(bx[r2]), ival(by[r2])),
                        acc1=None if u1 == 0 else (ival(pts["acc1x"][ci]), ival(pts["acc1y"][ci])),
                        acc2=(ival(pts["acc2x"][ci]), ival(pts["acc2y"][ci]))))
    return out


# ---------------------------------------------------------------------------
# prove / verify
# ---------------------------------------------------------------------------


def prove_ecrecover(w, params: Optional[StarkParams] = None, device=None
                    ) -> Tuple[StarkProof, List[dict], StarkParams]:
    """Prove the witness's ladders on `device` (None: the card).  Returns
    (proof, calls_public, params)."""
    fixed, phase1, log_n = build_ecrecover_trace(w, device)
    if params is None:
        params = StarkParams(log_n=log_n)
    air = ecrecover_air()
    ftree = _commit_columns(fixed, params)
    ptree = _commit_columns(phase1, params)
    ch, _ = challenges_from_cap(ptree["cap"], air, ftree["cap"])
    calls_public = calls_public_from_witness(w)
    acc = records_rlc(ladder_records(calls_public), int(ch[1]))
    public = gf.from_u64(np.array([acc], np.uint64), phase1.device)
    proof = prove(phase1, air, params, public, build_phase2=_build_phase2, fixed_cols=fixed,
                  phase1_tree=ptree)
    return proof, calls_public, params


def verify_ecrecover(proof: StarkProof, calls_public: Sequence[dict],
                     params: StarkParams) -> bool:
    """calls_public: plaintext per-call claims (see ladder_records).  The
    proof's own `params` are trusted, as in the JAX package (ROADMAP Queue
    3)."""
    n = 1 << params.log_n
    if 2 * BITS * len(calls_public) >= n:
        return False
    air = ecrecover_air()
    dev = proof.q_cap.device
    fixed = fixed_cols(n, dev)
    fcap = _commit_columns(fixed, params)["cap"]
    if len(proof.caps) != 3:
        return False
    ch, _ = challenges_from_cap(proof.caps[1], air, fcap)
    acc = records_rlc(ladder_records(calls_public), int(ch[1]))
    public = gf.from_u64(np.array([acc], np.uint64), dev)
    return verify(proof, air, params, public, fixed_cols=fixed)
