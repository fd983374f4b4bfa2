"""FRI verifier as an AIR (the JAX package's `prover/verifier_air.py`, on
torch tensors): a STARK that proves the query-phase verification of a batch
of child FRI proofs, the node-level step of the recursion tree (ref
`src/recursion/node_layer/mod.rs:193-249`: pop query -> verify -> bind the
public input).

  * every Merkle authentication (leaf hash, path compressions) is a
    Poseidon2 permutation row held by the S-box relations of
    prover/poseidon2_air.py;
  * the fold arithmetic of each layer (v' = (a + b)/2 + beta (a - b)/(2x)
    in GF(p^2) through committed odd parts), the reappear checks between
    layers, the index bits and the final polynomial's value are field
    constraints over carried accumulator columns;
  * the point x = shift w^i is built along the path rows from the same
    committed bits that steer the siblings;
  * the Fiat-Shamir replay: each transcript absorb and squeeze is a
    permutation row, so a forged challenge breaks the proof.

PUBLIC inputs, all recomputable from the children's public data: per
(child, layer) the Merkle cap (cap_log2 = 1: 2 x 4 lanes) and beta; per
(child, query) the query index and the layer-0 pair; per child the final
polynomial.  The query-index derivation and the DEEP binding of the
layer-0 values stay outer checks, as in the JAX package.

Row schedule (fixed columns, one permutation a row): per child the
transcript rows (3 a layer, one for the final polynomial), then per query
and layer a LEAF row (the pair absorbed with capacity (0, 0, 0, 4)) and its
PATH rows (a compression each; the last carries the cap select, the
x-inverse certificate and the fold).  Padding replicates the last live row.

The trace builder is host numpy, a python loop over the 2^12 rows of 16
children, with the permutations batched by their position in a path; the
constraints are the JAX module's in the same order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import fri, gf, gf2, ntt
from ..ops.fri import FriParams, FriProof
from ..ops.gf import MODULUS
from ..runtime import native
from ..utils.device import resolve_device
from .air_common import grp
from .poseidon2_air import PermCols, _perm_rows, fold_perm_constraints
from .stark import AirSpec, StarkParams, StarkProof, _alpha_sum, prove, verify

_HALF = pow(2, MODULUS - 2, MODULUS)
_W_NR = gf2.W_NONRESIDUE


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static row plan for a batch of child FRI proofs (hashable: the AIR
    and the fixed columns are cached by schedule)."""

    fri_params: Tuple[FriParams, ...]   # per child
    rows: tuple                         # row descriptors
    n: int                              # padded trace length
    num_public: int
    # public slot offsets
    off_caps: tuple                     # per (child, layer): cap, 8 lanes
    off_beta: tuple                     # per (child, layer): beta, 2
    off_idx: tuple                      # per (child, query): index
    off_leaf0: tuple                    # per (child, query): 4 values
    off_final: tuple                    # per child: 2 * final_deg_len


def _layers_of(p: FriParams) -> List[dict]:
    """Per-layer structure: domain log, depth, shift, root."""
    out = []
    shift = p.coset_shift
    log_n = p.log_domain
    while log_n > p.final_poly_log_len:
        out.append(dict(log_n=log_n, depth=log_n - 1 - p.cap_log2, shift=shift,
                        w=ntt.root_of_unity(log_n)))
        shift = shift * shift % MODULUS
        log_n -= 1
    return out


@functools.lru_cache(maxsize=8)
def build_schedule(fri_params: Tuple[FriParams, ...]) -> Schedule:
    rows = []
    off_caps, off_beta, off_idx, off_leaf0, off_final = [], [], [], [], []
    pub = 0
    for c, p in enumerate(fri_params):
        assert p.cap_log2 == 1, "verifier AIR assumes cap_log2 = 1"
        layers = _layers_of(p)
        fdl = 1 << max(p.final_poly_log_len - p.log_blowup, 0)
        assert fdl <= 2, "final poly eval supports degree < 2 only"
        caps_c, beta_c = [], []
        for _ in layers:
            caps_c.append(pub); pub += 8
            beta_c.append(pub); pub += 2
        off_caps.append(tuple(caps_c))
        off_beta.append(tuple(beta_c))
        idx_c, leaf_c = [], []
        for _ in range(p.num_queries):
            idx_c.append(pub); pub += 1
            leaf_c.append(pub); pub += 4
        off_idx.append(tuple(idx_c))
        off_leaf0.append(tuple(leaf_c))
        off_final.append(pub); pub += 4
        nlayers = len(layers)
        sfinal = layers[-1]["shift"] ** 2 % MODULUS
        wf = ntt.root_of_unity(p.final_poly_log_len)
        # the Fiat-Shamir replay: per layer the transcript absorbs the cap
        # (2 permutation rows: hash_padded of state || cap) and squeezes
        # beta (1 row); then one row absorbs the final polynomial
        for l in range(nlayers):
            rows.append(dict(kind="tabs1", child=c, q=0, layer=l, tfirst=(l == 0)))
            rows.append(dict(kind="tabs2", child=c, q=0, layer=l))
            rows.append(dict(kind="tsqz", child=c, q=0, layer=l))
        rows.append(dict(kind="tfin", child=c, q=0, layer=0, fdl=fdl))
        for q in range(p.num_queries):
            for l, lay in enumerate(layers):
                rows.append(dict(kind="leaf", child=c, q=q, layer=l, first=(l == 0), lay=lay,
                                 fshift=sfinal if l == nlayers - 1 else 1))
                for k in range(lay["depth"]):
                    last = k == lay["depth"] - 1
                    rows.append(dict(
                        kind="path", child=c, q=q, layer=l, k=k, lay=lay, last=last,
                        last0=(last and l == 0), lastF=(last and l == nlayers - 1),
                        lastNF=(last and 0 < l),
                        wstep=pow(lay["w"], 1 << k, MODULUS),
                        wfstep=pow(wf, 1 << k, MODULUS) if l == nlayers - 1 else 1,
                        capw=1 << lay["depth"],
                        wcap=pow(lay["w"], 1 << lay["depth"], MODULUS),
                        wfcap=pow(wf, 1 << lay["depth"], MODULUS) if l == nlayers - 1 else 1))
    n = 1 << max(4, (len(rows) - 1).bit_length())
    return Schedule(fri_params=tuple(fri_params),
                    rows=tuple(tuple(sorted(r.items(), key=lambda kv: kv[0])) for r in rows),
                    n=n, num_public=pub, off_caps=tuple(off_caps), off_beta=tuple(off_beta),
                    off_idx=tuple(off_idx), off_leaf0=tuple(off_leaf0),
                    off_final=tuple(off_final))


def _row_dicts(sched: Schedule) -> List[dict]:
    return [dict(r) for r in sched.rows]


# ---------------------------------------------------------------------------
# columns
# ---------------------------------------------------------------------------


class _Cols:
    def __init__(self):
        i = 0
        self.pad = i; i += 1
        # committed row-type flags (live-bound to the fixed schedule)
        for nm in ("cleaf", "cpath", "clast", "clast0", "clastF", "clastNF", "creent", "ctab1",
                   "ctab2", "ctsqz", "ctfin"):
            setattr(self, nm, i); i += 1
        self.bit = i; i += 1
        self.capb = i; i += 1
        self.perm = PermCols(i); i = self.perm.end
        self.qa = slice(i, i + 4); i += 4
        self.fv = slice(i, i + 2); i += 2
        self.od = slice(i, i + 2); i += 2
        self.beta = slice(i, i + 2); i += 2
        for nm in ("iacc", "iprev", "xacc", "xfacc", "xinv", "wmul", "wfmul", "wfcmul", "wcmul",
                   "xcf", "xff"):
            setattr(self, nm, i); i += 1
        self.num_phase1 = i


@functools.lru_cache(maxsize=1)
def _cols() -> _Cols:
    return _Cols()


class _Fix:
    """The fixed-column layout; the selector banks sized by schedule."""

    def __init__(self, n_lsel: int, n_qsel: int, n_csel: int):
        i = 0
        for nm in ("f_leaf", "f_path", "f_last", "f_last0", "f_lastF", "f_lastNF", "f_first",
                   "f_reent", "f_pad", "f_tab1", "f_tab2", "f_tsqz", "f_tfin", "f_tfirst",
                   "f_treent", "f_fdl2", "f_pw2", "f_capw", "f_shift", "f_fshift", "f_wstep",
                   "f_wfstep", "f_wfcap", "f_wcap", "f_tlen"):
            setattr(self, nm, i); i += 1
        self.lsel = slice(i, i + n_lsel); i += n_lsel
        self.qsel = slice(i, i + n_qsel); i += n_qsel
        self.csel = slice(i, i + n_csel); i += n_csel
        self.num_fixed = i


def _fix_of(sched: Schedule) -> _Fix:
    return _Fix(sum(len(x) for x in sched.off_caps), sum(len(x) for x in sched.off_idx),
                len(sched.fri_params))


def _slot_maps(sched: Schedule):
    """Flat (child, layer) -> lsel slot and (child, q) -> qsel slot."""
    lmap, qmap = {}, {}
    for c in range(len(sched.fri_params)):
        for l in range(len(sched.off_caps[c])):
            lmap[(c, l)] = len(lmap)
        for q in range(len(sched.off_idx[c])):
            qmap[(c, q)] = len(qmap)
    return lmap, qmap


def fixed_columns(sched: Schedule, device=None) -> torch.Tensor:
    """The schedule's fixed columns (the verifying key) on `device` (None:
    the card)."""
    fx = _fix_of(sched)
    lmap, qmap = _slot_maps(sched)
    out = np.zeros((fx.num_fixed, sched.n), np.uint64)
    out[fx.f_pad, len(sched.rows):] = 1
    for nm in ("f_shift", "f_fshift", "f_wstep", "f_wfstep", "f_wfcap", "f_wcap"):
        out[getattr(fx, nm)] = 1
    for i, r in enumerate(_row_dicts(sched)):
        c = r["child"]
        if r["kind"] == "tabs1":
            out[fx.f_tab1, i] = 1
            out[fx.f_tfirst if r["tfirst"] else fx.f_treent, i] = 1
        elif r["kind"] == "tabs2":
            out[fx.f_tab2, i] = 1
        elif r["kind"] == "tsqz":
            out[fx.f_tsqz, i] = 1
        elif r["kind"] == "tfin":
            out[fx.f_tfin, i] = 1
            out[fx.f_tlen, i] = 4 + 2 * r["fdl"]
            if r["fdl"] == 2:
                out[fx.f_fdl2, i] = 1
        elif r["kind"] == "leaf":
            out[fx.f_leaf, i] = 1
            out[fx.f_first if r["first"] else fx.f_reent, i] = 1
            out[fx.f_shift, i] = r["lay"]["shift"]
            out[fx.f_fshift, i] = r["fshift"]
        else:
            out[fx.f_path, i] = 1
            out[fx.f_pw2, i] = 1 << r["k"]
            out[fx.f_wstep, i] = r["wstep"]
            out[fx.f_wfstep, i] = r["wfstep"]
            if r["last"]:
                out[fx.f_last, i] = 1
                out[fx.f_capw, i] = r["capw"]
                out[fx.f_wcap, i] = r["wcap"]
                out[fx.f_wfcap, i] = r["wfcap"]
            for key, col in (("last0", fx.f_last0), ("lastF", fx.f_lastF),
                             ("lastNF", fx.f_lastNF)):
                if r.get(key):
                    out[col, i] = 1
        out[fx.lsel.start + lmap[(c, r["layer"])], i] = 1
        out[fx.qsel.start + qmap[(c, r["q"])], i] = 1
        out[fx.csel.start + c, i] = 1
    return gf.from_u64(out, resolve_device(device))


# ---------------------------------------------------------------------------
# the AIR
# ---------------------------------------------------------------------------


def verifier_air(sched: Schedule) -> AirSpec:
    return _verifier_air(sched.fri_params)


@functools.lru_cache(maxsize=8)
def _verifier_air(fri_params: Tuple[FriParams, ...]) -> AirSpec:
    sched = build_schedule(fri_params)
    c = _cols()
    fx = _fix_of(sched)
    F = fx.num_fixed
    lmap, qmap = _slot_maps(sched)

    # the public gather matrices: lsel / qsel / csel-weighted sums of slots
    n_lsel = fx.lsel.stop - fx.lsel.start
    n_qsel = fx.qsel.stop - fx.qsel.start
    cap_lo_ix = np.zeros((n_lsel, 4), np.int64)
    cap_hi_ix = np.zeros((n_lsel, 4), np.int64)
    beta_ix = np.zeros((n_lsel, 2), np.int64)
    for (ch_, l), s in lmap.items():
        cap_lo_ix[s] = np.arange(sched.off_caps[ch_][l], sched.off_caps[ch_][l] + 4)
        cap_hi_ix[s] = np.arange(sched.off_caps[ch_][l] + 4, sched.off_caps[ch_][l] + 8)
        beta_ix[s] = np.arange(sched.off_beta[ch_][l], sched.off_beta[ch_][l] + 2)
    idx_ix = np.zeros(n_qsel, np.int64)
    leaf0_ix = np.zeros((n_qsel, 4), np.int64)
    for (ch_, q), s in qmap.items():
        idx_ix[s] = sched.off_idx[ch_][q]
        leaf0_ix[s] = np.arange(sched.off_leaf0[ch_][q], sched.off_leaf0[ch_][q] + 4)
    fin_ix = np.array([[b, b + 1, b + 2, b + 3] for b in sched.off_final], np.int64)
    pc_abs = PermCols(F + c.perm.chunk.start)

    def cc(row, i):
        return row[..., F + i]

    def fxc(row, i):
        return row[..., i]

    def span(row, s: slice):
        return row[..., F + s.start:F + s.stop]

    def _pubsel(cur, public, sel_slice, pub_ix):
        """sum_s sel_s(row) public[pub_ix[s]]: degree 1 in trace cells."""
        sel = cur[..., sel_slice]
        pv = public[torch.as_tensor(pub_ix.reshape(-1), device=public.device)].reshape(
            pub_ix.shape)
        if pub_ix.ndim == 1:
            return gf.sum_mod(gf.mul(sel, pv))
        return gf.sum_mod(gf.mul(sel.unsqueeze(-1), pv), dim=-2)  # (batch, k)

    def compose_row_pub(cur, public, ch, alpha, a_pow):
        dev = cur.device
        one = torch.ones((), dtype=torch.int64, device=dev)
        half = gf.constant(_HALF, dev)

        def _not(x):
            return gf.sub(one, x)

        vals = []
        pad = cc(cur, c.pad)
        live = _not(pad)
        # booleanity
        for i in (c.pad, c.cleaf, c.cpath, c.clast, c.clast0, c.clastF, c.clastNF, c.creent,
                  c.ctab1, c.ctab2, c.ctsqz, c.ctfin, c.bit, c.capb):
            v = cc(cur, i)
            vals.append(gf.mul(v, gf.sub(v, one)))
        # padding is schedule-determined: pad == f_pad
        vals.append(gf.sub(pad, fxc(cur, fx.f_pad)))
        # flag bindings to the fixed schedule
        for ci, fi in ((c.cleaf, fx.f_leaf), (c.cpath, fx.f_path), (c.clast, fx.f_last),
                       (c.clast0, fx.f_last0), (c.clastF, fx.f_lastF),
                       (c.clastNF, fx.f_lastNF), (c.creent, fx.f_reent), (c.ctab1, fx.f_tab1),
                       (c.ctab2, fx.f_tab2), (c.ctsqz, fx.f_tsqz), (c.ctfin, fx.f_tfin)):
            vals.append(gf.sub(cc(cur, ci), gf.mul(live, fxc(cur, fi))))
        cleaf, clast, capb = cc(cur, c.cleaf), cc(cur, c.clast), cc(cur, c.capb)
        out12 = span(cur, c.perm.out)
        chunk = span(cur, c.perm.chunk)
        carry = span(cur, c.perm.carry)
        qa = span(cur, c.qa)
        # leaf rows: sponge capacity (0, 0, 0, 4), the pair's chunk layout,
        # the qa / iacc / xacc / xfacc inits
        for k in range(3):
            vals.append(gf.mul(cleaf, carry[..., k]))
        vals.append(gf.mul(cleaf, gf.sub(carry[..., 3], gf.constant(4, dev))))
        for k in range(4):
            vals.append(gf.mul(cleaf, chunk[..., 4 + k]))
        vals.append(gf.mul(cleaf, cc(cur, c.iacc)))
        vals.append(gf.mul(cleaf, gf.sub(cc(cur, c.xacc), fxc(cur, fx.f_shift))))
        vals.append(gf.mul(cleaf, gf.sub(cc(cur, c.xfacc), fxc(cur, fx.f_fshift))))
        for k in range(4):
            vals.append(gf.mul(cleaf, gf.sub(qa[..., k], chunk[..., k])))
        # the layer-0 leaf values are PUBLIC
        first = fxc(cur, fx.f_first)
        leaf0 = _pubsel(cur, public, fx.qsel, leaf0_ix)
        for k in range(4):
            vals.append(gf.mul(first, gf.sub(chunk[..., k], leaf0[..., k])))
        # path rows: compression carries zero
        cpath = cc(cur, c.cpath)
        for k in range(4):
            vals.append(gf.mul(cpath, carry[..., k]))
        # the x-accumulator step factors
        bit = cc(cur, c.bit)
        vals.append(gf.mul(cpath, gf.sub(cc(cur, c.wmul),
                                         gf.add(_not(bit), gf.mul(bit, fxc(cur, fx.f_wstep))))))
        vals.append(gf.mul(cpath, gf.sub(cc(cur, c.wfmul),
                                         gf.add(_not(bit), gf.mul(bit, fxc(cur, fx.f_wfstep))))))
        vals.append(gf.mul(clast, gf.sub(cc(cur, c.wfcmul),
                                         gf.add(_not(capb), gf.mul(capb, fxc(cur, fx.f_wfcap))))))
        vals.append(gf.mul(clast, gf.sub(cc(cur, c.wcmul),
                                         gf.add(_not(capb), gf.mul(capb, fxc(cur, fx.f_wcap))))))
        # the fold point includes the cap-select bit: x = shift w^{i_full}
        vals.append(gf.mul(clast, gf.sub(cc(cur, c.xcf),
                                         gf.mul(cc(cur, c.xacc), cc(cur, c.wcmul)))))
        # last path row: cap equality, x inverse, fold
        cap_lo = _pubsel(cur, public, fx.lsel, cap_lo_ix)
        cap_hi = _pubsel(cur, public, fx.lsel, cap_hi_ix)
        for k in range(4):
            want = gf.add(gf.mul(_not(capb), cap_lo[..., k]), gf.mul(capb, cap_hi[..., k]))
            vals.append(gf.mul(clast, gf.sub(out12[..., k], want)))
        vals.append(gf.mul(clast, gf.sub(gf.mul(cc(cur, c.xcf), cc(cur, c.xinv)), one)))
        # odd parts: od = half (a - b) xinv, componentwise in GF(p^2)
        od = span(cur, c.od)
        hx = gf.mul(half, cc(cur, c.xinv))
        vals.append(gf.mul(clast, gf.sub(od[..., 0], gf.mul(gf.sub(qa[..., 0], qa[..., 2]), hx))))
        vals.append(gf.mul(clast, gf.sub(od[..., 1], gf.mul(gf.sub(qa[..., 1], qa[..., 3]), hx))))
        # beta binding + fold value
        beta_pub = _pubsel(cur, public, fx.lsel, beta_ix)
        betac = span(cur, c.beta)
        vals.append(gf.mul(clast, gf.sub(betac[..., 0], beta_pub[..., 0])))
        vals.append(gf.mul(clast, gf.sub(betac[..., 1], beta_pub[..., 1])))
        fv = span(cur, c.fv)
        ev0 = gf.mul(half, gf.add(qa[..., 0], qa[..., 2]))
        ev1 = gf.mul(half, gf.add(qa[..., 1], qa[..., 3]))
        f0 = gf.add(ev0, gf.add(gf.mul(betac[..., 0], od[..., 0]),
                                gf.mul_const(gf.mul(betac[..., 1], od[..., 1]), _W_NR)))
        f1 = gf.add(ev1, gf.add(gf.mul(betac[..., 0], od[..., 1]),
                                gf.mul(betac[..., 1], od[..., 0])))
        vals.append(gf.mul(clast, gf.sub(fv[..., 0], f0)))
        vals.append(gf.mul(clast, gf.sub(fv[..., 1], f1)))
        # the layer-0 index public: iacc + capb capw == the public index
        idxp = _pubsel(cur, public, fx.qsel, idx_ix)
        ifull = gf.add(cc(cur, c.iacc), gf.mul(capb, fxc(cur, fx.f_capw)))
        vals.append(gf.mul(cc(cur, c.clast0), gf.sub(ifull, idxp)))
        # later layers: the full index == the carried iprev
        vals.append(gf.mul(cc(cur, c.clastNF), gf.sub(ifull, cc(cur, c.iprev))))
        # the final layer: fold == final_poly(x_f)
        clastF = cc(cur, c.clastF)
        vals.append(gf.mul(clastF, gf.sub(cc(cur, c.xff),
                                          gf.mul(cc(cur, c.xfacc), cc(cur, c.wfcmul)))))
        fin = _pubsel(cur, public, fx.csel, fin_ix)   # (batch, 4)
        p0 = gf.add(fin[..., 0], gf.mul(fin[..., 1], cc(cur, c.xff)))
        p1 = gf.add(fin[..., 2], gf.mul(fin[..., 3], cc(cur, c.xff)))
        vals.append(gf.mul(clastF, gf.sub(fv[..., 0], p0)))
        vals.append(gf.mul(clastF, gf.sub(fv[..., 1], p1)))
        # ---- the Fiat-Shamir replay rows ----
        # tabs1 absorbs [state | cap_lo] with capacity (0, 0, 0, 12)
        # (ops/fri.Transcript.absorb = hash_padded(state || cap), 12 lanes)
        ctab1, ctab2 = cc(cur, c.ctab1), cc(cur, c.ctab2)
        ctsqz, ctfin = cc(cur, c.ctsqz), cc(cur, c.ctfin)
        for k in range(3):
            vals.append(gf.mul(ctab1, carry[..., k]))
            vals.append(gf.mul(ctfin, carry[..., k]))
        vals.append(gf.mul(ctab1, gf.sub(carry[..., 3], gf.constant(12, dev))))
        vals.append(gf.mul(ctfin, gf.sub(carry[..., 3], fxc(cur, fx.f_tlen))))
        for k in range(4):
            vals.append(gf.mul(ctsqz, carry[..., k]))
            # tabs1 absorbs cap_lo in chunk lanes 4..8; tabs2 cap_hi in
            # lanes 0..4 and zero-pads 4..8; tsqz zero-pads 4..8
            vals.append(gf.mul(ctab1, gf.sub(chunk[..., 4 + k], cap_lo[..., k])))
            vals.append(gf.mul(ctab2, gf.sub(chunk[..., k], cap_hi[..., k])))
            vals.append(gf.mul(ctab2, chunk[..., 4 + k]))
            vals.append(gf.mul(ctsqz, chunk[..., 4 + k]))
            # a child's FIRST transcript row starts from the empty state
            vals.append(gf.mul(fxc(cur, fx.f_tfirst), chunk[..., k]))
        # the squeeze's output lanes 0..1 ARE this layer's beta publics
        vals.append(gf.mul(ctsqz, gf.sub(out12[..., 0], beta_pub[..., 0])))
        vals.append(gf.mul(ctsqz, gf.sub(out12[..., 1], beta_pub[..., 1])))
        # tfin absorbs the final polynomial (the flattened (2, fdl)
        # coefficients; fdl in {1, 2} by f_fdl2)
        fdl2 = fxc(cur, fx.f_fdl2)
        vals.append(gf.mul(ctfin, gf.sub(chunk[..., 4], fin[..., 0])))
        vals.append(gf.mul(ctfin, gf.sub(chunk[..., 5], gf.add(gf.mul(fdl2, fin[..., 1]),
                                                               gf.mul(_not(fdl2), fin[..., 2])))))
        vals.append(gf.mul(ctfin, gf.sub(chunk[..., 6], gf.mul(fdl2, fin[..., 2]))))
        vals.append(gf.mul(ctfin, gf.sub(chunk[..., 7], gf.mul(fdl2, fin[..., 3]))))
        acc, a_pow = _alpha_sum(vals, alpha, a_pow)
        # the Poseidon2 permutation relations (PermCols offsets are
        # phase-1-relative; rows are [fixed | phase1])
        pacc, a_pow, final = fold_perm_constraints(cur, pc_abs, alpha, a_pow)
        acc = gf.add(acc, pacc)
        live_ = _not(cc(cur, c.pad))
        tail = [gf.mul(live_, gf.sub(out12[..., k], final[..., k])) for k in range(12)]
        t_acc, a_pow = _alpha_sum(tail, alpha, a_pow)
        return gf.add(acc, t_acc), a_pow

    def constraints_pub(cur, nxt, public, ch):
        one = torch.ones((), dtype=torch.int64, device=cur.device)

        def _not(x):
            return gf.sub(one, x)

        out = []
        pad_n = cc(nxt, c.pad)
        copy = slice(F + c.bit, F + c.num_phase1)
        out.append(gf.mul(pad_n, grp(gf.sub(nxt[..., copy], cur[..., copy]))))
        # path rows chain from the previous row's digest
        cpath_n, bit_n = cc(nxt, c.cpath), cc(nxt, c.bit)
        out_c = cur[..., F + c.perm.out.start:F + c.perm.out.start + 4]
        chunk_n = span(nxt, c.perm.chunk)
        for k in range(4):
            out.append(gf.mul(gf.mul(cpath_n, _not(bit_n)), gf.sub(chunk_n[..., k], out_c[..., k])))
            out.append(gf.mul(gf.mul(cpath_n, bit_n), gf.sub(chunk_n[..., 4 + k], out_c[..., k])))
        # carried accumulators along the path rows
        out.append(gf.mul(cpath_n, gf.sub(
            cc(nxt, c.iacc), gf.add(cc(cur, c.iacc), gf.mul(bit_n, fxc(nxt, fx.f_pw2))))))
        out.append(gf.mul(cpath_n, gf.sub(cc(nxt, c.xacc),
                                          gf.mul(cc(cur, c.xacc), cc(nxt, c.wmul)))))
        out.append(gf.mul(cpath_n, gf.sub(cc(nxt, c.xfacc),
                                          gf.mul(cc(cur, c.xfacc), cc(nxt, c.wfmul)))))
        out.append(gf.mul(cpath_n, gf.sub(cc(nxt, c.iprev), cc(cur, c.iprev))))
        out.append(gf.mul(cpath_n, grp(gf.sub(span(nxt, c.qa), span(cur, c.qa)))))
        # reappear: the fold lands in the selected half of the next leaf
        creent_n = cc(nxt, c.creent)
        capb_c = cc(cur, c.capb)
        fv_c = span(cur, c.fv)
        for k in range(2):
            sel = gf.add(gf.mul(_not(capb_c), chunk_n[..., k]), gf.mul(capb_c, chunk_n[..., 2 + k]))
            out.append(gf.mul(creent_n, gf.sub(sel, fv_c[..., k])))
        # iprev on re-entry: i_{l+1} = i_l mod 2^depth = cur.iacc
        out.append(gf.mul(creent_n, gf.sub(cc(nxt, c.iprev), cc(cur, c.iacc))))
        # transcript chaining: tabs2 carries tabs1's capacity; tsqz, tfin and
        # a later tabs1 absorb the previous row's output lanes
        out_full_c = span(cur, c.perm.out)
        ctab2_n = cc(nxt, c.ctab2)
        tchain_n = gf.add(cc(nxt, c.ctsqz), gf.add(cc(nxt, c.ctfin),
                                                   gf.mul(cc(nxt, c.ctab1), fxc(nxt, fx.f_treent))))
        for k in range(4):
            out.append(gf.mul(ctab2_n, gf.sub(nxt[..., F + c.perm.carry.start + k],
                                              out_full_c[..., 8 + k])))
            out.append(gf.mul(tchain_n, gf.sub(chunk_n[..., k], out_full_c[..., k])))
        return out

    return AirSpec(num_cols=c.num_phase1, max_degree=3, constraints=None,
                   constraints_pub=constraints_pub, compose_row_pub=compose_row_pub,
                   num_public=sched.num_public, num_fixed_cols=fx.num_fixed)


# ---------------------------------------------------------------------------
# publics + trace builders
# ---------------------------------------------------------------------------


def fri_transcript_scalars(proof: FriProof, params: FriParams):
    """The outer public-coin replay (ops/fri.verify): the betas and query
    indices from the proof's caps and final polynomial; (betas [(b0, b1)],
    indices [int]) or None on a transcript mismatch."""
    if len(proof.caps) != params.log_domain - params.final_poly_log_len:
        return None
    dev = proof.caps[0].device
    tr = fri.Transcript(dev)
    betas = []
    for cap in proof.caps:
        tr.absorb(cap)
        b = tr.challenge_ext()
        betas.append((int(gf.to_u64(b.c0)), int(gf.to_u64(b.c1))))
    tr.absorb(gf.from_u64(np.asarray(proof.final_poly).reshape(-1), dev))
    indices = tr.challenge_indices(1 << (params.log_domain - 1), params.num_queries)
    if indices != list(proof.query_indices):
        return None
    return betas, indices


def _caps_u64(proofs: Sequence[FriProof]) -> List[np.ndarray]:
    """every child's caps pulled once: (layers, 2, 4) u64 each."""
    return [gf.to_u64(torch.stack(list(p.caps))).reshape(-1, 2, 4) for p in proofs]


def build_publics(proofs: Sequence[FriProof], fri_params: Sequence[FriParams]
                  ) -> Optional[torch.Tensor]:
    """The public vector from the CHILD PROOFS' public data (caps, betas,
    indices, layer-0 pairs, final polynomials), on the children's device;
    the prover and the outer verifier derive it alike."""
    sched = build_schedule(tuple(fri_params))
    pub = np.zeros(sched.num_public, np.uint64)
    caps = _caps_u64(proofs)
    for ci, (proof, params) in enumerate(zip(proofs, fri_params)):
        scal = fri_transcript_scalars(proof, params)
        if scal is None:
            return None
        betas, indices = scal
        for l in range(len(proof.caps)):
            o = sched.off_caps[ci][l]
            pub[o:o + 8] = caps[ci][l].reshape(8)
            pub[sched.off_beta[ci][l]:sched.off_beta[ci][l] + 2] = betas[l]
        for q, idx in enumerate(indices):
            pub[sched.off_idx[ci][q]] = idx
            pair = np.asarray(proof.openings[q][0]["pair"], np.uint64)
            o = sched.off_leaf0[ci][q]
            pub[o:o + 4] = [pair[0, 0], pair[0, 1], pair[1, 0], pair[1, 1]]
        fdl = 1 << max(params.final_poly_log_len - params.log_blowup, 0)
        fp = np.asarray(proof.final_poly, np.uint64)
        base = sched.off_final[ci]
        pub[base] = fp[0, 0]
        pub[base + 2] = fp[1, 0]
        if fdl > 1:
            pub[base + 1] = fp[0, 1]
            pub[base + 3] = fp[1, 1]
    return gf.from_u64(pub, proofs[0].caps[0].device)


def build_verifier_trace(proofs: Sequence[FriProof], fri_params: Sequence[FriParams],
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(phase1, fixed) on `device` (None: the card): the query-phase
    verification of every child replayed into the committed trace.  Raises
    AssertionError if a child does NOT verify: an honest prover cannot build
    a satisfying trace for a bad proof (the cap, fold and final checks below
    are the ones the AIR enforces)."""
    device = resolve_device(device)
    sched = build_schedule(tuple(fri_params))
    c = _cols()
    pc = c.perm
    n = sched.n
    C = np.zeros((c.num_phase1, n), np.uint64)
    rows = _row_dicts(sched)
    live = len(rows)

    scalars, tr_rows = {}, {}
    for ci, (proof, params) in enumerate(zip(proofs, fri_params)):
        s = fri_transcript_scalars(proof, params)
        assert s is not None, "child FRI transcript mismatch"
        scalars[ci] = s
        tr_rows[ci] = _transcript_row_states(proof, s[0])
    caps = _caps_u64(proofs)

    # ---- host pass: everything but the permutations' insides ----
    states = np.zeros((live, 12), np.uint64)
    seg_pos = np.zeros(live, np.int64)  # the position inside a (q, l) segment
    tr_seen = {ci: 0 for ci in range(len(proofs))}
    flag_of = {"tabs1": c.ctab1, "tabs2": c.ctab2, "tsqz": c.ctsqz, "tfin": c.ctfin}
    for i, r in enumerate(rows):
        ci, q, l = r["child"], r["q"], r["layer"]
        proof, params = proofs[ci], fri_params[ci]
        betas, indices = scalars[ci]
        if r["kind"] in flag_of:
            kind, lay_l, st_in = tr_rows[ci][tr_seen[ci]]
            tr_seen[ci] += 1
            assert kind == r["kind"] and lay_l == l, (kind, r)
            states[i] = st_in
            C[flag_of[kind], i] = 1
            continue
        op = proof.openings[q][l]
        pair = np.asarray(op["pair"], np.uint64)
        path = np.asarray(op["path"], np.uint64)
        lay = r["lay"]
        idx = _iprev_of(indices[q], params, l + 1)  # the pair index in this layer
        if r["kind"] == "leaf":
            states[i, 0:4] = [pair[0, 0], pair[0, 1], pair[1, 0], pair[1, 1]]
            states[i, 11] = 4
            C[c.cleaf, i] = 1
            C[c.xacc, i] = lay["shift"]
            C[c.xfacc, i] = r["fshift"]
            C[c.qa, i] = states[i, 0:4]
            if not r["first"]:
                C[c.creent, i] = 1
                C[c.iprev, i] = idx
            continue
        k = r["k"]
        seg_pos[i] = 1 + k
        bitk = (idx >> k) & 1
        # the previous digest is filled after the permutation pass; the
        # sibling half now
        if bitk:
            states[i, 0:4] = path[k]
        else:
            states[i, 4:8] = path[k]
        C[c.cpath, i] = 1
        C[c.bit, i] = bitk
        C[c.wmul, i] = r["wstep"] if bitk else 1
        C[c.wfmul, i] = r["wfstep"] if bitk else 1
        C[c.iacc, i] = int(C[c.iacc, i - 1]) + bitk * (1 << k)
        C[c.xacc, i] = int(C[c.xacc, i - 1]) * (r["wstep"] if bitk else 1) % MODULUS
        C[c.xfacc, i] = int(C[c.xfacc, i - 1]) * (r["wfstep"] if bitk else 1) % MODULUS
        C[c.iprev, i] = C[c.iprev, i - 1]
        C[c.qa, i] = C[c.qa, i - 1]
        if not r["last"]:
            continue
        capbit = (idx >> lay["depth"]) & 1
        C[c.clast, i] = 1
        C[c.capb, i] = capbit
        C[c.wfcmul, i] = r["wfcap"] if capbit else 1
        C[c.wcmul, i] = r["wcap"] if capbit else 1
        xcf = int(C[c.xacc, i]) * int(C[c.wcmul, i]) % MODULUS
        C[c.xcf, i] = xcf
        xinv = pow(xcf, MODULUS - 2, MODULUS)
        C[c.xinv, i] = xinv
        a = (int(C[c.qa.start, i]), int(C[c.qa.start + 1, i]))
        b = (int(C[c.qa.start + 2, i]), int(C[c.qa.start + 3, i]))
        beta = betas[l]
        od0 = (a[0] - b[0]) % MODULUS * _HALF % MODULUS * xinv % MODULUS
        od1 = (a[1] - b[1]) % MODULUS * _HALF % MODULUS * xinv % MODULUS
        C[c.od, i] = (od0, od1)
        C[c.beta, i] = beta
        ev0 = (a[0] + b[0]) * _HALF % MODULUS
        ev1 = (a[1] + b[1]) * _HALF % MODULUS
        f0 = (ev0 + beta[0] * od0 + _W_NR * beta[1] % MODULUS * od1) % MODULUS
        f1 = (ev1 + beta[0] * od1 + beta[1] * od0) % MODULUS
        C[c.fv, i] = (f0, f1)
        ifull = int(C[c.iacc, i]) + capbit * (1 << lay["depth"])
        if r.get("last0"):
            C[c.clast0, i] = 1
            assert ifull == indices[q], "query index mismatch"
        if r.get("lastNF"):
            C[c.clastNF, i] = 1
            assert ifull == int(C[c.iprev, i]), "index chain mismatch"
        if r.get("lastF"):
            C[c.clastF, i] = 1
            xff = int(C[c.xfacc, i]) * int(C[c.wfcmul, i]) % MODULUS
            C[c.xff, i] = xff
            assert fri._eval_poly_ext(np.asarray(proof.final_poly), xff) == (f0, f1), \
                "final-poly mismatch: child proof invalid"

    # the reappear checks (a leaf pair holds the previous layer's fold)
    for i in np.flatnonzero(C[c.creent, :live]):
        off = 2 if C[c.capb, i - 1] else 0
        assert (states[i, off:off + 2] == C[c.fv, i - 1]).all(), \
            "fold does not reappear: child proof invalid"

    # ---- the permutation pass, batched by segment position (digest chaining)
    perm_rows = np.zeros((live, pc.end - pc.chunk.start), np.uint64)
    for ppos in range(int(seg_pos.max()) + 1):
        sel = np.flatnonzero(seg_pos == ppos)
        if ppos > 0:
            # the previous digest fills the other half of each compression input
            prev = perm_rows[sel - 1, -12:-8]
            bit = C[c.bit, sel].astype(bool)
            states[sel[bit], 4:8] = prev[bit]
            states[sel[~bit], 0:4] = prev[~bit]
        perm_rows[sel] = gf.to_u64(_perm_rows(gf.from_u64(states[sel], device)))
    C[pc.chunk.start:pc.end, :live] = perm_rows.T
    out_np = perm_rows[:, -12:]

    # cap equality (the check that makes a forged path unbuildable)
    for i, r in enumerate(rows):
        if r["kind"] == "path" and r["last"]:
            want = caps[r["child"]][r["layer"]][int(C[c.capb, i])]
            assert (out_np[i, :4] == want).all(), "Merkle cap mismatch: child proof invalid"

    # padding: the last live row
    C[c.pad, live:] = 1
    C[c.bit:, live:] = C[c.bit:, live - 1][:, None]
    return gf.from_u64(C, device), fixed_columns(sched, device)


def _transcript_row_states(proof: FriProof, betas) -> list:
    """[(kind, layer, state12_in)] of the FS-replay rows, by the native
    Poseidon2; equal to ops/fri.Transcript (asserted against the betas)."""
    out = []
    st = np.zeros(4, np.uint64)
    for l, cap_u in enumerate(_caps_u64([proof])[0].reshape(-1, 8)):
        in1 = np.zeros(12, np.uint64)
        in1[0:4] = st
        in1[4:8] = cap_u[:4]
        in1[11] = 12
        out1 = native.poseidon2_permute(in1)
        out.append(("tabs1", l, in1))
        in2 = np.zeros(12, np.uint64)
        in2[0:4] = cap_u[4:8]
        in2[8:12] = out1[8:12]
        out2 = native.poseidon2_permute(in2)
        out.append(("tabs2", l, in2))
        in3 = np.zeros(12, np.uint64)
        in3[0:4] = out2[:4]
        out3 = native.poseidon2_permute(in3)
        out.append(("tsqz", l, in3))
        st = out3[:4].copy()
        assert (int(st[0]), int(st[1])) == tuple(betas[l]), \
            "transcript replay diverged from ops/fri.Transcript"
    flat = np.asarray(proof.final_poly, np.uint64).reshape(-1)
    in4 = np.zeros(12, np.uint64)
    in4[0:4] = st
    in4[4:4 + flat.shape[0]] = flat
    in4[11] = 4 + flat.shape[0]
    out.append(("tfin", 0, in4))
    return out


def _iprev_of(idx0: int, params: FriParams, upto: int) -> int:
    """The pair index after folding `upto` layers (fri.verify's pos chain)."""
    pos = idx0
    for ll in range(upto):
        pos = pos % ((1 << (params.log_domain - ll)) // 2)
    return pos


# ---------------------------------------------------------------------------
# prove / verify
# ---------------------------------------------------------------------------


def prove_fri_verification(proofs: Sequence[FriProof], fri_params: Sequence[FriParams],
                           params: Optional[StarkParams] = None
                           ) -> Tuple[StarkProof, torch.Tensor, StarkParams]:
    """STARK-prove "these child FRI proofs verify" (the query phase) on the
    children's device.  Returns (verifier_proof, publics, stark_params);
    raises AssertionError on an invalid child, as the JAX package does
    (ROADMAP Queue 3)."""
    sched = build_schedule(tuple(fri_params))
    phase1, fixed = build_verifier_trace(proofs, fri_params, proofs[0].caps[0].device)
    air = verifier_air(sched)
    if params is None:
        params = StarkParams(log_n=int(sched.n).bit_length() - 1)
    public = build_publics(proofs, fri_params)
    assert public is not None
    return prove(phase1, air, params, public, fixed_cols=fixed), public, params


def verify_fri_verification(vproof: StarkProof, proofs: Sequence[FriProof],
                            fri_params: Sequence[FriParams], params: StarkParams) -> bool:
    """The outer verifier: rebuild the publics from the CHILD PROOFS' public
    data (caps, transcript replay, layer-0 pairs, final polynomials), then
    check the verifier STARK against the schedule's fixed columns (the VK).
    The proof's own `params` are trusted, as in the JAX package (ROADMAP
    Queue 3)."""
    sched = build_schedule(tuple(fri_params))
    public = build_publics(proofs, fri_params)
    if public is None:
        return False
    fixed = fixed_columns(sched, vproof.q_cap.device)
    return verify(vproof, verifier_air(sched), params, public.to(vproof.q_cap.device),
                  fixed_cols=fixed)
