"""demux_log_queue routing AIR (the JAX package's `prover/demux_air.py`, on
torch tensors): a STARK of the per-pop routing decision of circuit type 4
(ref `src/demux_log_queue/mod.rs:279-310`).

One row per input element commits the query's fields as bytes, re-derives
the 20-lane standard encoding affinely (the packing of
`base_structures/log_query.py`), proves the 6 routing selectors with
equality certificates, and accumulates challenge-RLC streams:

  iacc   - RLC of every executed element's 20-lane encoding (input queue)
  oacc_k - RLC of the selected elements' encodings per output queue k

Publics: [iacc final | 6 x oacc final].  The verifier recomputes all seven
from the plaintext queries and the routing rule.  A flag carries an
inverse certificate against a challenge-compressed field difference (flag
= 1 iff the compressed difference is zero, whp over the FS challenge).

Routing rule (models/demux_log_queue.py route_flags; mod.rs:222-232):
  0 rollup_storage: aux == STORAGE && shard == 0
  1 events:         aux == EVENT
  2 l1_messages:    aux == L1_MESSAGE
  3 keccak:         aux == PRECOMPILE && address == KECCAK_FORMAL
  4 sha256:         aux == PRECOMPILE && address == SHA256_FORMAL
  5 ecrecover:      aux == PRECOMPILE && address == ECRECOVER_FORMAL

The constraints are the JAX module's in the same order (so the same alpha
powers), each family one gathered group: the encoding is a weighted sum
over an index map of byte columns, the six rule differences share one
address sum.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..base_structures.log_query import encode_log_query_ref
from ..isa.system_params import (
    ECRECOVER_PRECOMPILE_FORMAL_ADDRESS,
    EVENT_AUX_BYTE,
    KECCAK256_PRECOMPILE_FORMAL_ADDRESS,
    L1_MESSAGE_AUX_BYTE,
    PRECOMPILE_AUX_BYTE,
    SHA256_PRECOMPILE_FORMAL_ADDRESS,
    STORAGE_AUX_BYTE,
)
from ..ops import gf
from ..ops.gf import MODULUS
from ..utils.device import resolve_device
from .air_common import (Reg, byte_lookup_columns, byte_lookup_rows, challenge, grp,
                         lookup_diff, masked_scan, powers)
from .stark import (AirSpec, StarkParams, StarkProof, _alpha_sum, _commit_columns,
                    challenges_from_cap, prove, verify)

QUEUE_RULES = (
    ("rollup_storage", STORAGE_AUX_BYTE, None),
    ("events", EVENT_AUX_BYTE, None),
    ("l1_messages", L1_MESSAGE_AUX_BYTE, None),
    ("keccak", PRECOMPILE_AUX_BYTE, KECCAK256_PRECOMPILE_FORMAL_ADDRESS),
    ("sha256", PRECOMPILE_AUX_BYTE, SHA256_PRECOMPILE_FORMAL_ADDRESS),
    ("ecrecover", PRECOMPILE_AUX_BYTE, ECRECOVER_PRECOMPILE_FORMAL_ADDRESS),
)
NQ = len(QUEUE_RULES)
ENC_W = 20
_FIELDS = (("key_b", "key", 32), ("addr_b", "address", 20), ("rv_b", "read_value", 32),
           ("wv_b", "written_value", 32), ("ts_b", "timestamp", 4),
           ("tx_b", "tx_number_in_block", 4))


@functools.lru_cache(maxsize=1)
def layout() -> Tuple[Reg, Reg, Reg]:
    fx = Reg()
    fx.add("t_byte")
    p1 = Reg()
    # field bytes (LE): key 32, addr 20, read_value 32, written_value 32,
    # ts 4, tx 4
    for name, _, k in _FIELDS:
        p1.add(name, k)
    p1.add("aux")            # byte-valued (range-checked)
    p1.add("shard")          # byte-valued
    p1.add("rw"); p1.add("rollback"); p1.add("svc"); p1.add("exec")  # bools
    # routing flags (finv certificates are challenge-derived -> phase 2)
    p1.add("flag", NQ)
    p1.add("m_byte")
    p2 = Reg()
    p2.add("finv", NQ)
    p2.add("inv_qb", p1.index["rw"][0])  # byte-checked columns: key..shard
    p2.add("inv_tb")
    p2.add("lacc")
    p2.add("iacc")
    p2.add("oacc", NQ)
    return fx, p1, p2


@functools.lru_cache(maxsize=1)
def _enc_map():
    """(ENC_W, 7) phase-1 column indices and weights of the 20-lane
    encoding: lane = sum_j weight_j * column_j (weight 0 pads a lane)."""
    _, p1, _ = layout()
    at = p1.at
    ix = np.zeros((ENC_W, 7), np.int64)
    wt = np.zeros((ENC_W, 7), np.uint64)

    def lane(k, base, tail):
        terms = [(at(base[0], base[1] + i), 1 << (8 * i)) for i in range(4)]
        terms += [(col, 1 << s) for col, s in zip(tail, (32, 40, 48))]
        for j, (col, w) in enumerate(terms):
            ix[k, j], wt[k, j] = col, w

    for k in range(8):
        lane(k, ("rv_b", 4 * k), [at("key_b", 3 * k + i) for i in range(3)])
    stream = [at("key_b", 24 + i) for i in range(8)] + [at("addr_b", i) for i in range(16)]
    for k in range(8):
        lane(8 + k, ("wv_b", 4 * k), stream[3 * k:3 * k + 3])
    lane(16, ("ts_b", 0), [at("addr_b", 16 + i) for i in range(3)])
    lane(17, ("tx_b", 0), [at("addr_b", 19), at("aux"), at("shard")])
    ix[18, :2], wt[18, :2] = (at("rw"), at("svc")), (1, 2)
    ix[19, 0], wt[19, 0] = at("rollback"), 1
    return ix, wt


def _enc_lanes(rows: torch.Tensor, F: int) -> torch.Tensor:
    """The 20-lane standard encoding, affine in the committed bytes:
    (batch, ENC_W) from row views whose phase-1 columns start at F."""
    ix, wt = _enc_map()
    terms = rows[..., torch.as_tensor(ix + F, device=rows.device)]  # (batch, 20, 7)
    return gf.sum_mod(gf.mul(terms, gf.from_u64(wt, rows.device)))


def _row_rlc(rows: torch.Tensor, F: int, delta: int) -> torch.Tensor:
    """sum_j delta^j lane_j: the Horner RLC of a row's encoding."""
    return gf.dot_mod(_enc_lanes(rows, F), powers(delta, ENC_W, rows.device))


def _rule_diffs(rows: torch.Tensor, F: int, mu: int) -> torch.Tensor:
    """(NQ, batch) challenge-compressed differences, ZERO iff queue qi's
    rule matches: (aux - aux_c), times mu, plus the shard (queue 0) or the
    20 address-byte differences in Horner order (the precompiles)."""
    _, p1, _ = layout()
    dev = rows.device
    aux = rows[..., F + p1.at("aux")]
    addr = rows[..., F + p1.at("addr_b"):F + p1.at("addr_b") + 20]
    mpow = [pow(mu, 19 - i, MODULUS) for i in range(20)]
    addr_sum = gf.dot_mod(addr, gf.from_u64(np.array(mpow, np.uint64), dev))
    mu20 = pow(mu, 20, MODULUS)
    out = []
    for qi, (_, aux_c, addr_c) in enumerate(QUEUE_RULES):
        d = gf.sub(aux, gf.constant(aux_c, dev))
        if qi == 0:
            d = gf.add(gf.mul_const(d, mu), rows[..., F + p1.at("shard")])
        elif addr_c is not None:
            c = sum(((addr_c >> (8 * i)) & 0xFF) * mpow[i] for i in range(20)) % MODULUS
            d = gf.add(gf.mul_const(d, mu20), gf.sub(addr_sum, gf.constant(c, dev)))
        out.append(d)
    return torch.stack(out)


@functools.lru_cache(maxsize=1)
def demux_air() -> AirSpec:
    fx, p1, p2 = layout()
    F, P1 = fx.n, p1.n
    NB = p2.index["inv_qb"][1]

    def at(nm, j=0):
        return F + p1.at(nm, j)

    def at2(nm, j=0):
        return F + P1 + p2.at(nm, j)

    def flags(row):
        return row[..., at("flag"):at("flag") + NQ]

    def byte_terms(row):
        return (row[..., F:F + NB], row[..., at2("inv_qb"):at2("inv_qb") + NB],
                row[..., at2("inv_tb")])

    def compose_row_pub(cur, public, ch, alpha, a_pow):
        one = torch.ones_like(cur[..., 0])
        ex = cur[..., at("exec")]
        # booleanity of rw, rollback, svc, exec (adjacent columns)
        b = cur[..., at("rw"):at("rw") + 4]
        out = [grp(gf.mul(b, gf.sub(b, torch.ones_like(b))))]
        # per queue: flag booleanity; flag == 1 => rule matches (f d == 0);
        # executed && flag == 0 => certificate d finv == 1; padding rows
        # route nowhere ((1 - exec) f == 0)
        f = grp(flags(cur))                                    # (NQ, batch)
        d = _rule_diffs(cur, F, challenge(ch, 2))
        finv = grp(cur[..., at2("finv"):at2("finv") + NQ])
        out.append(torch.stack([
            gf.mul(f, gf.sub(f, one)),
            gf.mul(f, d),
            gf.mul(gf.sub(ex, f), gf.sub(gf.mul(d, finv), one)),
            gf.mul(gf.sub(one, ex), f)], dim=1))               # (NQ, 4, batch)
        qb, invb, inv_tb = byte_terms(cur)
        out += byte_lookup_rows(qb, invb, inv_tb, cur[..., fx.at("t_byte")],
                                cur[..., at("m_byte")], ch[0])
        return _alpha_sum(out, alpha, a_pow)

    def constraints_pub(cur, nxt, public, ch):
        delta = challenge(ch, 1)
        d20 = pow(delta, ENC_W, MODULUS)
        one = torch.ones_like(cur[..., 0])
        r = _row_rlc(cur, F, delta)
        # input RLC on executed rows, output RLCs on selected rows only
        # (flag implies exec by the pad rule)
        sel = torch.cat([cur[..., at("exec")].unsqueeze(0), grp(flags(cur))])  # (1+NQ, batch)
        acc_ix = [at2("iacc")] + [at2("oacc", qi) for qi in range(NQ)]
        acc_c, acc_n = grp(cur[..., acc_ix]), grp(nxt[..., acc_ix])
        pushed = gf.add(gf.mul_const(acc_c, d20), r)
        out = [gf.sub(acc_n, gf.add(gf.mul(sel, pushed), gf.mul(gf.sub(one, sel), acc_c)))]
        # logUp accumulator
        _, invb, inv_tb = byte_terms(nxt)
        out.append(gf.sub(gf.sub(nxt[..., at2("lacc")], cur[..., at2("lacc")]),
                          lookup_diff(invb, inv_tb)))
        return out

    def first_row(row, public, ch):
        _, invb, inv_tb = byte_terms(row)
        return [grp(row[..., [at2("iacc")] + [at2("oacc", qi) for qi in range(NQ)]]),
                gf.sub(row[..., at2("lacc")], lookup_diff(invb, inv_tb))]

    def last_row(row, public, ch):
        # final accumulators: the last row must be padding (exec=0) so the
        # before-row accumulators are the totals
        accs = grp(row[..., [at2("iacc")] + [at2("oacc", qi) for qi in range(NQ)]])
        return [row[..., at("exec")], gf.sub(accs, public.unsqueeze(-1)),
                row[..., at2("lacc")]]

    return AirSpec(
        num_cols=P1,
        max_degree=3,
        constraints=None,
        constraints_pub=constraints_pub,
        compose_row_pub=compose_row_pub,
        first_row=first_row,
        last_row=last_row,
        num_public=1 + NQ,
        num_fixed_cols=F,
        num_phase2_cols=p2.n,
        num_challenges=3,
    )


# ---------------------------------------------------------------------------
# trace builder + prove/verify
# ---------------------------------------------------------------------------


def _le_bytes(queries, field: str, k: int) -> np.ndarray:
    """(k, Q) little-endian bytes of one field of every query."""
    raw = b"".join(int(q.get(field, 0)).to_bytes(k, "little") for q in queries)
    return np.frombuffer(raw, np.uint8).reshape(len(queries), k).T.astype(np.uint64)


def _field_rows(queries, execute) -> dict:
    """Plaintext query fields -> byte rows (host numpy)."""
    f = {name: _le_bytes(queries, field, k) for name, field, k in _FIELDS}
    for name, field in (("aux", "aux_byte"), ("shard", "shard_id")):
        f[name] = np.array([int(q.get(field, 0)) for q in queries], np.uint64)
    for name, field in (("rw", "rw_flag"), ("rollback", "rollback"), ("svc", "is_service")):
        f[name] = np.array([int(bool(q.get(field, False))) for q in queries], np.uint64)
    f["exec"] = np.asarray(execute, np.uint64)
    return f


def _route_host(f: dict) -> np.ndarray:
    """(NQ, Q) routing flags of the plaintext rows."""
    addr = [sum(int(v) << (8 * j) for j, v in enumerate(col)) for col in f["addr_b"].T]
    out = np.zeros((NQ, len(addr)), np.uint64)
    for qi, (_, aux_c, addr_c) in enumerate(QUEUE_RULES):
        hit = f["aux"] == aux_c
        if qi == 0:
            hit &= f["shard"] == 0
        elif addr_c is not None:
            hit &= np.array([a == addr_c for a in addr], bool)
        out[qi] = hit
    return out


def _fixed(n: int, device) -> torch.Tensor:
    return gf.from_u64(np.stack([np.arange(n, dtype=np.uint64) % 256]), device)


def demux_trace(queries, n: Optional[int] = None, device=None):
    """(fixed, phase1, log_n) on `device` (None: the card).  queries: list of
    plaintext LogQuery dicts (the executed input stream, in order)."""
    Q = len(queries)
    n = n or (1 << max(8, Q.bit_length()))
    device = resolve_device(device)
    f = _field_rows(queries, np.ones(Q, np.uint64))
    fx, p1, p2 = layout()
    cols = np.zeros((p1.n, n), np.uint64)
    for name in ("key_b", "addr_b", "rv_b", "wv_b", "ts_b", "tx_b", "aux", "shard",
                 "rw", "rollback", "svc", "exec"):
        cols[p1.sl(name), :Q] = f[name]
    cols[p1.sl("flag"), :Q] = _route_host(f)
    # byte multiplicities
    NB = p2.index["inv_qb"][1]
    counts = np.bincount(cols[:NB].reshape(-1).astype(np.int64), minlength=256)
    cols[p1.at("m_byte"), :256] = counts
    return _fixed(n, device), gf.from_u64(cols, device), n.bit_length() - 1


def _build_phase2(trace: torch.Tensor, ch_ints) -> torch.Tensor:
    """The phase-2 columns from [fixed | phase1] (m, n)."""
    fx, p1, p2 = layout()
    F = fx.n
    NB = p2.index["inv_qb"][1]
    X, delta, mu = (int(c) for c in ch_ints)
    rows = trace.T
    d = _rule_diffs(rows, F, mu)
    finv = gf.inv(d)  # gf.inv(0) is 0 (0^(p-2) = 0)
    inv_qb, inv_tb, lacc = byte_lookup_columns(trace[F:F + NB], trace[fx.at("t_byte")],
                                               trace[F + p1.at("m_byte")], X)
    r = _row_rlc(rows, F, delta)
    d20 = pow(delta, ENC_W, MODULUS)
    sels = [trace[F + p1.at("exec")]] + [trace[F + p1.at("flag", qi)] for qi in range(NQ)]
    accs = [masked_scan(s, d20, r) for s in sels]
    return torch.cat([finv, inv_qb, torch.stack([inv_tb, lacc] + accs)])


def host_publics(queries, delta: int) -> np.ndarray:
    """Verifier-side recomputation of [iacc | oacc_0..5] from the plaintext
    input stream and the routing rule."""
    flags = _route_host(_field_rows(queries, np.ones(len(queries), np.uint64)))
    d20 = pow(delta, 20, MODULUS)
    iacc = 0
    oacc = [0] * NQ
    for i, q in enumerate(queries):
        r = 0
        for v in reversed(encode_log_query_ref(q)):
            r = (r * delta + int(v)) % MODULUS
        iacc = (iacc * d20 + r) % MODULUS
        for qi in np.flatnonzero(flags[:, i]):
            oacc[qi] = (oacc[qi] * d20 + r) % MODULUS
    return np.array([iacc] + oacc, np.uint64)


def prove_demux(queries, params: Optional[StarkParams] = None, device=None):
    """Prove the routing of the executed input log stream on `device`
    (None: the card).  Returns (proof, publics, params)."""
    fixed, phase1, log_n = demux_trace(queries, device=device)
    if params is None:
        params = StarkParams(log_n=log_n)
    air = demux_air()
    ftree = _commit_columns(fixed, params)
    ptree = _commit_columns(phase1, params)
    ch, _ = challenges_from_cap(ptree["cap"], air, ftree["cap"])
    publics = host_publics(queries, ch[1])
    proof = prove(phase1, air, params, gf.from_u64(publics, phase1.device),
                  build_phase2=_build_phase2, fixed_cols=fixed, phase1_tree=ptree)
    return proof, publics, params


def verify_demux(proof: StarkProof, queries, params: StarkParams) -> bool:
    """queries: the plaintext executed input stream (public data: the
    scheduler derives it; downstream circuits consume the routed
    substreams).  The proof's own `params` are trusted, as in the JAX
    package (ROADMAP Queue 3)."""
    n = 1 << params.log_n
    if len(queries) > n:
        return False
    air = demux_air()
    dev = proof.q_cap.device
    fixed = _fixed(n, dev)
    fcap = _commit_columns(fixed, params)["cap"]
    ch, _ = challenges_from_cap(proof.caps[1], air, fcap)
    publics = host_publics(queries, ch[1])
    return verify(proof, air, params, gf.from_u64(publics, dev), fixed_cols=fixed)
