"""ecrecover, circuit type 7: ECDSA public-key recovery precompile (the JAX
package's `models/ecrecover.py`).

Reference parity: `src/ecrecover/` (entry `new_optimized.rs:1129-1384`, inner
`:870-1128`) — non-native secp256k1 over Goldilocks, per call 4 memory reads
(digest, v, r, s — MEMORY_QUERIES_PER_CALL = 4, mod.rs:41), recovery
`Q = r^{-1}(s*R - h*G) = u1*G + u2*R` with `u1 = -h*r^{-1}, u2 = s*r^{-1}
(mod n)`, final keccak256 of the affine point -> address, and a (success,
address) pair written to memory.

The affine double-and-add trace is materialized as rows — one row per scalar
bit per ladder — and every group-law transition is checked as an integer
identity over 16 x u16 limbs (`ops/nonnative.py`) with per-identity quotient
witnesses; all (calls x 512) rows in one batched pass on the witness's
device.

Exception semantics mirror new_optimized.rs:913-1127; every flag is
recomputed in-circuit from values bound to the memory-read tape:

  - s >= (n-1)/2 convention violation (HALF_SUBGROUP_SIZE, :927-932)
  - x_overflow with r + n overflowing 256 bits (:934-937)
  - x = r + n*x_overflow out of base-field range (:939-945)
  - r == 0 / s == 0 (mod n)  (:949-954; h == 0 allowed, ALLOW_ZERO_MESSAGE
    = true, :53)
  - t = x^3 + b == 0 (:975-980)
  - t a quadratic non-residue (:1033-1035) — proven by a witness certificate
    w with w^2 == -t (mod p), valid because p == 3 (mod 4).  The residue case
    is proven by ry itself (ry^2 == t).
  - recovered point at infinity (:1090-1096) — proven by acc1 == -acc2 on
    the checked ladder results.

recid is the low byte of the v word (:1288); bit 0 selects the y parity of
the lifted R, bit 1 the x = r + n branch (:915-925).  success/address writes
are masked on any exception (:1123).

The witness is built on the host (python-int point arithmetic, the JAX
package's per-row builder `_W`; here it keeps python ints and turns each
column into limbs once, in bulk, inverts with `pow(x, -1, p)` where the JAX
package raises to p - 2, and takes an add row's sum from its own witness
instead of adding twice: the same values); its sponge chains go through
`queues.simulate_chains`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..base_structures.log_query import LogQueries, encode_log_queries
from ..base_structures.memory_query import MemoryQueries, encode_memory_queries
from ..isa.system_params import ECRECOVER_PRECOMPILE_FORMAL_ADDRESS, PRECOMPILE_AUX_BYTE
from ..ops import keccak, nonnative as nn, queues, secp256k1 as ec
from ..utils.device import resolve_device
from ..utils.shard_plan import RowWindow, ShardPlan, owned_rows, summed
from . import precompile_common as pc

MEMORY_QUERIES_PER_CALL = 4
BITS = 256
# new_optimized.rs:109 HALF_SUBGROUP_SIZE = (n-1)/2; s >= this is an exception
HALF_N = (ec.N - 1) // 2
# 2^256 - n: r >= this means r + n overflows 256 bits (the `error` flag)
R_PLUS_N_OVERFLOW = (1 << 256) - ec.N
M32 = pc.M32


@dataclasses.dataclass(frozen=True)
class EcrecoverConfig:
    max_calls: int


# the limb count of each column: 16 for a 256-bit value, 17 for a quotient
# (which can slightly exceed 256 bits), 0 for a flag
_STEP_KEYS = ["base_x", "base_y", "acc_x", "acc_y", "acc_inf", "bit",
              "d_lam", "d_qa", "d_qb", "d_qc", "d_qd", "d_qe", "d_qf",
              "a_lam", "a_qa", "a_qb", "a_qc", "a_qd", "a_qe", "a_qf",
              "base_nx", "base_ny", "acc_nx", "acc_ny", "acc_ninf"]
_SCALAR_KEYS = ["u1", "u2", "r", "s", "h", "r_inv", "q_rinv", "q_u1", "q_u2",
                "call_valid", "nonres", "exc_inf"]
_POINT_KEYS = ["rx", "ry", "curve_w", "q_curve_w", "t", "q_t", "q_ry",
               "w_cert", "q_w", "qx", "qy",
               "f_lam", "f_qa", "f_qb", "f_qc", "f_qd", "f_qe", "f_qf",
               "acc1x", "acc1y", "acc2x", "acc2y"]
_FLAGS = ("acc_inf", "bit", "acc_ninf", "call_valid", "nonres", "exc_inf")


def _width(key: str) -> int:
    """q_* and the d_q* / a_q* / f_q* quotients take 17 limbs, flags none."""
    if key in _FLAGS:
        return 0
    return 17 if key.startswith("q_") or key[1:3] == "_q" else 16


def _limb_matrix(values, nlimbs: int) -> np.ndarray:
    """python ints -> (n, nlimbs) u16 limbs, in one pass over bytes; a value
    that does not fit raises, as `nn.from_int` does."""
    nbytes = 2 * nlimbs
    try:
        raw = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    except OverflowError as exc:
        raise ValueError("value does not fit the limb count") from exc
    return np.frombuffer(raw, "<u2").reshape(len(values), nlimbs).astype(np.int64)


class _W:
    """column builder: keyed lists of python ints -> stacked limb arrays."""

    def __init__(self):
        self.cols = {}

    def add(self, **kw):
        for k, v in kw.items():
            self.cols.setdefault(k, []).append(v)

    def stack(self, total, keys, device):
        out = {}
        for k in keys:
            vs = self.cols.get(k, [])
            width = _width(k)
            vs = list(vs) + [0] * (total - len(vs))
            if width:
                # 16-limb columns hold values mod 2^256, as the JAX package's `_limbs16`
                arr = _limb_matrix([v % (1 << 256) if width == 16 else v for v in vs], width)
            else:
                arr = np.asarray([int(v) for v in vs], np.int64)
            out[k] = torch.from_numpy(arr).to(device)
        return out


def _dummy_step(wb: _W):
    """all-zero step row (layout filler for masked calls)."""
    wb.add(**{k: (1 if k in ("acc_inf", "acc_ninf") else 0) for k in _STEP_KEYS})


def _split(d: int):
    """a signed difference as (positive quotient, negative quotient) of P."""
    return (d // ec.P, 0) if d >= 0 else (0, -d // ec.P)


def _double_witness(wb: _W, pt):
    """emit witness columns for doubling pt -> returns 2*pt."""
    x, y = pt
    lam = 3 * x * x * pow(2 * y, -1, ec.P) % ec.P
    x3 = (lam * lam - 2 * x) % ec.P
    y3 = (lam * (x - x3) - y) % ec.P
    qc, qd = _split(lam * lam - (x3 + 2 * x))
    qe, qf = _split(lam * x - (lam * x3 + y3 + y))
    wb.add(d_lam=lam, d_qa=(lam * 2 * y) // ec.P, d_qb=(3 * x * x) // ec.P,
           d_qc=qc, d_qd=qd, d_qe=qe, d_qf=qf)
    return (x3, y3)


def _add_witness(wb: _W, p1, p2, res_if_degenerate=None, prefix="a_"):
    """emit witness columns for p1 + p2 (x1 != x2 assumed when used)."""
    names = [prefix + k for k in ("lam", "qa", "qb", "qc", "qd", "qe", "qf")]
    if p1 is None or p2 is None or p1[0] == p2[0]:
        # unused row (gated off); emit zeros
        wb.add(**{k: 0 for k in names})
        return res_if_degenerate
    x1, y1 = p1
    x2, y2 = p2
    lam = (y2 - y1) * pow(x2 - x1, -1, ec.P) % ec.P
    x3 = (lam * lam - x1 - x2) % ec.P
    y3 = (lam * (x1 - x3) - y1) % ec.P
    qa, qb = _split((lam * x2 + y1) - (lam * x1 + y2))
    qc, qd = _split(lam * lam - (x3 + x1 + x2))
    qe, qf = _split(lam * x1 - (lam * x3 + y3 + y1))
    wb.add(**dict(zip(names, (lam, qa, qb, qc, qd, qe, qf))))
    return (x3, y3)


def _analyze_call(h, v, r, s):
    """host-side mirror of the in-circuit exception evaluation.

    Returns a dict with all per-call derived quantities (flags, t/ry/w_cert,
    ladder inputs).  Mirrors new_optimized.rs:913-1096."""
    recid = v & 0xFF
    y_odd = recid & 1
    x_ovf = (recid >> 1) & 1
    out = dict(y_odd=y_odd, x_ovf=x_ovf, t=0, ry=0, w_cert=0, nonres=False,
               rx=0, exc_inf=False, R=None)
    out["exc_s_conv"] = s >= HALF_N
    out["exc_error"] = bool(x_ovf) and r >= R_PLUS_N_OVERFLOW
    out["exc_r_zero"] = r % ec.N == 0
    out["exc_s_zero"] = s % ec.N == 0
    need_x = not out["exc_error"]
    x = (r + ec.N * x_ovf) if need_x else 0
    out["rx"] = x
    out["exc_x_range"] = need_x and x >= ec.P
    need_t = need_x and not out["exc_x_range"]
    out["need_t"] = need_t
    t = (x * x * x + ec.B) % ec.P if need_t else 0
    out["t"] = t
    out["exc_t_zero"] = need_t and t == 0
    if need_t and not out["exc_t_zero"]:
        y = pow(t, (ec.P + 1) // 4, ec.P)
        if y * y % ec.P == t:
            out["ry"] = y if (y & 1) == y_odd else ec.P - y
            out["R"] = (x, out["ry"])
        else:
            out["nonres"] = True
            out["w_cert"] = pow(ec.P - t, (ec.P + 1) // 4, ec.P)
            if out["w_cert"] ** 2 % ec.P != (ec.P - t) % ec.P:
                raise ArithmeticError("no square root of -t: the non-residue certificate fails")
    out["pre_exc"] = (
        out["exc_s_conv"] or out["exc_error"] or out["exc_x_range"]
        or out["exc_r_zero"] or out["exc_s_zero"] or out["exc_t_zero"]
        or out["nonres"]
    )
    out["ladder_on"] = not out["pre_exc"]
    return out


@dataclasses.dataclass(frozen=True)
class EcrecoverWitness:
    num_calls: int
    calls: LogQueries
    call_execute: torch.Tensor
    call_chain: torch.Tensor
    scalars: dict  # per-call limbs + flags (see _SCALAR_KEYS)
    points: dict  # per-call point/exception columns (see _POINT_KEYS)
    steps: dict  # ladder step columns, (C*512, ...)
    step_execute: torch.Tensor
    reads: MemoryQueries  # (4C,)
    writes: MemoryQueries  # (2C,)
    mem_chain: torch.Tensor
    addresses: torch.Tensor  # (C, 8) u32 LE limbs of the recovered address


def _curve_columns(pts: _W, a: dict, ladder: bool):
    """rx, curve_w, t, ry and w_cert with their quotients, where defined."""
    need_x = not a["exc_error"]
    x = a["rx"] if need_x else 0
    pts.add(rx=x)
    if a["need_t"]:
        w_sq = x * x % ec.P
        q_ry = 0 if a["nonres"] else (a["ry"] ** 2 - a["t"]) // ec.P
        pts.add(curve_w=w_sq, q_curve_w=(x * x) // ec.P, t=a["t"],
                q_t=(x * w_sq + ec.B - a["t"]) // ec.P, ry=a["ry"], q_ry=q_ry)
        if ladder:
            pts.add(w_cert=0, q_w=0)
        else:
            pts.add(w_cert=a["w_cert"], q_w=(a["w_cert"] ** 2 + a["t"]) // ec.P)
    else:
        pts.add(curve_w=0, t=0, ry=0, w_cert=0, q_curve_w=0, q_t=0, q_ry=0, q_w=0)


def generate_witness(calls: list, memory: dict, config: EcrecoverConfig, mem_init_state=None,
                     device=None) -> EcrecoverWitness:
    """calls: LogQuery dicts (key = ABI: [0]=in word off, [2]=out word off,
    [4]=in page, [5]=out page).  memory[(page, word)] = 32-byte value.
    Input layout at in_off: [digest, v, r, s].  `device=None` is the card."""
    device = resolve_device(device)
    C = max(len(calls), 1)
    S = 2 * BITS

    sc, pts, steps = _W(), _W(), _W()
    step_exec = []
    read_rows, write_rows = [], []
    addresses = []

    for call in calls:
        kl = pc.key_limbs(call["key"])
        in_off, out_off, in_page, out_page = kl[0], kl[2], kl[4], kl[5]
        ts = int(call["timestamp"])

        def word(idx):
            return int.from_bytes(memory.get((in_page, in_off + idx), b"\x00" * 32), "big")

        h, v, r, s = word(0), word(1), word(2), word(3)
        for j, val in enumerate([h, v, r, s]):
            read_rows.append(dict(timestamp=ts, memory_page=in_page, index=in_off + j,
                                  rw_flag=False, is_ptr=False, value=val))
        a = _analyze_call(h, v, r, s)
        sc.add(r=r, s=s, h=h, nonres=int(a["nonres"]))

        valid = False
        if not a["ladder_on"]:
            # masked failure: ladder gated off (2*BITS dummy rows keep the
            # per-call step layout); still bind rx/t/ry/w_cert where defined
            for _ in range(S):
                _dummy_step(steps)
            step_exec += [False] * S
            sc.add(u1=0, u2=0, r_inv=0, q_rinv=0, q_u1=0, q_u2=0, exc_inf=0)
            _curve_columns(pts, a, ladder=False)
            pts.add(qx=0, qy=0, acc1x=0, acc1y=0, acc2x=0, acc2y=0, f_lam=0, f_qa=0, f_qb=0,
                    f_qc=0, f_qd=0, f_qe=0, f_qf=0)
        else:
            r_inv = pow(r % ec.N, -1, ec.N)
            u1 = (-h * r_inv) % ec.N
            u2 = (s * r_inv) % ec.N
            sc.add(u1=u1, u2=u2, r_inv=r_inv, q_rinv=(r * r_inv - 1) // ec.N,
                   q_u1=(h * r_inv + u1) // ec.N, q_u2=(s * r_inv - u2) // ec.N)
            _curve_columns(pts, a, ladder=True)

            # two ladders
            accs = []
            for scalar, base in ((u1, (ec.GX, ec.GY)), (u2, a["R"])):
                acc = None
                cur = base
                for i in range(BITS):
                    bit = (scalar >> i) & 1
                    steps.add(base_x=cur[0], base_y=cur[1], acc_x=acc[0] if acc else 0,
                              acc_y=acc[1] if acc else 0, acc_inf=int(acc is None), bit=bit)
                    nxt_base = _double_witness(steps, cur)
                    if bit:
                        # the add row's own sum where it is one (x1 != x2), else the group law
                        new_acc = _add_witness(steps, acc, cur)
                        if acc is None:
                            new_acc = cur
                        elif new_acc is None:
                            new_acc = ec.add(acc, cur)
                    else:
                        new_acc = acc
                        _add_witness(steps, None, None)
                    steps.add(base_nx=nxt_base[0], base_ny=nxt_base[1],
                              acc_nx=new_acc[0] if new_acc else 0,
                              acc_ny=new_acc[1] if new_acc else 0,
                              acc_ninf=int(new_acc is None))
                    step_exec.append(True)
                    acc = new_acc
                    cur = nxt_base
                accs.append(acc)

            acc1, acc2 = accs
            # acc2 = u2*R with u2 != 0 (mod n) -> never infinity here
            if acc2 is None:
                raise ArithmeticError("u2 * R is the point at infinity")
            exc_inf = (acc1 is not None and acc1[0] == acc2[0]
                       and (acc1[1] + acc2[1]) % ec.P == 0)
            sc.add(exc_inf=int(exc_inf))
            pts.add(acc1x=acc1[0] if acc1 else 0, acc1y=acc1[1] if acc1 else 0,
                    acc2x=acc2[0], acc2y=acc2[1])
            Q = None
            if exc_inf or acc1 is None:
                # infinity, or u1 == 0 (zero message hash): Q = acc2 directly
                Q = None if exc_inf else acc2
                _add_witness(pts, None, None, prefix="f_")
            else:
                if acc1[0] == acc2[0]:
                    raise ArithmeticError("doubling coincidence (prob ~2^-256)")
                Q = _add_witness(pts, acc1, acc2, prefix="f_")
            pts.add(qx=Q[0] if Q else 0, qy=Q[1] if Q else 0)
            valid = Q is not None

        sc.add(call_valid=int(valid))
        if valid:
            addr = ec.eth_address(Q)
            addresses.append(addr)
            values = (1, addr)
        else:
            addresses.append(0)
            values = (0, 0)
        for word_i, value in enumerate(values):
            write_rows.append(dict(timestamp=ts + 1, memory_page=out_page, index=out_off + word_i,
                                   rw_flag=True, is_ptr=False, value=value))

    steps_t = steps.stack(C * S, _STEP_KEYS, device)
    step_exec += [False] * (C * S - len(step_exec))
    scalars = sc.stack(C, _SCALAR_KEYS, device)
    points = pts.stack(C, _POINT_KEYS, device)

    reads = pc.memory_rows(read_rows, 4 * C, device)
    writes = pc.memory_rows(write_rows, 2 * C, device)
    order = []
    for ci in range(len(calls)):
        order += read_rows[4 * ci: 4 * ci + 4] + write_rows[2 * ci: 2 * ci + 2]
    mem_q = pc.memory_rows(order, 6 * C, device)
    mem_exec = pc.executed(6 * C, len(order), device)
    (mem_chain,) = queues.simulate_chains(
        queues.FULL_STATE_WIDTH, [(encode_memory_queries(mem_q), mem_exec)],
        init=[mem_init_state])
    calls_q = pc.call_rows(calls, C, device)
    call_exec = pc.executed(C, len(calls), device)
    (call_chain,) = queues.simulate_chains(
        queues.NARROW_STATE_WIDTH, [(encode_log_queries(calls_q), call_exec)])
    addr_limbs = np.zeros((C, 8), np.int64)
    for i, addr in enumerate(addresses):
        addr_limbs[i] = [(addr >> (32 * k)) & M32 for k in range(8)]

    return EcrecoverWitness(
        num_calls=len(calls),
        calls=calls_q,
        call_execute=call_exec,
        call_chain=call_chain,
        scalars=scalars,
        points=points,
        steps=steps_t,
        step_execute=torch.tensor(step_exec, dtype=torch.bool, device=device),
        reads=reads,
        writes=writes,
        mem_chain=mem_chain,
        addresses=torch.from_numpy(addr_limbs).to(device),
    )


_P = ec.P
_N = ec.N


def _const(value: int, batch, device) -> torch.Tensor:
    limbs = torch.from_numpy(nn.from_int(value).astype(np.int64)).to(device)
    return limbs.expand(tuple(batch) + (16,))


def _check_double(st, batch):
    """group-law identities for base doubling (all rows)."""
    x, y, lam = st["base_x"], st["base_y"], st["d_lam"]
    xn, yn = st["base_nx"], st["base_ny"]
    pc_ = _const(_P, batch, x.device)

    def pl(q):
        return ("prod", q, pc_, 1)

    i1 = nn.sides_equal([("prod", lam, y, 2), pl(st["d_qb"])],
                        [("prod", x, x, 3), pl(st["d_qa"])], batch)
    i2 = nn.sides_equal([("prod", lam, lam, 1), pl(st["d_qd"])],
                        [("lin", xn, 1), ("lin", x, 2), pl(st["d_qc"])], batch)
    i3 = nn.sides_equal([("prod", lam, x, 1), pl(st["d_qf"])],
                        [("prod", lam, xn, 1), ("lin", yn, 1), ("lin", y, 1), pl(st["d_qe"])],
                        batch)
    return i1 & i2 & i3


def _check_add(x1, y1, x2, y2, x3, y3, lam, qa, qb, qc, qd, qe, qf, batch):
    pc_ = _const(_P, batch, x1.device)

    def pl(q):
        return ("prod", q, pc_, 1)

    i1 = nn.sides_equal([("prod", lam, x2, 1), ("lin", y1, 1), pl(qb)],
                        [("prod", lam, x1, 1), ("lin", y2, 1), pl(qa)], batch)
    i2 = nn.sides_equal([("prod", lam, lam, 1), pl(qd)],
                        [("lin", x3, 1), ("lin", x1, 1), ("lin", x2, 1), pl(qc)], batch)
    i3 = nn.sides_equal([("prod", lam, x1, 1), pl(qf)],
                        [("prod", lam, x3, 1), ("lin", y3, 1), ("lin", y1, 1), pl(qe)], batch)
    return i1 & i2 & i3


def _limbs_eq_const(a, value: int):
    """a (..., 16) u16 limbs == constant 256-bit value."""
    return (a == _const(value, a.shape[:-1], a.device)).all(-1)


def _u16_pairs_eq_u32(limbs16, words32):
    """limbs16 (..., 16) u16-in-u32 recombine to words32 (..., 8) u32.

    Exact when limbs16 is range-checked (<= 0xFFFF)."""
    lo = limbs16[..., 0::2]
    hi = limbs16[..., 1::2]
    return (((lo + (hi << 16)) & M32) == words32).all(-1)


def _be_bytes(limbs16):
    """16 u16 LE limbs -> (..., 32) BE bytes."""
    return torch.stack([(limbs16[..., i // 2] >> (8 * (i % 2))) & 0xFF
                        for i in range(31, -1, -1)], dim=-1)


def eval_constraints(w: EcrecoverWitness, config: EcrecoverConfig,
                     window: Optional[RowWindow] = None) -> dict:
    """Row-parallel constraint evaluation on the witness's device; every
    entry must be all-True.  `window` places a block of ladder steps in its
    run (`parallel/auto.py`); None is the whole run."""
    res = {}
    C = w.call_execute.shape[0]
    S = w.step_execute.shape[0]
    st, sc, pt = w.steps, w.scalars, w.points
    ce = w.call_execute
    dev = ce.device
    true_c = torch.ones_like(ce)

    def gate(cond, ok):
        return torch.where(cond, ok, torch.ones_like(ok))

    # --- witness limb range checks (all witness-supplied limb columns) -----
    rng = torch.ones((), dtype=torch.bool, device=dev)
    for d in (sc, pt, st):
        for v in d.values():
            if v.dim() >= 2 and v.shape[-1] in (16, 17):
                rng = rng & nn.check_range(v).all()
    res["limb_range"] = rng

    # --- call queue + precompile identity ---------------------------------
    res["call_chain"] = queues.check_chain(w.call_chain, encode_log_queries(w.calls), ce)
    res["call_is_ecrecover"] = torch.where(
        ce, pc.address_is(w.calls.address, ECRECOVER_PRECOMPILE_FORMAL_ADDRESS)
        & (w.calls.aux_byte == PRECOMPILE_AUX_BYTE), true_c)

    # --- memory ABI binding (reads/writes tied to the call's ABI key) -----
    key = w.calls.key  # (C, 8) u32
    in_off, out_off = key[:, 0], key[:, 2]
    in_page, out_page = key[:, 4], key[:, 5]
    call_ts = w.calls.timestamp
    rd = torch.arange(4 * C, device=dev)
    rd_call, rd_j = rd // 4, rd % 4
    reads_ok = ((w.reads.memory_page == in_page[rd_call])
                & (w.reads.index == ((in_off[rd_call] + rd_j) & M32))
                & (w.reads.timestamp == call_ts[rd_call]) & ~w.reads.rw_flag & ~w.reads.is_ptr)
    res["reads_abi"] = gate(ce[rd_call], reads_ok)
    wr = torch.arange(2 * C, device=dev)
    wr_call, wr_j = wr // 2, wr % 2
    writes_ok = ((w.writes.memory_page == out_page[wr_call])
                 & (w.writes.index == ((out_off[wr_call] + wr_j) & M32))
                 & (w.writes.timestamp == ((call_ts[wr_call] + 1) & M32))
                 & w.writes.rw_flag & ~w.writes.is_ptr)
    res["writes_abi"] = gate(ce[wr_call], writes_ok)

    # --- bind h/r/s scalar limbs to the read tape -------------------------
    h_words, v_words = w.reads.value[0::4], w.reads.value[1::4]
    r_words, s_words = w.reads.value[2::4], w.reads.value[3::4]
    res["reads_bind_scalars"] = gate(ce, _u16_pairs_eq_u32(sc["h"], h_words)
                                     & _u16_pairs_eq_u32(sc["r"], r_words)
                                     & _u16_pairs_eq_u32(sc["s"], s_words))

    # --- recid bits from the v word low byte (new_optimized.rs:1288,924) --
    v_byte = v_words[:, 0] & 0xFF
    y_odd = v_byte & 1
    x_ovf_b = ((v_byte >> 1) & 1) == 1

    # --- in-circuit exception flags (new_optimized.rs:913-1096) -----------
    exc_s_conv = ~nn.limbs_lt(sc["s"], HALF_N)
    exc_error = x_ovf_b & ~nn.limbs_lt(sc["r"], R_PLUS_N_OVERFLOW)
    r_zero_mod_n = (sc["r"] == 0).all(-1) | _limbs_eq_const(sc["r"], _N)
    s_zero_mod_n = (sc["s"] == 0).all(-1) | _limbs_eq_const(sc["s"], _N)
    # h == 0 is allowed (ALLOW_ZERO_MESSAGE = true, new_optimized.rs:53)

    # rx binding: rx == r + n * x_overflow whenever r + n does not overflow
    need_x = ~exc_error
    rx_eq_r = (pt["rx"] == sc["r"]).all(-1)
    rx_eq_r_plus_n = nn.sides_equal([("lin", pt["rx"], 1)],
                                    [("lin", sc["r"], 1), ("const", _N)], (C,))
    res["rx_binding"] = gate(ce & need_x, torch.where(x_ovf_b, rx_eq_r_plus_n, rx_eq_r))
    exc_x_range = need_x & ~nn.limbs_lt(pt["rx"], _P)
    need_t = need_x & ~exc_x_range

    # t = rx^3 + b (mod p): curve_w == rx^2 mod p, then t == rx*curve_w + b
    p_c = _const(_P, (C,), dev)
    curve_w_ok = nn.sides_equal([("prod", pt["rx"], pt["rx"], 1)],
                                [("prod", pt["q_curve_w"], p_c, 1), ("lin", pt["curve_w"], 1)],
                                (C,))
    t_ok = nn.sides_equal([("prod", pt["rx"], pt["curve_w"], 1), ("const", ec.B)],
                          [("prod", pt["q_t"], p_c, 1), ("lin", pt["t"], 1)], (C,))
    res["t_binding"] = gate(ce & need_t, curve_w_ok & t_ok)
    exc_t_zero = need_t & (pt["t"] == 0).all(-1)

    # residue status: either ry^2 == t (residue) or w^2 == -t (non-residue)
    nonres = sc["nonres"] == 1
    has_y = need_t & ~exc_t_zero & ~nonres
    ry_sq_ok = nn.sides_equal([("prod", pt["ry"], pt["ry"], 1)],
                              [("prod", pt["q_ry"], p_c, 1), ("lin", pt["t"], 1)], (C,))
    res["ry_lift"] = gate(ce & has_y, ry_sq_ok)
    w_cert_ok = nn.sides_equal([("prod", pt["w_cert"], pt["w_cert"], 1), ("lin", pt["t"], 1)],
                               [("prod", pt["q_w"], p_c, 1)], (C,))
    res["nonres_cert"] = gate(ce & need_t & ~exc_t_zero & nonres, w_cert_ok)
    # the nonres flag only means anything where t is bound
    res["nonres_flag_domain"] = gate(ce & ~(need_t & ~exc_t_zero), ~nonres)
    exc_nonres = need_t & ~exc_t_zero & nonres

    res["r_point_range"] = gate(ce & has_y, nn.limbs_lt(pt["ry"], _P))
    res["ry_parity"] = gate(ce & has_y, (pt["ry"][:, 0] & 1) == y_odd)

    pre_exc = (exc_s_conv | exc_error | exc_x_range | r_zero_mod_n
               | s_zero_mod_n | exc_t_zero | exc_nonres)
    ladder_on = ce & ~pre_exc

    # acc1/acc2 infinity flags from the checked ladder's last steps: each
    # call's pair of acc_ninf values, summed over the run's own steps (the
    # residuals that read them are sums over the members of a window)
    row0 = window.row0 if window else 0
    idx = torch.arange(row0, row0 + S, device=dev)  # run steps
    step_call = idx // (2 * BITS)
    in_pair = idx % (2 * BITS)
    ends = (torch.stack([in_pair == BITS - 1, in_pair == 2 * BITS - 1], dim=-1)
            & owned_rows(window, S, dev)[:, None])
    flags = torch.where(ends, st["acc_ninf"][:, None], 0)
    ladder_ends = torch.zeros((C, 2), dtype=torch.int64, device=dev).index_add_(0, step_call, flags)

    def by_ends(residual):
        return summed(ladder_ends, lambda s: residual(s[:, 0] == 1, s[:, 1] == 1), window)

    exc_inf_flag = sc["exc_inf"] == 1
    # infinity certificate: acc1 == -acc2 (both finite, x equal, y's sum to p)
    acc_opposite = ((pt["acc1x"] == pt["acc2x"]).all(-1)
                    & nn.sides_equal([("lin", pt["acc1y"], 1), ("lin", pt["acc2y"], 1)],
                                     [("const", _P)], (C,)))
    res["exc_inf_cert"] = by_ends(lambda acc1_inf, acc2_inf: gate(
        ladder_on & exc_inf_flag, ~acc1_inf & ~acc2_inf & acc_opposite))
    res["exc_inf_domain"] = gate(~ladder_on, ~exc_inf_flag)

    valid = ladder_on & ~exc_inf_flag
    res["call_valid_binding"] = gate(ce, (sc["call_valid"] == 1) == valid)

    # --- scalar derivation (mod n), gated on ladder_on --------------------
    n_c = _const(_N, (C,), dev)
    one = torch.zeros((C, 16), dtype=torch.int64, device=dev)
    one[:, 0] = 1
    ok = nn.sides_equal([("prod", sc["r"], sc["r_inv"], 1)],
                        [("prod", sc["q_rinv"], n_c, 1), ("lin", one, 1)], (C,))
    ok &= nn.sides_equal([("prod", sc["h"], sc["r_inv"], 1), ("lin", sc["u1"], 1)],
                         [("prod", sc["q_u1"], n_c, 1)], (C,))
    ok &= nn.sides_equal([("prod", sc["s"], sc["r_inv"], 1)],
                         [("prod", sc["q_u2"], n_c, 1), ("lin", sc["u2"], 1)], (C,))
    res["scalar_derivation"] = gate(ladder_on, ok)

    # --- ladder steps -----------------------------------------------------
    sbatch = (S,)
    se = w.step_execute
    # step_execute is fully determined by the per-call ladder_on flag
    res["step_execute_binding"] = se == ladder_on[step_call]
    res["double_steps"] = gate(se, _check_double(st, sbatch))
    bit = st["bit"]
    acc_inf = st["acc_inf"] == 1
    acc_ninf = st["acc_ninf"] == 1
    do_add = se & (bit == 1) & ~acc_inf
    add_ok = _check_add(st["acc_x"], st["acc_y"], st["base_x"], st["base_y"],
                        st["acc_nx"], st["acc_ny"], st["a_lam"],
                        st["a_qa"], st["a_qb"], st["a_qc"], st["a_qd"], st["a_qe"], st["a_qf"],
                        sbatch)
    res["add_steps"] = gate(do_add, add_ok)
    # distinct x for real adds (group-law completeness guard)
    res["add_distinct_x"] = gate(do_add, (st["acc_x"] != st["base_x"]).any(-1))
    # bit==1 & inf: acc_next = base; bit==0: acc_next = acc; inf flag updates
    take_base = se & (bit == 1) & acc_inf
    keep = se & (bit == 0)
    res["acc_assignment"] = (
        gate(take_base, (st["acc_nx"] == st["base_x"]).all(-1)
             & (st["acc_ny"] == st["base_y"]).all(-1))
        & gate(keep, (st["acc_nx"] == st["acc_x"]).all(-1) & (st["acc_ny"] == st["acc_y"]).all(-1))
        & gate(se, acc_ninf == (acc_inf & (bit == 0))))

    # step chaining: base/acc continuity within each 256-step ladder
    pos_in_ladder = idx % BITS
    not_first = (pos_in_ladder > 0) & se

    def prev(a):
        return torch.cat([a[:1], a[:-1]])

    cont = ((st["base_x"] == prev(st["base_nx"])).all(-1)
            & (st["base_y"] == prev(st["base_ny"])).all(-1)
            & (st["acc_x"] == prev(st["acc_nx"])).all(-1)
            & (st["acc_y"] == prev(st["acc_ny"])).all(-1)
            & (acc_inf == prev(acc_ninf)))
    res["step_continuity"] = gate(not_first, cont)
    # ladder starts: first step of ladder1 has base = G; ladder2 base = R
    is_l2_start = (pos_in_ladder == 0) & (in_pair == BITS)
    gx = _const(ec.GX, (S,), dev)
    gy = _const(ec.GY, (S,), dev)
    res["ladder1_base"] = gate(se & (in_pair == 0), (st["base_x"] == gx).all(-1)
                               & (st["base_y"] == gy).all(-1) & acc_inf)
    res["ladder2_base"] = gate(se & is_l2_start, (st["base_x"] == pt["rx"][step_call]).all(-1)
                               & (st["base_y"] == pt["ry"][step_call]).all(-1) & acc_inf)
    # scalar bits match u1/u2 decomposition
    limb_idx = (pos_in_ladder // 16)[:, None]
    bit_in_limb = pos_in_ladder % 16
    is_l2 = in_pair >= BITS
    limb = torch.where(is_l2, sc["u2"][step_call].gather(1, limb_idx)[:, 0],
                       sc["u1"][step_call].gather(1, limb_idx)[:, 0])
    res["scalar_bits"] = gate(se, bit == ((limb >> bit_in_limb) & 1))

    # the last step of each ladder must carry acc == acc1/acc2
    last1 = in_pair == BITS - 1
    last2 = in_pair == 2 * BITS - 1
    res["ladder_results"] = (
        gate(se & last1 & ~acc_ninf, (st["acc_nx"] == pt["acc1x"][step_call]).all(-1)
             & (st["acc_ny"] == pt["acc1y"][step_call]).all(-1))
        & gate(se & last2 & ~acc_ninf, (st["acc_nx"] == pt["acc2x"][step_call]).all(-1)
               & (st["acc_ny"] == pt["acc2y"][step_call]).all(-1)))
    # acc2 must be finite for a running ladder (u2 != 0 given s != 0 mod n)
    res["acc2_finite"] = by_ends(lambda acc1_inf, acc2_inf: gate(ladder_on, ~acc2_inf))

    # --- final addition: Q = acc1 + acc2 (or Q = acc2 when u1 == 0) -------
    final_ok = _check_add(pt["acc1x"], pt["acc1y"], pt["acc2x"], pt["acc2y"],
                          pt["qx"], pt["qy"], pt["f_lam"],
                          pt["f_qa"], pt["f_qb"], pt["f_qc"], pt["f_qd"], pt["f_qe"], pt["f_qf"],
                          (C,))
    res["final_add"] = by_ends(lambda acc1_inf, acc2_inf: gate(valid & ~acc1_inf, final_ok))
    distinct_x = (pt["acc1x"] != pt["acc2x"]).any(-1)
    res["final_add_distinct_x"] = by_ends(
        lambda acc1_inf, acc2_inf: gate(valid & ~acc1_inf, distinct_x))
    q_is_acc2 = (pt["qx"] == pt["acc2x"]).all(-1) & (pt["qy"] == pt["acc2y"]).all(-1)
    res["final_q_from_acc2"] = by_ends(
        lambda acc1_inf, acc2_inf: gate(valid & acc1_inf, q_is_acc2))

    # --- address: keccak256(Qx_be || Qy_be)[12:] --------------------------
    pad_block = torch.zeros((C, 136), dtype=torch.int64, device=dev)
    pad_block[:, :32] = _be_bytes(pt["qx"])
    pad_block[:, 32:64] = _be_bytes(pt["qy"])
    pad_block[:, 64] = 0x01
    pad_block[:, 135] = 0x80
    zeros25 = torch.zeros((C, 25), dtype=torch.int64, device=dev)
    slo, shi = keccak.absorb_block(zeros25, zeros25, *keccak.lane_halves(pad_block))
    addr_bytes = keccak.digest_bytes(slo, shi)[:, 12:]  # (C, 20) BE address bytes
    addr_limbs = torch.zeros((C, 8), dtype=torch.int64, device=dev)
    for i in range(20):
        addr_limbs[:, (19 - i) // 4] += addr_bytes[:, i] << (8 * ((19 - i) % 4))
    res["address"] = gate(valid, (addr_limbs == w.addresses).all(-1))
    res["masked_address_zero"] = gate(ce & ~valid, (w.addresses == 0).all(-1))

    # --- memory writes: (success, masked address) -------------------------
    exp_success = valid.to(torch.int64)
    res["write_success"] = gate(ce, (w.writes.value[0::2, 0] == exp_success)
                                & (w.writes.value[0::2, 1:] == 0).all(-1))
    exp_addr = torch.where(valid[:, None], w.addresses, torch.zeros_like(w.addresses))
    res["write_address"] = gate(ce, (w.writes.value[1::2] == exp_addr).all(-1))

    # --- memory queue: encodings recomputed from the bound reads/writes ---
    def interleave(r_field, w_field):
        rf = r_field.reshape((C, 4) + tuple(r_field.shape[1:]))
        wf = w_field.reshape((C, 2) + tuple(w_field.shape[1:]))
        return torch.cat([rf, wf], dim=1).reshape((6 * C,) + tuple(r_field.shape[1:]))

    mem_q = MemoryQueries(*[interleave(getattr(w.reads, f.name), getattr(w.writes, f.name))
                            for f in dataclasses.fields(MemoryQueries)])
    mem_exec = ce[torch.arange(6 * C, device=dev) // 6]
    res["mem_chain"] = queues.check_chain(w.mem_chain, encode_memory_queries(mem_q), mem_exec)
    return res


all_ok = pc.all_ok

# row-sharded over the ladder steps: a step reads the previous step and its
# call's columns by index; the call, read, write and memory-queue fields
# stay whole on every member, their residuals computed on each and taken
# from the first; the range check is ANDed over the members; the residuals
# of the ladders' last steps' flags are sums over the members
eval_constraints.shard_plan = ShardPlan(
    halo=(1, 0),
    rows=frozenset({"steps", "step_execute"}),
    every=frozenset({"limb_range"}),
    whole=frozenset({"call_chain", "call_is_ecrecover", "reads_abi", "writes_abi",
                     "reads_bind_scalars", "rx_binding", "t_binding", "ry_lift", "nonres_cert",
                     "nonres_flag_domain", "r_point_range", "ry_parity", "exc_inf_domain",
                     "call_valid_binding", "scalar_derivation", "address", "masked_address_zero",
                     "write_success", "write_address", "mem_chain"}),
    sums=frozenset({"exc_inf_cert", "acc2_finite", "final_add", "final_add_distinct_x",
                    "final_q_from_acc2"}),
    takes_window=True,
)

# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


def instance_compact_form(w: EcrecoverWitness, config: EcrecoverConfig):
    """Single-instance ClosedFormInput (precompile I/O shape)."""
    return pc.single_instance_form(w.call_chain, w.num_calls, w.mem_chain,
                                   int(w.call_execute.sum()) * 6)
