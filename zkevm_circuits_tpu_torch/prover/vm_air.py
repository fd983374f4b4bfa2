"""main_vm committed-trace STARK (the JAX package's `prover/vm_air.py`, on
torch tensors).

The reference pins the VM to a committed trace whose satisfaction IS the
proof (`src/main_vm/cycle.rs:959-966`).  The VM witness of the EraVM oracle
(models/vm/sim.py, native_sim.py) becomes committed Goldilocks columns, one
row a cycle (the state before the cycle and the cycle's witness), and a core
subset of the cycle relation (`cycle.rs:28-795`, `pre_state.rs:71-519`,
`decoded_opcode.rs:42-220`) is proven with the two-phase STARK
(prover/stark.py); every decode-table access goes through an in-trace logUp
lookup (`decoded_opcode.rs:233`).

Proven: the skip / pending prestate and the NOP / PANIC masks; the raw
opcode's byte select by sub-pc; the decode (word split, opcode -> price and
properties by logUp against the 2^11 table, the condition by logUp against
the 64-row table, the 51-bit property spread); the fast exceptions
(out-of-ergs by a u32 compare, kernel / static mode, a full callstack);
register writeback by one-hot destinations and preservation of the others;
the register / immediate source bindings; ADD/SUB carry chains and flags;
MUL/DIV through a 256 x 256 -> 512 multiplier over u16 limbs with
byte-committed carries, SHIFT through the same multiplier with y = 2^f,
BINOP over committed operand bits; pc, timestamp, depth, ergs and frame
continuity; u8 range checks by a shared byte table; the boundary state as
challenge-RLC publics at the first and last row; the code-read memory-query
stream as an RLC public (`macc`).  Memory, storage and log queue contents,
stack operands, pointer erasure and far-call / ret semantics stay with the
evaluator `models/vm/circuit.py`, each masked by family selectors.

The trace builder is host numpy (vectorised, as the JAX one) and uploads
once; the constraints are gathered int64 groups in the JAX module's order,
so that the alpha powers are the same.  The JAX pc transition
(`vm_air.py:1540-1551`) has no term for a near call's panic to its
exception handler, so an honest witness with one does not prove in either
package (ROADMAP Queue 3).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..base_structures.memory_query import encode_memory_queries_np
from ..isa import opcodes as isa
from ..isa import system_params as sp
from ..ops import gf
from ..ops.gf import MODULUS
from ..utils.device import resolve_device
from .air_common import (Reg, byte_lookup_columns, challenge, grp, horner_prefix, masked_scan,
                         powers)
from .stark import (AirSpec, StarkParams, StarkProof, _commit_columns, challenges_from_cap,
                    prove, verify)

_MASK48 = (1 << 48) - 1
_NOP_SPREAD = isa.NOP_BITSPREAD & _MASK48
_PANIC_SPREAD = isa.PANIC_BITSPREAD & _MASK48
_NOP_ENC = isa.NOP_ENCODING
_PANIC_ENC = isa.PANIC_ENCODING
_N_PB = 51  # property bitspread width (48 description + 3 aux)
_MAX_DEPTH = sp.VM_MAX_STACK_DEPTH
# rows of one block of `debug_residuals`
_DEBUG_ROWS = 1 << 13


# ---------------------------------------------------------------------------
# column registry
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def layout() -> Tuple[Reg, Reg, Reg, list]:
    """(fixed, phase1, phase2, state_col_names)."""
    fx = Reg()
    for nm in ("t_dec_vi", "t_dec_price", "t_dec_props", "t_cond_c", "t_cond_f", "t_cond_r",
               "t_byte"):
        fx.add(nm)

    p1 = Reg()
    # the state before the cycle; the boundary-RLC publics bind this set
    state = ["depth", "pc", "sp", "ergs", "ts", "f_of", "f_eq", "f_gt", "pending", "is_kernel",
             "is_static", "code_page", "base_page", "prev_code_page", "prev_super_pc"]
    for s in state:
        p1.add(s)
    p1.add("prev_code_word", 8)
    p1.add("regs", 120)      # 15 registers x 8 u32 limbs
    p1.add("regs_ptr", 15)
    state_names = state + ["prev_code_word", "regs", "regs_ptr"]
    # the cycle's witness
    for nm, k in (("depth_inv", 1), ("skip", 1), ("ep", 1), ("normal", 1), ("eq_page", 1),
                  ("eq_page_inv", 1), ("eq_spc", 1), ("eq_spc_inv", 1), ("sro", 1),
                  ("cw_sel", 8), ("pcb0", 1), ("pcb1", 1), ("spc", 1), ("spc_b", 2),
                  ("subpc_oh", 4), ("raw_lo", 1), ("raw_hi", 1), ("variant_idx", 1),
                  ("gap0", 1), ("gap1", 1), ("cond", 1), ("e_src0", 1), ("e_src1", 1),
                  ("e_dst0", 1), ("e_dst1", 1), ("enc_bits", 16), ("imm0", 1), ("imm0_b", 2),
                  ("imm1", 1), ("imm1_b", 2), ("price", 1), ("props", 1), ("pb", _N_PB),
                  ("cond_ok", 1), ("oo", 1), ("ediff", 1), ("ediff_b", 4), ("kernel_exc", 1),
                  ("static_exc", 1), ("cs_full", 1), ("csf_inv", 1), ("p1", 1), ("p2", 1),
                  ("p3", 1), ("mask_panic", 1), ("mask_nop", 1), ("et", 16), ("ev", 10),
                  ("ef", 2), ("es", 6), ("ed", 4), ("swap", 1), ("sel0", 15), ("sel1", 15),
                  ("wsel0", 15), ("wsel1", 15), ("nz0", 1), ("inv0", 1), ("nz1", 1),
                  ("inv1", 1), ("nzw0", 1), ("invw0", 1), ("nzw1", 1), ("invw1", 1),
                  ("ew0", 1), ("ew1", 1), ("regread0", 8), ("regread1", 8), ("rr0_ptr", 1),
                  ("rr1_ptr", 1), ("src0_val", 8), ("src1_val", 8), ("s0p", 1), ("s1p", 1),
                  ("bind_s0", 1), ("bind_s0_sw", 1), ("bind_s1", 1), ("bind_s1_sw", 1),
                  ("dst0_val", 8), ("dst0_b", 32), ("d0ptr", 1), ("dst1_val", 8),
                  ("d1ptr", 1), ("carry", 8), ("as_eq", 1), ("as_sum_inv", 1), ("as_gt", 1),
                  ("upd_flags", 1), ("dst0_reg_write", 1), ("dst1_reg_write", 1),
                  ("ret_pc", 1), ("j_lo16", 1), ("j_hi16", 1), ("j_b", 4), ("pc_wrap", 1),
                  # ALU value semantics (cycle.rs:632-795): operand bytes, the
                  # shared multiplier z = x*y + a over u16 limbs (31 position
                  # carries x 3 bytes), the borrow comparator, the shift
                  # amount's (f = 16q + r) one-hots, the binop bits
                  ("src0_b", 32), ("src1_b", 32), ("dst1_b", 32), ("mx_b", 32),
                  ("my_b", 32), ("ma_b", 32), ("mzl_b", 32), ("mzh_b", 32), ("mc_b", 93),
                  ("cmp_d_b", 32), ("cmp_brw", 8), ("cmp_act", 1), ("sh_q", 16),
                  ("sh_r", 16), ("sh_nz", 1), ("sh_nz_inv", 1), ("sh_rnz", 1),
                  ("sh_full", 1), ("bb0", 256), ("bb1", 256), ("bop_and", 1), ("bop_or", 1),
                  ("bop_xor", 1), ("s1z", 1), ("s1z_inv", 1), ("d1z", 1), ("d1z_inv", 1),
                  ("nf_of", 1), ("nf_eq", 1), ("nf_gt", 1),
                  # bytes of cw_sel limbs 5..7 (the memory query's packing)
                  ("cw_b", 12), ("m_decode", 1), ("m_cond", 1), ("m_byte", 1)):
        p1.add(nm, k)

    p2 = Reg()
    for nm, k in (("inv_qd", 1), ("inv_td", 1), ("inv_qc", 1), ("inv_tc", 1),
                  ("inv_qb", len(_byte_query_names())), ("inv_tb", 1), ("acc", 1),
                  # the code-read stream RLC, the accumulator BEFORE the row
                  ("macc", 1)):
        p2.add(nm, k)
    return fx, p1, p2, state_names


def _byte_query_names() -> list:
    """(phase1 column name, lane) pairs range-checked against the byte
    table: every committed u8 limb."""
    out = [("dst0_b", j) for j in range(32)]
    out += [("ediff_b", j) for j in range(4)]
    out += [("imm0_b", j) for j in range(2)]
    out += [("imm1_b", j) for j in range(2)]
    out += [("spc_b", j) for j in range(2)]
    out += [("j_b", j) for j in range(4)]
    for nm in ("src0_b", "src1_b", "dst1_b", "mx_b", "my_b", "ma_b", "mzl_b", "mzh_b"):
        out += [(nm, j) for j in range(32)]
    out += [("mc_b", j) for j in range(93)]
    out += [("cmp_d_b", j) for j in range(32)]
    out += [("cw_b", j) for j in range(12)]
    return out


_BOOL_COLS = [
    "skip", "ep", "normal", "eq_page", "eq_spc", "sro", "pcb0", "pcb1",
    "cond_ok", "oo", "kernel_exc", "static_exc", "cs_full", "p1", "p2",
    "p3", "mask_panic", "mask_nop", "swap", "nz0", "nz1", "nzw0", "nzw1",
    "rr0_ptr", "rr1_ptr", "s0p", "s1p", "bind_s0", "bind_s0_sw", "bind_s1",
    "bind_s1_sw", "d0ptr", "d1ptr", "as_eq", "as_gt", "upd_flags",
    "dst0_reg_write", "dst1_reg_write", "pc_wrap",
    # boolean-valued state columns
    "f_of", "f_eq", "f_gt", "pending", "is_kernel", "is_static",
    "gap0", "gap1",
    "cmp_act", "sh_nz", "sh_rnz", "s1z", "d1z",
    "nf_of", "nf_eq", "nf_gt", "bop_and", "bop_or", "bop_xor",
]
_BOOL_SPANS = ["subpc_oh", "enc_bits", "pb", "et", "ev", "ef", "es", "ed",
               "sel0", "sel1", "wsel0", "wsel1", "carry",
               "cmp_brw", "sh_q", "sh_r", "bb0", "bb1"]


def _span(reg: Reg, name: str, base: int = 0) -> np.ndarray:
    s, k = reg.index[name]
    return np.arange(base + s, base + s + k)


# ---------------------------------------------------------------------------
# fixed tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _cond_table() -> np.ndarray:
    """(64,) whether condition c resolves under flags f (of | eq << 1 | gt
    << 2), at 8 c + f (tables/conditional.rs:16-58)."""
    return np.array([int(isa.condition_resolves(c, bool(f & 1), bool(f & 2), bool(f & 4)))
                     for c in range(8) for f in range(8)], np.uint64)


def fixed_tables(n: int, device=None) -> torch.Tensor:
    """The verifier-known columns at trace length n, on `device` (None: the
    card)."""
    fx = layout()[0]
    cols = np.zeros((fx.n, n), np.uint64)
    T = 1 << isa.OPCODES_TABLE_WIDTH
    assert n >= T, f"trace length {n} < decode table size {T}"
    cols[fx.at("t_dec_vi"), :T] = np.arange(T, dtype=np.uint64)
    cols[fx.at("t_dec_price"), :T] = np.asarray(isa.OPCODES_PRICES).astype(np.uint64)
    cols[fx.at("t_dec_props"), :T] = np.asarray(isa.OPCODES_PROPS_INTEGER_BITMASKS).astype(
        np.uint64)
    # the conditional-resolution table in the ISA's condition order
    cols[fx.at("t_cond_c"), :64] = np.arange(64) // 8
    cols[fx.at("t_cond_f"), :64] = np.arange(64) % 8
    cols[fx.at("t_cond_r"), :64] = _cond_table()
    cols[fx.at("t_byte"), :256] = np.arange(256, dtype=np.uint64)
    return gf.from_u64(cols, resolve_device(device))


# ---------------------------------------------------------------------------
# trace builder (host numpy; the semantics of models/vm/circuit.py)
# ---------------------------------------------------------------------------


def _np_w(w: dict, k: str) -> np.ndarray:
    return np.asarray(w[k])


def _sub_mod(a: np.ndarray, b) -> np.ndarray:
    """(a - b) mod p for u64 inputs < p."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64) * np.ones_like(a)
    return np.where(a >= b, a - b, np.uint64(MODULUS) - (b - a))


def _inv_or_zero(x: np.ndarray) -> np.ndarray:
    """Field inverse elementwise (0 -> 0): one pow a distinct value."""
    vals, where = np.unique(np.asarray(x, np.uint64), return_inverse=True)
    inv = np.array([pow(int(v), MODULUS - 2, MODULUS) if v else 0 for v in vals], np.uint64)
    return inv[where].reshape(np.shape(x))


def vm_core_trace(w: dict, limit: int, device=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(phase1 (C, n), fixed (F, n), log_n) from a host VM witness, on
    `device` (None: the card).

    Rows beyond the witness's cycles replicate the final state with skip
    semantics (depth == 0 after a clean exit), so every transition holds on
    padding rows by the same rules."""
    fx, p1, _, state_names = layout()
    total = int(np.asarray(w["ts"]).shape[0]) - 1
    need = max(total + 1, 1 << isa.OPCODES_TABLE_WIDTH)
    n = 1 << (need - 1).bit_length()

    C = np.zeros((p1.n, n), np.uint64)

    def put(name, vals):
        s, k = p1.index[name]
        vals = np.asarray(vals)
        if k == 1:
            C[s, :total] = vals[:total].astype(np.uint64)
        else:
            C[s:s + k, :total] = vals[:total].astype(np.uint64).reshape(total, k).T

    # state columns (rows 0..total-1 = the states before each cycle)
    smap = dict(depth="cs_depth", pc="ctx_pc", sp="ctx_sp", ergs="ctx_ergs", ts="ts",
                f_of="f_of", f_eq="f_eq", f_gt="f_gt", pending="pending_exc",
                is_kernel="ctx_is_kernel", is_static="ctx_is_static",
                code_page="ctx_code_page", base_page="ctx_base_page",
                prev_code_page="prev_code_page", prev_super_pc="prev_super_pc")
    for col, key in smap.items():
        put(col, _np_w(w, key)[:-1])
    put("prev_code_word", _np_w(w, "prev_code_word")[:-1])
    regs_all = _np_w(w, "regs").astype(np.uint64)  # (total + 1, 15, 8)
    ptr_all = _np_w(w, "regs_ptr").astype(np.uint64)
    C[p1.sl("regs"), :total] = regs_all[:total].reshape(total, 120).T
    C[p1.sl("regs_ptr"), :total] = ptr_all[:total].T

    # padding rows: the FINAL state (after the last cycle), NOP / skip values
    for col, key in smap.items():
        C[p1.at(col), total:] = int(np.asarray(w[key])[total])
    C[p1.sl("prev_code_word"), total:] = (
        _np_w(w, "prev_code_word")[total].astype(np.uint64)[:, None])
    C[p1.sl("regs"), total:] = regs_all[total].reshape(120)[:, None]
    C[p1.sl("regs_ptr"), total:] = ptr_all[total][:, None]

    # ---- per-cycle derivation ----
    depth = C[p1.at("depth")]
    pc = C[p1.at("pc")]
    ergs = C[p1.at("ergs")]
    pending = C[p1.at("pending")]
    skip = (depth == 0).astype(np.uint64)
    ep = (pending.astype(bool) & ~skip.astype(bool)).astype(np.uint64)
    normal = ((1 - skip) * (1 - pending)).astype(np.uint64)
    C[p1.at("depth_inv")] = _inv_or_zero(depth)
    C[p1.at("skip")] = skip
    C[p1.at("ep")] = ep
    C[p1.at("normal")] = normal

    spc = pc // 4
    sub_pc = pc % 4
    C[p1.at("pcb0")] = pc % 2
    C[p1.at("pcb1")] = (pc // 2) % 2
    C[p1.at("spc")] = spc
    C[p1.at("spc_b")] = spc % 256
    C[p1.at("spc_b") + 1] = spc // 256
    for k in range(4):
        C[p1.at("subpc_oh", k)] = (sub_pc == k).astype(np.uint64)

    dpage = _sub_mod(C[p1.at("prev_code_page")], C[p1.at("code_page")])
    eq_page = (dpage == 0).astype(np.uint64)
    C[p1.at("eq_page")] = eq_page
    C[p1.at("eq_page_inv")] = _inv_or_zero(dpage)
    dspc = _sub_mod(C[p1.at("prev_super_pc")], spc)
    eq_spc = (dspc == 0).astype(np.uint64)
    C[p1.at("eq_spc")] = eq_spc
    C[p1.at("eq_spc_inv")] = _inv_or_zero(dspc)
    sro = normal * (1 - eq_page * eq_spc)
    C[p1.at("sro")] = sro

    cwr = np.zeros((8, n), np.uint64)
    cwr[:, :total] = _np_w(w, "code_word_read")[:total].astype(np.uint64).T
    cw_sel = np.where(sro.astype(bool)[None, :], cwr, C[p1.sl("prev_code_word")])
    C[p1.sl("cw_sel")] = cw_sel

    picked_lo = np.zeros(n, np.uint64)
    picked_hi = np.zeros(n, np.uint64)
    for k in range(4):
        m = C[p1.at("subpc_oh", k)].astype(bool)
        picked_lo = np.where(m, cw_sel[6 - 2 * k], picked_lo)
        picked_hi = np.where(m, cw_sel[7 - 2 * k], picked_hi)
    raw_lo = np.where(skip.astype(bool), _NOP_ENC & 0xFFFFFFFF,
                      np.where(ep.astype(bool), _PANIC_ENC & 0xFFFFFFFF, picked_lo))
    raw_hi = np.where(skip.astype(bool), _NOP_ENC >> 32,
                      np.where(ep.astype(bool), _PANIC_ENC >> 32, picked_hi))
    C[p1.at("raw_lo")] = raw_lo
    C[p1.at("raw_hi")] = raw_hi

    vi = raw_lo & 0x7FF
    C[p1.at("variant_idx")] = vi
    C[p1.at("gap0")] = (raw_lo >> 11) & 1
    C[p1.at("gap1")] = (raw_lo >> 12) & 1
    cond = (raw_lo >> 13) & 7
    C[p1.at("cond")] = cond
    encs = {}
    for j, nm in enumerate(("e_src0", "e_src1", "e_dst0", "e_dst1")):
        encs[nm] = (raw_lo >> (16 + 4 * j)) & 0xF
        C[p1.at(nm)] = encs[nm]
        for b in range(4):
            C[p1.at("enc_bits", 4 * j + b)] = (encs[nm] >> b) & 1
    imm0 = raw_hi & 0xFFFF
    imm1 = raw_hi >> 16
    C[p1.at("imm0")] = imm0
    C[p1.at("imm0_b")] = imm0 % 256
    C[p1.at("imm0_b") + 1] = imm0 // 256
    C[p1.at("imm1")] = imm1
    C[p1.at("imm1_b")] = imm1 % 256
    C[p1.at("imm1_b") + 1] = imm1 // 256

    price = np.asarray(isa.OPCODES_PRICES).astype(np.uint64)[vi]
    props = np.asarray(isa.OPCODES_PROPS_INTEGER_BITMASKS).astype(np.uint64)[vi]
    C[p1.at("price")] = price
    C[p1.at("props")] = props
    C[p1.sl("pb")] = (props[None, :] >> np.arange(_N_PB, dtype=np.uint64)[:, None]) & 1

    packed = (C[p1.at("f_of")].astype(bool).astype(np.uint64)
              + 2 * C[p1.at("f_eq")].astype(bool).astype(np.uint64)
              + 4 * C[p1.at("f_gt")].astype(bool).astype(np.uint64))
    C[p1.at("cond_ok")] = _cond_table()[(cond * 8 + packed).astype(np.int64)]

    masked_price = (1 - skip) * price
    oo = (masked_price > ergs).astype(np.uint64)
    ediff = ergs - masked_price + oo * (1 << 32)
    C[p1.at("oo")] = oo
    C[p1.at("ediff")] = ediff
    for b in range(4):
        C[p1.at("ediff_b") + b] = (ediff >> (8 * b)) & 0xFF

    AUX = isa.AUX_BITS_OFFSET
    kernel_only = (props >> (AUX + isa.KERNEL_MODE_FLAG_IDX)) & 1
    static_ok = (props >> (AUX + isa.CAN_BE_USED_IN_STATIC_CONTEXT_FLAG_IDX)) & 1
    explicit_panic = (props >> (AUX + isa.EXPLICIT_PANIC_FLAG_IDX)) & 1
    kernel_exc = kernel_only * (1 - C[p1.at("is_kernel")])
    static_exc = C[p1.at("is_static")] * (1 - static_ok)
    ddep = _sub_mod(depth, _MAX_DEPTH)
    cs_full = (ddep == 0).astype(np.uint64)
    C[p1.at("kernel_exc")] = kernel_exc
    C[p1.at("static_exc")] = static_exc
    C[p1.at("cs_full")] = cs_full
    C[p1.at("csf_inv")] = _inv_or_zero(ddep)
    pa = explicit_panic | oo
    pb_ = pa | kernel_exc
    pcc = pb_ | static_exc
    mask_panic = pcc | cs_full
    mask_nop = (1 - mask_panic) * (1 - C[p1.at("cond_ok")])
    mask_any = mask_panic | mask_nop
    C[p1.at("p1")] = pa
    C[p1.at("p2")] = pb_
    C[p1.at("p3")] = pcc
    C[p1.at("mask_panic")] = mask_panic
    C[p1.at("mask_nop")] = mask_nop

    eff = np.where(mask_panic.astype(bool), _PANIC_SPREAD,
                   np.where(mask_nop.astype(bool), _NOP_SPREAD, props & _MASK48))
    for grp_, width, off in (("et", 16, isa.TYPE_BITS_OFFSET), ("ev", 10, isa.VARIANT_BITS_OFFSET),
                             ("ef", 2, isa.FLAG_BITS_OFFSET), ("es", 6, isa.INPUT_BITS_OFFSET),
                             ("ed", 4, isa.OUTPUT_BITS_OFFSET)):
        C[p1.sl(grp_)] = (eff[None, :] >> (off + np.arange(width, dtype=np.uint64))[:, None]) & 1

    def et(t):
        return C[p1.at("et", t)]

    def etb(t):
        return C[p1.at("et", t)].astype(bool)

    def evb(j):
        return C[p1.at("ev", j)].astype(bool)

    swap = (et(isa.SUB) + et(isa.DIV) + et(isa.SHIFT) + et(isa.PTR)) * C[p1.at("ef", 1)]
    C[p1.at("swap")] = swap

    # ---- operand one-hots + register reads ----
    def onehot(name, eff_idx):
        C[p1.sl(name)] = (eff_idx[None, :] == np.arange(1, 16, dtype=np.uint64)[:, None])
        return (eff_idx != 0).astype(np.uint64), _inv_or_zero(eff_idx % MODULUS)

    e0 = (1 - mask_any) * encs["e_src0"]
    e1 = (1 - mask_any) * encs["e_src1"]
    C[p1.at("nz0")], C[p1.at("inv0")] = onehot("sel0", e0)
    C[p1.at("nz1")], C[p1.at("inv1")] = onehot("sel1", e1)

    # dst0_reg_write: ALU rows decide from the dst mode (bound by the AIR);
    # ptr / ctx / uma / log rows from the OBSERVED register change
    is_alu = (et(isa.ADD) + et(isa.SUB) + et(isa.MUL) + et(isa.DIV) + et(isa.SHIFT)
              + et(isa.BINOP))
    dw_stack = (C[p1.at("ed", isa.DST_STACK_ABSOLUTE)] + C[p1.at("ed", isa.DST_STACK_OFFSET)]
                + C[p1.at("ed", isa.DST_STACK_PUSH_POP)])
    changed = np.zeros((15, n), bool)
    changed[:, :total] = ((regs_all[1:total + 1] != regs_all[:total]).any(-1)
                          | (ptr_all[1:total + 1] != ptr_all[:total])).T
    d0w = np.where(is_alu.astype(bool), 1 - dw_stack, 0).astype(np.uint64)
    is_wfam = (et(isa.PTR) + et(isa.CONTEXT) + et(isa.UMA) + et(isa.LOG)).astype(bool)
    chg_d0 = np.zeros(n, bool)
    chg_d1 = np.zeros(n, bool)
    for k in range(15):
        chg_d0 |= (encs["e_dst0"] == k + 1) & changed[k]
        chg_d1 |= (encs["e_dst1"] == k + 1) & changed[k]
    dst0_reg_write = np.where(is_wfam, chg_d0, d0w).astype(np.uint64)
    d1w = (et(isa.MUL) + et(isa.DIV)).astype(np.uint64)
    d1w = np.where(etb(isa.UMA), chg_d1, d1w).astype(np.uint64)
    C[p1.at("dst0_reg_write")] = dst0_reg_write
    C[p1.at("dst1_reg_write")] = d1w
    ew0 = dst0_reg_write * (1 - mask_any) * encs["e_dst0"]
    ew1 = d1w * (1 - mask_any) * encs["e_dst1"]
    C[p1.at("ew0")] = ew0
    C[p1.at("ew1")] = ew1
    C[p1.at("nzw0")], C[p1.at("invw0")] = onehot("wsel0", ew0)
    C[p1.at("nzw1")], C[p1.at("invw1")] = onehot("wsel1", ew1)

    regs_cols = C[p1.sl("regs")].reshape(15, 8, n)
    ptr_cols = C[p1.sl("regs_ptr")]
    sel0 = C[p1.sl("sel0")]
    sel1 = C[p1.sl("sel1")]
    # one-hot selections of limbs < 2^32: exact in u64, below p
    C[p1.sl("regread0")] = (sel0[:, None, :] * regs_cols).sum(0) % MODULUS
    C[p1.sl("regread1")] = (sel1[:, None, :] * regs_cols).sum(0) % MODULUS
    rr0p = (sel0 * ptr_cols).sum(0) % MODULUS
    rr1p = (sel1 * ptr_cols).sum(0) % MODULUS
    C[p1.at("rr0_ptr")] = rr0p
    C[p1.at("rr1_ptr")] = rr1p

    # src values: the evaluator's witness (after swap and erasure)
    s0v = np.zeros((8, n), np.uint64)
    s1v = np.zeros((8, n), np.uint64)
    s0v[:, :total] = _np_w(w, "src0_val")[:total].astype(np.uint64).T
    s1v[:, :total] = _np_w(w, "src1_val")[:total].astype(np.uint64).T
    C[p1.sl("src0_val")] = s0v
    C[p1.sl("src1_val")] = s1v
    C[p1.at("s0p"), :total] = _np_w(w, "src0_is_ptr")[:total].astype(np.uint64)
    C[p1.at("s1p"), :total] = _np_w(w, "src1_is_ptr")[:total].astype(np.uint64)
    es_reg = C[p1.at("es", isa.SRC_REG)]
    C[p1.at("bind_s0")] = (1 - swap) * es_reg * (1 - rr0p)
    C[p1.at("bind_s0_sw")] = swap * (1 - rr1p)
    C[p1.at("bind_s1")] = (1 - swap) * (1 - rr1p)
    C[p1.at("bind_s1_sw")] = swap * es_reg * (1 - rr0p)

    # ---- dst values: add / sub computed; the other families' from the witness
    is_add, is_sub = etb(isa.ADD), etb(isa.SUB)
    addv = np.zeros((8, n), np.uint64)
    subv = np.zeros((8, n), np.uint64)
    addc = np.zeros((8, n), np.uint64)
    subb = np.zeros((8, n), np.uint64)
    cprev = np.zeros(n, np.uint64)
    bprev = np.zeros(n, np.uint64)
    for l in range(8):
        t = s0v[l] + s1v[l] + cprev
        addc[l] = (t >> 32) & 1
        addv[l] = t & 0xFFFFFFFF
        cprev = addc[l]
        d = s0v[l] - s1v[l] - bprev
        subb[l] = (d >> 63) & 1  # a wrapped negative in u64
        subv[l] = d + subb[l] * (1 << 32)
        bprev = subb[l]
    zeros8 = np.zeros((8, n), np.uint64)
    d0 = np.where(is_add[None], addv, np.where(is_sub[None], subv, zeros8))
    carries = np.where(is_add[None], addc, np.where(is_sub[None], subb, zeros8))
    # the other families: dst0 from the next row's register file where written
    regs_next = np.empty((120, n), np.uint64)
    regs_next[:, :total] = regs_all[1:total + 1].reshape(total, 120).T
    regs_next[:, total:] = regs_all[total].reshape(120)[:, None]
    regs_next = regs_next.reshape(15, 8, n)
    ptr_next = np.stack([ptr_cols_next(k, w, total, n) for k in range(15)])
    wsel0 = C[p1.sl("wsel0")].astype(bool)
    wsel1 = C[p1.sl("wsel1")].astype(bool)
    other = ~(is_add | is_sub)
    for k in range(15):
        d0 = np.where((other & wsel0[k])[None], regs_next[k], d0)
    # ALU families: dst0 is the family RESULT (bound by the relations below)
    fam0 = np.zeros((8, n), np.uint64)
    fam1 = np.zeros((8, n), np.uint64)
    fam0[:, :total] = _np_w(w, "fam_res0")[:total].astype(np.uint64).T
    fam1[:, :total] = _np_w(w, "fam_res1")[:total].astype(np.uint64).T
    is_mulr, is_divr = etb(isa.MUL), etb(isa.DIV)
    is_shiftr, is_binr = etb(isa.SHIFT), etb(isa.BINOP)
    is_shl_r = is_shiftr & evb(isa.SHIFT_SHL)
    is_shr_r = is_shiftr & evb(isa.SHIFT_SHR)
    is_cyc_r = is_shiftr & (evb(isa.SHIFT_ROL) | evb(isa.SHIFT_ROR))
    is_and_r = is_binr & evb(isa.BINOP_AND)
    is_or_r = is_binr & evb(isa.BINOP_OR)
    is_xor_r = is_binr & evb(isa.BINOP_XOR)
    bin_r = np.where(is_and_r[None], s0v & s1v,
                     np.where(is_or_r[None], s0v | s1v,
                              np.where(is_xor_r[None], s0v ^ s1v, zeros8)))
    shift_r = np.where(is_cyc_r[None], fam0 | fam1, fam0)
    d0 = np.where((is_mulr | is_divr)[None], fam0, d0)
    d0 = np.where(is_shiftr[None], shift_r, d0)
    d0 = np.where(is_binr[None], bin_r, d0)
    C[p1.sl("dst0_val")] = d0
    C[p1.sl("carry")] = carries
    d0p = np.zeros(n, np.uint64)
    d1v = zeros8
    d1p = np.zeros(n, np.uint64)
    for k in range(15):
        d0p = np.where(wsel0[k], ptr_next[k], d0p)
        d1v = np.where(wsel1[k][None], regs_next[k], d1v)
        d1p = np.where(wsel1[k], ptr_next[k], d1p)
    C[p1.at("d0ptr")] = d0p
    d1v = np.where((is_mulr | is_divr)[None], fam1, d1v)
    C[p1.sl("dst1_val")] = d1v
    C[p1.at("d1ptr")] = d1p

    dsum = d0.sum(0)  # limbs < 2^32: the u64 sum is exact and < p
    as_eq = (dsum == 0).astype(np.uint64)
    C[p1.at("as_eq")] = as_eq
    C[p1.at("as_sum_inv")] = _inv_or_zero(dsum)
    as_gt = (1 - carries[7]) * as_eq_not(as_eq)
    C[p1.at("as_gt")] = as_gt
    C[p1.at("upd_flags")] = is_alu * C[p1.at("ef", 0)]

    # ---- ALU value-semantics blocks (mul / div / shift / binop) ----
    def put_bytes(name, limbs):
        """(8, n) u32 limbs -> 32 byte columns (4 l + b)."""
        C[p1.sl(name)] = ((limbs[:, None, :] >> (8 * np.arange(4, dtype=np.uint64))[None, :, None])
                          & 0xFF).reshape(32, n)

    put_bytes("dst0_b", d0)
    put_bytes("src0_b", s0v)
    put_bytes("src1_b", s1v)
    put_bytes("dst1_b", d1v)

    s1sum = s1v.sum(0)  # < 2^35 < p: exact
    s1z = (s1sum == 0).astype(np.uint64)
    C[p1.at("s1z")] = s1z
    C[p1.at("s1z_inv")] = _inv_or_zero(s1sum)
    d1sum = d1v.sum(0)
    d1z = (d1sum == 0).astype(np.uint64)
    C[p1.at("d1z")] = d1z
    C[p1.at("d1z_inv")] = _inv_or_zero(d1sum)

    # shift machinery: f = (ror & amt != 0) ? 256 - amt : amt; y = 2^f
    amt = s1v[0] & 0xFF
    C[p1.at("sh_nz")] = (amt != 0).astype(np.uint64)
    C[p1.at("sh_nz_inv")] = _inv_or_zero(amt)
    sh_rnz = (is_shiftr & evb(isa.SHIFT_ROR) & (amt != 0)).astype(np.uint64)
    C[p1.at("sh_rnz")] = sh_rnz
    fsh = np.where(is_shiftr, np.where(sh_rnz.astype(bool), 256 - amt, amt),
                   np.uint64(0)).astype(np.uint64)
    C[p1.at("sh_full")] = fsh
    j16 = np.arange(16, dtype=np.uint64)[:, None]
    C[p1.sl("sh_q")] = is_shiftr[None] & (fsh // 16 == j16)
    C[p1.sl("sh_r")] = is_shiftr[None] & (fsh % 16 == j16)
    pow2 = np.where(is_shiftr[None] & (fsh // 32 == np.arange(8, dtype=np.uint64)[:, None]),
                    np.uint64(1) << (fsh % 32), np.uint64(0))

    # the multiplier block z = x*y + a (512-bit), operands by family
    xm = (is_mulr | is_shl_r | is_cyc_r)[None]
    mx = np.where(xm, s0v, np.where((is_divr | is_shr_r)[None], d0, zeros8))
    my = np.where((is_mulr | is_divr)[None], s1v, np.where(is_shiftr[None], pow2, zeros8))
    # division by zero leaves the whole block zero (its bindings are masked)
    dv_mask = is_divr & (s1z == 0)
    mx = np.where((is_divr & (s1z == 1))[None], zeros8, mx)
    my = np.where((is_divr & (s1z == 1))[None], zeros8, my)
    ma = np.where(dv_mask[None], d1v, np.where(is_shr_r[None], fam1, zeros8))
    mzl = np.where(xm, fam0, np.where(dv_mask[None] | is_shr_r[None], s0v, zeros8))
    mzh = np.where(xm, fam1, zeros8)
    put_bytes("mx_b", mx)
    put_bytes("my_b", my)
    put_bytes("ma_b", ma)
    put_bytes("mzl_b", mzl)
    put_bytes("mzh_b", mzh)

    def u16limbs(v8):  # (8, n) -> (16, n)
        return ((v8[:, None, :] >> np.array([0, 16], np.uint64)[None, :, None])
                & 0xFFFF).reshape(16, n)

    x16, y16, a16 = u16limbs(mx), u16limbs(my), u16limbs(ma)
    z16 = np.concatenate([u16limbs(mzl), u16limbs(mzh)], axis=0)
    cprev = np.zeros(n, np.uint64)
    mc = np.empty((31, n), np.uint64)
    for k in range(31):
        S = cprev.copy()
        for i in range(max(0, k - 15), min(15, k) + 1):
            S += x16[i] * y16[k - i]
        if k < 16:
            S += a16[k]
        ck = (S - z16[k]) >> 16
        assert ((S - z16[k]) & 0xFFFF == 0).all(), f"mul carry at {k}"
        assert (ck < (1 << 24)).all(), f"mul carry overflow at {k}"
        mc[k] = ck
        cprev = ck
    assert (z16[31] == cprev).all(), "mul top limb != final carry"
    C[p1.sl("mc_b")] = ((mc[:, None, :] >> (8 * np.arange(3, dtype=np.uint64))[None, :, None])
                        & 0xFF).reshape(93, n)

    # comparator block: active on div (r < b) and shr (r < 2^f)
    act = dv_mask | is_shr_r
    C[p1.at("cmp_act")] = act.astype(np.uint64)
    cu = np.where(dv_mask[None], s1v, np.where(is_shr_r[None], pow2, zeros8))
    cv = np.where(dv_mask[None], d1v, np.where(is_shr_r[None], fam1, zeros8))
    bprev = act.astype(np.int64)  # the trailing "-1" of u - v - 1
    dk = np.empty((8, n), np.uint64)
    for k in range(8):
        t = cu[k].astype(np.int64) - cv[k].astype(np.int64) - bprev
        neg = (t < 0).astype(np.int64)
        dk[k] = (t + (neg << 32)).astype(np.uint64)
        C[p1.at("cmp_brw", k)] = neg.astype(np.uint64)
        bprev = neg
    assert (bprev[act] == 0).all(), "comparator: r >= bound on active row"
    put_bytes("cmp_d_b", dk)

    # binop bit decomposition (binop rows only; the bindings are masked)
    bits = np.arange(32, dtype=np.uint64)[None, :, None]
    C[p1.sl("bb0")] = np.where(is_binr[None], ((s0v[:, None, :] >> bits) & 1).reshape(256, n), 0)
    C[p1.sl("bb1")] = np.where(is_binr[None], ((s1v[:, None, :] >> bits) & 1).reshape(256, n), 0)
    C[p1.at("bop_and")] = is_and_r
    C[p1.at("bop_or")] = is_or_r
    C[p1.at("bop_xor")] = is_xor_r

    # each family's next flags (sim._op_* flag semantics)
    is_addsub = is_add | is_sub
    C[p1.at("nf_of")] = np.where(is_addsub, carries[7],
                                 np.where(is_mulr, 1 - d1z, np.where(is_divr, s1z, 0)))
    C[p1.at("nf_eq")] = np.where(is_addsub | is_mulr | is_shiftr | is_binr, as_eq,
                                 np.where(is_divr, (1 - s1z) * as_eq, 0))
    C[p1.at("nf_gt")] = np.where(is_addsub, as_gt,
                                 np.where(is_mulr, d1z * (1 - as_eq),
                                          np.where(is_divr, (1 - s1z) * d1z, 0)))

    # the memory-query packing bytes of cw_sel limbs 5..7 (every row)
    C[p1.sl("cw_b")] = ((cw_sel[5:8, None, :] >> (8 * np.arange(4, dtype=np.uint64))[None, :, None])
                        & 0xFF).reshape(12, n)

    C[p1.at("ret_pc"), :total] = _np_w(w, "ret_popped_pc")[:total].astype(np.uint64)
    j16 = s0v[0] & 0xFFFF
    jh = s0v[0] >> 16
    C[p1.at("j_lo16")] = j16
    C[p1.at("j_hi16")] = jh
    C[p1.at("j_b")] = j16 % 256
    C[p1.at("j_b") + 1] = j16 // 256
    C[p1.at("j_b") + 2] = jh % 256
    C[p1.at("j_b") + 3] = jh // 256
    C[p1.at("pc_wrap")] = (pc == 0xFFFF).astype(np.uint64)

    # ---- lookup multiplicities ----
    C[p1.at("m_decode")] = np.bincount(vi.astype(np.int64), minlength=n)[:n]
    C[p1.at("m_cond")] = np.bincount((cond * 8 + packed).astype(np.int64), minlength=n)[:n]
    qb_ix = np.array([p1.at(nm, j) for (nm, j) in _byte_query_names()], np.int64)
    counts = np.zeros(n, np.int64)
    for i in range(0, len(qb_ix), 64):
        counts += np.bincount(C[qb_ix[i:i + 64]].reshape(-1).astype(np.int64), minlength=n)[:n]
    C[p1.at("m_byte")] = counts

    device = resolve_device(device)
    return gf.from_u64(C, device), fixed_tables(n, device), n.bit_length() - 1


def ptr_cols_next(k: int, w: dict, total: int, n: int) -> np.ndarray:
    """register k's pointer flag after each row (the final one on padding)."""
    pn = np.zeros(n, np.uint64)
    pall = np.asarray(w["regs_ptr"]).astype(np.uint64)
    pn[:total] = pall[1:total + 1, k]
    pn[total:] = pall[total, k]
    return pn


def as_eq_not(x: np.ndarray) -> np.ndarray:
    return (1 - x).astype(np.uint64)


# ---------------------------------------------------------------------------
# the AIR
# ---------------------------------------------------------------------------

# challenge indices
_XD, _BD, _XC, _BC, _XB, _RLC, _MQ = range(7)


@functools.lru_cache(maxsize=4)
def _index_tensors(device: torch.device) -> dict:
    """The AIR's gather indices as int64 tensors on `device`."""
    fx, p1, p2, state_names = layout()
    F, P1 = fx.n, p1.n
    at = {nm: F + s for nm, (s, _) in p1.index.items()}
    ix = dict(
        bool=np.array([at[nm] for nm in _BOOL_COLS]
                      + [j for nm in _BOOL_SPANS for j in _span(p1, nm, F)], np.int64),
        byte_q=np.array([at[nm] + j for (nm, j) in _byte_query_names()], np.int64),
        state=np.array([j for nm in state_names for j in _span(p1, nm, F)], np.int64),
        inv_qb=_span(p2, "inv_qb", F + P1),
        pb_groups={off: at["pb"] + off + np.arange(width)
            for width, off in ((16, isa.TYPE_BITS_OFFSET), (10, isa.VARIANT_BITS_OFFSET),
                               (2, isa.FLAG_BITS_OFFSET), (6, isa.INPUT_BITS_OFFSET),
                               (4, isa.OUTPUT_BITS_OFFSET))},
    )
    for nm, (s, k) in p1.index.items():
        if k > 1:
            ix[nm] = np.arange(F + s, F + s + k)
    # strided lanes: u16 limbs from byte pairs, u32 limbs from byte quads,
    # the multiplier's 3-byte carries
    for nm, stride in (("mx_b", 2), ("my_b", 2), ("ma_b", 2), ("mzl_b", 2), ("mzh_b", 2),
                       ("dst0_b", 2), ("mc_b", 3), ("dst0_b", 4), ("src0_b", 4),
                       ("src1_b", 4), ("dst1_b", 4), ("cmp_d_b", 4)):
        for j in range(stride):
            ix[f"{nm}:{j}/{stride}"] = ix[nm][j::stride]

    def to_dev(v):
        if isinstance(v, dict):
            return {k: to_dev(x) for k, x in v.items()}
        return torch.as_tensor(np.asarray(v, np.int64), device=device)

    return to_dev(ix)


@functools.lru_cache(maxsize=1)
def vm_core_air() -> AirSpec:
    fx, p1, p2, state_names = layout()
    F, P1, P2 = fx.n, p1.n, p2.n

    def fat(name, j=0):
        return fx.at(name, j)

    def at(name, j=0):
        return F + p1.at(name, j)

    def at2(name, j=0):
        return F + P1 + p2.at(name, j)

    n_state = sum(p1.index[nm][1] for nm in state_names)
    pan_nop = {off: (gf.from_u64([(_PANIC_SPREAD >> (off + j)) & 1 for j in range(width)]),
                     gf.from_u64([(_NOP_SPREAD >> (off + j)) & 1 for j in range(width)]))
               for width, off in ((16, isa.TYPE_BITS_OFFSET), (10, isa.VARIANT_BITS_OFFSET),
                                  (2, isa.FLAG_BITS_OFFSET), (6, isa.INPUT_BITS_OFFSET),
                                  (4, isa.OUTPUT_BITS_OFFSET))}

    def cc(row, i):
        return row[..., i]

    def et(row, t):
        return row[..., at("et", t)]

    def etsum(row, ts_):
        v = et(row, ts_[0])
        for t in ts_[1:]:
            v = gf.add(v, et(row, t))
        return v

    def row_constraints(cur, ch):
        I = _index_tensors(cur.device)
        dev = cur.device
        one = torch.ones((), dtype=torch.int64, device=dev)

        def _not(x):
            return gf.sub(one, x)

        def sp_(name):
            return cur[..., I[name]]

        out = []
        # G1: booleanity
        b = grp(cur[..., I["bool"]])
        out.append(gf.mul(b, gf.sub(b, one)))
        skip = cc(cur, at("skip"))
        depth = cc(cur, at("depth"))
        zero = torch.zeros_like(skip)
        # G2: skip == (depth == 0)
        out.append(gf.mul(skip, depth))
        out.append(gf.mul(_not(skip), gf.sub(one, gf.mul(depth, cc(cur, at("depth_inv"))))))
        pend = cc(cur, at("pending"))
        out.append(gf.sub(cc(cur, at("ep")), gf.mul(pend, _not(skip))))
        out.append(gf.sub(cc(cur, at("normal")), gf.mul(_not(skip), _not(pend))))
        # G5/G6: page / super-pc equality flags
        pc = cc(cur, at("pc"))
        spc = cc(cur, at("spc"))
        dpage = gf.sub(cc(cur, at("prev_code_page")), cc(cur, at("code_page")))
        eqp = cc(cur, at("eq_page"))
        out.append(gf.mul(eqp, dpage))
        out.append(gf.mul(_not(eqp), gf.sub(one, gf.mul(dpage, cc(cur, at("eq_page_inv"))))))
        dspc = gf.sub(cc(cur, at("prev_super_pc")), spc)
        eqs = cc(cur, at("eq_spc"))
        out.append(gf.mul(eqs, dspc))
        out.append(gf.mul(_not(eqs), gf.sub(one, gf.mul(dspc, cc(cur, at("eq_spc_inv"))))))
        # G7: should_read_op
        out.append(gf.sub(cc(cur, at("sro")),
                          gf.mul(cc(cur, at("normal")), gf.sub(one, gf.mul(eqp, eqs)))))
        # G8: pc composition + sub-pc one-hot
        pcb0, pcb1 = cc(cur, at("pcb0")), cc(cur, at("pcb1"))
        out.append(gf.sub(pc, gf.add(gf.add(pcb0, gf.mul_const(pcb1, 2)), gf.mul_const(spc, 4))))
        out.append(gf.sub(spc, gf.add(cc(cur, at("spc_b", 0)),
                                      gf.mul_const(cc(cur, at("spc_b", 1)), 256))))
        oh = [cc(cur, at("subpc_oh", k)) for k in range(4)]
        out.append(gf.sub(gf.add(gf.add(oh[0], oh[1]), gf.add(oh[2], oh[3])), one))
        out.append(gf.sub(gf.add(oh[1], gf.add(gf.mul_const(oh[2], 2), gf.mul_const(oh[3], 3))),
                          gf.add(pcb0, gf.mul_const(pcb1, 2))))
        # G9: cw_sel == prev_code_word where not read
        nsro = _not(cc(cur, at("sro")))
        out.append(gf.mul(nsro.unsqueeze(0), grp(gf.sub(sp_("cw_sel"), sp_("prev_code_word")))))
        # G10: raw opcode select
        picked_lo, picked_hi = zero, zero
        for k in range(4):
            picked_lo = gf.add(picked_lo, gf.mul(oh[k], cc(cur, at("cw_sel", 6 - 2 * k))))
            picked_hi = gf.add(picked_hi, gf.mul(oh[k], cc(cur, at("cw_sel", 7 - 2 * k))))
        normal = cc(cur, at("normal"))
        epv = cc(cur, at("ep"))
        raw_lo = cc(cur, at("raw_lo"))
        raw_hi = cc(cur, at("raw_hi"))
        out.append(gf.sub(raw_lo, gf.add(
            gf.add(gf.mul_const(skip, _NOP_ENC & 0xFFFFFFFF),
                   gf.mul_const(epv, _PANIC_ENC & 0xFFFFFFFF)),
            gf.mul(normal, picked_lo))))
        out.append(gf.sub(raw_hi, gf.add(
            gf.add(gf.mul_const(skip, _NOP_ENC >> 32), gf.mul_const(epv, _PANIC_ENC >> 32)),
            gf.mul(normal, picked_hi))))
        # G11: decode decomposition
        comp = cc(cur, at("variant_idx"))
        for nm, sh in (("gap0", 11), ("gap1", 12), ("cond", 13), ("e_src0", 16),
                       ("e_src1", 20), ("e_dst0", 24), ("e_dst1", 28)):
            comp = gf.add(comp, gf.mul_const(cc(cur, at(nm)), 1 << sh))
        out.append(gf.sub(raw_lo, comp))
        # G12: operand-encoding bits
        for j, nm in enumerate(("e_src0", "e_src1", "e_dst0", "e_dst1")):
            v = zero
            for b_ in range(4):
                v = gf.add(v, gf.mul_const(cc(cur, at("enc_bits", 4 * j + b_)), 1 << b_))
            out.append(gf.sub(cc(cur, at(nm)), v))
        # G13: raw_hi == imm0 + 2^16 imm1 (+ byte splits)
        imm0 = cc(cur, at("imm0"))
        imm1 = cc(cur, at("imm1"))
        out.append(gf.sub(raw_hi, gf.add(imm0, gf.mul_const(imm1, 1 << 16))))
        for nm in ("imm0", "imm1"):
            out.append(gf.sub(cc(cur, at(nm)), gf.add(
                cc(cur, at(nm + "_b", 0)), gf.mul_const(cc(cur, at(nm + "_b", 1)), 256))))
        # ediff byte composition
        ed_v = zero
        for b_ in range(4):
            ed_v = gf.add(ed_v, gf.mul_const(cc(cur, at("ediff_b", b_)), 1 << (8 * b_)))
        out.append(gf.sub(cc(cur, at("ediff")), ed_v))
        price = cc(cur, at("price"))
        # G20: ergs compare: ergs - (1 - skip) price == ediff - oo 2^32
        ergs = cc(cur, at("ergs"))
        out.append(gf.sub(gf.sub(ergs, gf.mul(_not(skip), price)),
                          gf.sub(cc(cur, at("ediff")), gf.mul_const(cc(cur, at("oo")), 1 << 32))))
        # G17: property bitspread binding
        pv = zero
        for j in range(_N_PB):
            pv = gf.add(pv, gf.mul_const(cc(cur, at("pb", j)), 1 << j))
        out.append(gf.sub(cc(cur, at("props")), pv))
        # G19: exception flags
        aux = isa.AUX_BITS_OFFSET
        kernel_bit = cc(cur, at("pb", aux + isa.KERNEL_MODE_FLAG_IDX))
        static_bit = cc(cur, at("pb", aux + isa.CAN_BE_USED_IN_STATIC_CONTEXT_FLAG_IDX))
        panic_bit = cc(cur, at("pb", aux + isa.EXPLICIT_PANIC_FLAG_IDX))
        out.append(gf.sub(cc(cur, at("kernel_exc")),
                          gf.mul(kernel_bit, _not(cc(cur, at("is_kernel"))))))
        out.append(gf.sub(cc(cur, at("static_exc")),
                          gf.mul(cc(cur, at("is_static")), _not(static_bit))))
        ddep = gf.sub(depth, gf.constant(_MAX_DEPTH, dev))
        csf = cc(cur, at("cs_full"))
        out.append(gf.mul(csf, ddep))
        out.append(gf.mul(_not(csf), gf.sub(one, gf.mul(ddep, cc(cur, at("csf_inv"))))))

        # G21: panic OR-chain + nop mask
        def _or(x, y):
            return gf.sub(gf.add(x, y), gf.mul(x, y))

        oo = cc(cur, at("oo"))
        out.append(gf.sub(cc(cur, at("p1")), _or(panic_bit, oo)))
        out.append(gf.sub(cc(cur, at("p2")), _or(cc(cur, at("p1")), cc(cur, at("kernel_exc")))))
        out.append(gf.sub(cc(cur, at("p3")), _or(cc(cur, at("p2")), cc(cur, at("static_exc")))))
        mp = cc(cur, at("mask_panic"))
        out.append(gf.sub(mp, _or(cc(cur, at("p3")), csf)))
        mn = cc(cur, at("mask_nop"))
        out.append(gf.sub(mn, gf.mul(_not(mp), _not(cc(cur, at("cond_ok"))))))
        mask_any = gf.add(mp, mn)
        # G18: effective spread bits
        for grp_, off in (("et", isa.TYPE_BITS_OFFSET), ("ev", isa.VARIANT_BITS_OFFSET),
                          ("ef", isa.FLAG_BITS_OFFSET), ("es", isa.INPUT_BITS_OFFSET),
                          ("ed", isa.OUTPUT_BITS_OFFSET)):
            pan, nop = (t.to(dev) for t in pan_nop[off])
            exp = gf.add(gf.add(gf.mul(mp.unsqueeze(-1), pan), gf.mul(mn.unsqueeze(-1), nop)),
                         gf.mul(gf.sub(one, mask_any).unsqueeze(-1), cur[..., I["pb_groups"][off]]))
            out.append(grp(gf.sub(sp_(grp_), exp)))
        # no INVALID opcode may execute
        out.append(et(cur, isa.INVALID))
        # G24: swap
        swp = cc(cur, at("swap"))
        out.append(gf.sub(swp, gf.mul(etsum(cur, [isa.SUB, isa.DIV, isa.SHIFT, isa.PTR]),
                                      cc(cur, at("ef", 1)))))
        # G25/26: operand one-hot bindings
        ks = gf.from_u64(np.arange(1, 16, dtype=np.uint64), dev)

        def bind_onehot(sel_nm, nz_nm, inv_nm, eff):
            sel = sp_(sel_nm)
            out.append(gf.sub(gf.sum_mod(gf.mul(sel, ks)), eff))
            out.append(gf.sub(gf.sum_mod(sel), cc(cur, at(nz_nm))))
            out.append(gf.mul(_not(cc(cur, at(nz_nm))), eff))
            out.append(gf.sub(cc(cur, at(nz_nm)), gf.mul(eff, cc(cur, at(inv_nm)))))

        nomask = gf.sub(one, mask_any)
        bind_onehot("sel0", "nz0", "inv0", gf.mul(nomask, cc(cur, at("e_src0"))))
        bind_onehot("sel1", "nz1", "inv1", gf.mul(nomask, cc(cur, at("e_src1"))))
        # the effective write indices are committed (ew0 / ew1): degree <= 3
        d0w = cc(cur, at("dst0_reg_write"))
        d1w = cc(cur, at("dst1_reg_write"))
        out.append(gf.sub(cc(cur, at("ew0")), gf.mul(gf.mul(nomask, d0w), cc(cur, at("e_dst0")))))
        out.append(gf.sub(cc(cur, at("ew1")), gf.mul(gf.mul(nomask, d1w), cc(cur, at("e_dst1")))))
        bind_onehot("wsel0", "nzw0", "invw0", cc(cur, at("ew0")))
        bind_onehot("wsel1", "nzw1", "invw1", cc(cur, at("ew1")))
        is_alu = etsum(cur, [isa.ADD, isa.SUB, isa.MUL, isa.DIV, isa.SHIFT, isa.BINOP])
        dw_stack = gf.add(gf.add(cc(cur, at("ed", isa.DST_STACK_ABSOLUTE)),
                                 cc(cur, at("ed", isa.DST_STACK_OFFSET))),
                          cc(cur, at("ed", isa.DST_STACK_PUSH_POP)))
        out.append(gf.mul(is_alu, gf.sub(d0w, gf.sub(one, dw_stack))))
        out.append(gf.mul(etsum(cur, [isa.NOP, isa.JUMP, isa.NEAR_CALL]), d0w))
        out.append(gf.mul(etsum(cur, [isa.MUL, isa.DIV]), gf.sub(d1w, one)))
        out.append(gf.mul(gf.sub(one, etsum(cur, [isa.MUL, isa.DIV, isa.UMA])), d1w))
        # G27: register reads
        regs = sp_("regs").reshape(tuple(cur.shape[:-1]) + (15, 8))
        rr0 = gf.sum_mod(gf.mul(sp_("sel0").unsqueeze(-1), regs), dim=-2)
        rr1 = gf.sum_mod(gf.mul(sp_("sel1").unsqueeze(-1), regs), dim=-2)
        out.append(grp(gf.sub(sp_("regread0"), rr0)))
        out.append(grp(gf.sub(sp_("regread1"), rr1)))
        ptrs = sp_("regs_ptr")
        out.append(gf.sub(cc(cur, at("rr0_ptr")), gf.sum_mod(gf.mul(sp_("sel0"), ptrs))))
        out.append(gf.sub(cc(cur, at("rr1_ptr")), gf.sum_mod(gf.mul(sp_("sel1"), ptrs))))
        # G28: src-value bindings (register / imm addressing)
        es_reg = cc(cur, at("es", isa.SRC_REG))
        es_imm = cc(cur, at("es", isa.SRC_IMM))
        out.append(gf.sub(cc(cur, at("bind_s0")),
                          gf.mul(gf.mul(_not(swp), es_reg), _not(cc(cur, at("rr0_ptr"))))))
        out.append(gf.sub(cc(cur, at("bind_s0_sw")), gf.mul(swp, _not(cc(cur, at("rr1_ptr"))))))
        out.append(gf.sub(cc(cur, at("bind_s1")), gf.mul(_not(swp), _not(cc(cur, at("rr1_ptr"))))))
        out.append(gf.sub(cc(cur, at("bind_s1_sw")),
                          gf.mul(gf.mul(swp, es_reg), _not(cc(cur, at("rr0_ptr"))))))
        s0v = sp_("src0_val")
        s1v = sp_("src1_val")
        rr0c = sp_("regread0")
        rr1c = sp_("regread1")

        def vbind(mask, a_, b_):
            out.append(grp(gf.mul(mask.unsqueeze(-1), gf.sub(a_, b_))))

        vbind(cc(cur, at("bind_s0")), s0v, rr0c)
        vbind(cc(cur, at("bind_s0_sw")), s0v, rr1c)
        vbind(cc(cur, at("bind_s1")), s1v, rr1c)
        vbind(cc(cur, at("bind_s1_sw")), s1v, rr0c)
        out.append(gf.mul(cc(cur, at("bind_s0")), cc(cur, at("s0p"))))
        out.append(gf.mul(cc(cur, at("bind_s1")), cc(cur, at("s1p"))))
        # imm mode: src0 (no swap) / src1 (swap) == imm0 in limb 0, 0 above
        imm_limbs = torch.cat([imm0.unsqueeze(-1), torch.zeros_like(s0v[..., 1:])], dim=-1)
        vbind(gf.mul(es_imm, _not(swp)), s0v, imm_limbs)
        vbind(gf.mul(es_imm, swp), s1v, imm_limbs)
        # G29: add / sub carry chains onto dst0_val
        d0v = sp_("dst0_val")
        carry = [cc(cur, at("carry", l)) for l in range(8)]
        addr_, subr_ = [], []
        for l in range(8):
            cm1 = carry[l - 1] if l else zero
            addr_.append(gf.sub(gf.add(gf.add(s0v[..., l], s1v[..., l]), cm1),
                                gf.add(d0v[..., l], gf.mul_const(carry[l], 1 << 32))))
            subr_.append(gf.sub(gf.add(gf.sub(s0v[..., l], s1v[..., l]),
                                       gf.sub(gf.mul_const(carry[l], 1 << 32), cm1)),
                                d0v[..., l]))
        out.append(gf.mul(et(cur, isa.ADD).unsqueeze(0), torch.stack(addr_)))
        out.append(gf.mul(et(cur, isa.SUB).unsqueeze(0), torch.stack(subr_)))
        # ALU results are never pointers
        out.append(gf.mul(is_alu, cc(cur, at("d0ptr"))))
        # G30: dst0 zero test + gt + byte composition
        dsum = gf.sum_mod(d0v)
        aeq = cc(cur, at("as_eq"))
        out.append(gf.mul(aeq, dsum))
        out.append(gf.mul(_not(aeq), gf.sub(one, gf.mul(dsum, cc(cur, at("as_sum_inv"))))))
        out.append(gf.sub(cc(cur, at("as_gt")), gf.mul(_not(carry[7]), _not(aeq))))
        out.append(gf.sub(cc(cur, at("upd_flags")), gf.mul(
            etsum(cur, [isa.ADD, isa.SUB, isa.MUL, isa.DIV, isa.SHIFT, isa.BINOP]),
            cc(cur, at("ef", 0)))))

        def u32limbs(name):  # 32 byte columns (4 l + b) -> (batch, 8)
            v = torch.zeros_like(d0v)
            for bb in range(4):
                v = gf.add(v, gf.mul_const(cur[..., I[f"{name}:{bb}/4"]], 1 << (8 * bb)))
            return v

        out.append(grp(gf.sub(d0v, u32limbs("dst0_b"))))
        # G33: jump target split
        out.append(gf.sub(s0v[..., 0], gf.add(cc(cur, at("j_lo16")),
                                              gf.mul_const(cc(cur, at("j_hi16")), 1 << 16))))
        out.append(gf.sub(cc(cur, at("j_lo16")), gf.add(
            cc(cur, at("j_b", 0)), gf.mul_const(cc(cur, at("j_b", 1)), 256))))
        out.append(gf.sub(cc(cur, at("j_hi16")), gf.add(
            cc(cur, at("j_b", 2)), gf.mul_const(cc(cur, at("j_b", 3)), 256))))
        out.append(gf.mul(cc(cur, at("pc_wrap")), gf.sub(pc, gf.constant(0xFFFF, dev))))

        # ================= ALU value semantics (G40+) =================
        def u16(name):  # 32 byte columns -> (batch, 16) u16 limbs
            return gf.add(cur[..., I[f"{name}:0/2"]], gf.mul_const(cur[..., I[f"{name}:1/2"]], 256))

        def bind_bytes(mask, name, other=None):
            d = sp_(name)
            if other is not None:
                d = gf.sub(d, other)
            out.append(gf.mul(mask, grp(d)))

        # byte decompositions of src0 / src1 / dst1 (unmasked: they define the limbs)
        out.append(grp(gf.sub(u32limbs("src0_b"), s0v)))
        out.append(grp(gf.sub(u32limbs("src1_b"), s1v)))
        d1limbs = sp_("dst1_val")
        out.append(grp(gf.sub(u32limbs("dst1_b"), d1limbs)))

        # zero certificates
        s1sum = gf.sum_mod(s1v)
        s1z = cc(cur, at("s1z"))
        out.append(gf.mul(s1z, s1sum))
        out.append(gf.mul(_not(s1z), gf.sub(one, gf.mul(s1sum, cc(cur, at("s1z_inv"))))))
        d1sum = gf.sum_mod(d1limbs)
        d1z = cc(cur, at("d1z"))
        out.append(gf.mul(d1z, d1sum))
        out.append(gf.mul(_not(d1z), gf.sub(one, gf.mul(d1sum, cc(cur, at("d1z_inv"))))))

        # the multiplier core: z = x*y + a over u16 positions (every row;
        # inactive rows hold the all-zero block)
        x16, y16 = u16("mx_b"), u16("my_b")
        a16v, zl16, zh16 = u16("ma_b"), u16("mzl_b"), u16("mzh_b")
        carr = gf.add(gf.add(cur[..., I["mc_b:0/3"]], gf.mul_const(cur[..., I["mc_b:1/3"]], 256)),
                      gf.mul_const(cur[..., I["mc_b:2/3"]], 1 << 16))  # (batch, 31)
        P = gf.mul(x16.unsqueeze(-1), y16.unsqueeze(-2))
        P = P.reshape(tuple(P.shape[:-2]) + (256,))
        mvals = []
        for k in range(31):
            idx = [i * 16 + (k - i) for i in range(max(0, k - 15), min(15, k) + 1)]
            S = gf.sum_mod(P[..., idx], dim=-1)
            if k < 16:
                S = gf.add(S, a16v[..., k])
            if k > 0:
                S = gf.add(S, carr[..., k - 1])
            zk = zl16[..., k] if k < 16 else zh16[..., k - 16]
            mvals.append(gf.sub(S, gf.add(zk, gf.mul_const(carr[..., k], 1 << 16))))
        mvals.append(gf.sub(zh16[..., 15], carr[..., 30]))
        out.append(torch.stack(mvals))

        # family operand bindings
        et_mul, et_div = et(cur, isa.MUL), et(cur, isa.DIV)
        et_shift, et_binop = et(cur, isa.SHIFT), et(cur, isa.BINOP)
        src0b, src1b = sp_("src0_b"), sp_("src1_b")
        dst0b, dst1b = sp_("dst0_b"), sp_("dst1_b")
        # MUL: s0 * s1 + 0 = [dst0 | dst1]
        bind_bytes(et_mul, "mx_b", src0b)
        bind_bytes(et_mul, "my_b", src1b)
        bind_bytes(et_mul, "ma_b")
        bind_bytes(et_mul, "mzl_b", dst0b)
        bind_bytes(et_mul, "mzh_b", dst1b)
        # DIV (b != 0): q * b + r = [s0 | 0]; (b == 0): q = r = 0
        dvm = gf.mul(et_div, _not(s1z))
        bind_bytes(dvm, "mx_b", dst0b)
        bind_bytes(dvm, "my_b", src1b)
        bind_bytes(dvm, "ma_b", dst1b)
        bind_bytes(dvm, "mzl_b", src0b)
        bind_bytes(dvm, "mzh_b")
        dzm = gf.mul(et_div, s1z)
        bind_bytes(dzm, "dst0_b")
        bind_bytes(dzm, "dst1_b")
        # SHIFT: the amount machinery
        amt_e = cc(cur, at("src1_b", 0))
        sh_nz = cc(cur, at("sh_nz"))
        out.append(gf.mul(_not(sh_nz), amt_e))
        out.append(gf.sub(sh_nz, gf.mul(amt_e, cc(cur, at("sh_nz_inv")))))
        sh_rnz = cc(cur, at("sh_rnz"))
        out.append(gf.sub(sh_rnz, gf.mul(gf.mul(et_shift, cc(cur, at("ev", isa.SHIFT_ROR))),
                                         sh_nz)))
        sh_full = cc(cur, at("sh_full"))
        out.append(gf.sub(sh_full, gf.add(gf.mul(et_shift, amt_e),
                                          gf.sub(gf.mul_const(sh_rnz, 256),
                                                 gf.mul_const(gf.mul(sh_rnz, amt_e), 2)))))
        shq, shr_ = sp_("sh_q"), sp_("sh_r")
        out.append(gf.sub(gf.sum_mod(shq), et_shift))
        out.append(gf.sub(gf.sum_mod(shr_), et_shift))
        wq = gf.from_u64(np.arange(16, dtype=np.uint64) * 16, dev)
        wr = gf.from_u64(np.arange(16, dtype=np.uint64), dev)
        out.append(gf.sub(gf.add(gf.sum_mod(gf.mul(shq, wq)), gf.sum_mod(gf.mul(shr_, wr))),
                          sh_full))
        p2r = gf.sum_mod(gf.mul(shr_, gf.from_u64(np.uint64(1) << np.arange(16, dtype=np.uint64),
                                                  dev)))
        # y = 2^f on shift rows: y16_j = sh_q[j] 2^(f mod 16)
        out.append(gf.mul(et_shift, grp(gf.sub(y16, gf.mul(shq, p2r.unsqueeze(-1))))))
        m_shl = gf.mul(et_shift, cc(cur, at("ev", isa.SHIFT_SHL)))
        m_shr = gf.mul(et_shift, cc(cur, at("ev", isa.SHIFT_SHR)))
        m_cyc = gf.mul(et_shift, gf.add(cc(cur, at("ev", isa.SHIFT_ROL)),
                                        cc(cur, at("ev", isa.SHIFT_ROR))))
        # SHL: s0 * 2^f + 0 = [dst0 | scratch-hi]
        bind_bytes(m_shl, "mx_b", src0b)
        bind_bytes(m_shl, "ma_b")
        bind_bytes(m_shl, "mzl_b", dst0b)
        # ROL / ROR: s0 * 2^f = [zl | zh], dst0 = zl + zh (disjoint bits)
        bind_bytes(m_cyc, "mx_b", src0b)
        bind_bytes(m_cyc, "ma_b")
        out.append(gf.mul(m_cyc, grp(gf.sub(u16("dst0_b"), gf.add(zl16, zh16)))))
        # SHR: dst0 * 2^f + r = [s0 | 0]
        bind_bytes(m_shr, "mx_b", dst0b)
        bind_bytes(m_shr, "mzl_b", src0b)
        bind_bytes(m_shr, "mzh_b")
        # the comparator: r < bound on div (b) / shr (2^f) rows
        cmp_act = cc(cur, at("cmp_act"))
        out.append(gf.sub(cmp_act, gf.add(dvm, m_shr)))
        dlimb = u32limbs("cmp_d_b")
        brw = [cc(cur, at("cmp_brw", k)) for k in range(8)]
        yu32 = gf.add(y16[..., 0::2], gf.mul_const(y16[..., 1::2], 1 << 16))  # (batch, 8)
        au32 = gf.add(a16v[..., 0::2], gf.mul_const(a16v[..., 1::2], 1 << 16))
        chain_div, chain_shr = [], []
        for k in range(8):
            bm1 = brw[k - 1] if k else one  # k == 0: the trailing -1 of u - v - 1
            lhs_d = gf.sub(gf.sub(s1v[..., k], d1limbs[..., k]), bm1)
            lhs_s = gf.sub(gf.sub(yu32[..., k], au32[..., k]), bm1)
            rhs = gf.sub(dlimb[..., k], gf.mul_const(brw[k], 1 << 32))
            chain_div.append(gf.sub(lhs_d, rhs))
            chain_shr.append(gf.sub(lhs_s, rhs))
        out.append(gf.mul(dvm, torch.stack(chain_div)))
        out.append(gf.mul(m_shr, torch.stack(chain_shr)))
        out.append(gf.mul(cmp_act, brw[7]))
        # binop: bitwise ops over committed operand bits
        b0r = sp_("bb0").reshape(tuple(cur.shape[:-1]) + (32, 8))
        b1r = sp_("bb1").reshape(tuple(cur.shape[:-1]) + (32, 8))
        w8 = gf.from_u64(np.uint64(1) << np.arange(8, dtype=np.uint64), dev)
        out.append(gf.mul(et_binop, grp(gf.sub(src0b, gf.dot_mod(b0r, w8)))))
        out.append(gf.mul(et_binop, grp(gf.sub(src1b, gf.dot_mod(b1r, w8)))))
        for nm, vb in (("bop_and", isa.BINOP_AND), ("bop_or", isa.BINOP_OR),
                       ("bop_xor", isa.BINOP_XOR)):
            out.append(gf.sub(cc(cur, at(nm)), gf.mul(et_binop, cc(cur, at("ev", vb)))))
        and_b = gf.dot_mod(gf.mul(b0r, b1r), w8)             # (batch, 32)
        sum_b = gf.dot_mod(gf.add(b0r, b1r), w8)
        or_b = gf.sub(sum_b, and_b)
        xor_b = gf.sub(sum_b, gf.double(and_b))
        res_b = gf.add(gf.add(gf.mul(cc(cur, at("bop_and")).unsqueeze(-1), and_b),
                              gf.mul(cc(cur, at("bop_or")).unsqueeze(-1), or_b)),
                       gf.mul(cc(cur, at("bop_xor")).unsqueeze(-1), xor_b))
        out.append(grp(gf.sub(gf.mul(et_binop.unsqueeze(-1), dst0b), res_b)))
        # each family's next-flag bindings
        et_as = etsum(cur, [isa.ADD, isa.SUB])
        nf_of, nf_eq, nf_gt = cc(cur, at("nf_of")), cc(cur, at("nf_eq")), cc(cur, at("nf_gt"))
        aeq_c, agt_c, c7 = cc(cur, at("as_eq")), cc(cur, at("as_gt")), cc(cur, at("carry", 7))
        out.append(gf.mul(et_as, gf.sub(nf_of, c7)))
        out.append(gf.mul(et_as, gf.sub(nf_eq, aeq_c)))
        out.append(gf.mul(et_as, gf.sub(nf_gt, agt_c)))
        out.append(gf.mul(et_mul, gf.sub(nf_of, _not(d1z))))
        out.append(gf.mul(et_mul, gf.sub(nf_eq, aeq_c)))
        out.append(gf.mul(et_mul, gf.sub(nf_gt, gf.mul(d1z, _not(aeq_c)))))
        out.append(gf.mul(et_div, gf.sub(nf_of, s1z)))
        out.append(gf.mul(et_div, gf.sub(nf_eq, gf.mul(_not(s1z), aeq_c))))
        out.append(gf.mul(et_div, gf.sub(nf_gt, gf.mul(_not(s1z), d1z))))
        et_sb = gf.add(et_shift, et_binop)
        out.append(gf.mul(et_sb, nf_of))
        out.append(gf.mul(et_sb, gf.sub(nf_eq, aeq_c)))
        out.append(gf.mul(et_sb, nf_gt))

        # the memory-query packing bytes of cw_sel limbs 5..7 (affine, every row)
        for k in range(3):
            v = zero
            for bb in range(4):
                v = gf.add(v, gf.mul_const(cc(cur, at("cw_b", 4 * k + bb)), 1 << (8 * bb)))
            out.append(gf.sub(cc(cur, at("cw_sel", 5 + k)), v))

        # ---- logUp row relations ----
        Xd, bd = ch[_XD], ch[_BD]
        key_q = gf.add(cc(cur, at("variant_idx")),
                       gf.add(gf.mul(bd, price), gf.mul(gf.mul(bd, bd), cc(cur, at("props")))))
        out.append(gf.sub(gf.mul(cc(cur, at2("inv_qd")), gf.sub(Xd, key_q)), one))
        key_t = gf.add(cc(cur, fat("t_dec_vi")),
                       gf.add(gf.mul(bd, cc(cur, fat("t_dec_price"))),
                              gf.mul(gf.mul(bd, bd), cc(cur, fat("t_dec_props")))))
        out.append(gf.sub(gf.mul(cc(cur, at2("inv_td")), gf.sub(Xd, key_t)),
                          cc(cur, at("m_decode"))))
        Xc, bc = ch[_XC], ch[_BC]
        packed = gf.add(cc(cur, at("f_of")), gf.add(gf.mul_const(cc(cur, at("f_eq")), 2),
                                                    gf.mul_const(cc(cur, at("f_gt")), 4)))
        key_qc = gf.add(cc(cur, at("cond")),
                        gf.add(gf.mul(bc, packed), gf.mul(gf.mul(bc, bc), cc(cur, at("cond_ok")))))
        out.append(gf.sub(gf.mul(cc(cur, at2("inv_qc")), gf.sub(Xc, key_qc)), one))
        key_tc = gf.add(cc(cur, fat("t_cond_c")),
                        gf.add(gf.mul(bc, cc(cur, fat("t_cond_f"))),
                               gf.mul(gf.mul(bc, bc), cc(cur, fat("t_cond_r")))))
        out.append(gf.sub(gf.mul(cc(cur, at2("inv_tc")), gf.sub(Xc, key_tc)),
                          cc(cur, at("m_cond"))))
        Xb = ch[_XB]
        qb = cur[..., I["byte_q"]]
        out.append(grp(gf.sub(gf.mul(cur[..., I["inv_qb"]], gf.sub(Xb, qb)), one)))
        out.append(gf.sub(gf.mul(cc(cur, at2("inv_tb")), gf.sub(Xb, cc(cur, fat("t_byte")))),
                          cc(cur, at("m_byte"))))
        return out

    def _mq_row_rlc(row, ch):
        """the delta-RLC of the row's code-read memory query, 8-wide
        packing (affine in committed cells; memory_query/mod.rs:103-221)."""
        d = ch[_MQ]
        vs = [cc(row, at("ts")), cc(row, at("code_page")), cc(row, at("spc"))]
        for k in range(4):
            v = cc(row, at("cw_sel", k))
            for bb in range(3):
                v = gf.add(v, gf.mul_const(cc(row, at("cw_b", 3 * k + bb)), 1 << (32 + 8 * bb)))
            vs.append(v)
        vs.append(cc(row, at("cw_sel", 4)))
        r = vs[0]
        dp = d
        for j in range(1, 8):
            r = gf.add(r, gf.mul(dp, vs[j]))
            if j < 7:
                dp = gf.mul(dp, d)
        return r, gf.mul(dp, d)  # (the row's RLC, delta^8)

    def _lookup_diff(row):
        I = _index_tensors(row.device)
        v = gf.add(cc(row, at2("inv_qd")), cc(row, at2("inv_qc")))
        v = gf.add(v, gf.sum_mod(row[..., I["inv_qb"]]))
        return gf.sub(v, gf.add(cc(row, at2("inv_td")),
                                gf.add(cc(row, at2("inv_tc")), cc(row, at2("inv_tb")))))

    def constraints(cur, nxt, ch):
        I = _index_tensors(cur.device)
        one = torch.ones((), dtype=torch.int64, device=cur.device)

        def _not(x):
            return gf.sub(one, x)

        out = []
        skip = cc(cur, at("skip"))
        nskip = _not(skip)
        # ts
        out.append(gf.sub(gf.sub(cc(nxt, at("ts")), cc(cur, at("ts"))), gf.mul_const(nskip, 4)))
        # depth
        out.append(gf.sub(gf.sub(cc(nxt, at("depth")), cc(cur, at("depth"))),
                          gf.mul(nskip, gf.sub(etsum(cur, [isa.NEAR_CALL, isa.FAR_CALL]),
                                               et(cur, isa.RET)))))
        # pc (no term for a near call's panic to its handler: ROADMAP Queue 3)
        pc = cc(cur, at("pc"))
        pc_seq = gf.sub(gf.add(pc, one), gf.mul_const(cc(cur, at("pc_wrap")), 1 << 16))
        muts = etsum(cur, [isa.JUMP, isa.NEAR_CALL, isa.FAR_CALL, isa.RET])
        exp = gf.add(gf.mul(gf.sub(one, muts), pc_seq),
                     gf.add(gf.mul(et(cur, isa.JUMP), cc(cur, at("j_lo16"))),
                            gf.add(gf.mul(et(cur, isa.NEAR_CALL), cc(cur, at("imm0"))),
                                   gf.mul(et(cur, isa.RET), cc(cur, at("ret_pc"))))))
        out.append(gf.sub(cc(nxt, at("pc")), gf.add(gf.mul(skip, pc), gf.mul(nskip, exp))))
        # ergs (simple families)
        is_es = etsum(cur, [isa.ADD, isa.SUB, isa.MUL, isa.DIV, isa.JUMP, isa.BINOP, isa.SHIFT,
                            isa.PTR, isa.CONTEXT, isa.NOP])
        ergs1 = gf.mul(_not(cc(cur, at("oo"))), cc(cur, at("ediff")))
        out.append(gf.mul(is_es, gf.sub(cc(nxt, at("ergs")), ergs1)))
        # flags: each ALU family supplies its committed next-flag values;
        # families that never touch flags keep them
        is_fs = etsum(cur, [isa.ADD, isa.SUB, isa.MUL, isa.DIV, isa.SHIFT, isa.BINOP, isa.JUMP,
                            isa.NOP, isa.CONTEXT, isa.PTR, isa.UMA, isa.LOG])
        upd = cc(cur, at("upd_flags"))
        for nm, nf in (("f_of", "nf_of"), ("f_eq", "nf_eq"), ("f_gt", "nf_gt")):
            out.append(gf.mul(is_fs, gf.sub(cc(nxt, at(nm)),
                                            gf.add(gf.mul(upd, cc(cur, at(nf))),
                                                   gf.mul(_not(upd), cc(cur, at(nm)))))))
        # pending cleared on families that cannot raise it
        is_sp = etsum(cur, [isa.ADD, isa.SUB, isa.MUL, isa.DIV, isa.JUMP, isa.BINOP, isa.SHIFT,
                            isa.NOP, isa.CONTEXT, isa.LOG, isa.NEAR_CALL, isa.RET])
        out.append(gf.mul(is_sp, cc(nxt, at("pending"))))
        # frame-scoped state unchanged outside far_call / ret
        not_fr = gf.sub(one, etsum(cur, [isa.FAR_CALL, isa.RET]))
        for nm in ("is_kernel", "is_static", "code_page", "base_page"):
            out.append(gf.mul(not_fr, gf.sub(cc(nxt, at(nm)), cc(cur, at(nm)))))
        # code-word cache continuity
        out.append(grp(gf.sub(nxt[..., I["prev_code_word"]], cur[..., I["cw_sel"]])))
        out.append(gf.sub(cc(nxt, at("prev_code_page")), cc(cur, at("code_page"))))
        out.append(gf.sub(cc(nxt, at("prev_super_pc")),
                          gf.add(gf.mul(skip, cc(cur, at("prev_super_pc"))),
                                 gf.mul(nskip, cc(cur, at("spc"))))))
        # register file
        shape = tuple(cur.shape[:-1]) + (15, 8)
        regs_c = cur[..., I["regs"]].reshape(shape)
        regs_n = nxt[..., I["regs"]].reshape(shape)
        w0 = cur[..., I["wsel0"]].unsqueeze(-1)
        w1 = cur[..., I["wsel1"]].unsqueeze(-1)
        d0v = cur[..., I["dst0_val"]].unsqueeze(-2)
        d1v = cur[..., I["dst1_val"]].unsqueeze(-2)
        resid = gf.sub(gf.sub(regs_n, regs_c), gf.add(gf.mul(w0, gf.sub(d0v, regs_c)),
                                                      gf.mul(w1, gf.sub(d1v, regs_c))))
        resid = gf.mul(not_fr[..., None, None], resid)
        out.append(grp(resid, lanes=2))
        ptr_c = cur[..., I["regs_ptr"]]
        ptr_n = nxt[..., I["regs_ptr"]]
        d0p = cc(cur, at("d0ptr")).unsqueeze(-1)
        d1p = cc(cur, at("d1ptr")).unsqueeze(-1)
        presid = gf.sub(gf.sub(ptr_n, ptr_c),
                        gf.add(gf.mul(cur[..., I["wsel0"]], gf.sub(d0p, ptr_c)),
                               gf.mul(cur[..., I["wsel1"]], gf.sub(d1p, ptr_c))))
        out.append(grp(gf.mul(not_fr.unsqueeze(-1), presid)))
        # logUp accumulator
        out.append(gf.sub(gf.sub(cc(nxt, at2("acc")), cc(cur, at2("acc"))), _lookup_diff(nxt)))
        # the code-read stream RLC (macc = the accumulator BEFORE the row;
        # pushed on sro rows; the final pad row carries the total)
        sro_c = cc(cur, at("sro"))
        r_c, D = _mq_row_rlc(cur, ch)
        macc_c = cc(cur, at2("macc"))
        pushed = gf.add(gf.mul(macc_c, D), r_c)
        out.append(gf.sub(cc(nxt, at2("macc")),
                          gf.add(gf.mul(sro_c, pushed), gf.mul(_not(sro_c), macc_c))))
        return out

    def _state_rlc(row, ch):
        I = _index_tensors(row.device)
        pows = powers(challenge(ch, _RLC), n_state, row.device)
        return gf.sum_mod(gf.mul(row[..., I["state"]], pows))

    def first_row(row, public, ch):
        return [gf.sub(_state_rlc(row, ch), public[0]),
                gf.sub(cc(row, at2("acc")), _lookup_diff(row)),
                cc(row, at2("macc"))]

    def last_row(row, public, ch):
        return [gf.sub(_state_rlc(row, ch), public[1]), cc(row, at2("acc")),
                gf.sub(cc(row, at2("macc")), public[2])]

    return AirSpec(num_cols=P1, max_degree=3, constraints=constraints,
                   row_constraints=row_constraints, first_row=first_row, last_row=last_row,
                   num_public=3, num_fixed_cols=F, num_phase2_cols=P2, num_challenges=7)


# ---------------------------------------------------------------------------
# phase 2, prove / verify
# ---------------------------------------------------------------------------


def _build_phase2(trace: torch.Tensor, ch_ints) -> torch.Tensor:
    """[fixed | phase1] (F + P1, n) -> the (P2, n) inverse / accumulator
    columns."""
    fx, p1, _, _ = layout()
    F = fx.n
    dev = trace.device

    def col(name, j=0):
        return trace[F + p1.at(name, j)]

    def fcol(name):
        return trace[fx.at(name)]

    def c(k):
        return gf.constant(int(ch_ints[k]), dev)

    Xd, bd, Xc, bc = c(_XD), c(_BD), c(_XC), c(_BC)
    bd2, bc2 = gf.mul(bd, bd), gf.mul(bc, bc)
    key_q = gf.add(col("variant_idx"), gf.add(gf.mul(bd, col("price")), gf.mul(bd2, col("props"))))
    inv_qd = gf.inv(gf.sub(Xd, key_q))
    key_t = gf.add(fcol("t_dec_vi"), gf.add(gf.mul(bd, fcol("t_dec_price")),
                                            gf.mul(bd2, fcol("t_dec_props"))))
    inv_td = gf.mul(col("m_decode"), gf.inv(gf.sub(Xd, key_t)))
    packed = gf.add(col("f_of"), gf.add(gf.mul_const(col("f_eq"), 2), gf.mul_const(col("f_gt"), 4)))
    key_qc = gf.add(col("cond"), gf.add(gf.mul(bc, packed), gf.mul(bc2, col("cond_ok"))))
    inv_qc = gf.inv(gf.sub(Xc, key_qc))
    key_tc = gf.add(fcol("t_cond_c"), gf.add(gf.mul(bc, fcol("t_cond_f")),
                                             gf.mul(bc2, fcol("t_cond_r"))))
    inv_tc = gf.mul(col("m_cond"), gf.inv(gf.sub(Xc, key_tc)))
    qb_ix = torch.as_tensor([F + p1.at(nm, j) for (nm, j) in _byte_query_names()], device=dev)
    inv_qb, inv_tb, byte_acc = byte_lookup_columns(trace[qb_ix], fcol("t_byte"), col("m_byte"),
                                                   int(ch_ints[_XB]))
    # acc = the running sum of every lookup's difference (the byte part's
    # is byte_acc)
    acc = gf.add(byte_acc, gf.cumsum_mod(gf.sub(gf.add(inv_qd, inv_qc), gf.add(inv_td, inv_tc))))

    # macc: the code-read stream RLC, the accumulator BEFORE each row
    dq = int(ch_ints[_MQ])
    dpows = [1]
    for _ in range(8):
        dpows.append(dpows[-1] * dq % MODULUS)
    vs = [col("ts"), col("code_page"), col("spc")]
    for k in range(4):
        v = col("cw_sel", k)
        for bb in range(3):
            v = gf.add(v, gf.mul_const(col("cw_b", 3 * k + bb), 1 << (32 + 8 * bb)))
        vs.append(v)
    vs.append(col("cw_sel", 4))
    r = vs[0]
    for j in range(1, 8):
        r = gf.add(r, gf.mul_const(vs[j], dpows[j]))
    macc = masked_scan(col("sro"), dpows[8], r)
    return torch.cat([torch.stack([inv_qd, inv_td, inv_qc, inv_tc]), inv_qb,
                      torch.stack([inv_tb, acc, macc])])


def boundary_state_vectors(phase1: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """(state_in, state_out) plaintext u64 vectors: the values the boundary
    RLC publics bind (the instance's FSM input and output)."""
    _, p1, _, state_names = layout()
    ix = np.concatenate([_span(p1, nm) for nm in state_names])
    ends = gf.to_u64(phase1[torch.as_tensor(ix, device=phase1.device)][:, [0, -1]])
    return ends[:, 0].copy(), ends[:, 1].copy()


def _boundary_publics(state_in: np.ndarray, state_out: np.ndarray, rlc: int, macc: int,
                      device) -> torch.Tensor:
    k = state_in.shape[0]
    pows = [1] * k
    for j in range(1, k):
        pows[j] = pows[j - 1] * rlc % MODULUS
    pin = sum(int(v) * p for v, p in zip(state_in, pows)) % MODULUS
    pout = sum(int(v) * p for v, p in zip(state_out, pows)) % MODULUS
    return gf.from_u64(np.array([pin, pout, macc], np.uint64), device)


def code_read_queries(w: dict, limit: int) -> np.ndarray:
    """(k, 8) u64 8-wide packings of the VM's code-read memory queries in
    push order: PUBLIC data the proof's macc public binds; the block
    cross-checks it against the code-page reads of the memory tape."""
    total = int(np.asarray(w["ts"]).shape[0]) - 1
    sro = np.asarray(w["should_read_opcode"])[:total].astype(bool)
    ts = np.asarray(w["ts"])[:total][sro]
    page = np.asarray(w["ctx_code_page"])[:total][sro]
    pc = np.asarray(w["ctx_pc"])[:total][sro]
    value = np.asarray(w["code_word_read"])[:total][sro]
    k = int(sro.sum())
    return encode_memory_queries_np(ts, page, pc // 4, np.zeros(k, bool), np.zeros(k, bool),
                                    value).reshape(k, 8)


def stream_rlc(encodings: np.ndarray, delta: int) -> int:
    """The verifier's recomputation of the macc public from the plaintext
    8-wide query encodings: acc' = acc delta^8 + sum_j v_j delta^j."""
    enc = np.asarray(encodings, np.uint64).reshape(-1, 8)
    if enc.shape[0] == 0:
        return 0
    rows = gf.to_u64(gf.dot_mod(gf.from_u64(enc, "cpu"), powers(delta, 8, "cpu")))
    return int(horner_prefix(rows, pow(delta, 8, MODULUS))[-1])


_DEBUG_CH = tuple((0x9E3779B97F4A7C15 * (k + 1)) % MODULUS
                  for k in range(7))  # large: avoids logUp denominator hits


def debug_residuals(w: dict, limit: int, ch_ints: Tuple[int, ...] = _DEBUG_CH, device=None):
    """Every AIR constraint on the trace domain itself (no STARK), on
    `device` (None: the card): {kind: [(constraint index, rows where it
    fails), ...]} for the constraints that do NOT vanish, as the JAX
    `debug_residuals` gives it."""
    phase1, fixed, _ = vm_core_trace(w, limit, device)
    p2cols = _build_phase2(torch.cat([fixed, phase1]), ch_ints)
    state_in, state_out = boundary_state_vectors(phase1)
    macc_total = stream_rlc(code_read_queries(w, limit), ch_ints[_MQ])
    public = _boundary_publics(state_in, state_out, ch_ints[_RLC], macc_total, phase1.device)
    bad = residual_counts(torch.cat([fixed, phase1, p2cols]), public, ch_ints)
    # cross-check: the phase-2 macc total equals the plaintext stream's RLC
    if int(gf.to_u64(p2cols[-1, -1])) != macc_total:
        bad["macc_plaintext"] = [(0, 1)]
    return bad


def residual_counts(cols: torch.Tensor, public: torch.Tensor, ch_ints) -> dict:
    """The failing constraints of the (m, n) columns [fixed | phase1 |
    phase2]: {kind: [(constraint index, rows where it fails), ...]}, the
    transitions on rows 0..n-2 against the next row; a block of rows at a
    time."""
    air = vm_core_air()
    n = cols.shape[1]
    rows = cols.T.contiguous()  # (n, m)
    ch = gf.from_u64(np.array(ch_ints, np.uint64), cols.device)
    counts = {}

    def tally(kind, vals):
        got = counts.setdefault(kind, {})
        for i, v in enumerate(vals):
            got[i] = got.get(i, 0) + int((gf.canonicalize(v) != 0).sum())

    for s in range(0, n, _DEBUG_ROWS):
        e = min(s + _DEBUG_ROWS, n)
        tally("row", air.row_constraints(rows[s:e], ch))
        e_t = min(e, n - 1)
        if e_t > s:
            tally("transition", air.constraints(rows[s:e_t], rows[s + 1:e_t + 1], ch))
    tally("first", air.first_row(rows[0:1], public, ch))
    tally("last", air.last_row(rows[n - 1:n], public, ch))
    bad = {}
    for kind in ("row", "transition", "first", "last"):
        got = [(i, c) for i, c in sorted(counts[kind].items()) if c]
        if got:
            bad[kind] = got
    return bad


def prove_vm_core(w: dict, limit: int, params: Optional[StarkParams] = None, device=None
                  ) -> Tuple[StarkProof, np.ndarray, np.ndarray, np.ndarray, StarkParams]:
    """STARK-prove the VM core relations of one instance's witness on
    `device` (None: the card).

    Returns (proof, state_in, state_out, code_reads, params): the boundary
    state vectors are the proof's public binding (challenge RLC), and
    `code_reads` is the PLAINTEXT (k, 8) code-read stream the macc public
    binds."""
    phase1, fixed, log_n = vm_core_trace(w, limit, device)
    air = vm_core_air()
    if params is None:
        params = StarkParams(log_n=log_n)
    state_in, state_out = boundary_state_vectors(phase1)
    code_reads = code_read_queries(w, limit)
    # the publics depend on the RLC challenges: derive them as the verifier
    # will (FS over the fixed cap and the phase-1 cap), then prove
    cap_f = _commit_columns(fixed, params)["cap"]
    tree = _commit_columns(phase1, params)
    ch, _ = challenges_from_cap(tree["cap"], air, cap_f)
    public = _boundary_publics(state_in, state_out, ch[_RLC], stream_rlc(code_reads, ch[_MQ]),
                               phase1.device)
    proof = prove(phase1, air, params, public, build_phase2=_build_phase2, fixed_cols=fixed,
                  phase1_tree=tree)
    return proof, state_in, state_out, code_reads, params


def verify_vm_core(proof: StarkProof, state_in: np.ndarray, state_out: np.ndarray,
                   code_reads: np.ndarray, params: StarkParams) -> bool:
    """Recompute the fixed-table cap (the VK), re-derive the RLC and stream
    challenges, rebuild the boundary publics from the CLAIMED state vectors
    and the PLAINTEXT code-read stream, run the STARK verifier.  The proof's
    own `params` are trusted, as in the JAX package (ROADMAP Queue 3)."""
    air = vm_core_air()
    _, p1, _, state_names = layout()
    k = sum(p1.index[nm][1] for nm in state_names)
    state_in = np.asarray(state_in, np.uint64)
    state_out = np.asarray(state_out, np.uint64)
    if state_in.shape != (k,) or state_out.shape != (k,):
        return False
    code_reads = np.asarray(code_reads, np.uint64)
    if code_reads.ndim != 2 or code_reads.shape[1] != 8:
        return False
    if len(proof.caps) != 3:
        return False
    dev = proof.q_cap.device
    fixed = fixed_tables(1 << params.log_n, dev)
    ch, _ = challenges_from_cap(proof.caps[1], air, proof.caps[0])
    public = _boundary_publics(state_in, state_out, ch[_RLC], stream_rlc(code_reads, ch[_MQ]),
                               dev)
    return verify(proof, air, params, public, fixed_cols=fixed)
