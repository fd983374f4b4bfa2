"""main_vm row-parallel constraint evaluation (the JAX package's
`models/vm/circuit.py`).

Re-derives every cycle transition of the EraVM trace that the witness oracle
(`native_sim.py`) produced and checks it against the claimed state columns.
Each residual is a bool tensor; the trace is satisfied when every residual is
all-True.

Layout: state columns have N + 1 rows (row i = the state before cycle i);
per-cycle witness columns have N rows.  A 256-bit value is (N, 8) u32
little-endian limbs; Poseidon2 and queue states are field elements.

u32 arithmetic.  The witness columns are u32 values held in int64 tensors
(torch has no unsigned 32-bit arithmetic), and the EraVM wraps at 2^32.  So
every sum, difference, product and left shift that can leave [0, 2^32) is cut
back with `_u32` (`& 0xFFFFFFFF`, exact for two's-complement int64), and every
right shift acts on a value already in range.

Check groups:
  decode and masking, operands, add/sub, mul/div, shift, binop/jump/nop,
  context/ptr, uma, log, near/far/ret, the queue and callstack sponges, and
  state continuity (every state column's next value re-derived).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...base_structures.decommit_query import DecommitQueries, encode_decommit_queries
from ...base_structures.log_query import (
    LogQueries,
    encode_log_queries,
    encode_with_rollback_flag,
)
from ...base_structures.memory_query import MemoryQueries, encode_memory_queries
from ...isa import opcodes as isa
from ...isa import system_params as sp
from ...ops import gf, nonnative as nn, poseidon2
from ...utils.device import resolve_device
from ...utils.shard_plan import ShardPlan

M32 = 0xFFFFFFFF
MASK48 = (1 << 48) - 1

_NOP_SPREAD = isa.NOP_BITSPREAD
_PANIC_SPREAD = isa.PANIC_BITSPREAD
_NOP_ENC = isa.NOP_ENCODING
_PANIC_ENC = isa.PANIC_ENCODING

# witness columns that hold field elements (u64 on the host)
_GF_KEYS = frozenset({
    "cs_sponge", "mem_q_state", "dec_q_state", "log_fwd_tail",
    "ctx_rq_head", "ctx_rq_tail", "rb_prev_head", "call_rb_tail",
    "ret_prev_cs_sponge", "block_rollback_tail",
    "ret_popped_rq_head", "ret_popped_rq_tail",
})


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The ISA tables on `device`, built once per device: the 51-bit opcode
    properties and the ergs prices by variant index (2^11 entries each), and
    2^s as 8 u32 limbs for s in 0..256 (the bit-shift table)."""
    props = np.asarray(isa.OPCODES_PROPS_INTEGER_BITMASKS, dtype=np.uint64).astype(np.int64)
    prices = np.asarray(isa.OPCODES_PRICES).astype(np.int64)
    shift_limbs = np.zeros((257, 8), dtype=np.int64)
    for s in range(257):
        for k in range(8):
            shift_limbs[s, k] = ((1 << s) >> (32 * k)) & M32
    return tuple(torch.from_numpy(t).to(device) for t in (props, prices, shift_limbs))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """cut to 32 bits: the u32 wrap of a sum, difference, product or shift."""
    return x & M32


def _bool_bit(x: torch.Tensor, t: int) -> torch.Tensor:
    return ((x >> t) & 1) == 1


def _is_zero256(x):
    return (x == 0).all(-1)


def _eq256(a, b):
    return (a == b).all(-1)


def _lt256(a, b):
    """a < b over (N, 8) LE u32 limbs."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for k in range(8):
        lt = torch.where(a[..., k] != b[..., k], a[..., k] < b[..., k], lt)
    return lt


def _u16limbs(x):
    """(N, 8) u32 -> (N, 16) u16."""
    return torch.stack([x & 0xFFFF, x >> 16], dim=-1).reshape(*x.shape[:-1], 16)


def _set_col(x: torch.Tensor, k: int, v) -> torch.Tensor:
    """a copy of x with x[..., k] = v (never a write into a witness tensor)."""
    out = x.clone()
    out[..., k] = v
    return out


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def prepare_device_witness(w: dict, device=None) -> dict:
    """Host to device: the u64 field columns as field tensors, the u32
    columns as int64, the flags as bool.  `w` is the numpy dict that
    `NativeEraVM.run()` returns; `device` None is the card
    (`utils.device.default_device`)."""
    device = resolve_device(device)
    out = {}
    for k, v in w.items():
        if k in _GF_KEYS:
            out[k] = gf.from_u64(v, device)
        else:
            arr = np.asarray(v)
            if arr.dtype != np.bool_:
                arr = arr.astype(np.uint32).astype(np.int64)
            out[k] = torch.from_numpy(np.array(arr)).to(device)  # a copy; keeps 0-d
    return out


# --------------------------------------------------------------------------
# sponge helpers
# --------------------------------------------------------------------------


def _absorb_full(state: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Replace lanes 0..8 and permute.  state (N, 12), enc (N, 8)."""
    return poseidon2.absorb_round(enc, state)


def _narrow_rounds(enc20: torch.Tensor, tail: torch.Tensor):
    """The 3-round narrow queue push (`ops/queues.narrow_state_transition`:
    the previous tail in the capacity lanes, the 20-element encoding
    zero-padded to 24 and absorbed by rate replacement).  enc20 (N, 20),
    tail (N, 4).  Returns the new tail (N, 4)."""
    n = tuple(enc20.shape[:-1])
    r0 = poseidon2.permutation(torch.cat([enc20[..., 0:8], tail], dim=-1))
    r1 = poseidon2.permutation(torch.cat([enc20[..., 8:16], r0[..., 8:]], dim=-1))
    st2 = torch.cat([enc20[..., 16:20], gf.zeros(n + (4,), enc20.device), r1[..., 8:]], dim=-1)
    return poseidon2.permutation(st2)[..., 0:4]


def _gf_sel(mask, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = mask
    while m.dim() < a.dim():
        m = m.unsqueeze(-1)
    return torch.where(m, a, b)


def _gf_eq(a: torch.Tensor, b: torch.Tensor):
    return (a == b).all(-1)


def _pack_lohi(lo32, hi_bits):
    """field element = lo32 + hi_bits * 2^32 (all < 2^57 < p)."""
    return lo32 | (_u32(hi_bits) << 32)


# --------------------------------------------------------------------------
# the evaluation
# --------------------------------------------------------------------------


def eval_constraints(w: dict, limit: int) -> dict:
    """Row-parallel transition checks.  `w` is `prepare_device_witness` output."""
    N = limit
    dev = w["regs"].device
    props_t, prices_t, shift_limbs_t = _tables(dev)
    res = {}
    rows = torch.arange(N, device=dev)

    # ---- state views: b = before the cycle, a = after it ----
    def b(k):
        return w[k][:-1]

    def a(k):
        return w[k][1:]

    # ================= prestate =================
    depth_b = b("cs_depth")
    should_skip = depth_b == 0
    pending_b = b("pending_exc")
    exec_pending = pending_b & ~should_skip
    should_try_read = ~should_skip & ~pending_b

    pc_b = b("ctx_pc")
    pc_plus_one = (pc_b + 1) & 0xFFFF
    super_pc = pc_b >> 2
    sub_pc = pc_b & 3
    should_read_new = ~(
        (b("prev_code_page") == b("ctx_code_page")) & (super_pc == b("prev_super_pc"))
    )
    should_read_op = should_try_read & should_read_new
    res["should_read_opcode"] = w["should_read_opcode"] == should_read_op

    ts_b = b("ts")
    res["timestamp"] = a("ts") == torch.where(should_skip, ts_b, _u32(ts_b + 4))

    # code word selection + prev_* updates
    cw = torch.where(should_read_op[:, None], w["code_word_read"], b("prev_code_word"))
    res["prev_code_word"] = _eq256(a("prev_code_word"), cw)
    res["prev_code_page"] = a("prev_code_page") == b("ctx_code_page")
    res["prev_super_pc"] = a("prev_super_pc") == torch.where(
        should_skip, b("prev_super_pc"), super_pc
    )

    # raw opcode: limbs (6-2k, 7-2k) for sub-pc k, then the skip/pending masks
    raw_lo = _zeros((N,), dev)
    raw_hi = _zeros((N,), dev)
    for k in range(4):
        m = sub_pc == k
        raw_lo = torch.where(m, cw[:, 6 - 2 * k], raw_lo)
        raw_hi = torch.where(m, cw[:, 7 - 2 * k], raw_hi)
    raw_lo = torch.where(should_skip, _NOP_ENC & M32, raw_lo)
    raw_hi = torch.where(should_skip, _NOP_ENC >> 32, raw_hi)
    raw_lo = torch.where(exec_pending, _PANIC_ENC & M32, raw_lo)
    raw_hi = torch.where(exec_pending, _PANIC_ENC >> 32, raw_hi)
    res["raw_opcode"] = (w["raw_opcode_lo"] == raw_lo) & (w["raw_opcode_hi"] == raw_hi)
    # pending is consumed here; a family may set it again (continuity below)
    res["pending_clear"] = ~exec_pending | ~a("pending_exc") | should_skip

    # ============ decode + fast exceptions ============
    variant_idx = raw_lo & 0x7FF
    cond = (raw_lo >> 13) & 7
    src0_enc = (raw_lo >> 16) & 0xF
    src1_enc = (raw_lo >> 20) & 0xF
    dst0_enc = (raw_lo >> 24) & 0xF
    dst1_enc = (raw_lo >> 28) & 0xF
    imm0 = raw_hi & 0xFFFF
    imm1 = raw_hi >> 16

    price = prices_t[variant_idx]
    props = props_t[variant_idx]

    f_of, f_eq, f_gt = b("f_of"), b("f_eq"), b("f_gt")
    cond_ok = (
        (cond == isa.COND_ALWAYS)
        | ((cond == isa.COND_GT) & f_gt)
        | ((cond == isa.COND_LT) & f_of)
        | ((cond == isa.COND_EQ) & f_eq)
        | ((cond == isa.COND_GE) & (f_gt | f_eq))
        | ((cond == isa.COND_LE) & (f_of | f_eq))
        | ((cond == isa.COND_NE) & ~f_eq)
        | ((cond == isa.COND_GT_OR_LT) & (f_gt | f_of))
    )

    masked_price = torch.where(should_skip, 0, price)
    ergs0 = b("ctx_ergs")
    out_of_ergs = masked_price > ergs0
    ergs1 = torch.where(out_of_ergs, 0, _u32(ergs0 - masked_price))

    AUX = isa.AUX_BITS_OFFSET
    kernel_only = _bool_bit(props, AUX + isa.KERNEL_MODE_FLAG_IDX)
    static_ok = _bool_bit(props, AUX + isa.CAN_BE_USED_IN_STATIC_CONTEXT_FLAG_IDX)
    explicit_panic = _bool_bit(props, AUX + isa.EXPLICIT_PANIC_FLAG_IDX)
    kernel_exc = kernel_only & ~b("ctx_is_kernel")
    static_exc = b("ctx_is_static") & ~static_ok
    callstack_full = depth_b == sp.VM_MAX_STACK_DEPTH
    mask_panic = explicit_panic | out_of_ergs | kernel_exc | static_exc | callstack_full
    mask_nop = ~mask_panic & ~cond_ok
    mask_any = mask_panic | mask_nop

    # the effective 48-bit property spread after masking (aux bits dropped)
    eff = props & MASK48
    eff = torch.where(mask_panic, _PANIC_SPREAD, eff)
    eff = torch.where(mask_nop, _NOP_SPREAD, eff)

    def opbit(t):  # opcode-type boolean
        return _bool_bit(eff, isa.TYPE_BITS_OFFSET + t)

    def varbit(t):  # sub-variant boolean
        return _bool_bit(eff, isa.VARIANT_BITS_OFFSET + t)

    def flagbit(t):  # per-opcode flag boolean
        return _bool_bit(eff, isa.FLAG_BITS_OFFSET + t)

    def srcmode(t):
        return _bool_bit(eff, isa.INPUT_BITS_OFFSET + t)

    def dstmode(t):
        return _bool_bit(eff, isa.OUTPUT_BITS_OFFSET + t)

    res["no_invalid"] = ~opbit(isa.INVALID)

    src0_idx = torch.where(mask_any, 0, src0_enc)
    src1_idx = torch.where(mask_any, 0, src1_enc)
    dst0_idx = torch.where(mask_any, 0, dst0_enc)
    dst1_idx = torch.where(mask_any, 0, dst1_enc)

    # ============ operand resolution ============
    regs_b = b("regs")  # (N, 15, 8)
    regs_ptr_b = b("regs_ptr")

    def read_reg(idx):
        slot = idx.clamp(min=1) - 1
        v = regs_b[rows, slot]
        p = regs_ptr_b[rows, slot]
        z = idx == 0
        return torch.where(z[:, None], 0, v), torch.where(z, False, p)

    draft_src0, draft_src0_ptr = read_reg(src0_idx)
    src1_reg, src1_reg_ptr = read_reg(src1_idx)
    dst0_reg, _ = read_reg(dst0_idx)

    base_page = b("ctx_base_page")
    stack_page = _u32(base_page + 1)
    heap_page = _u32(base_page + 2)
    aux_heap_page = _u32(base_page + 3)
    sp_b = b("ctx_sp")

    is_nop_op = opbit(isa.NOP)
    src_reg_low = draft_src0[:, 0] & 0xFFFF
    idx_abs = (src_reg_low + imm0) & 0xFFFF
    idx_rel = (sp_b - idx_abs) & 0xFFFF
    use_code = srcmode(isa.SRC_CODE)
    use_stack_abs = srcmode(isa.SRC_STACK_ABSOLUTE)
    use_stack_rel = srcmode(isa.SRC_STACK_OFFSET)
    use_stack_pp = srcmode(isa.SRC_STACK_PUSH_POP)
    use_stack = use_stack_abs | use_stack_rel | use_stack_pp
    src0_did_read = (use_stack | use_code) & ~is_nop_op
    res["src0_did_read"] = w["src0_did_read"] == src0_did_read
    src0_page = torch.where(use_stack, stack_page, b("ctx_code_page"))
    src0_index = torch.where(use_code | use_stack_abs, idx_abs, idx_rel)
    sp_after_src = torch.where(use_stack_pp, idx_rel, sp_b)

    dst0_reg_low = dst0_reg[:, 0] & 0xFFFF
    d_idx_abs = (dst0_reg_low + imm1) & 0xFFFF
    d_idx_rel_push = (sp_after_src + d_idx_abs) & 0xFFFF
    d_idx_rel = (sp_after_src - d_idx_abs) & 0xFFFF
    d_abs = dstmode(isa.DST_STACK_ABSOLUTE)
    d_rel = dstmode(isa.DST_STACK_OFFSET)
    d_pp = dstmode(isa.DST_STACK_PUSH_POP)
    dst0_did_write = (d_abs | d_rel | d_pp) & ~is_nop_op
    res["dst0_did_write"] = w["dst0_did_write"] == dst0_did_write
    dst0_index = torch.where(d_abs, d_idx_abs, torch.where(d_pp, sp_after_src, d_idx_rel))
    sp_new = torch.where(d_pp, d_idx_rel_push, sp_after_src)
    # far_call installs a fresh frame (sp = 0); ret (and the mask-panic rows,
    # whose spread IS the panic-ret spread) restores the popped frame's sp:
    # the pop is bound by the callstack sponge.
    exp_sp = torch.where(opbit(isa.FAR_CALL), 0, sp_new)
    exp_sp = torch.where(opbit(isa.RET), w["ret_popped_sp"], exp_sp)
    res["sp"] = a("ctx_sp") == torch.where(should_skip, sp_b, exp_sp)
    res["dst0_location"] = (w["dst0_index"] == dst0_index) & (w["dst0_page"] == stack_page)

    # src0 selection + swap + fat-pointer erasure
    imm_as_val = torch.cat([imm0[:, None], _zeros((N, 7), dev)], dim=-1)
    src0_v = torch.where(
        srcmode(isa.SRC_REG)[:, None],
        draft_src0,
        torch.where(srcmode(isa.SRC_IMM)[:, None], imm_as_val, w["src0_mem_val"]),
    )
    src0_p = torch.where(
        srcmode(isa.SRC_REG), draft_src0_ptr,
        torch.where(srcmode(isa.SRC_IMM), False, w["src0_mem_is_ptr"]),
    )
    src1_v, src1_p = src1_reg, src1_reg_ptr

    is_asym = opbit(isa.SUB) | opbit(isa.DIV) | opbit(isa.SHIFT)
    swap = (is_asym & flagbit(isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES)) | (
        opbit(isa.PTR) & flagbit(isa.SWAP_OPERANDS_FLAG_IDX_FOR_PTR_OPCODE)
    )
    s0v = torch.where(swap[:, None], src1_v, src0_v)
    s1v = torch.where(swap[:, None], src0_v, src1_v)
    s0p = torch.where(swap, src1_p, src0_p)
    s1p = torch.where(swap, src0_p, src1_p)

    not_kernel = ~b("ctx_is_kernel")
    keeps_ptr = opbit(isa.RET) | opbit(isa.PTR) | opbit(isa.UMA) | opbit(isa.FAR_CALL)
    erase0 = s0p & ~keeps_ptr & not_kernel
    erase1 = s1p & not_kernel

    def erase(v, m):
        v = _set_col(v, 1, torch.where(m, 0, v[:, 1]))
        return _set_col(v, 2, torch.where(m, 0, v[:, 2]))

    s0v = erase(s0v, erase0)
    s1v = erase(s1v, erase1)
    s0p = s0p & ~erase0
    s1p = s1p & ~erase1

    res["src0"] = _eq256(w["src0_val"], s0v) & (w["src0_is_ptr"] == s0p)
    res["src1"] = _eq256(w["src1_val"], s1v) & (w["src1_is_ptr"] == s1p)
    src0_val, src1_val = w["src0_val"], w["src1_val"]
    src0_isptr, src1_isptr = w["src0_is_ptr"], w["src1_is_ptr"]

    ctx = dict(
        N=N, dev=dev, res=res, b=b, a=a, shift_limbs=shift_limbs_t,
        should_skip=should_skip, should_read_op=should_read_op,
        pc_plus_one=pc_plus_one, ts=ts_b, ergs1=ergs1,
        imm0=imm0, imm1=imm1,
        opbit=opbit, varbit=varbit, flagbit=flagbit,
        src0_val=src0_val, src1_val=src1_val,
        src0_isptr=src0_isptr, src1_isptr=src1_isptr,
        dst0_idx=dst0_idx, dst1_idx=dst1_idx,
        dst0_did_write=dst0_did_write, dst0_index=dst0_index,
        stack_page=stack_page, heap_page=heap_page,
        aux_heap_page=aux_heap_page,
        src0_did_read=src0_did_read, src0_page=src0_page,
        src0_index=src0_index,
    )
    return _eval_families(w, ctx)


def _add256(x, y):
    """(x + y) mod 2^256 over (N, 8) u32 limbs, and the carry out."""
    outs = []
    carry = 0
    for k in range(8):
        t = x[..., k] + y[..., k] + carry
        outs.append(_u32(t))
        carry = t >> 32
    return torch.stack(outs, dim=-1), carry == 1


def _sub256(x, y):
    """(x - y) mod 2^256 over (N, 8) u32 limbs, and the borrow out."""
    outs = []
    borrow = 0
    for k in range(8):
        d = x[..., k] - y[..., k] - borrow
        outs.append(_u32(d))
        borrow = (d < 0).to(torch.int64)
    return torch.stack(outs, dim=-1), borrow == 1


def _eval_families(w: dict, c: dict) -> dict:
    N, dev, res, b = c["N"], c["dev"], c["res"], c["b"]
    opbit, varbit, flagbit = c["opbit"], c["varbit"], c["flagbit"]
    s0, s1 = c["src0_val"], c["src1_val"]
    s0p, s1p = c["src0_isptr"], c["src1_isptr"]
    ergs1 = c["ergs1"]

    is_add, is_sub = opbit(isa.ADD), opbit(isa.SUB)
    is_mul, is_div = opbit(isa.MUL), opbit(isa.DIV)
    is_jump, is_ctxf = opbit(isa.JUMP), opbit(isa.CONTEXT)
    is_shift, is_binop = opbit(isa.SHIFT), opbit(isa.BINOP)
    is_ptrf, is_ncall = opbit(isa.PTR), opbit(isa.NEAR_CALL)
    is_logf, is_fcall = opbit(isa.LOG), opbit(isa.FAR_CALL)
    is_retf, is_uma = opbit(isa.RET), opbit(isa.UMA)

    set_flags = flagbit(isa.SET_FLAGS_FLAG_IDX)

    # ---------------- add/sub ----------------
    add_r, add_of = _add256(s0, s1)
    sub_r, sub_uf = _sub256(s0, s1)
    addsub_r = torch.where(is_add[:, None], add_r, sub_r)
    addsub_of = torch.where(is_add, add_of, sub_uf)
    addsub_eq = _is_zero256(addsub_r)
    addsub_gt = ~addsub_of & ~addsub_eq

    # ---------------- mul/div ----------------
    a16 = _u16limbs(s0)
    b16 = _u16limbs(s1)
    r0_16 = _u16limbs(w["fam_res0"])
    r1_16 = _u16limbs(w["fam_res1"])
    lo_hi = torch.cat([r0_16, r1_16], dim=-1)  # res0 + res1 << 256
    mul_id = nn.sides_equal([("prod", a16, b16, 1)], [("lin", lo_hi, 1)], (N,), ncoef=34)
    res["mul_relation"] = torch.where(is_mul, mul_id, True)
    mul_of = ~_is_zero256(w["fam_res1"])
    mul_eq = _is_zero256(w["fam_res0"])
    mul_gt = ~mul_of & ~mul_eq

    div_id = nn.sides_equal(
        [("lin", a16, 1)],
        [("prod", r0_16, b16, 1), ("lin", r1_16, 1)],
        (N,), ncoef=34,
    )
    b_zero = _is_zero256(s1)
    rem_lt = _lt256(w["fam_res1"], s1)
    div_ok = torch.where(
        b_zero,
        _is_zero256(w["fam_res0"]) & _is_zero256(w["fam_res1"]),
        div_id & rem_lt,
    )
    res["div_relation"] = torch.where(is_div, div_ok, True)
    div_of = b_zero
    div_eq = ~b_zero & _is_zero256(w["fam_res0"])
    div_gt = ~b_zero & _is_zero256(w["fam_res1"])

    muldiv_r0, muldiv_r1 = w["fam_res0"], w["fam_res1"]
    muldiv_of = torch.where(is_mul, mul_of, div_of)
    muldiv_eq = torch.where(is_mul, mul_eq, div_eq)
    muldiv_gt = torch.where(is_mul, mul_gt, div_gt)

    # ---------------- shift (with the bit-shift table) ----------------
    sh_amt = s1[:, 0] & 0xFF
    is_rol, is_ror = varbit(isa.SHIFT_ROL), varbit(isa.SHIFT_ROR)
    is_shr = varbit(isa.SHIFT_SHR)
    is_cyclic = is_rol | is_ror
    full_shift = torch.where(is_ror & (sh_amt != 0), 256 - sh_amt, sh_amt)
    mult = c["shift_limbs"][full_shift]  # (N, 8): 2^full_shift in limbs
    m16 = _u16limbs(mult)
    # right shift: a = q * 2^s + r, r < 2^s  (q = res0, r = res1)
    shr_id = nn.sides_equal(
        [("lin", a16, 1)],
        [("prod", r0_16, m16, 1), ("lin", r1_16, 1)],
        (N,), ncoef=34,
    )
    shr_ok = shr_id & _lt256(w["fam_res1"], mult)
    # left shift: a * 2^s = hi << 256 + lo  (lo = res0, hi = res1)
    shl_id = nn.sides_equal([("prod", a16, m16, 1)], [("lin", lo_hi, 1)], (N,), ncoef=34)
    res["shift_relation"] = torch.where(is_shift, torch.where(is_shr, shr_ok, shl_id), True)
    shift_r = torch.where(
        is_shr[:, None],
        w["fam_res0"],
        torch.where(is_cyclic[:, None], w["fam_res0"] | w["fam_res1"], w["fam_res0"]),
    )
    shift_eq = _is_zero256(shift_r)

    # ---------------- binop ----------------
    is_and, is_or = varbit(isa.BINOP_AND), varbit(isa.BINOP_OR)
    binop_r = torch.where(
        is_and[:, None], s0 & s1, torch.where(is_or[:, None], s0 | s1, s0 ^ s1)
    )
    binop_eq = _is_zero256(binop_r)

    # ---------------- context ----------------
    v_this, v_caller = varbit(isa.CTX_THIS), varbit(isa.CTX_CALLER)
    v_code = varbit(isa.CTX_CODE_ADDRESS)
    v_meta, v_ergs = varbit(isa.CTX_META), varbit(isa.CTX_ERGS_LEFT)
    v_get128 = varbit(isa.CTX_GET_CONTEXT_U128)
    v_set128 = varbit(isa.CTX_SET_CONTEXT_U128)
    v_setpp = varbit(isa.CTX_SET_ERGS_PER_PUBDATA)
    v_inctx = varbit(isa.CTX_INCREMENT_TX_NUMBER)

    zcol = _zeros((N,), dev)
    low32 = torch.where(v_ergs, ergs1, b("ctx_sp"))
    ctx_res = torch.cat([low32[:, None], _zeros((N, 7), dev)], dim=-1)
    ctx_res = torch.where(
        v_get128[:, None],
        torch.cat([b("ctx_ctx_u128"), _zeros((N, 4), dev)], dim=-1),
        ctx_res,
    )
    for mask, name in ((v_this, "ctx_this"), (v_caller, "ctx_caller"),
                       (v_code, "ctx_code_address")):
        padded = torch.cat([b(name), _zeros((N, 3), dev)], dim=-1)
        ctx_res = torch.where(mask[:, None], padded, ctx_res)
    meta = torch.stack(
        [
            b("ergs_pp"), zcol,
            b("ctx_heap_bound"), b("ctx_aux_heap_bound"),
            zcol, zcol, zcol,
            _u32(
                b("ctx_shard_this")
                | (b("ctx_shard_caller") << 8)
                | (b("ctx_shard_code") << 16)
            ),
        ],
        dim=-1,
    )
    ctx_res = torch.where(v_meta[:, None], meta, ctx_res)
    ctx_write_dst0 = ~(v_set128 | v_setpp | v_inctx)

    # ---------------- ptr ----------------
    p_add, p_sub = varbit(isa.PTR_ADD), varbit(isa.PTR_SUB)
    p_pack, p_shrink = varbit(isa.PTR_PACK), varbit(isa.PTR_SHRINK)
    args_bad = ~(s0p & ~s1p)
    b_hi_nz = ~(s1[:, 1:] == 0).all(-1)
    b_lo128_nz = ~(s1[:, :4] == 0).all(-1)
    off_add = _u32(s0[:, 0] + s1[:, 0])
    add_of_p = off_add < s0[:, 0]
    off_sub = _u32(s0[:, 0] - s1[:, 0])
    sub_uf_p = s0[:, 0] < s1[:, 0]
    len_shrink = _u32(s0[:, 3] - s1[:, 0])
    shrink_uf = s0[:, 3] < s1[:, 0]
    ptr_panic = args_bad | (
        (p_add | p_sub) & b_hi_nz
    ) | (p_pack & b_lo128_nz) | (p_add & add_of_p) | (p_sub & sub_uf_p) | (
        p_shrink & shrink_uf
    )
    ptr_r = _set_col(s0, 0, torch.where(p_add, off_add, torch.where(p_sub, off_sub, s0[:, 0])))
    ptr_r[:, 3] = torch.where(p_shrink, len_shrink, s0[:, 3])  # ptr_r is already a copy
    ptr_r = torch.where(
        p_pack[:, None],
        torch.cat([s0[:, :4], s1[:, 4:]], dim=-1),
        ptr_r,
    )

    # ---------------- jump ----------------
    jump_pc = s0[:, 0] & 0xFFFF

    c.update(
        is_add=is_add, is_sub=is_sub, is_mul=is_mul, is_div=is_div,
        is_jump=is_jump, is_ctxf=is_ctxf, is_shift=is_shift,
        is_binop=is_binop, is_ptrf=is_ptrf, is_ncall=is_ncall,
        is_logf=is_logf, is_fcall=is_fcall, is_retf=is_retf, is_uma=is_uma,
        set_flags=set_flags,
        addsub_r=addsub_r, addsub_of=addsub_of, addsub_eq=addsub_eq,
        addsub_gt=addsub_gt,
        muldiv_r0=muldiv_r0, muldiv_r1=muldiv_r1,
        muldiv_of=muldiv_of, muldiv_eq=muldiv_eq, muldiv_gt=muldiv_gt,
        shift_r=shift_r, shift_eq=shift_eq,
        binop_r=binop_r, binop_eq=binop_eq,
        ctx_res=ctx_res, ctx_write_dst0=ctx_write_dst0,
        v_set128=v_set128, v_setpp=v_setpp, v_inctx=v_inctx,
        ptr_panic=ptr_panic, ptr_r=ptr_r, jump_pc=jump_pc,
    )
    return _eval_memory_and_log(w, c)


def _be_bytes(limbs):
    """(N, 8) u32 LE limbs -> (N, 32) big-endian bytes."""
    outs = []
    for j in range(32):
        limb = limbs[..., 7 - j // 4]
        outs.append((limb >> (8 * (3 - j % 4))) & 0xFF)
    return torch.stack(outs, dim=-1)


def _from_be_bytes(bts):
    """(N, 32) BE bytes -> (N, 8) u32 LE limbs."""
    outs = []
    for k in range(8):
        base = (7 - k) * 4
        outs.append(
            (bts[..., base] << 24)
            | (bts[..., base + 1] << 16)
            | (bts[..., base + 2] << 8)
            | bts[..., base + 3]
        )
    return torch.stack(outs, dim=-1)


def _eval_memory_and_log(w: dict, c: dict) -> dict:
    N, dev, res, b = c["N"], c["dev"], c["res"], c["b"]
    varbit, flagbit = c["varbit"], c["flagbit"]
    s0, s1 = c["src0_val"], c["src1_val"]
    s0p = c["src0_isptr"]
    ergs1, ts = c["ergs1"], c["ts"]
    is_uma, is_logf = c["is_uma"], c["is_logf"]

    # ================= UMA =================
    u_hr, u_hw = varbit(isa.UMA_HEAP_READ), varbit(isa.UMA_HEAP_WRITE)
    u_ahr, u_ahw = varbit(isa.UMA_AUX_HEAP_READ), varbit(isa.UMA_AUX_HEAP_WRITE)
    u_fpr = varbit(isa.UMA_FAT_PTR_READ)
    u_incr = flagbit(isa.UMA_INCREMENT_FLAG_IDX)
    access_heap = is_uma & (u_hr | u_hw)
    access_aux = is_uma & (u_ahr | u_ahw)
    uma_read = u_hr | u_ahr | u_fpr
    uma_write = u_hw | u_ahw

    offset, upage = s0[:, 0], s0[:, 1]
    ustart, ulen = s0[:, 2], s0[:, 3]
    not_ptr_exp = u_fpr & ~s0p
    in_slice = offset < ulen
    skip_legit = u_fpr & ~in_slice
    formal_start = torch.where(u_fpr, ustart, 0)
    abs_addr = _u32(formal_start + offset)
    inc_off = _u32(offset + 32)
    non_addr = offset >= 0xFFFFFFDF
    uma_panic = not_ptr_exp | non_addr
    uma_skip = not_ptr_exp | skip_legit | non_addr
    d_oob = _u32(inc_off - ulen)
    bytes_oob = torch.where(~uma_skip & (inc_off >= ulen), d_oob & 31, 0)

    heap_like = access_heap | access_aux
    bound = torch.where(access_heap, b("ctx_heap_bound"), b("ctx_aux_heap_bound"))
    grows = heap_like & (inc_off > bound)
    growth = torch.where(grows, _u32(inc_off - bound), 0)
    top_nz = ~(s0[:, 1:] == 0).all(-1)
    penal = heap_like & (top_nz | non_addr)
    growth_cost = torch.where(penal, M32, growth)
    uma_panic = uma_panic | penal
    uma_skip = uma_skip | penal
    uma_new_bound = torch.where(grows, inc_off, bound)

    ergs_uf = growth_cost > ergs1
    uma_ergs2 = torch.where(ergs_uf, 0, _u32(ergs1 - growth_cost))
    uma_panic = uma_panic | ergs_uf
    uma_skip = uma_skip | ergs_uf

    mem_page = torch.where(
        access_heap, c["heap_page"], torch.where(access_aux, c["aux_heap_page"], upage)
    )
    cell = abs_addr >> 5
    cell_next = _u32(cell + 1)
    unalign = abs_addr & 31
    read_a = is_uma & ~uma_skip
    read_b = read_a & (unalign != 0)
    exec_write = is_uma & uma_write & ~uma_skip
    exec_write_b = exec_write & (unalign != 0)

    a_val = torch.where(read_a[:, None], w["uma_a_val"], 0)
    b_val = torch.where(read_b[:, None], w["uma_b_val"], 0)
    res["uma_masked_reads"] = _eq256(a_val, w["uma_a_val"]) & _eq256(b_val, w["uma_b_val"])

    buf = torch.cat([_be_bytes(a_val), _be_bytes(b_val)], dim=-1)  # (N, 64)
    selected = _zeros((N, 32), dev)
    for u in range(32):
        m = (unalign == u)[:, None]
        selected = torch.where(m, buf[:, u : u + 32], selected)
    cleanup = torch.where(u_fpr, bytes_oob, 0)
    keep = torch.arange(32, device=dev)[None, :] < (32 - cleanup)[:, None]
    selected = torch.where(keep, selected, 0)
    uma_read_value = _from_be_bytes(selected)

    wr_bytes = _be_bytes(s1)
    wbuf = buf
    for u in range(32):
        m = (unalign == u)[:, None]
        patched = torch.cat([buf[:, :u], wr_bytes, buf[:, u + 32 :]], dim=-1)
        wbuf = torch.where(m, patched, wbuf)
    a_new = _from_be_bytes(wbuf[:, :32])
    b_new = _from_be_bytes(wbuf[:, 32:])

    incr_src0 = _set_col(s0, 0, inc_off)

    # ================= memory queue chain =================
    mem0 = b("mem_q_state")
    zero_b = torch.zeros(N, dtype=torch.bool, device=dev)
    one_b = torch.ones(N, dtype=torch.bool, device=dev)
    ts3 = _u32(ts + 3)

    def mq(ts_, page, index, rw, is_ptr, value):
        return MemoryQueries(
            timestamp=ts_, memory_page=page, index=index,
            rw_flag=rw, is_ptr=is_ptr, value=value,
        )

    # code-word read
    super_pc = b("ctx_pc") >> 2
    enc_code = encode_memory_queries(
        mq(ts, b("ctx_code_page"), super_pc, zero_b, zero_b, w["code_word_read"])
    )
    mem1 = _gf_sel(c["should_read_op"], _absorb_full(mem0, enc_code), mem0)

    # src0 read
    enc_src0 = encode_memory_queries(
        mq(ts, c["src0_page"], c["src0_index"], zero_b,
           w["src0_mem_is_ptr"], w["src0_mem_val"])
    )
    mem2 = _gf_sel(c["src0_did_read"], _absorb_full(mem1, enc_src0), mem1)

    # uma reads + writes (chained)
    enc_uma_ra = encode_memory_queries(mq(ts, mem_page, cell, zero_b, zero_b, a_val))
    mem3 = _gf_sel(read_a, _absorb_full(mem2, enc_uma_ra), mem2)
    enc_uma_rb = encode_memory_queries(mq(ts, mem_page, cell_next, zero_b, zero_b, b_val))
    mem4 = _gf_sel(read_b, _absorb_full(mem3, enc_uma_rb), mem3)
    enc_uma_wa = encode_memory_queries(mq(ts3, mem_page, cell, one_b, zero_b, a_new))
    mem5 = _gf_sel(exec_write, _absorb_full(mem4, enc_uma_wa), mem4)
    enc_uma_wb = encode_memory_queries(mq(ts3, mem_page, cell_next, one_b, zero_b, b_new))
    mem6 = _gf_sel(exec_write_b, _absorb_full(mem5, enc_uma_wb), mem5)

    def i64(m):
        return m.to(torch.int64)

    c.update(
        uma_panic=is_uma & uma_panic, uma_read_value=uma_read_value,
        uma_read=uma_read, uma_write=uma_write, u_incr=u_incr,
        incr_src0=incr_src0, uma_ergs2=uma_ergs2,
        uma_grow_heap=access_heap, uma_grow_aux=access_aux,
        uma_new_bound=uma_new_bound,
        mem_after_uma=mem6,
        mem_count_pre_dst0=(
            i64(c["should_read_op"]) + i64(c["src0_did_read"])
            + i64(read_a) + i64(read_b) + i64(exec_write) + i64(exec_write_b)
        ),
    )

    # ================= log family =================
    l_sr, l_sw = varbit(isa.LOG_STORAGE_READ), varbit(isa.LOG_STORAGE_WRITE)
    l_ev, l_l1 = varbit(isa.LOG_EVENT), varbit(isa.LOG_TO_L1_MESSAGE)
    l_pc = varbit(isa.LOG_PRECOMPILE_CALL)
    is_storage = l_sr | l_sw
    revertable = ~(l_sr | l_pc)

    swap_r = is_logf & l_pc & (s0[:, 4] == 0)
    swap_w = is_logf & l_pc & (s0[:, 5] == 0)
    key = _set_col(s0, 4, torch.where(swap_r, c["heap_page"], s0[:, 4]))
    key[:, 5] = torch.where(swap_w, c["heap_page"], s0[:, 5])  # key is already a copy

    shard = b("ctx_shard_this")
    aux_byte = (
        i64(is_storage) * sp.STORAGE_AUX_BYTE
        + i64(l_ev) * sp.EVENT_AUX_BYTE
        + i64(l_l1) * sp.L1_MESSAGE_AUX_BYTE
        + i64(l_pc) * sp.PRECOMPILE_AUX_BYTE
    )
    refund = w["pubdata_refund"]
    res["pubdata_refund_range"] = refund <= sp.INITIAL_STORAGE_WRITE_PUBDATA_BYTES
    burn = torch.where(
        l_sw & (shard == 0),
        _u32(b("ergs_pp") * _u32(sp.INITIAL_STORAGE_WRITE_PUBDATA_BYTES - refund)),
        torch.where(
            l_l1,
            _u32(b("ergs_pp") * sp.L1_MESSAGE_PUBDATA_BYTES),
            torch.where(l_pc, s1[:, 0], 0),
        ),
    )
    log_uf = burn > ergs1
    log_ergs2 = torch.where(log_uf, 0, _u32(ergs1 - burn))
    log_exec = is_logf & ~log_uf
    log_exec_rb = log_exec & revertable

    read_value = torch.where((is_storage & log_exec)[:, None], w["storage_read_val"], 0)
    written_value = torch.where(revertable[:, None], s1, read_value)
    first_flag = flagbit(isa.FIRST_MESSAGE_FLAG_IDX) & (l_ev | l_l1)
    ts1 = _u32(ts + 1)

    lq = LogQueries(
        address=b("ctx_this"),
        key=key,
        read_value=read_value,
        written_value=written_value,
        rw_flag=revertable,
        aux_byte=aux_byte,
        rollback=zero_b,
        is_service=first_flag,
        shard_id=shard,
        tx_number_in_block=b("tx_number"),
        timestamp=ts1,
    )
    enc_fwd = encode_log_queries(lq)
    enc_rb = encode_with_rollback_flag(lq)

    # forward queue push + the independent rollback chain (the rollback side
    # starts from the claimed previous head in the capacity lanes)
    new_fwd_tail = _narrow_rounds(enc_fwd, b("log_fwd_tail"))
    rb_head = _narrow_rounds(enc_rb, w["rb_prev_head"])
    res["log_rollback_head_chain"] = torch.where(
        log_exec_rb, _gf_eq(rb_head, b("ctx_rq_head")), True
    )

    log_dst0 = torch.where(
        l_sr[:, None],
        read_value,
        torch.cat([i64(log_exec)[:, None], _zeros((N, 7), dev)], dim=-1),
    )

    c.update(
        log_exec=log_exec, log_exec_rb=log_exec_rb, log_ergs2=log_ergs2,
        log_new_fwd_tail=new_fwd_tail, log_dst0=log_dst0,
        log_dst0_update=is_logf & (l_sr | l_pc),
        ts1=ts1, ts3=ts3,
    )
    return _eval_callret(w, c)


def _enc32(f: dict) -> torch.Tensor:
    """Pack the saved-context fields into the 32-element encoding.  f: dict
    of (N,) or (N, k) tensors."""

    def flag(name):
        return f[name].to(torch.int64) << 24

    lanes = [f["rq_head"][..., k] for k in range(4)]
    lanes += [f["rq_tail"][..., k] for k in range(4)]
    for key in ("code_address", "this", "caller"):
        lanes += [f[key][..., k] for k in range(5)]
    lanes += [f["ctx_u128"][..., k] for k in range(4)]
    lanes.append(
        _pack_lohi(f["code_page"], f["pc"] | (f["shard_this"] << 16) | flag("is_static")))
    lanes.append(
        _pack_lohi(f["base_page"], f["sp"] | (f["shard_caller"] << 16) | flag("is_kernel")))
    lanes.append(
        _pack_lohi(f["ergs"], f["eh"] | (f["shard_code"] << 16) | flag("is_local")))
    ql = f["rq_len"]
    lanes.append(_pack_lohi(f["heap_bound"], (ql & 0xFF) | (((ql >> 8) & 0xFF) << 8)))
    lanes.append(
        _pack_lohi(f["aux_heap_bound"], ((ql >> 16) & 0xFF) | (((ql >> 24) & 0xFF) << 8)))
    return torch.stack(lanes, dim=-1)


def _eval_callret(w: dict, c: dict) -> dict:
    N, dev, res, b, a = c["N"], c["dev"], c["res"], c["b"], c["a"]
    varbit, flagbit = c["varbit"], c["flagbit"]
    s0, s1 = c["src0_val"], c["src1_val"]
    s0p = c["src0_isptr"]
    ergs1 = c["ergs1"]
    is_ncall, is_fcall, is_retf = c["is_ncall"], c["is_fcall"], c["is_retf"]
    imm0 = c["imm0"]

    def i64(m):
        return m.to(torch.int64)

    # ---------------- far_call ----------------
    fc_delegate = varbit(isa.FAR_CALL_DELEGATE)
    fc_mimic = varbit(isa.FAR_CALL_MIMIC)
    fc_static = flagbit(isa.FAR_CALL_STATIC_FLAG_IDX)
    fc_shard = flagbit(isa.FAR_CALL_SHARD_FLAG_IDX)

    ergs_abi = s0[:, 6]
    fwd_byte = s0[:, 7] & 0xFF
    shard_byte = (s0[:, 7] >> 8) & 0xFF
    ctor_byte = (s0[:, 7] >> 16) & 0xFF
    sys_byte = s0[:, 7] >> 24
    use_aux = fwd_byte == sp.FORWARD_PAGE_USE_AUX_HEAP
    fwd_ptr = fwd_byte == sp.FORWARD_PAGE_FORWARD_FAT_POINTER
    use_heap = ~(use_aux | fwd_ptr)

    dest5 = s1[:, :5]
    target_kernel = (s1[:, 0] < (1 << 16)) & (s1[:, 1:5] == 0).all(-1)
    dest_shard = torch.where(fc_shard, shard_byte, b("ctx_shard_this"))
    zkporter = dest_shard != 0
    kernel_b = b("ctx_is_kernel")
    ctor_call = (ctor_byte != 0) & kernel_b
    sys_call = (sys_byte != 0) & target_kernel

    offset, page = s0[:, 0], s0[:, 1]
    start, length = s0[:, 2], s0[:, 3]
    nonzero_off_fresh = (offset != 0) & ~fwd_ptr
    end_ni = _u32(start + length)
    slice_of = end_ni < start
    invalid_slice = length < offset
    ptr_invalid = nonzero_off_fresh | slice_of | invalid_slice

    zkp_avail = w["zkporter_available"]
    should_read = (~zkporter | zkp_avail) & is_fcall
    raw_hash = w["storage_read_val"]
    hash_empty = _is_zero256(raw_hash)
    mask_aa = should_read & hash_empty & ~target_kernel
    aa_hash = w["default_aa_code_hash"].expand(N, 8)
    porter_mask = zkporter & ~zkp_avail
    bytecode_hash = torch.where(mask_aa[:, None], aa_hash, raw_hash)
    bytecode_hash = torch.where(porter_mask[:, None], 0, bytecode_hash)

    # the code-hash read goes into the forward log queue (narrow, 3 rounds)
    dep5 = torch.cat(
        [torch.full((N, 1), sp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS & M32, dtype=torch.int64,
                    device=dev), _zeros((N, 4), dev)], dim=-1)
    key8 = torch.cat([dest5, _zeros((N, 3), dev)], dim=-1)
    zero_b = torch.zeros(N, dtype=torch.bool, device=dev)
    fc_lq = LogQueries(
        address=dep5, key=key8, read_value=raw_hash, written_value=raw_hash,
        rw_flag=zero_b,
        aux_byte=torch.full((N,), sp.STORAGE_AUX_BYTE, dtype=torch.int64, device=dev),
        rollback=zero_b, is_service=zero_b,
        shard_id=dest_shard, tx_number_in_block=b("tx_number"), timestamp=c["ts1"],
    )
    fc_fwd_tail = _narrow_rounds(encode_log_queries(fc_lq), b("log_fwd_tail"))

    version = bytecode_hash[:, 7] >> 24
    marker = (bytecode_hash[:, 7] >> 16) & 0xFF
    version_ok = version == sp.CODE_HASH_VERSION_BYTE
    normal_marker = marker == sp.CODE_AT_REST_MARKER
    constructed_marker = marker == sp.YET_CONSTRUCTED_MARKER
    format_exc = ~version_ok | ~(normal_marker | constructed_marker)
    can_call = (normal_marker & ~ctor_call) | (constructed_marker & ctor_call)
    in_construction_kernel = ~can_call & target_kernel

    at_rest7 = (bytecode_hash[:, 7] & 0xFF00FFFF) | _u32(sp.CODE_AT_REST_MARKER << 16)
    at_rest = _set_col(bytecode_hash, 7, at_rest7)
    masked_else = torch.where(target_kernel[:, None], 0, aa_hash)
    masked_hash = torch.where(can_call[:, None], at_rest, masked_else)
    code_len = torch.where(format_exc, 0, masked_hash[:, 7] & 0xFFFF)

    fat_ptr_exp_exc = fwd_ptr & ~s0p
    exc0 = format_exc | in_construction_kernel | fat_ptr_exp_exc | ptr_invalid

    ub = torch.where(exc0, 0, end_ni)
    ub = torch.where(slice_of & ~fwd_ptr, M32, ub)
    fc_bound = torch.where(use_heap, b("ctx_heap_bound"), b("ctx_aux_heap_bound"))
    fc_grows = (use_heap | use_aux) & (ub > fc_bound)
    fc_growth = torch.where(fc_grows, _u32(ub - fc_bound), 0)
    fc_new_bound = torch.where(fc_grows, ub, fc_bound)
    fc_uf = fc_growth > ergs1
    fc_ergs2 = torch.where(fc_uf, 0, _u32(ergs1 - fc_growth))
    exc1 = exc0 | fc_uf

    dec_cost = _u32(sp.ERGS_PER_CODE_WORD_DECOMMITTMENT * code_len)
    dec_uf = dec_cost > fc_ergs2
    should_dec = is_fcall & ~exc1 & ~dec_uf
    fc_exc = exc1 | dec_uf
    ergs_after_dec = torch.where(should_dec, _u32(fc_ergs2 - dec_cost), fc_ergs2)
    suggested = w["dec_suggested_page"]
    new_base_page = b("page_counter")
    dec_first = suggested == new_base_page
    ergs_after_dec = torch.where(should_dec & ~dec_first, fc_ergs2, ergs_after_dec)
    code_page_new = torch.where(should_dec, suggested, sp.UNMAPPED_PAGE)

    dq = DecommitQueries(
        code_hash=masked_hash, page=suggested, is_first=dec_first, timestamp=c["ts1"],
    )
    out_dec = _absorb_full(b("dec_q_state"), encode_decommit_queries(dq))
    dec_next = _gf_sel(should_dec, out_dec, b("dec_q_state"))
    res["dec_queue"] = _gf_eq(a("dec_q_state"), dec_next) & (
        a("dec_q_len") == _u32(b("dec_q_len") + i64(should_dec))
    )

    max_pass = (ergs_after_dec // 64) * 63
    fc_pass = torch.minimum(ergs_abi, max_pass)
    fc_caller_remaining = _u32(ergs_after_dec - fc_pass)

    # far-call ABI registers (r1 pointer, r2 flags)
    fptr_page = torch.where(
        fwd_ptr, page, torch.where(use_heap, c["heap_page"], c["aux_heap_page"]))
    fptr_start = torch.where(fwd_ptr, _u32(start + offset), start)
    fptr_len = torch.where(fwd_ptr, _u32(length - offset), length)
    zcol = _zeros((N,), dev)
    fc_r1 = torch.stack(
        [zcol, torch.where(fc_exc, 0, fptr_page), torch.where(fc_exc, 0, fptr_start),
         torch.where(fc_exc, 0, fptr_len), zcol, zcol, zcol, zcol], dim=-1)
    fc_r2 = torch.cat(
        [(i64(ctor_call) | (i64(sys_call) << 1))[:, None], _zeros((N, 7), dev)], dim=-1)

    # ---------------- near_call ----------------
    nc_abi = s0[:, 0]
    nc_pass_all = nc_abi == 0
    nc_to_pass = torch.where(nc_pass_all, ergs1, nc_abi)
    nc_uf = nc_to_pass > ergs1
    nc_remaining = torch.where(nc_uf, 0, _u32(ergs1 - nc_to_pass))
    nc_passed = torch.where(nc_uf, ergs1, nc_to_pass)

    # ---------------- ret ----------------
    r_rev = varbit(isa.RET_REVERT)
    r_panic = varbit(isa.RET_PANIC)
    r_local = b("ctx_is_local")
    r_far = ~r_local
    r_label = flagbit(isa.RET_TO_LABEL_BIT_IDX)

    rs0 = torch.where(r_panic[:, None], 0, s0)
    rs0p = ~r_panic & s0p
    r_fwd_byte = rs0[:, 7] & 0xFF
    r_use_aux = r_fwd_byte == sp.FORWARD_PAGE_USE_AUX_HEAP
    r_fwd_ptr = r_fwd_byte == sp.FORWARD_PAGE_FORWARD_FAT_POINTER
    r_use_heap = ~(r_use_aux | r_fwd_ptr)
    r_off, r_page = rs0[:, 0], rs0[:, 1]
    r_start, r_len = rs0[:, 2], rs0[:, 3]
    r_fpe = r_fwd_ptr & ~rs0p & r_far
    r_nonuni = r_fwd_ptr & (r_page < b("ctx_base_page"))
    r_end = _u32(r_start + r_len)
    r_slice_of = r_end < r_start
    r_ptr_invalid = ((r_off != 0) & ~r_fwd_ptr) | r_slice_of | (r_len < r_off)
    r_exc = r_panic | (r_far & (r_fpe | r_nonuni | r_ptr_invalid))

    r_ub = torch.where(r_exc, 0, r_end)
    r_ub = torch.where(r_slice_of & ~r_fwd_ptr, M32, r_ub)
    r_bound = torch.where(r_use_heap, b("ctx_heap_bound"), b("ctx_aux_heap_bound"))
    r_growth = torch.where(
        r_far & ~r_exc & (r_use_heap | r_use_aux) & (r_ub > r_bound),
        _u32(r_ub - r_bound), 0,
    )
    r_uf = r_growth > ergs1
    r_ergs2 = torch.where(r_uf, 0, _u32(ergs1 - r_growth))
    r_exc = r_exc | (r_far & r_uf)
    r_ergs2 = torch.where(r_local, ergs1, r_ergs2)
    r_nl_panic = r_far & (r_panic | r_exc)
    r_revert = r_rev | r_panic | r_nl_panic

    r_parent_ergs = _u32(w["ret_popped_ergs"] + r_ergs2)

    # rollback-queue joins
    res["ret_revert_head_is_fwd_tail"] = torch.where(
        is_retf & r_revert,
        _gf_eq(b("ctx_rq_head"), b("log_fwd_tail")),
        True,
    )
    res["ret_ok_parent_head_is_child_tail"] = torch.where(
        is_retf & ~r_revert,
        _gf_eq(w["ret_popped_rq_head"], b("ctx_rq_tail")),
        True,
    )

    rptr_page = torch.where(
        r_fwd_ptr, r_page, torch.where(r_use_heap, c["heap_page"], c["aux_heap_page"])
    )
    rptr_start = torch.where(r_fwd_ptr, _u32(r_start + r_off), r_start)
    rptr_len = torch.where(r_fwd_ptr, _u32(r_len - r_off), r_len)
    r_r1 = torch.stack(
        [zcol, torch.where(r_exc, 0, rptr_page), torch.where(r_exc, 0, rptr_start),
         torch.where(r_exc, 0, rptr_len), zcol, zcol, zcol, zcol], dim=-1)

    r_dst_pc = torch.where(r_revert, b("ctx_eh"), w["ret_popped_pc"])
    r_dst_pc = torch.where(r_label & r_local, imm0, r_dst_pc)

    # ---------------- callstack sponge ----------------
    push_mask = is_ncall | is_fcall
    pop_mask = is_retf
    any_cs = push_mask | pop_mask

    saved_ergs = torch.where(is_fcall, fc_caller_remaining, nc_remaining)
    saved_heap = torch.where(is_fcall & use_heap & fc_grows, fc_new_bound, b("ctx_heap_bound"))
    saved_aux = torch.where(
        is_fcall & use_aux & fc_grows, fc_new_bound, b("ctx_aux_heap_bound"))
    push_fields = dict(
        rq_head=b("ctx_rq_head"), rq_tail=b("ctx_rq_tail"),
        code_address=b("ctx_code_address"), this=b("ctx_this"),
        caller=b("ctx_caller"), ctx_u128=b("ctx_ctx_u128"),
        code_page=b("ctx_code_page"), base_page=b("ctx_base_page"),
        pc=c["pc_plus_one"], sp=a("ctx_sp"),
        shard_this=b("ctx_shard_this"), shard_caller=b("ctx_shard_caller"),
        shard_code=b("ctx_shard_code"),
        is_static=b("ctx_is_static"), is_kernel=b("ctx_is_kernel"),
        is_local=b("ctx_is_local"),
        ergs=saved_ergs, eh=b("ctx_eh"),
        heap_bound=saved_heap, aux_heap_bound=saved_aux,
        rq_len=b("ctx_rq_len"),
    )
    pop_fields = dict(
        rq_head=w["ret_popped_rq_head"], rq_tail=w["ret_popped_rq_tail"],
        code_address=w["ret_popped_code_address"], this=w["ret_popped_this"],
        caller=w["ret_popped_caller"], ctx_u128=w["ret_popped_ctx_u128"],
        code_page=w["ret_popped_code_page"], base_page=w["ret_popped_base_page"],
        pc=w["ret_popped_pc"], sp=w["ret_popped_sp"],
        shard_this=w["ret_popped_shard_this"],
        shard_caller=w["ret_popped_shard_caller"],
        shard_code=w["ret_popped_shard_code"],
        is_static=w["ret_popped_is_static"], is_kernel=w["ret_popped_is_kernel"],
        is_local=w["ret_popped_is_local"],
        ergs=w["ret_popped_ergs"], eh=w["ret_popped_eh"],
        heap_bound=w["ret_popped_heap_bound"],
        aux_heap_bound=w["ret_popped_aux_heap_bound"],
        rq_len=w["ret_popped_rq_len"],
    )
    enc_cs = _gf_sel(pop_mask, _enc32(pop_fields), _enc32(push_fields))
    st = _gf_sel(pop_mask, w["ret_prev_cs_sponge"], b("cs_sponge"))
    for r in range(4):
        st = poseidon2.absorb_round(enc_cs[..., 8 * r : 8 * r + 8], st)
    res["cs_sponge_push"] = torch.where(push_mask, _gf_eq(st, a("cs_sponge")), True)
    res["cs_sponge_pop"] = torch.where(
        pop_mask,
        _gf_eq(st, b("cs_sponge")) & _gf_eq(a("cs_sponge"), w["ret_prev_cs_sponge"]),
        True,
    )
    res["cs_sponge_keep"] = torch.where(~any_cs, _gf_eq(a("cs_sponge"), b("cs_sponge")), True)
    res["cs_depth"] = a("cs_depth") == torch.where(
        push_mask, _u32(b("cs_depth") + 1),
        torch.where(pop_mask, _u32(b("cs_depth") - 1), b("cs_depth")),
    )

    c.update(
        is_fcall=is_fcall, fc_exc=is_fcall & fc_exc,
        fc_delegate=fc_delegate, fc_mimic=fc_mimic, fc_static=fc_static,
        fc_pass=fc_pass, fc_fwd_tail=fc_fwd_tail, fc_should_read=should_read,
        fc_code_page=code_page_new, fc_dest5=dest5, fc_dest_shard=dest_shard,
        fc_target_kernel=target_kernel, fc_sys_call=sys_call,
        fc_r1=fc_r1, fc_r2=fc_r2, new_base_page=new_base_page,
        nc_passed=nc_passed,
        r_far=r_far, r_revert=r_revert,
        r_nl_panic=r_nl_panic, r_panic=r_panic, r_parent_ergs=r_parent_ergs,
        r_dst_pc=r_dst_pc, r_r1=r_r1,
    )
    return _eval_continuity(w, c)


def _eval_continuity(w: dict, c: dict) -> dict:
    """Every state column's next value re-derived and compared (the role of
    the state-diffs accumulator)."""
    N, dev, res, b, a = c["N"], c["dev"], c["res"], c["b"], c["a"]
    s0 = c["src0_val"]
    is_add, is_sub, is_mul, is_div = c["is_add"], c["is_sub"], c["is_mul"], c["is_div"]
    is_shift, is_binop, is_ptrf = c["is_shift"], c["is_binop"], c["is_ptrf"]
    is_ctxf, is_jump, is_uma = c["is_ctxf"], c["is_jump"], c["is_uma"]
    is_logf, is_ncall, is_fcall, is_retf = (
        c["is_logf"], c["is_ncall"], c["is_fcall"], c["is_retf"],
    )
    should_skip = c["should_skip"]
    set_flags = c["set_flags"]

    def i64(m):
        return m.to(torch.int64)

    # ---- dst0/dst1 candidates ----
    uma_wr_incr = c["uma_write"] & c["u_incr"]
    dst0_val = torch.where((is_add | is_sub)[:, None], c["addsub_r"], 0)
    dst0_val = torch.where((is_mul | is_div)[:, None], c["muldiv_r0"], dst0_val)
    dst0_val = torch.where(is_shift[:, None], c["shift_r"], dst0_val)
    dst0_val = torch.where(is_binop[:, None], c["binop_r"], dst0_val)
    dst0_val = torch.where(is_ptrf[:, None], c["ptr_r"], dst0_val)
    dst0_val = torch.where(is_ctxf[:, None], c["ctx_res"], dst0_val)
    dst0_val = torch.where(
        is_uma[:, None],
        torch.where(uma_wr_incr[:, None], c["incr_src0"], c["uma_read_value"]),
        dst0_val,
    )
    dst0_val = torch.where(is_logf[:, None], c["log_dst0"], dst0_val)
    dst0_ptr_flag = (is_ptrf | (is_uma & uma_wr_incr)) & c["src0_isptr"]

    dst0_update = (
        is_add | is_sub | is_mul | is_div | is_shift | is_binop
        | (is_ptrf & ~c["ptr_panic"])
        | (is_ctxf & c["ctx_write_dst0"])
        | (is_uma & ~c["uma_panic"] & (c["uma_read"] | uma_wr_incr))
        | c["log_dst0_update"]
    )
    dst1_val = torch.where((is_mul | is_div)[:, None], c["muldiv_r1"], c["incr_src0"])
    dst1_update = (is_mul | is_div) | (
        is_uma & ~c["uma_panic"] & c["uma_read"] & c["u_incr"]
    )
    dst1_ptr_flag = is_uma & c["src0_isptr"]

    # ---- register writeback (with the far_call and ret specifics) ----
    regs_b, regs_a = b("regs"), a("regs")
    ptr_b, ptr_a = b("regs_ptr"), a("regs_ptr")
    dst0_reg_write = dst0_update & ~c["dst0_did_write"]
    ok = torch.ones(N, dtype=torch.bool, device=dev)
    far_ret = is_retf & c["r_far"]
    for r in range(15):
        sel0 = dst0_reg_write & (c["dst0_idx"] == r + 1)
        sel1 = dst1_update & (c["dst1_idx"] == r + 1)
        expv = regs_b[:, r]
        expp = ptr_b[:, r]
        expv = torch.where(sel0[:, None], dst0_val, expv)
        expp = torch.where(sel0, dst0_ptr_flag, expp)
        expv = torch.where(sel1[:, None], dst1_val, expv)
        expp = torch.where(sel1, dst1_ptr_flag, expp)
        # far_call ABI registers
        if r == 0:
            expv = torch.where(is_fcall[:, None], c["fc_r1"], expv)
            expp = torch.where(is_fcall, True, expp)
            expv = torch.where(far_ret[:, None], c["r_r1"], expv)
            expp = torch.where(far_ret, True, expp)
        elif r == 1:
            expv = torch.where(is_fcall[:, None], c["fc_r2"], expv)
            expp = torch.where(is_fcall, False, expp)
        if r in sp.CALL_SYSTEM_ABI_REGISTERS:
            zero_it = is_fcall & ~c["fc_sys_call"]
            expv = torch.where(zero_it[:, None], 0, expv)
            expp = torch.where(is_fcall, False, expp)
        if r in sp.CALL_RESERVED_RANGE or r == sp.CALL_IMPLICIT_PARAMETER_REG_IDX:
            expv = torch.where(is_fcall[:, None], 0, expv)
            expp = torch.where(is_fcall, False, expp)
        if r >= 1:
            expv = torch.where(far_ret[:, None], 0, expv)
            expp = torch.where(far_ret, False, expp)
        ok = ok & _eq256(regs_a[:, r], expv) & (ptr_a[:, r] == expp)
    res["registers"] = ok

    # ---- flags ----
    upd = torch.zeros(N, dtype=torch.bool, device=dev)
    nf = [upd, upd, upd]  # of, eq, gt

    def set_fl(m, of, eq, gt):
        nonlocal upd
        upd = upd | m
        for i, v in enumerate((of, eq, gt)):
            nf[i] = torch.where(m, v, nf[i])

    set_fl((is_add | is_sub) & set_flags, c["addsub_of"], c["addsub_eq"], c["addsub_gt"])
    set_fl((is_mul | is_div) & set_flags, c["muldiv_of"], c["muldiv_eq"], c["muldiv_gt"])
    set_fl(is_shift & set_flags, False, c["shift_eq"], False)
    set_fl(is_binop & set_flags, False, c["binop_eq"], False)
    ret_panic_flag = is_retf & (c["r_panic"] | c["r_nl_panic"])
    set_fl(is_ncall | is_fcall | is_retf, ret_panic_flag, False, False)
    res["flags"] = (
        (a("f_of") == torch.where(upd, nf[0], b("f_of")))
        & (a("f_eq") == torch.where(upd, nf[1], b("f_eq")))
        & (a("f_gt") == torch.where(upd, nf[2], b("f_gt")))
    )

    # ---- pc ----
    exp_pc = c["pc_plus_one"]
    exp_pc = torch.where(is_jump, c["jump_pc"], exp_pc)
    exp_pc = torch.where(is_ncall, c["imm0"], exp_pc)
    exp_pc = torch.where(is_fcall, 0, exp_pc)
    exp_pc = torch.where(is_retf, c["r_dst_pc"], exp_pc)
    exp_pc = torch.where(should_skip, b("ctx_pc"), exp_pc)
    res["pc"] = a("ctx_pc") == exp_pc

    # ---- ergs ----
    exp_ergs = c["ergs1"]
    exp_ergs = torch.where(is_uma, c["uma_ergs2"], exp_ergs)
    exp_ergs = torch.where(is_logf, c["log_ergs2"], exp_ergs)
    exp_ergs = torch.where(is_ncall, c["nc_passed"], exp_ergs)
    exp_ergs = torch.where(is_fcall, c["fc_pass"], exp_ergs)
    exp_ergs = torch.where(is_retf, c["r_parent_ergs"], exp_ergs)
    res["ergs"] = a("ctx_ergs") == exp_ergs

    # ---- heap bounds ----
    stip = sp.NEW_FRAME_MEMORY_STIPEND
    exp_hb = torch.where(c["uma_grow_heap"], c["uma_new_bound"], b("ctx_heap_bound"))
    exp_ab = torch.where(c["uma_grow_aux"], c["uma_new_bound"], b("ctx_aux_heap_bound"))
    exp_hb = torch.where(is_fcall, stip, exp_hb)
    exp_ab = torch.where(is_fcall, stip, exp_ab)
    exp_hb = torch.where(far_ret, w["ret_popped_heap_bound"], exp_hb)
    exp_ab = torch.where(far_ret, w["ret_popped_aux_heap_bound"], exp_ab)
    res["heap_bounds"] = (a("ctx_heap_bound") == exp_hb) & (a("ctx_aux_heap_bound") == exp_ab)

    # ---- pending exception ----
    exp_pend = (is_ptrf & c["ptr_panic"]) | c["uma_panic"] | c["fc_exc"]
    res["pending"] = a("pending_exc") == exp_pend

    # ---- u128 context value + frame composite ----
    v128 = torch.where((is_ctxf & c["v_set128"])[:, None], s0[:, :4], b("ctx_u128"))
    v128 = torch.where((is_fcall | far_ret)[:, None], 0, v128)
    res["ctx_u128"] = (a("ctx_u128") == v128).all(-1)
    frame128 = b("ctx_ctx_u128")
    frame128 = torch.where(
        is_fcall[:, None],
        torch.where(c["fc_delegate"][:, None], b("ctx_ctx_u128"), b("ctx_u128")),
        frame128,
    )
    frame128 = torch.where(is_retf[:, None], w["ret_popped_ctx_u128"], frame128)
    res["frame_u128"] = (a("ctx_ctx_u128") == frame128).all(-1)

    # ---- tx number / pubdata price / page counter ----
    res["tx_number"] = a("tx_number") == torch.where(
        is_ctxf & c["v_inctx"], _u32(b("tx_number") + 1), b("tx_number")
    )
    res["ergs_pp"] = a("ergs_pp") == torch.where(is_ctxf & c["v_setpp"], s0[:, 0], b("ergs_pp"))
    res["page_counter"] = a("page_counter") == torch.where(
        is_fcall, _u32(b("page_counter") + sp.NEW_MEMORY_PAGES_PER_FAR_CALL),
        b("page_counter"),
    )

    # ---- frame identity fields ----
    def frame_field(name, fc_val, pop_key, width=None):
        exp = b(name)
        if fc_val is not None:
            m = is_fcall[:, None] if width else is_fcall
            exp = torch.where(m, fc_val, exp)
        m = is_retf[:, None] if width else is_retf
        exp = torch.where(m, w[pop_key], exp)
        got = a(name)
        return (got == exp).all(-1) if width else got == exp

    kern_b = b("ctx_is_kernel")
    fc_this = torch.where(c["fc_delegate"][:, None], b("ctx_this"), c["fc_dest5"])
    mimic_reg = b("regs")[:, sp.CALL_IMPLICIT_PARAMETER_REG_IDX, :5]
    fc_caller = torch.where(
        c["fc_delegate"][:, None],
        b("ctx_caller"),
        torch.where(c["fc_mimic"][:, None], mimic_reg, b("ctx_this")),
    )
    okf = frame_field("ctx_this", fc_this, "ret_popped_this", width=5)
    okf &= frame_field("ctx_caller", fc_caller, "ret_popped_caller", width=5)
    okf &= frame_field("ctx_code_address", c["fc_dest5"], "ret_popped_code_address", width=5)
    okf &= frame_field("ctx_code_page", c["fc_code_page"], "ret_popped_code_page")
    okf &= frame_field("ctx_base_page", c["new_base_page"], "ret_popped_base_page")
    okf &= frame_field(
        "ctx_shard_this",
        torch.where(c["fc_delegate"], b("ctx_shard_this"), c["fc_dest_shard"]),
        "ret_popped_shard_this",
    )
    okf &= frame_field("ctx_shard_caller", b("ctx_shard_this"), "ret_popped_shard_caller")
    okf &= frame_field("ctx_shard_code", c["fc_dest_shard"], "ret_popped_shard_code")
    res["frame_identity"] = okf

    exp_eh = b("ctx_eh")
    exp_eh = torch.where(is_ncall, c["imm1"], exp_eh)
    exp_eh = torch.where(is_fcall, c["imm0"], exp_eh)
    exp_eh = torch.where(is_retf, w["ret_popped_eh"], exp_eh)
    res["frame_eh"] = a("ctx_eh") == exp_eh

    exp_static = b("ctx_is_static")
    exp_static = torch.where(is_fcall, c["fc_static"] | b("ctx_is_static"), exp_static)
    exp_static = torch.where(is_retf, w["ret_popped_is_static"], exp_static)
    exp_kernel = b("ctx_is_kernel")
    exp_kernel = torch.where(
        is_fcall,
        torch.where(c["fc_delegate"], kern_b, c["fc_target_kernel"]),
        exp_kernel,
    )
    exp_kernel = torch.where(is_retf, w["ret_popped_is_kernel"], exp_kernel)
    exp_local = b("ctx_is_local")
    exp_local = torch.where(is_ncall, True, exp_local)
    exp_local = torch.where(is_fcall, False, exp_local)
    exp_local = torch.where(is_retf, w["ret_popped_is_local"], exp_local)
    res["frame_flags"] = (
        (a("ctx_is_static") == exp_static)
        & (a("ctx_is_kernel") == exp_kernel)
        & (a("ctx_is_local") == exp_local)
    )

    # ---- rollback queue head/tail/len ----
    call_mask = is_ncall | is_fcall
    exp_head = b("ctx_rq_head")
    exp_tail = b("ctx_rq_tail")
    exp_len = b("ctx_rq_len")
    exp_head = _gf_sel(c["log_exec_rb"], w["rb_prev_head"], exp_head)
    exp_len = torch.where(c["log_exec_rb"], _u32(exp_len + 1), exp_len)
    exp_head = _gf_sel(call_mask, w["call_rb_tail"], exp_head)
    exp_tail = _gf_sel(call_mask, w["call_rb_tail"], exp_tail)
    exp_len = torch.where(call_mask, 0, exp_len)
    pop_head = w["ret_popped_rq_head"]
    pop_tail = w["ret_popped_rq_tail"]
    pop_len = w["ret_popped_rq_len"]
    ret_ok_m = is_retf & ~c["r_revert"]
    ret_rv_m = is_retf & c["r_revert"]
    exp_head = _gf_sel(ret_rv_m, pop_head, exp_head)
    exp_head = _gf_sel(ret_ok_m, b("ctx_rq_head"), exp_head)
    exp_tail = _gf_sel(is_retf, pop_tail, exp_tail)
    exp_len = torch.where(ret_rv_m, pop_len, exp_len)
    exp_len = torch.where(ret_ok_m, _u32(pop_len + b("ctx_rq_len")), exp_len)
    res["rq_head"] = _gf_eq(a("ctx_rq_head"), exp_head)
    res["rq_tail"] = _gf_eq(a("ctx_rq_tail"), exp_tail)
    res["rq_len"] = a("ctx_rq_len") == exp_len

    # ---- memory queue (the dst0 write chained after uma) ----
    dst0_mem_cap = is_add | is_sub | is_mul | is_div | is_shift | is_binop | is_ptrf
    dst0_mem = c["dst0_did_write"] & dst0_update & dst0_mem_cap
    enc_dst0 = encode_memory_queries(
        MemoryQueries(
            timestamp=c["ts3"],
            memory_page=c["stack_page"],
            index=c["dst0_index"],
            rw_flag=torch.ones(N, dtype=torch.bool, device=dev),
            is_ptr=dst0_ptr_flag,
            value=dst0_val,
        )
    )
    mem6 = c["mem_after_uma"]
    mem_final = _gf_sel(dst0_mem, _absorb_full(mem6, enc_dst0), mem6)
    res["mem_queue"] = _gf_eq(a("mem_q_state"), mem_final)
    res["mem_queue_len"] = a("mem_q_len") == _u32(
        b("mem_q_len") + c["mem_count_pre_dst0"] + i64(dst0_mem)
    )

    # ---- log forward queue ----
    exp_fwd = b("log_fwd_tail")
    exp_fwd_len = b("log_fwd_len")
    exp_fwd = _gf_sel(c["log_exec"], c["log_new_fwd_tail"], exp_fwd)
    exp_fwd_len = torch.where(c["log_exec"], _u32(exp_fwd_len + 1), exp_fwd_len)
    exp_fwd = _gf_sel(c["fc_should_read"], c["fc_fwd_tail"], exp_fwd)
    exp_fwd_len = torch.where(c["fc_should_read"], _u32(exp_fwd_len + 1), exp_fwd_len)
    exp_fwd = _gf_sel(ret_rv_m, b("ctx_rq_tail"), exp_fwd)
    exp_fwd_len = torch.where(ret_rv_m, _u32(exp_fwd_len + b("ctx_rq_len")), exp_fwd_len)
    res["log_fwd_tail"] = _gf_eq(a("log_fwd_tail"), exp_fwd)
    res["log_fwd_len"] = a("log_fwd_len") == exp_fwd_len

    return res


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())


# per-block constants, classified by NAME: a constant column's shape can
# coincide with total or total + 1 at small cycle counts (default_aa_code_hash
# is (8,) when total = 8) and must never be cut with row indices
BLOCK_CONSTANT_KEYS = frozenset({"block_rollback_tail", "default_aa_code_hash",
                                 "zkporter_available"})

# row-sharded: a cycle reads its state before and after (the state columns'
# extra entry), nothing of other cycles; the limit is the window's cycles
eval_constraints.shard_plan = ShardPlan(
    replicated=BLOCK_CONSTANT_KEYS,
    window_config=lambda limit, rows: rows,
)


# PyTorch runs eagerly: the counterpart of the JAX package's jitted name.
eval_constraints_jit = eval_constraints
