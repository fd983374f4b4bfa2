"""main_vm multi-instance ClosedFormInput (ref src/main_vm/mod.rs:47-229):
the JAX package's `models/vm/compact.py`.

A long EraVM run of n*limit cycles is sliced into n circuit instances of
`limit` cycles each.  Instance k's hidden FSM input/output are the FULL
VmLocalState at cycle boundaries k*limit and (k+1)*limit (ref
`base_structures/vm_state/mod.rs:92-109`).

The observable input is the VmInputData analog (ref `src/main_vm/input.rs`):
per-block context (default AA code hash, zkporter availability), the block
rollback-queue tail and the memory / decommit queues' initial states; the
observable output is VmOutputData, the final log / memory / decommit queue
states.

Boot checks (ref `src/main_vm/loading.rs:13-226`): the first instance's row-0
state must be the bootloader boot state, with the callstack sponge equal to
the 4-round Poseidon2 absorption of the empty-entry encoding whose rollback
head/tail are pinned to the block rollback tail (`_boot_sponge`, a batch of
one: on the card the small-batch kernel).  Exit invariant (ref
`mod.rs:147-160`): at the final boundary the callstack is empty and pc == 0.

`dw` is the dict of `circuit.prepare_device_witness`: u32 columns as int64,
flags as bool, field columns as int64 field elements.
`vm_eval_instances_sharded` evaluates the instances over the "inst" axis of
a mesh (`parallel/mesh.py`), one block of instances a member.
"""

from __future__ import annotations

import numpy as np
import torch

from ...isa import system_params as sp
from ...ops import gf, poseidon2
from ...utils import protocol
from .circuit import BLOCK_CONSTANT_KEYS, _enc32

# (key, kind) in canonical encoding order.  kind: "u32" scalar column,
# "bool", "vec<k>" u32 vector column, "gf<k>" field lanes column.
VM_LOCAL_STATE_LAYOUT = (
    ("regs", "vec120"),          # (15,8) u32 flattened
    ("regs_ptr", "bvec15"),
    ("f_of", "bool"), ("f_eq", "bool"), ("f_gt", "bool"),
    ("ts", "u32"), ("page_counter", "u32"), ("tx_number", "u32"),
    ("prev_code_page", "u32"), ("prev_super_pc", "u32"),
    ("prev_code_word", "vec8"),
    ("pending_exc", "bool"), ("ergs_pp", "u32"),
    ("ctx_u128", "vec4"),
    ("cs_depth", "u32"), ("cs_sponge", "gf12"),
    ("mem_q_state", "gf12"), ("mem_q_len", "u32"),
    ("dec_q_state", "gf12"), ("dec_q_len", "u32"),
    ("log_fwd_tail", "gf4"), ("log_fwd_len", "u32"),
    ("ctx_rq_head", "gf4"), ("ctx_rq_tail", "gf4"), ("ctx_rq_len", "u32"),
    ("ctx_this", "vec5"), ("ctx_caller", "vec5"), ("ctx_code_address", "vec5"),
    ("ctx_code_page", "u32"), ("ctx_base_page", "u32"),
    ("ctx_heap_bound", "u32"), ("ctx_aux_heap_bound", "u32"),
    ("ctx_pc", "u32"), ("ctx_sp", "u32"), ("ctx_eh", "u32"),
    ("ctx_ergs", "u32"),
    ("ctx_is_static", "bool"), ("ctx_is_kernel", "bool"),
    ("ctx_is_local", "bool"),
    ("ctx_shard_this", "u32"), ("ctx_shard_caller", "u32"),
    ("ctx_shard_code", "u32"),
    ("ctx_ctx_u128", "vec4"),
)


def _as_index(rows, device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device)
    return torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=device)


def encode_local_state(dw: dict, rows) -> torch.Tensor:
    """VmLocalState rows -> field lane encoding, shape (len(rows), L)."""
    rows = _as_index(rows, dw["ts"].device)
    lanes = []
    for key, kind in VM_LOCAL_STATE_LAYOUT:
        col = dw[key][rows]
        if kind.startswith("gf"):
            lanes += [col[..., k] for k in range(int(kind[2:]))]
        elif kind == "u32":
            lanes.append(col)
        elif kind == "bool":
            lanes.append(gf.from_u32(col))
        elif kind == "bvec15":
            v = col.to(torch.int64)  # (n, 15) -> one packed lane
            packed = torch.zeros(v.shape[:-1], dtype=torch.int64, device=v.device)
            for k in range(15):
                packed = packed | (v[..., k] << k)
            lanes.append(packed)
        elif kind == "vec120":
            v = col.reshape(*rows.shape, 120)
            lanes += [v[..., k] for k in range(120)]
        else:  # vecK
            lanes += [col[..., k] for k in range(int(kind[3:]))]
    return torch.stack(lanes, dim=-1)


def _queue_state_enc(state: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    return torch.cat([state, gf.from_u32(length).unsqueeze(-1)], dim=-1)


def observable_input_encoding(dw: dict) -> torch.Tensor:
    """VmInputData analog (ref input.rs:33-47), shape (1, L): per-block
    context + the block rollback tail + the memory-queue INITIAL state (the
    ts=0 bootloader-heap pushes the scheduler made before handing over)."""
    aa = dw["default_aa_code_hash"].reshape(1, 8)
    lanes = [gf.from_u32(dw["zkporter_available"]).reshape(1)]
    lanes += [aa[:, k] for k in range(8)]
    rb = dw["block_rollback_tail"].reshape(1, 4)
    lanes += [rb[:, k] for k in range(4)]
    lanes += [dw["mem_q_state"][:1, k] for k in range(12)]
    lanes.append(dw["mem_q_len"][:1])
    lanes += [dw["dec_q_state"][:1, k] for k in range(12)]
    lanes.append(dw["dec_q_len"][:1])
    return torch.stack(lanes, dim=-1)


def observable_output_encoding(dw: dict) -> torch.Tensor:
    """VmOutputData analog (ref input.rs:71-90), shape (1, L): the final
    log / memory / decommittment queue states."""
    last = slice(dw["ts"].shape[0] - 1, None)
    return torch.cat(
        [
            _queue_state_enc(dw["log_fwd_tail"][last], dw["log_fwd_len"][last]),
            _queue_state_enc(dw["mem_q_state"][last], dw["mem_q_len"][last]),
            _queue_state_enc(dw["dec_q_state"][last], dw["dec_q_len"][last]),
        ],
        dim=-1,
    )


def _boot_sponge(block_rollback_tail: torch.Tensor) -> torch.Tensor:
    """Callstack sponge after absorbing the empty entry (loading.rs:95-171):
    an all-zero kernel-mode record whose rollback head/tail are the block
    rollback tail.  (1, 12)."""
    dev = block_rollback_tail.device
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    zf = torch.zeros((1,), dtype=torch.bool, device=dev)
    z5 = torch.zeros((1, 5), dtype=torch.int64, device=dev)
    z4 = torch.zeros((1, 4), dtype=torch.int64, device=dev)
    rb = block_rollback_tail.reshape(1, 4)
    enc = _enc32(
        dict(
            rq_head=rb, rq_tail=rb,
            code_address=z5, this=z5, caller=z5, ctx_u128=z4,
            code_page=zero, base_page=zero, pc=zero, sp=zero,
            shard_this=zero, shard_caller=zero, shard_code=zero,
            is_static=zf, is_kernel=~zf, is_local=zf,
            ergs=zero, eh=zero, heap_bound=zero, aux_heap_bound=zero,
            rq_len=zero,
        )
    )
    st = gf.zeros((1, 12), dev)
    for r in range(4):
        st = poseidon2.permutation(torch.cat([enc[..., 8 * r : 8 * r + 8], st[..., 8:]], dim=-1))
    return st


def boot_and_exit_residuals(dw: dict) -> dict:
    """Row-0 boot-state pins + final-row exit invariants (0-d bool tensors)."""
    res = {}
    dev = dw["ts"].device
    n_last = dw["ts"].shape[0] - 1

    # --- registers: r1 = formal calldata fat pointer, rest zero ---
    regs0 = dw["regs"][0]  # (15, 8)
    r1_expected = torch.zeros(8, dtype=torch.int64, device=dev)
    r1_expected[1] = sp.BOOTLOADER_CALLDATA_PAGE
    res["boot_r1"] = (regs0[0] == r1_expected).all() & dw["regs_ptr"][0, 0]
    res["boot_regs_clear"] = (regs0[1:] == 0).all() & (~dw["regs_ptr"][0, 1:]).all()

    # --- scalar state pins ---
    pins = [
        ("f_of", 0), ("f_eq", 0), ("f_gt", 0),
        ("ts", sp.STARTING_TIMESTAMP), ("page_counter", sp.STARTING_BASE_PAGE),
        ("tx_number", 0), ("prev_code_page", 0), ("prev_super_pc", 0),
        ("pending_exc", 0), ("ergs_pp", 0), ("cs_depth", 1),
        ("log_fwd_len", 0),
        ("ctx_rq_len", 0),
        ("ctx_code_page", sp.BOOTLOADER_CODE_PAGE),
        ("ctx_base_page", sp.BOOTLOADER_BASE_PAGE),
        ("ctx_heap_bound", sp.BOOTLOADER_MAX_MEMORY),
        ("ctx_aux_heap_bound", sp.BOOTLOADER_MAX_MEMORY),
        ("ctx_pc", 0), ("ctx_sp", 0),
        ("ctx_eh", sp.INITIAL_FRAME_FORMAL_EH_LOCATION),
        ("ctx_ergs", sp.VM_INITIAL_FRAME_ERGS),
        ("ctx_is_static", 0), ("ctx_is_kernel", 1), ("ctx_is_local", 0),
        ("ctx_shard_this", 0), ("ctx_shard_caller", 0), ("ctx_shard_code", 0),
    ]
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for key, val in pins:
        ok = ok & (dw[key][0].to(torch.int64) == val)
    res["boot_scalars"] = ok
    res["boot_vectors"] = (
        (dw["prev_code_word"][0] == 0).all()
        & (dw["ctx_u128"][0] == 0).all()
        & (dw["ctx_ctx_u128"][0] == 0).all()
        & (dw["ctx_caller"][0] == 0).all()
    )
    boot_addr = torch.tensor(
        [(sp.BOOTLOADER_FORMAL_ADDRESS >> (32 * k)) & 0xFFFFFFFF for k in range(5)],
        dtype=torch.int64, device=dev,
    )
    res["boot_address"] = (dw["ctx_this"][0] == boot_addr).all() & (
        dw["ctx_code_address"][0] == boot_addr
    ).all()

    # --- the log queue starts empty; the memory/decommit queues' initial
    # states are bound into the observable input instead ---
    res["boot_queues"] = (dw["log_fwd_tail"][:1] == 0).all()
    rb = dw["block_rollback_tail"].reshape(1, 4)
    res["boot_rollback_chain"] = (
        gf.equal(dw["ctx_rq_head"][:1], rb).all() & gf.equal(dw["ctx_rq_tail"][:1], rb).all()
    )

    # --- callstack sponge == 4-round absorption of the empty entry ---
    res["boot_cs_sponge"] = gf.equal(
        dw["cs_sponge"][:1], _boot_sponge(dw["block_rollback_tail"])
    ).all()

    # --- exit invariants at the final boundary (mod.rs:147-160) ---
    res["exit_callstack_empty"] = dw["cs_depth"][n_last] == 0
    res["exit_pc_zero"] = dw["ctx_pc"][n_last] == 0
    return res


def vm_instance_compact_forms(dw: dict, limit: int):
    """Slice an n*limit-cycle witness into n ClosedFormInput compact forms
    (ref mod.rs:178-229) + the boot/exit residual dict.

    Instance k: hidden fsm in/out = VmLocalState at rows k*limit and
    (k+1)*limit; start = (k==0); completion = (k==n-1).  Returns
    (compact_form_batch, residuals)."""
    total = dw["ts"].shape[0] - 1
    if total % limit:
        raise ValueError(f"{total} cycles are not whole instances of {limit}")
    n = total // limit
    dev = dw["ts"].device
    bounds = torch.arange(n + 1, device=dev) * limit
    states = encode_local_state(dw, bounds)  # (n+1, L)

    idx = torch.arange(n, device=dev)
    obs_in = observable_input_encoding(dw).expand(n, -1)
    obs_out = observable_output_encoding(dw).expand(n, -1)
    forms = protocol.compact_form_from_parts(
        idx == 0, idx == n - 1, obs_in, obs_out, states[:-1], states[1:]
    )
    residuals = boot_and_exit_residuals(dw)
    chain = protocol.check_instance_chaining(
        forms.start_flag,
        forms.completion_flag,
        forms.hidden_fsm_input_commitment,
        forms.hidden_fsm_output_commitment,
    )
    residuals.update({"instance_" + k: v for k, v in chain.items()})
    return forms, residuals


# ---------------------------------------------------------------------------
# Per-instance windows (what a per-instance evaluation takes)
# ---------------------------------------------------------------------------



def vm_instance_windows(dw: dict, limit: int):
    """Slice the witness into n overlapping per-instance windows.

    State columns (leading dim total+1) become (n, limit+1, ...) windows:
    consecutive instances SHARE their boundary row, the VmLocalState the
    compact forms commit as hidden FSM input/output, so a window-local
    evaluation plus `check_instance_chaining` equals the whole one.
    Per-cycle columns (leading dim total) become (n, limit, ...).  Everything
    else (per-block constants) is passed through.  Returns
    (windows, in_axes, n): in_axes[k] is 0 for a windowed column, None for one
    passed through (the JAX package's vmap axes)."""
    total = int(dw["ts"].shape[0]) - 1
    if total % limit:
        raise ValueError(f"{total} cycles are not whole instances of {limit}")
    n = total // limit
    dev = dw["ts"].device
    state_idx = (torch.arange(n, device=dev)[:, None] * limit
                 + torch.arange(limit + 1, device=dev)[None, :])
    cyc_idx = state_idx[:, :-1]
    windows, axes = {}, {}
    for k, v in dw.items():
        lead = int(v.shape[0]) if v.dim() else -1
        if k in BLOCK_CONSTANT_KEYS:
            windows[k], axes[k] = v, None
        elif lead == total + 1:
            windows[k], axes[k] = v[state_idx], 0
        elif lead == total:
            windows[k], axes[k] = v[cyc_idx], 0
        else:
            windows[k], axes[k] = v, None
    return windows, axes, n


def vm_eval_instances_sharded(dw: dict, limit: int, mesh, axis: str = "inst") -> dict:
    """Evaluate the VM circuit once per ClosedFormInput instance, member i
    of `axis` taking the block of instances that mesh slot i of the JAX
    package holds (the role of one prover machine per circuit instance).

    The circuit body is `eval_constraints` unchanged, over each instance's
    window (transition checks never cross a window edge by construction);
    the residuals are all-gathered along `axis`, so every member returns
    each entry with a leading (n_instances,) axis."""
    from ...parallel import mesh as meshlib
    from .circuit import eval_constraints

    windows, axes, n = vm_instance_windows(dw, limit)
    d = mesh.size(axis)
    if n % d:
        raise ValueError(f"{n} instances do not split over {d} members of {axis!r}")
    per = n // d
    first = mesh.index(axis) * per
    mine = [eval_constraints({k: v[i] if axes[k] == 0 else v for k, v in windows.items()},
                             limit)
            for i in range(first, first + per)]
    return {k: meshlib.all_gather(torch.stack([r[k] for r in mine]), mesh, axis)
            .reshape((n,) + tuple(mine[0][k].shape))
            for k in mine[0]}
