"""Plain reference of the ram_permutation (memory sorter) circuit.

From the two query tapes it works out the witness the circuit is checked on:
the 8-element query encodings, the Fiat-Shamir challenges drawn from the two
sponge chains' tails, the running grand products of both queues and the count
of nondeterministic heap writes.  Over any witness it evaluates the circuit's
constraints row by row:

  chain_*            each segment of `stride` rows, absorbed from its start
                     state, lands on the next stored state
  challenges         the stored challenges are the ones drawn from the tails
  lhs/rhs_transitions  product[i] = product[i-1] * factor[i] (1 before row 0;
                     the factor is 1 on rows not executed)
  encoding_*         the stored encodings pack the query fields
  sort_order         (page, index, timestamp) strictly rises on executed rows
  uninit_read_zero   a read of a cell not touched before sees zero, no pointer
  read_consistency   a read of the cell of the row before sees its value
  grand_product_final, nondet_writes_final  the last row closes the argument

A witness is a dict of tensors: "unsorted.<field>" and "sorted.<field>" for
the query fields (timestamp, memory_page, index, rw_flag, is_ptr, value),
enc_unsorted, enc_sorted, chain_unsorted, chain_sorted (the states every
`stride` rows), challenges, lhs, rhs, nondet_count, execute, and the ints n
and snapshot_length.  Plain torch; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import goldilocks as gl
from . import poseidon2 as p2

FIELDS = ("timestamp", "memory_page", "index", "rw_flag", "is_ptr", "value")
REPETITIONS = 2
ENC = 8


def encode(q: dict) -> torch.Tensor:
    """(n, 8) encodings of the queries q[field] (u32 values, bools)."""
    i = {k: q[k].to(torch.int64) for k in FIELDS}
    v = i["value"]

    def byte(limb, j):
        return (v[:, limb] >> (8 * j)) & 0xFF

    return torch.stack([
        i["timestamp"],
        i["memory_page"],
        i["index"] | (i["rw_flag"] << 32) | (i["is_ptr"] << 33),
        v[:, 0] | (byte(5, 0) << 32) | (byte(5, 1) << 40) | (byte(5, 2) << 48),
        v[:, 1] | (byte(5, 3) << 32) | (byte(6, 0) << 40) | (byte(6, 1) << 48),
        v[:, 2] | (byte(6, 2) << 32) | (byte(6, 3) << 40) | (byte(7, 0) << 48),
        v[:, 3] | (byte(7, 1) << 32) | (byte(7, 2) << 40) | (byte(7, 3) << 48),
        v[:, 4],
    ], dim=-1)


def challenges(tail_u: torch.Tensor, tail_s: torch.Tensor, n: int) -> torch.Tensor:
    """(2, 9): column 0 is one, the rest squeezed from the sponge of
    tail_u ++ [n] ++ tail_s ++ [n]."""
    dev = tail_u.device
    count = torch.tensor([n], dtype=torch.int64, device=dev)
    state = p2.hash_elements(torch.cat([tail_u, count, tail_s, count]))
    drawn = []
    needed = REPETITIONS * ENC
    while True:
        drawn.extend(state[:p2.RATE].unbind())
        if len(drawn) >= needed:
            break
        state = p2.permute(state)
    one = torch.ones((), dtype=torch.int64, device=dev)
    return torch.stack([torch.stack([one] + drawn[r * ENC:(r + 1) * ENC])
                        for r in range(REPETITIONS)])


def factors(enc: torch.Tensor, ch: torch.Tensor, execute: torch.Tensor) -> torch.Tensor:
    """(n, 2): ch[r, 8] + sum_j enc[:, j] * ch[r, j]; 1 where not executed."""
    out = []
    for r in range(REPETITIONS):
        acc = ch[r, ENC].expand(enc.shape[0])
        for j in range(ENC):
            acc = gl.add(acc, gl.mul(enc[:, j], ch[r, j]))
        out.append(acc)
    f = torch.stack(out, dim=-1)
    return torch.where(execute.unsqueeze(-1), f, torch.ones_like(f))


def nondet_writes(q: dict, execute: torch.Tensor, heap_page: int) -> torch.Tensor:
    return (execute & (q["timestamp"] == 0) & (q["memory_page"] == heap_page)
            & q["rw_flag"].bool() & ~q["is_ptr"].bool())


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """a tape column: bools as bool, u32 values as int64."""
    a = np.asarray(a)
    return torch.from_numpy(a if a.dtype == bool else a.astype(np.int64)).to(device)


def derive(tape_u: dict, tape_s: dict, heap_page: int, device) -> dict:
    """The parts of the witness that follow from the tapes alone."""
    u = {k: _tensor(v, device) for k, v in tape_u.items()}
    s = {k: _tensor(v, device) for k, v in tape_s.items()}
    n = u["timestamp"].shape[0]
    execute = torch.ones(n, dtype=torch.bool, device=device)
    count = torch.cumsum(nondet_writes(s, execute, heap_page).to(torch.int64), 0)
    return dict(enc_unsorted=encode(u), enc_sorted=encode(s), execute=execute,
                nondet_count=count, snapshot_length=int(count[-1]),
                **{f"unsorted.{k}": v for k, v in u.items()},
                **{f"sorted.{k}": v for k, v in s.items()})


def products(w: dict, ch: torch.Tensor) -> tuple:
    """(lhs, rhs) running products of the witness's encodings under `ch`."""
    return tuple(gl.prefix_product(factors(w[key], ch, w["execute"]))
                 for key in ("enc_unsorted", "enc_sorted"))


def _step(state, enc, ex):
    return torch.where(ex.unsqueeze(-1), p2.absorb(state, enc), state)


def landings(starts: torch.Tensor, enc_steps: torch.Tensor, ex_steps: torch.Tensor):
    """Where chain segments land: a batch of start states (B, 12) absorbs a
    batch of encodings (stride, B, 8), one plain permutation a step, skipping
    the rows not executed (ex_steps (stride, B)).  On the card one step is
    captured once as a CUDA graph of the same plain torch operations and
    replayed `stride` times: eagerly, its thousands of small launches would
    take most of a run's window."""
    if not starts.is_cuda:
        state = starts
        for k in range(enc_steps.shape[0]):
            state = _step(state, enc_steps[k], ex_steps[k])
        return state
    state, enc, ex = starts.clone(), enc_steps[0].clone(), ex_steps[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _step(state, enc, ex)  # warms the constants and the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _step(state, enc, ex)
    for k in range(enc_steps.shape[0]):
        enc.copy_(enc_steps[k])
        ex.copy_(ex_steps[k])
        graph.replay()
        state.copy_(out)
    return state.clone()


def chain_landings(items: list, stride: int, rows=None) -> list:
    """For each (boundaries (S + 1, 12), enc (N, 8), execute (N,)), the (S, 12)
    landing states of its segments, all items in one batch.  `rows`, if set,
    keeps only the segments that start below that row (the control's half
    check); the others land where they are stored, unchecked."""
    starts, encs, exs, sizes = [], [], [], []
    for boundaries, enc, execute in items:
        segments = boundaries.shape[0] - 1
        keep = segments if rows is None else min(segments, rows // stride)
        sizes.append((segments, keep))
        starts.append(boundaries[:keep])
        encs.append(enc[:keep * stride].reshape(keep, stride, ENC))
        exs.append(execute[:keep * stride].reshape(keep, stride))
    start = torch.cat(starts)
    enc_steps = torch.cat(encs).transpose(0, 1).contiguous()
    ex_steps = torch.cat(exs).transpose(0, 1).contiguous()
    landed = landings(start, enc_steps, ex_steps) if start.shape[0] else start
    out, at = [], 0
    for (boundaries, _, _), (segments, keep) in zip(items, sizes):
        out.append(torch.cat([landed[at:at + keep], boundaries[keep + 1:]]))
        at += keep
    return out


def residuals(w: dict, landed_u: torch.Tensor, landed_s: torch.Tensor,
              heap_page: int, rows=None) -> dict:
    """Every constraint of the circuit over witness `w`, given where its two
    chains' segments land.  `rows`, if set, evaluates only the rows below it
    and passes the others (the control's half check)."""
    ex = w["execute"]
    total = ex.shape[0]
    dev = ex.device
    s = {k: w[f"sorted.{k}"] for k in FIELDS}
    u = {k: w[f"unsorted.{k}"] for k in FIELDS}
    row = torch.arange(total, device=dev)
    checked = row < (total if rows is None else rows)
    true = torch.ones(total, dtype=torch.bool, device=dev)

    ch = challenges(w["chain_unsorted"][-1], w["chain_sorted"][-1], w["n"])
    one = torch.ones((1, REPETITIONS), dtype=torch.int64, device=dev)
    out = {
        "chain_unsorted": (landed_u == w["chain_unsorted"][1:]).all(-1),
        "chain_sorted": (landed_s == w["chain_sorted"][1:]).all(-1),
        "challenges": (ch == w["challenges"]).all(),
        "encoding_unsorted": (encode(u) == w["enc_unsorted"]).all(-1),
        "encoding_sorted": (encode(s) == w["enc_sorted"]).all(-1),
    }
    for side, enc_key in (("lhs", "enc_unsorted"), ("rhs", "enc_sorted")):
        prev = torch.cat([one, w[side][:-1]])
        f = factors(w[enc_key], ch, ex)
        out[f"{side}_transitions"] = (w[side] == gl.mul(prev, f)).all(-1)

    prev = {k: v[(row - 1).clamp(min=0)] for k, v in s.items()}
    not_first = row > 0
    rises = ((s["memory_page"] > prev["memory_page"])
             | ((s["memory_page"] == prev["memory_page"]) & (s["index"] > prev["index"]))
             | ((s["memory_page"] == prev["memory_page"]) & (s["index"] == prev["index"])
                & (s["timestamp"] > prev["timestamp"])))
    out["sort_order"] = torch.where(ex & not_first, rises, true)
    same_cell = ((s["memory_page"] == prev["memory_page"]) & (s["index"] == prev["index"])
                 & not_first)
    read = ~s["rw_flag"].bool()
    zero = (s["value"] == 0).all(-1) & ~s["is_ptr"].bool()
    same_value = (s["value"] == prev["value"]).all(-1) & (s["is_ptr"] == prev["is_ptr"])
    out["uninit_read_zero"] = torch.where(ex & read & ~same_cell, zero, true)
    out["read_consistency"] = torch.where(ex & read & same_cell, same_value, true)
    for key in ("encoding_unsorted", "encoding_sorted", "lhs_transitions",
                "rhs_transitions", "sort_order", "uninit_read_zero", "read_consistency"):
        out[key] = out[key] | ~checked

    last = total - 1
    completed = total >= w["n"]
    out["grand_product_final"] = torch.tensor(
        not completed, device=dev) | (w["lhs"][last] == w["rhs"][last]).all()
    out["nondet_writes_final"] = torch.tensor(
        not completed, device=dev) | (w["nondet_count"][last] == w["snapshot_length"])
    return out
