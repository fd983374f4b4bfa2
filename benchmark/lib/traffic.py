"""The benchmark's one traffic generator: everything a cell's inputs are made
of, drawn from `--seed` and the parameters of its traffic file.

* `ram_tapes`: the ram_permutation query tapes (a frozen copy of the tape
  generator every bring-up run measured, with the seed as a parameter).
* `loop_counts`: the outer and inner counts of the main_vm benchmark loop,
  drawn so that the run returns within its cycles and every seed runs nearly
  the same number of cycles.
* `tamper_plan`: which instances of a closed-loop check cycle carry which
  seeded faults.  The traffic file lists the kinds of fault; the plan puts
  one fault of each kind in each of as many equal strata of the rows, so that
  every tampered instance has faults in both halves of its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.goldilocks import P, i64


def rng(seed: int, stream: int) -> np.random.Generator:
    """an independent generator for one use of the seed (any size of seed)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def ram_tapes(n: int, seed: int):
    """(unsorted, sorted) dicts of {timestamp, memory_page, index, rw_flag,
    is_ptr, value (n, 8)} numpy arrays: n writes, the sorted tape ordered by
    (page, index, timestamp), the unsorted tape a seeded shuffle of it."""
    g = rng(seed, 1)
    pages = np.sort(g.integers(4, 1 << 20, size=n, dtype=np.uint32))
    index = np.arange(n, dtype=np.uint32) % 1024
    ts = np.arange(n, dtype=np.uint32) + 16
    order = np.lexsort((ts, index, pages))
    pages, index, ts = pages[order], index[order], ts[order]
    value = g.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    sorted_t = dict(timestamp=ts, memory_page=pages, index=index,
                    rw_flag=np.ones(n, dtype=bool), is_ptr=np.zeros(n, dtype=bool), value=value)
    perm = g.permutation(n)
    unsorted_t = {k: v[perm] for k, v in sorted_t.items()}
    return unsorted_t, sorted_t


def loop_counts(cycles: int, seed: int, outer_range) -> tuple:
    """(outer, inner, return_cycle): `outer` drawn from `outer_range`
    (inclusive), `inner` the most rounds that still return within `cycles`.
    The loop takes 2 + outer * (3 + 4 * inner) cycles; the state after its
    return is row `return_cycle`."""
    lo, hi = outer_range
    outer = int(rng(seed, 2).integers(lo, hi + 1))
    inner = ((cycles - 2) // outer - 3) // 4
    if not 1 <= inner < 1 << 16:
        raise ValueError(f"inner count {inner} out of range for outer {outer}")
    return outer, inner, 2 + outer * (3 + 4 * inner)


def tamper_plan(traffic: dict, ranges: dict, seed: int, row_pc=None) -> list:
    """One list of faults per instance of the check cycle; instance 0 is honest.

    Each fault is {"field", "index" (a tuple), "op", "row"} and the kind's
    "fails" and "may" lists ([group, offset from the row] pairs) when it has
    them.  A kind with a "window" (an offset pair around its row: the rows
    whose residuals it may fail) is drawn so that its window lies inside its
    stratum with a row to spare on each side, so that no two faults' windows
    touch; with "pcs" only rows whose pc (`row_pc`, the reference's) is one
    of them are drawn."""
    kinds = traffic["tampers"]
    g = rng(seed, 3)
    plan = [[]]
    for t in range(traffic["tampered"]):
        faults = []
        for j in range(len(kinds)):
            kind = kinds[(j + t) % len(kinds)]
            lo, hi = ranges[kind["range"]]
            span = (hi - lo) // len(kinds)
            start = lo + j * span
            if "window" in kind:
                w0, w1 = kind["window"]
                rows = np.arange(start + 1 - w0, start + span - 1 - w1)
                if "pcs" in kind:
                    rows = rows[np.isin(row_pc[rows], kind["pcs"])]
                if not len(rows):
                    raise ValueError(f"no row for a fault of {kind['field']} in [{start}, "
                                     f"{start + span})")
                row = int(rows[int(g.integers(0, len(rows)))])
            else:
                row = start + int(g.integers(0, span))
            field = kind["field"]
            if isinstance(field, list):
                field = field[int(g.integers(0, len(field)))]
            index = tuple(row if part == "row" else
                          int(g.integers(part[0], part[1])) if isinstance(part, list) else part
                          for part in kind["index"])
            faults.append(dict(field=field, index=index, op=kind["op"], row=row,
                               fails=kind.get("fails", []), may=kind.get("may", [])))
        plan.append(faults)
    if len(plan) != traffic["instances"]:
        raise ValueError("instances must be one honest and the tampered ones")
    return plan


def apply_fault(tensor, fault: dict):
    """a changed copy of `tensor` (a torch tensor) with one fault applied."""
    out = tensor.clone()
    idx = fault["index"]
    op = fault["op"]
    if op == "not":
        out[idx] = ~out[idx]
    elif op == "xor":
        out[idx] = out[idx] ^ 1
    elif op == "inc":  # a field element plus one, kept canonical
        v = out[idx]
        out[idx] = torch.where(v == i64(P - 1), torch.zeros_like(v), v + 1)
    else:
        raise ValueError(f"unknown fault op {op!r}")
    return out
