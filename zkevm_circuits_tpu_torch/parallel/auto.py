"""Row-sharded constraint evaluation of any circuit that carries a shard
plan (the JAX package's `parallel/auto.py`).

The JAX package places every row-axis leaf of the witness on a row-sharded
layout and lets XLA's SPMD partitioner split the circuit's whole graph.
PyTorch has no partitioner, so each circuit states what its evaluation
needs of other rows in a `utils.shard_plan.ShardPlan`, kept beside its
`eval_constraints` as `eval_constraints.shard_plan`:

  1. `shard_rows` keeps this member's contiguous block of every row-axis
     field (the last member also the fields' extra entries);
  2. the halo rows come from the neighbours in two rings of point-to-point
     messages (all fields packed into one int64 buffer a direction), and
     the run's last entry of the plan's tail fields by one broadcast;
  3. the circuit's own `eval_constraints` runs on the window (with a
     `RowWindow` where the plan asks for one);
  4. the residuals are cut back to the block and all-gathered, or taken from
     the member the plan names.

The result equals the unsharded `eval_constraints(witness, config)` on
every member, key for key.  A circuit without a plan raises
`NotImplementedError`: nothing is silently replicated or gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from ..utils.shard_plan import RowWindow, ShardPlan
from . import mesh as meshlib

_AXIS = "rows"


# ---------------------------------------------------------------------------
# the witness as named fields of tensor leaves
# ---------------------------------------------------------------------------


def _fields(w) -> List[Tuple[str, object]]:
    if isinstance(w, dict):
        return list(w.items())
    if dataclasses.is_dataclass(w):
        return [(f.name, getattr(w, f.name)) for f in dataclasses.fields(w)]
    raise TypeError(f"a witness is a dict or a dataclass, not {type(w).__name__}")


def _fields_dict(w) -> dict:
    return dict(_fields(w))


def _rebuild(w, values: dict):
    if isinstance(w, dict):
        return dict(values)
    return dataclasses.replace(w, **values)


def _leaves(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict) or dataclasses.is_dataclass(x):
        return [t for _, v in _fields(x) for t in _leaves(v)]
    return []


def _map_leaves(x, fn):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict) or dataclasses.is_dataclass(x):
        return _rebuild(x, {k: _map_leaves(v, fn) for k, v in _fields(x)})
    return x


def plan_of(eval_fn: Callable) -> ShardPlan:
    plan = getattr(eval_fn, "shard_plan", None)
    if plan is None:
        name = f"{getattr(eval_fn, '__module__', '?')}.{getattr(eval_fn, '__qualname__', eval_fn)}"
        raise NotImplementedError(f"{name} has no shard plan: it cannot be row-sharded")
    return plan


def _row_fields(witness, plan: ShardPlan, num_rows: int) -> dict:
    """{field: extra entries} of the fields on the row axis."""
    out = {}
    for name, value in _fields(witness):
        leaves = _leaves(value)
        if not leaves or name in plan.replicated:
            continue
        if plan.rows is not None and name not in plan.rows:
            continue
        extras = {int(t.shape[0]) - num_rows if t.dim() else -1 for t in leaves}
        if len(extras) == 1 and extras <= {0, 1, 2}:
            out[name] = extras.pop()
        elif plan.rows is not None:
            raise ValueError(f"row field {name} has leading sizes {sorted(extras)} "
                             f"for {num_rows} rows")
    return out


# ---------------------------------------------------------------------------
# blocks and windows
# ---------------------------------------------------------------------------


def shard_rows(witness, mesh: meshlib.Mesh, num_rows: int, plan: ShardPlan,
               axis: str = _AXIS):
    """This member's block of the witness: each row-axis field cut to the
    member's rows (the last member keeps the field's extra entries after
    them); every other field whole.  Returns (block witness, row fields)."""
    rows = _row_fields(witness, plan, num_rows)
    sl = meshlib.Layout(mesh, axis).block(num_rows)
    last = mesh.index(axis) == mesh.size(axis) - 1
    values = {}
    for name, value in _fields(witness):
        if name in rows:
            stop = sl.stop + (rows[name] if last else 0)
            value = _map_leaves(value, lambda t: t[sl.start:stop].clone())
        values[name] = value
    return _rebuild(witness, values), rows


def _pack(pieces: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.to(torch.int64).reshape(-1) for p in pieces])


def _unpack(buf: torch.Tensor, likes: List[torch.Tensor], rows: List[int]):
    out, at = [], 0
    for like, r in zip(likes, rows):
        shape = (r,) + tuple(like.shape[1:])
        size = r * like[0].numel() if like.dim() else 0
        out.append(buf[at:at + size].reshape(shape).to(like.dtype))
        at += size
    return out


def _window(block, rows: dict, plan: ShardPlan, mesh: meshlib.Mesh, axis: str, L: int):
    """The block with its halos and, on all but the last member, the run's
    last entry of each tail field.  Returns (window, rows before, rows after)."""
    hb, ha = plan.halo
    d, i = mesh.size(axis), mesh.index(axis)
    first, last = i == 0, i == d - 1
    if L < max(hb, ha + 2):
        raise ValueError(f"blocks of {L} rows are shorter than the halo {plan.halo}")
    fields = _fields_dict(block)
    flat = [(n, t) for n in rows for t in _leaves(fields[n])]
    likes = [t for _, t in flat]
    before = after = None
    if hb:  # my last hb rows to the next member
        got = meshlib.ppermute(_pack([t[L - hb:L] for t in likes]), mesh, axis, 1)
        before = _unpack(got, likes, [hb] * len(flat))
    want = [ha + rows[n] for n, _ in flat]
    if any(want):  # my first ha + k rows to the previous member
        got = meshlib.ppermute(_pack([t[:k] for t, k in zip(likes, want)]), mesh, axis, -1)
        after = _unpack(got, likes, want)
    tails = [j for j, (n, _) in enumerate(flat) if n in plan.tails]
    if tails:  # the run's last entries, from the last member
        sizes = [likes[j][0].numel() for j in tails]
        buf = (_pack([likes[j][-1:] for j in tails]) if last else
               torch.zeros(sum(sizes), dtype=torch.int64, device=likes[0].device))
        run_last = meshlib.broadcast(buf, mesh, axis, d - 1).split(sizes)
    new = {}
    for j, (n, t) in enumerate(flat):
        parts = [before[j]] if hb and not first else []
        parts.append(t[:L + (rows[n] if last else 0)])
        if after is not None and not last:
            parts.append(after[j])
        new[id(t)] = torch.cat(parts)
    if tails and not last:
        for j, entry in zip(tails, run_last):
            w = new[id(likes[j])]
            w[-1] = entry.reshape(w.shape[1:]).to(w.dtype)
    values = {name: _map_leaves(value, lambda t: new[id(t)]) if name in rows else value
              for name, value in fields.items()}
    return _rebuild(block, values), (0 if first else hb), (0 if last else ha)


def _flag_carry(block, plan: ShardPlan, mesh, axis: str, lo: int, L: int) -> int:
    """the last run row before this member's block whose carry flag holds."""
    flag = _fields_dict(block)[plan.carry_flag][:L]
    idx = torch.arange(lo, lo + L, device=flag.device)
    mine = torch.where(flag, idx, torch.zeros_like(idx)).max().reshape(1)
    every = meshlib.all_gather(mine, mesh, axis)[:, 0]
    return int(every[:mesh.index(axis)].max()) if mesh.index(axis) else 0


def _gather_rows(res: torch.Tensor, key: str, off: int, L: int, T: int,
                 mesh, axis: str) -> torch.Tensor:
    """A per-row residual of the window (T rows, or T plus the extra
    entries) cut to this member's block and gathered in run order."""
    extra = int(res.shape[0]) - T if res.dim() else -1
    if extra not in (0, 1, 2):
        raise ValueError(f"residual {key} of shape {tuple(res.shape)} is neither per row "
                         f"nor named in the shard plan")
    d = mesh.size(axis)
    last = mesh.index(axis) == d - 1
    mine = res[off:off + L + (extra if last else 0)]
    if not last and extra:
        mine = torch.cat([mine, torch.zeros_like(res[:extra])])
    every = meshlib.all_gather(mine, mesh, axis)  # (D, L + extra, ...)
    head = every[:, :L].reshape((d * L,) + tuple(res.shape[1:]))
    return torch.cat([head, every[-1, L:]]) if extra else head


def eval_sharded(eval_fn: Callable, witness, config, mesh: meshlib.Mesh, num_rows: int,
                 axis: str = _AXIS) -> dict:
    """`eval_fn(witness, config)` over the members of `axis`, each holding a
    block of `num_rows // D` rows; the whole run's residuals on every
    member.  Every member passes the same witness and config."""
    plan = plan_of(eval_fn)
    d = mesh.size(axis)
    if num_rows % d:
        raise ValueError(f"{num_rows} rows do not split over {d} members")
    L = num_rows // d
    lo = mesh.index(axis) * L
    block, rows = shard_rows(witness, mesh, num_rows, plan, axis)
    win, before, after = _window(block, rows, plan, mesh, axis, L)
    T = before + L + after  # window rows
    kwargs = {}
    if plan.takes_window:
        carry = _flag_carry(block, plan, mesh, axis, lo, L) if plan.carry_flag else 0
        kwargs["window"] = RowWindow(row0=lo - before, total=num_rows, flag_carry=carry)
    res = eval_fn(win, plan.window_config(config, T), **kwargs)
    out = {}
    for key, value in res.items():
        if key in plan.whole:
            out[key] = meshlib.broadcast(value, mesh, axis, 0)
        elif key in plan.last:
            out[key] = meshlib.broadcast(value, mesh, axis, d - 1)
        else:
            out[key] = _gather_rows(value, key, before, L, T, mesh, axis)
    return out
