"""Row-sharded constraint evaluation of any circuit that carries a shard
plan (the JAX package's `parallel/auto.py`).

The JAX package places every row-axis leaf of the witness on a row-sharded
layout and lets XLA's SPMD partitioner split the circuit's whole graph.
PyTorch has no partitioner, so each circuit states what its evaluation
needs of other rows in a `utils.shard_plan.ShardPlan`, kept beside its
`eval_constraints` as `eval_constraints.shard_plan`:

  1. `_cut` splits each of the plan's row axes (the "rows" of the caller's
     `num_rows` and the plan's further axes) into blocks of ceil(N / D)
     rows, the last member's the rest; a member keeps its block of every
     field of the axis, k entries a row (the last member also the field's
     extra entries), and every other field whole;
  2. the halo rows come from the neighbours in two rings of point-to-point
     messages an axis (all its fields packed into one int64 buffer a
     direction), the run's last entry of the plan's tail fields by one
     broadcast, the last group start before the block (and its carried
     values) by one all-gather;
  3. the circuit's own `eval_constraints` runs on the window (with a
     `RowWindow` where the plan asks for one);
  4. each residual is made as the plan names it: cut back to the block and
     all-gathered (k entries a row, on the row axis it lies on), taken from
     the first or the last member (`whole`, `last`), ANDed over the members (`every`), or
     summed over the members and finished (`sums`).

The result equals the unsharded `eval_constraints(witness, config)` on
every member, key for key.  A circuit without a plan raises
`NotImplementedError`: nothing is silently replicated or gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, FrozenSet, List, Optional, Tuple

import torch

from ..utils.shard_plan import PartialSum, RowWindow, ShardPlan
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


def _extras(name: str, value, k: int, n: int, strict: bool) -> Optional[int]:
    """the extra entries of a field of k entries a row over n rows (None
    when it is not one and `strict` is off)."""
    leaves = _leaves(value)
    extras = {int(t.shape[0]) - k * n if t.dim() else -1 for t in leaves}
    if leaves and len(extras) == 1 and extras <= {0, 1, 2}:
        return extras.pop()
    if strict:
        raise ValueError(f"row field {name} has leading sizes {sorted(extras)} "
                         f"for {n} rows of {k} entries")
    return None


def _row_fields(witness, plan: ShardPlan, num_rows: int) -> dict:
    """{field: extra entries} of the fields on the row axis."""
    further = {f for ax in plan.axes.values() for f in ax.fields}
    out = {}
    for name, value in _fields(witness):
        if not _leaves(value) or name in plan.replicated or name in further:
            continue
        if plan.rows is not None and name not in plan.rows:
            continue
        extra = _extras(name, value, plan.entries.get(name, 1), num_rows, plan.rows is not None)
        if extra is not None:
            out[name] = extra
    return out


# ---------------------------------------------------------------------------
# the axes' blocks and windows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Cut:
    """One row axis on this member: the run's `n` rows in blocks of `L`
    (the last member's the rest), this member's `mine` rows from run row
    `lo`; its fields {name: (entries a row, extra entries)}, halo and tail
    fields."""

    n: int
    L: int
    lo: int
    mine: int
    first: bool
    last: bool
    fields: dict
    halo: Tuple[int, int]
    tails: FrozenSet[str]

    @property
    def before(self) -> int:
        return 0 if self.first else self.halo[0]

    @property
    def after(self) -> int:
        return 0 if self.last else self.halo[1]

    @property
    def rows(self) -> int:  # the window's rows
        return self.before + self.mine + self.after

    def window(self) -> RowWindow:
        return RowWindow(row0=self.lo - self.before, total=self.n,
                         own=(self.before, self.before + self.mine))


def _cut(n: int, fields: dict, halo, tails, mesh: meshlib.Mesh, axis: str) -> _Cut:
    d, i = mesh.size(axis), mesh.index(axis)
    L = -(-n // d)
    rest = n - (d - 1) * L
    hb, ha = halo
    # a block sends hb rows on, and ha rows and the extra entries back
    need = max([hb] + [ha + -(-e // k) for k, e in fields.values()])
    if L < need or rest < max(1, hb, ha):
        raise ValueError(f"{n} rows in blocks of {L} (the last {rest}) do not hold the "
                         f"halo {tuple(halo)} over {d} members")
    return _Cut(n, L, i * L, rest if i == d - 1 else L, i == 0, i == d - 1, fields,
                tuple(halo), frozenset(tails))


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


def _block(t: torch.Tensor, cut: _Cut, k: int, extra: int) -> torch.Tensor:
    """this member's entries of a field: k a row, the extra ones on the last."""
    return t[cut.lo * k:(cut.lo + cut.mine) * k + (extra if cut.last else 0)].clone()


def _window(fields: dict, cut: _Cut, mesh: meshlib.Mesh, axis: str) -> dict:
    """{id(leaf): its window}: the member's block of each leaf of the axis
    with the halo entries of the neighbours and, on all but the last
    member, the run's last entry of each tail field."""
    hb, ha = cut.halo
    flat = [(n, _block(t, cut, *cut.fields[n])) for n in cut.fields for t in _leaves(fields[n])]
    likes = [t for _, t in flat]
    ks = [cut.fields[n][0] for n, _ in flat]
    before = after = None
    if hb:  # my last hb rows to the next member
        got = meshlib.ppermute(
            _pack([t[(cut.mine - hb) * k:cut.mine * k] for t, k in zip(likes, ks)]), mesh, axis, 1)
        before = _unpack(got, likes, [hb * k for k in ks])
    want = [ha * k + cut.fields[n][1] for (n, _), k in zip(flat, ks)]
    if any(want):  # my first ha rows and the extra entries to the previous member
        got = meshlib.ppermute(_pack([t[:m] for t, m in zip(likes, want)]), mesh, axis, -1)
        after = _unpack(got, likes, want)
    tails = [j for j, (n, _) in enumerate(flat) if n in cut.tails]
    if tails:  # the run's last entries, from the last member
        sizes = [likes[j][0].numel() for j in tails]
        buf = (_pack([likes[j][-1:] for j in tails]) if cut.last else
               torch.zeros(sum(sizes), dtype=torch.int64, device=likes[0].device))
        run_last = meshlib.broadcast(buf, mesh, axis, mesh.size(axis) - 1).split(sizes)
    out = {}
    for j, t in enumerate(likes):
        parts = [before[j]] if hb and not cut.first else []
        parts.append(t)
        if after is not None and not cut.last:
            parts.append(after[j])
        out[j] = torch.cat(parts)
    if tails and not cut.last:
        for j, entry in zip(tails, run_last):
            out[j][-1] = entry.reshape(out[j].shape[1:]).to(out[j].dtype)
    leaves = [t for n in cut.fields for t in _leaves(fields[n])]
    return {id(t): out[j] for j, t in enumerate(leaves)}


def _windowed(witness, cuts: dict, mesh: meshlib.Mesh, axis: str):
    """the witness with every axis's fields replaced by their windows."""
    fields = _fields_dict(witness)
    new = {}
    for cut in cuts.values():
        new.update(_window(fields, cut, mesh, axis))
    on_axes = {n for cut in cuts.values() for n in cut.fields}
    return _rebuild(witness, {name: _map_leaves(value, lambda t: new[id(t)])
                              if name in on_axes else value
                              for name, value in fields.items()})


def _carry(win, plan: ShardPlan, cut: _Cut, mesh: meshlib.Mesh, axis: str):
    """(the last run row before this member's block where the carry flag
    holds, 0 when none does; the plan's carry values at that row)."""
    flag = plan.carry_flag(win)[cut.before:cut.before + cut.mine]
    idx = torch.arange(cut.lo, cut.lo + cut.mine, device=flag.device)
    mine = torch.where(flag, idx, torch.full_like(idx, 0 if cut.first else -1)).max().reshape(1)
    every = meshlib.all_gather(mine, mesh, axis)[:, 0]
    i = mesh.index(axis)
    src = int(torch.argmax(every[:i])) if i else 0
    row = int(every[src]) if i else 0
    if plan.carry_values is None:
        return row, None
    values = plan.carry_values(win)
    at = max(int(mine[0]) - (cut.lo - cut.before), 0)
    likes = [v[at:at + 1] for v in values.values()]
    got = meshlib.all_gather(_pack(likes), mesh, axis)[src]
    carried = _unpack(got, likes, [1] * len(likes))
    return row, {k: v[0] for k, v in zip(values, carried)}


def _gather_rows(res: torch.Tensor, key: str, cut: _Cut, k: int,
                 mesh: meshlib.Mesh, axis: str) -> torch.Tensor:
    """A residual of k entries a row of the window (or those and the extra
    entries) cut to this member's block and gathered in run order."""
    extra = int(res.shape[0]) - k * cut.rows if res.dim() else -1
    if extra not in (0, 1, 2):
        raise ValueError(f"residual {key} of shape {tuple(res.shape)} is neither per row "
                         f"nor named in the shard plan")
    shape = tuple(res.shape[1:])
    off, full, mine = cut.before * k, cut.L * k, cut.mine * k
    parts = [res[off:off + mine], res.new_zeros((full - mine,) + shape)]
    parts.append(res[off + mine:off + mine + extra] if cut.last else
                 res.new_zeros((extra,) + shape))
    every = meshlib.all_gather(torch.cat(parts), mesh, axis)  # (D, L k + extra, ...)
    rest = (cut.n - (mesh.size(axis) - 1) * cut.L) * k
    return torch.cat([every[:-1, :full].reshape((-1,) + shape), every[-1, :rest],
                      every[-1, full:]])


def eval_sharded(eval_fn: Callable, witness, config, mesh: meshlib.Mesh, num_rows: int,
                 axis: str = _AXIS) -> dict:
    """`eval_fn(witness, config)` over the members of `axis`, each holding a
    block of the `num_rows` rows (and of each further axis of the plan);
    the whole run's residuals on every member.  Every member passes the
    same witness and config."""
    plan = plan_of(eval_fn)
    fields = _fields_dict(witness)
    main = _cut(num_rows, {n: (plan.entries.get(n, 1), e)
                           for n, e in _row_fields(witness, plan, num_rows).items()},
                plan.halo, plan.tails, mesh, axis)
    cuts = {None: main}
    for name, ax in plan.axes.items():
        n = int(_leaves(fields[ax.rows_of])[0].shape[0])
        # in the witness's order: every member packs its messages alike
        cuts[name] = _cut(n, {f: (1, _extras(f, v, 1, n, True)) for f, v in fields.items()
                              if f in ax.fields}, ax.halo, frozenset(), mesh, axis)
    win = _windowed(witness, cuts, mesh, axis)
    kwargs = {}
    if plan.takes_window:
        carry, carried = _carry(win, plan, main, mesh, axis) if plan.carry_flag else (0, None)
        kwargs["window"] = dataclasses.replace(
            main.window(), flag_carry=carry, carried=carried,
            axes={name: c.window() for name, c in cuts.items() if name is not None} or None)
    res = eval_fn(win, plan.window_config(config, main.rows), **kwargs)
    axis_of = {key: name for name, ax in plan.axes.items() for key in ax.residuals}
    d = mesh.size(axis)
    out = {}
    for key, value in res.items():
        if key in plan.sums:
            if not isinstance(value, PartialSum):
                raise TypeError(f"residual {key} is a sum of the plan: its window gives a "
                                f"PartialSum, not {type(value).__name__}")
            out[key] = value.finish(meshlib.all_gather(value.value, mesh, axis).sum(0))
        elif key in plan.every:
            out[key] = meshlib.all_gather(value, mesh, axis).all(0)
        elif key in plan.whole:
            out[key] = meshlib.broadcast(value, mesh, axis, 0)
        elif key in plan.last:
            out[key] = meshlib.broadcast(value, mesh, axis, d - 1)
        else:
            name = axis_of.get(key)
            k = plan.entries.get(key, 1) if name is None else 1
            out[key] = _gather_rows(value, key, cuts[name], k, mesh, axis)
    return out
