"""The device mesh over a torch.distributed world (the JAX package's
`parallel/mesh.py`).

The parallel seams of the circuits are row-parallel constraint evaluation
within an instance and instance-level pipelining chained by FSM
commitments.  They map onto a 2-D mesh of ranks:

    axis "rows" — row (trace) sharding within circuit instances
    axis "inst" — instance sharding across the continuation chain

Rank k holds the block that device k of the JAX mesh holds: the ranks are
laid out as `np.arange(world).reshape(n_inst, n_rows)`.

One process a rank.  `run_world(fn, world, device)` builds the CUDA kernels
and the native runtime once in the parent, starts the ranks with the spawn
method (the parent may already hold a CUDA context), and joins them under a
deadline; each rank calls `init_world` (a FileStore rendezvous in a
temporary directory, NCCL on cuda:rank or gloo for the CPU) and then `fn`.
Every process group is made with an explicit timeout (`TIMEOUT`).  Nothing
falls back: too few cards, a failed init, a rank that fails or overruns, or
a collective that times out raises.

The collectives below (`ppermute`, `all_gather`, `all_to_all`,
`broadcast`) act along one axis of the mesh, as `jax.lax`'s do inside a
`shard_map`; a bool tensor goes over the wire as uint8.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
import uuid
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device

# every process group's timeout: a hung collective raises within it
TIMEOUT = datetime.timedelta(seconds=60)
# how long `run_world` waits for all ranks by default
DEADLINE_S = 120.0


def init_world(rank: int, world: int, device=None,
               init_file: Optional[str] = None) -> torch.device:
    """Join the world as `rank` of `world` through a FileStore at `init_file`.

    `device=None` is the card (an error without one): the rank takes
    cuda:rank under NCCL and raises when there are fewer cards than ranks.
    "cpu" joins a gloo world.  Returns the rank's device."""
    device = resolve_device(device)
    if init_file is None:
        raise ValueError("init_world needs the rendezvous file every rank shares")
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count < world:
            raise RuntimeError(f"{world} ranks need {world} CUDA cards; {count} found")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend, extra = "nccl", dict(device_id=device)
    elif device.type == "cpu":
        backend, extra = "gloo", {}
    else:
        raise ValueError(f"no backend for a {device.type} world")
    store = dist.FileStore(init_file, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT, **extra)
    return device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the (inst, rows) mesh: the shape, the rank
    layout, this rank's coordinates and the process group of each axis
    through it."""

    shape: Dict[str, int]
    ranks: np.ndarray  # (n_inst, n_rows) global ranks
    device: torch.device
    coords: Dict[str, int]
    groups: Dict[str, dist.ProcessGroup]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.groups[axis]

    def peer(self, axis: str, i: int) -> int:
        """the global rank of member i of this rank's group along `axis`."""
        if axis == "rows":
            return int(self.ranks[self.coords["inst"], i])
        return int(self.ranks[i, self.coords["rows"]])


def make_mesh(n_rows: Optional[int] = None, n_inst: int = 1, device=None) -> Mesh:
    """The (inst, rows) mesh over the initialised world.

    `device=None` is the card (an error without one) and needs an NCCL
    world; "cpu" needs a gloo world.  Each axis's groups are made here with
    `TIMEOUT`, every rank making every group in the same order (not by
    `init_device_mesh`, whose groups take the backend's default timeout of
    10-30 minutes)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world: call init_world (or run_world) first")
    backend = dist.get_backend()
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"a {device.type} mesh needs a {want} world, not {backend}")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_rows is None:
        n_rows = world // n_inst
    if n_rows * n_inst != world:
        raise ValueError(f"a {n_inst} x {n_rows} mesh does not cover {world} ranks")
    ranks = np.arange(world).reshape(n_inst, n_rows)
    groups = {}
    for i in range(n_inst):
        g = dist.new_group(ranks[i].tolist(), timeout=TIMEOUT)
        if rank in ranks[i]:
            groups["rows"] = g
    for j in range(n_rows):
        g = dist.new_group(ranks[:, j].tolist(), timeout=TIMEOUT)
        if rank in ranks[:, j]:
            groups["inst"] = g
    inst, row = divmod(rank, n_rows)
    return Mesh(dict(inst=n_inst, rows=n_rows), ranks, device, dict(inst=inst, rows=row), groups)


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """How an array lies over the mesh: its leading dimension cut into
    equal contiguous blocks along `axis` (member i holds block i), or whole
    on every rank (`axis` None)."""

    mesh: Mesh
    axis: Optional[str]

    def block(self, n: int) -> slice:
        """the leading rows of an n-row array that this rank holds."""
        if self.axis is None:
            return slice(0, n)
        d = self.mesh.size(self.axis)
        if n % d:
            raise ValueError(f"{n} rows do not split into {d} equal blocks")
        i = self.mesh.index(self.axis)
        return slice(i * (n // d), (i + 1) * (n // d))


def row_sharding(mesh: Mesh) -> Layout:
    return Layout(mesh, "rows")


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh, None)


# ---------------------------------------------------------------------------
# collectives along one axis
# ---------------------------------------------------------------------------


def _wire(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(torch.bool) if like.dtype == torch.bool else y


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, shift: int) -> torch.Tensor:
    """Member i sends x to member (i + shift) mod D and returns what member
    (i - shift) mod D sent: one ring of `batch_isend_irecv`."""
    d = mesh.size(axis)
    if shift % d == 0:
        return x.clone()
    i = mesh.index(axis)
    g = mesh.group(axis)
    w = _wire(x)
    out = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, mesh.peer(axis, (i + shift) % d), g),
           dist.P2POp(dist.irecv, out, mesh.peer(axis, (i - shift) % d), g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unwire(out, x)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(D, *x.shape): every member's x, in member order."""
    w = _wire(x)
    if mesh.size(axis) == 1:
        return _unwire(w.unsqueeze(0).clone(), x)
    parts = [torch.empty_like(w) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, w, group=mesh.group(axis))
    return _unwire(torch.stack(parts), x)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x's leading dimension in D equal contiguous chunks, chunk j to member
    j; returns the D chunks received, chunk i from member i, in x's shape."""
    w = _wire(x)
    if mesh.size(axis) == 1:
        return _unwire(w.clone(), x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group(axis))
    return _unwire(out, x)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """member src's x on every member (x gives the shape and dtype)."""
    w = _wire(x).clone()
    if mesh.size(axis) > 1:
        dist.broadcast(w, mesh.peer(axis, src), group=mesh.group(axis))
    return _unwire(w, x)


# ---------------------------------------------------------------------------
# one process a rank
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world, device, init_file, args, threads, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        dev = init_world(rank, world, device, init_file)
        results.put((rank, True, fn(rank, world, dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _build_once(device: torch.device) -> None:
    """Build what the ranks load, here, so that no two ranks race one
    compiler into the same path."""
    from ..runtime import native

    native.get_lib()
    if device.type == "cuda":
        from ..ops import poseidon2_cuda

        poseidon2_cuda.build()


def _collect(procs, results, deadline: float, deadline_s: float) -> dict:
    out = {}
    while len(out) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(len(procs))) - set(out))
            raise RuntimeError(f"ranks {missing} did not finish within {deadline_s:.0f} s")
        try:
            rank, ok, payload = results.get(timeout=min(left, 0.5))
        except queue.Empty:
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if r not in out and p.exitcode not in (None, 0)]
            if failed:
                try:  # its traceback may still be in the pipe
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    raise RuntimeError(f"ranks exited without a result: {failed}") from None
            else:
                continue
        if not ok:
            raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n{payload}")
        out[rank] = payload
    for r, p in enumerate(procs):
        p.join(max(deadline - time.monotonic(), 0.1))
        if p.exitcode != 0:
            raise RuntimeError(f"rank {r} exited with {p.exitcode} after its result")
    return out


def run_world(fn: Callable, world: int, device=None, args: tuple = (),
              deadline_s: float = DEADLINE_S, threads: Optional[int] = None,
              init_dir: Optional[str] = None) -> list:
    """Run `fn(rank, world, rank_device, *args)` in `world` spawned
    processes, one a card (`device=None`: the card, an error without one;
    "cpu": gloo ranks) and return the ranks' results in rank order.

    `fn` must be importable (a module-level function) and its result
    picklable.  The rendezvous file lies in `init_dir` (a temporary
    directory when None).  Raises when a rank fails, when one has not
    finished `deadline_s` seconds after the start, or when there are fewer
    cards than ranks; every rank is stopped before it returns."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} CUDA cards; "
                           f"{torch.cuda.device_count()} found")
    _build_once(device)
    own_dir = init_dir is None
    init_dir = tempfile.mkdtemp(prefix="zk_world_") if own_dir else init_dir
    init_file = os.path.join(init_dir, f"rendezvous_{uuid.uuid4().hex}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, device.type, init_file, args, threads, results))
             for r in range(world)]
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        out = _collect(procs, results, deadline, deadline_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5)
        results.close()
        if own_dir:
            shutil.rmtree(init_dir, ignore_errors=True)
    return [out[r] for r in range(world)]
