"""Distributed STARK commit over the mesh: column-sharded LDE, one
all-to-all, row-sharded Merkle (the JAX package's `parallel/prover.py`).

The commit is the prover's bandwidth-heavy phase: every column is LDE'd
(intt, coset scale, ntt), then every LDE row is leaf-hashed and the rows
Merkle-folded.  On the mesh:

  1. COLUMN sharding for the LDE: member d transforms its m/D whole columns
     (an NTT needs its whole column; sharding the butterflies would put a
     collective in every stage);
  2. ONE all-to-all turns the (N, m/D) row-major block of each member into
     the (N/D, m) rows of each: member d receives the rows [d N/D,
     (d+1) N/D) of every column;
  3. ROW sharding for the leaf hashing and the subtree: member d's leaves
     are contiguous, so its subtree is its own up to level log2(N/D); the
     levels are all-gathered and the top levels finished on every member.

The output is BIT-IDENTICAL to `prover.stark._commit_columns` (the same
leaves, levels and cap), and every member holds the whole tree, which
`stark.prove` reads over the whole domain; a proof made with
`commit_fn=make_sharded_commit(mesh)` is the single-device proof.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..ops import gf, merkle
from ..prover import stark
from . import mesh as meshlib


def _pad_cols(cols: torch.Tensor, D: int):
    """Zero-pad the column axis to a multiple of D (zero columns LDE to
    zeros and are dropped before the leaves are hashed)."""
    m = int(cols.shape[0])
    pad = (-m) % D
    if pad:
        cols = torch.cat([cols, gf.zeros((pad, cols.shape[1]), cols.device)])
    return cols, m


def _fold(cur: torch.Tensor, levels: int) -> list:
    out = []
    for _ in range(levels):
        pairs = cur.reshape(cur.shape[0] // 2, 2, merkle.DIGEST)
        cur = merkle.compress(pairs[:, 0], pairs[:, 1])
        out.append(cur)
    return out


def sharded_commit_columns(cols: torch.Tensor, params, mesh: meshlib.Mesh,
                           axis: str = "rows", times: Optional[dict] = None) -> dict:
    """Drop-in replacement for `stark._commit_columns` over the members of
    `axis`: the tree dict {cap, leaves, levels} on every member.  Each
    member passes the whole (m, n) column group and transforms its block.
    With `times`, each stage is synchronised and its seconds recorded
    (lde, all_to_all, merkle, gather) with the all-to-all's bytes sent."""
    D = mesh.size(axis)
    d = mesh.index(axis)
    cols_p, m_real = _pad_cols(cols, D)
    mp, n = (int(x) for x in cols_p.shape)
    N = n << params.log_blowup
    if N % D:
        raise ValueError(f"an LDE of {N} rows does not split over {D} members")
    sub = N // D
    cap_levels = N.bit_length() - 1 - params.cap_log2
    local_levels = min(sub.bit_length() - 1, cap_levels)
    width = mp // D
    clock = _Clock(times, cols.device)

    # 1. my column block's LDE, row-major: (N, mp/D)
    lde_loc = stark._lde_rows(cols_p[d * width:(d + 1) * width], params)
    clock.stage("lde")
    # 2. all-to-all: row block j to member j; block i back from member i
    recv = meshlib.all_to_all(lde_loc, mesh, axis)
    clock.stage("all_to_all", bytes_sent=lde_loc.numel() * lde_loc.element_size() * (D - 1) // D)
    del lde_loc
    leaves_loc = recv.reshape(D, sub, width).permute(1, 0, 2).reshape(sub, mp)[:, :m_real]
    # 3. leaf hashing of my contiguous rows, then my subtree
    lh = merkle.hash_leaves(leaves_loc.contiguous())
    local = [lh] + _fold(lh, local_levels)
    clock.stage("merkle")
    # the bottom levels gathered; the top levels finished on every member
    levels = [meshlib.all_gather(lv, mesh, axis).reshape(-1, merkle.DIGEST) for lv in local]
    levels += _fold(levels[-1], cap_levels - local_levels)
    leaves = meshlib.all_gather(leaves_loc, mesh, axis).reshape(N, m_real)
    clock.stage("gather")
    return dict(cap=levels[-1], leaves=leaves, levels=levels)


class _Clock:
    """Stage seconds into `times` (nothing when it is None)."""

    def __init__(self, times: Optional[dict], device: torch.device):
        self.times, self.device = times, device
        if times is not None:
            self._sync()
            self.t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stage(self, name: str, bytes_sent: Optional[int] = None):
        if self.times is None:
            return
        self._sync()
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + now - self.t
        if bytes_sent is not None:
            self.times[name + "_bytes"] = self.times.get(name + "_bytes", 0) + bytes_sent
        self.t = now


def make_sharded_commit(mesh: meshlib.Mesh, axis: str = "rows"):
    """A `commit_fn` for `stark.prove(..., commit_fn=...)`."""

    def commit(cols: torch.Tensor, params) -> dict:
        return sharded_commit_columns(cols, params, mesh, axis)

    return commit
