"""Row-sharded ram_permutation check over the mesh's "rows" axis (the JAX
package's `parallel/sharded.py`).

  * trace rows are cut into equal contiguous blocks, member i of the
    "rows" group holding block i;
  * cross-row references (the next sponge state, the previous sorted row)
    are one-row halos passed round a ring (`mesh.ppermute`);
  * the grand products and the nondet counter are a local inclusive scan,
    then an all-gather of the shard totals and an exclusive per-shard
    prefix: the associative-scan decomposition of the running products.

Every member calls `sharded_eval_constraints` with the whole witness on
its device and reads only its own block of it; the residuals come back
gathered, in global row order, on every member.  On the card the chain
transitions go through the Poseidon2 kernels: the thread-per-state kernel
for blocks of 2^14 rows or more, the small-batch kernel below that.

Semantics are the JAX function's, which differ from
`models.ram_permutation.eval_constraints`: the grand products are checked
as prefix products (the expected running product against `lhs` / `rhs`),
not as per-row transitions; the nondet counter's per-row values are
checked; the final checks sit on the last global row; there are nine keys.
"""

from __future__ import annotations

import torch

from ..base_structures.memory_query import MemoryQueries
from ..models import ram_permutation as ram
from ..ops import gf, queues
from ..ops.queues import QueueState
from ..utils import challenges as chal
from . import mesh as meshlib

_AXIS = "rows"


def _exclusive_prefix_product(shard_totals: torch.Tensor, my_idx: int) -> torch.Tensor:
    """the product of the totals of the shards before `my_idx`; totals (S, R)."""
    acc = gf.ones(shard_totals.shape[1:], shard_totals.device)
    for s in range(my_idx):
        acc = gf.mul(acc, shard_totals[s])
    return acc


def _pack_row(q: MemoryQueries) -> torch.Tensor:
    """one sorted row's six fields as a (13,) int64 vector."""
    return torch.cat([torch.stack([q.timestamp, q.memory_page, q.index,
                                   q.rw_flag.to(torch.int64), q.is_ptr.to(torch.int64)]),
                      q.value])


def _unpack_row(v: torch.Tensor) -> MemoryQueries:
    return MemoryQueries(v[0], v[1], v[2], v[3].bool(), v[4].bool(), v[5:])


def sharded_eval_constraints(mesh: meshlib.Mesh, w: ram.RamPermutationWitness,
                             config: ram.RamPermutationConfig) -> dict:
    """Row-sharded ram_permutation check; nine (N,) bool residuals in global
    row order.  Needs a witness with a chain state a row (no
    `chain_stride`): the before-states of this member's rows and the tails."""
    total = int(w.execute.shape[0])
    num_shards = mesh.size(_AXIS)
    sidx = mesh.index(_AXIS)
    if total % num_shards:
        raise ValueError(f"{total} rows do not split over {num_shards} shards")
    if int(w.chain_unsorted.shape[0]) != total + 1:
        raise ValueError("the sharded check needs a chain state a row (no chain_stride)")
    L = total // num_shards
    rows = slice(sidx * L, (sidx + 1) * L)
    dev = w.execute.device
    last = sidx == num_shards - 1

    execute = w.execute[rows]
    sorted_q = w.sorted[rows]
    enc_u, enc_s = w.enc_unsorted[rows], w.enc_sorted[rows]
    st_u, st_s = w.chain_unsorted[rows], w.chain_sorted[rows]
    lhs, rhs, nondet = w.lhs[rows], w.rhs[rows], w.nondet_count[rows]
    tail_u, tail_s = w.chain_unsorted[total], w.chain_sorted[total]

    # the challenges, recomputed on every member from the tails (tiny)
    zeros12 = gf.zeros((12,), dev)
    fs = chal.produce_fs_challenges(QueueState(zeros12, tail_u, w.n),
                                    QueueState(zeros12, tail_s, w.n),
                                    9, ram.NUM_REPETITIONS)

    # ---- sponge chains, the next member's first before-state as the halo ----
    exp_u = queues.transition(st_u, enc_u, execute)
    exp_s = queues.transition(st_s, enc_s, execute)
    nb_first = meshlib.ppermute(torch.cat([st_u[0], st_s[0]]), mesh, _AXIS, -1)
    next_u = torch.cat([st_u[1:], (tail_u if last else nb_first[:12]).unsqueeze(0)])
    next_s = torch.cat([st_s[1:], (tail_s if last else nb_first[12:]).unsqueeze(0)])
    chain_u_ok = gf.equal(exp_u, next_u).all(-1)
    chain_s_ok = gf.equal(exp_s, next_s).all(-1)

    # ---- grand products: local scan times the cross-shard exclusive prefix ----
    ones = gf.ones((ram.NUM_REPETITIONS,), dev)
    factors_u = chal.masked_factors(chal.grand_product_factors(enc_u, fs), execute)
    factors_s = chal.masked_factors(chal.grand_product_factors(enc_s, fs), execute)
    loc_l = chal.product_accumulate(factors_u, ones)
    loc_r = chal.product_accumulate(factors_s, ones)
    totals = meshlib.all_gather(torch.cat([loc_l[-1], loc_r[-1]]), mesh, _AXIS)  # (S, 2R)
    pre = _exclusive_prefix_product(totals, sidx)
    lhs_expected = gf.mul(loc_l, pre[:ram.NUM_REPETITIONS])
    rhs_expected = gf.mul(loc_r, pre[ram.NUM_REPETITIONS:])
    lhs_ok = gf.equal(lhs_expected, lhs).all(-1)
    rhs_ok = gf.equal(rhs_expected, rhs).all(-1)

    # ---- ordering and RW, the previous member's last sorted row as the halo ----
    prev_nb = _unpack_row(meshlib.ppermute(_pack_row(sorted_q[L - 1]), mesh, _AXIS, 1))
    local = torch.arange(L, device=dev)
    prev_local = sorted_q[(local - 1).clamp(min=0)]
    first = local == 0

    def splice(local_col, nb_col):
        mask = first.reshape((-1,) + (1,) * (local_col.dim() - 1))
        return torch.where(mask, nb_col, local_col)

    prev = MemoryQueries(*(splice(getattr(prev_local, f), getattr(prev_nb, f))
                           for f in ("timestamp", "memory_page", "index", "rw_flag",
                                     "is_ptr", "value")))
    not_first_global = (sidx * L + local) > 0
    true = torch.ones((), dtype=torch.bool, device=dev)
    order_ok = torch.where(execute & not_first_global,
                           ram._sorting_key_gt_prev(sorted_q, prev), true)
    same_cell = ((sorted_q.memory_page == prev.memory_page)
                 & (sorted_q.index == prev.index) & not_first_global)
    is_read = ~sorted_q.rw_flag
    value_zero = (sorted_q.value == 0).all(-1) & ~sorted_q.is_ptr
    value_eq_prev = (sorted_q.value == prev.value).all(-1) & (sorted_q.is_ptr == prev.is_ptr)
    uninit_ok = torch.where(execute & is_read & ~same_cell, value_zero, true)
    rw_ok = torch.where(execute & is_read & same_cell, value_eq_prev, true)

    # ---- nondet counter: local cumsum plus the exclusive prefix sum ----
    is_nondet = ram._is_nondet_write(sorted_q, execute, config.bootloader_heap_page)
    loc_cnt = torch.cumsum(is_nondet.to(torch.int64), dim=0)
    totals_cnt = meshlib.all_gather(loc_cnt[-1:], mesh, _AXIS)[:, 0]  # (S,)
    cnt_expected = loc_cnt + totals_cnt[:sidx].sum()
    cnt_ok = cnt_expected == nondet

    # ---- the final checks live on the last shard's last row ----
    final_eq = gf.equal(lhs_expected[L - 1], rhs_expected[L - 1]).all()
    nondet_final = cnt_expected[L - 1] == w.snapshot_length
    final_ok = torch.where(last & (local == L - 1), final_eq & nondet_final, true)

    local_res = {
        "chain_unsorted": chain_u_ok,
        "chain_sorted": chain_s_ok,
        "lhs_transitions": lhs_ok,
        "rhs_transitions": rhs_ok,
        "sort_order": order_ok,
        "uninit_read_zero": uninit_ok,
        "read_consistency": rw_ok,
        "nondet_count": cnt_ok,
        "final_checks": final_ok,
    }
    # every key's block from every member, in one gather
    gathered = meshlib.all_gather(torch.stack(list(local_res.values())), mesh, _AXIS)
    return {k: gathered[:, i].reshape(total) for i, k in enumerate(local_res)}
