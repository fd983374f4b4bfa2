"""The block's producer -> consumer paths after one EraVM run, as the JAX
package's block runtime wires them (zkevm_circuits_tpu/runtime/block2.py):

- `log_path` (block2.py:214-470): main_vm and its instance compact forms,
  the decommit sorter (type 2), demux (4), the storage, events and L1
  sorters (9, 11, 12) and the linear hasher (13);
- `storage_application` (block2.py:405-431): the storage tree (type 10) on
  storage_validity's survivors, seeded from the run's initial storage;
- `memory_thread` (block2.py:257-381): the decommit sorter, the code
  unpacker (3), the keccak, sha256 and ecrecover precompiles (5, 6, 7),
  each continuing the global memory queue where its predecessor stopped,
  and ram_permutation (8) over the union of the heap-init rows, the VM's
  tape, the unpacker's writes and the precompiles' traffic.

Each returns circuit -> (witness, residuals, compact forms) and the
handoffs between circuits.  With `times` (a dict) every stage's seconds
land there.  Where a path chooses an instance size itself (demux and the
linear hasher one instance of the next power of two, ecrecover one of the
call count, the unpacker, keccak and sha256 split into instances of a
limit), a keyword takes the block driver's size instead
(`runtime/block2.py:execute_block2`).

The union order of the memory thread is decided here, in `_thread_order`:
each circuit's rows reach ram_permutation in its own memory chain's order
(a call's reads, then its writes).  The JAX package appends all of a
circuit's reads, then all its writes (block2.py:316-351); with two calls of
one precompile that is not the order its memory chain absorbed, and its
`memory_thread_closes` is false.  The rows handed on are masked as the JAX
package masks them: the reads by `read_execute`, the writes by the call
count (`2 * calls` for ecrecover).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..base_structures.decommit_query import DecommitQueries
from ..base_structures.log_query import LogQueries
from ..isa import system_params as sp
from ..models import code_unpacker_sha256 as cu
from ..models import demux_log_queue as dm
from ..models import ecrecover as ecr
from ..models import keccak256_round_function as kc
from ..models import linear_hasher as lh
from ..models import log_sorter as ls
from ..models import ram_permutation as ram
from ..models import sha256_round_function as sh
from ..models import sort_decommittment_requests as sd
from ..models import storage_application as sa
from ..models import storage_validity as sv
from ..models import vm
from ..ops import gf, keccak, queues
from ..ops.poseidon2_cuda import KERNEL
from ..ops.queues import QueueState
from ..utils.device import resolve_device


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _ceil_to(n: int, m: int) -> int:
    return max(1, -(-n // m)) * m


def soa_rows(soa, mask) -> list:
    """rows of a query batch where `mask` holds, as dicts of python ints (the
    block runtime's `_soa_rows`)."""
    keep = np.flatnonzero(mask.cpu().numpy())
    cols = {f.name: getattr(soa, f.name).cpu().numpy()[keep] for f in dataclasses.fields(soa)}
    rows = []
    for i in range(len(keep)):
        row = {}
        for name, col in cols.items():
            v = col[i]
            row[name] = (sum(int(x) << (32 * k) for k, x in enumerate(v)) if v.ndim
                         else bool(v) if col.dtype == np.bool_ else int(v))
        rows.append(row)
    return rows


def stage(times, name, fn, runs=1):
    """fn(); with `times`, run `runs` times and its seconds (first, then
    steady, each ended by a synchronize) land under `name`; returns the last
    result."""
    if times is None:
        return fn()
    seconds = []
    for _ in range(runs):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    times[name] = seconds
    return out


def _tails_equal(a, b) -> bool:
    return bool(queues.queue_states_equal(a, b))


def _same(a, b) -> bool:
    return bool(torch.equal(a.cpu(), torch.as_tensor(b).cpu()))


def block_rows(v) -> dict:
    """What the block runtime hands each circuit from one EraVM run
    (block2.py:257-470): the decommit requests (the boot push, then the
    tape) sorted by (hash, timestamp), the log tape, the storage logs sorted
    by (address, key, cycle index) with those indices, and the event and
    L1-message logs sorted by (timestamp, rollback)."""
    dec = [dict(r) for r in v.initial_dec_rows] + [dict(r) for r in v.decommit_tape]
    logs = [dict(q) for q in v.log_tape]
    storages = [r for r in logs if r["aux_byte"] == sp.STORAGE_AUX_BYTE]
    order = sorted(range(len(storages)),
                   key=lambda i: (storages[i]["address"], storages[i]["key"], i))
    rows = dict(dec=dec, dec_sorted=sorted(dec, key=lambda r: (r["code_hash"], r["timestamp"])),
                logs=logs, storage=storages, storage_sorted=[storages[i] for i in order],
                storage_ts=order)
    for name, aux in (("events", sp.EVENT_AUX_BYTE), ("l1_messages", sp.L1_MESSAGE_AUX_BYTE)):
        rows[name] = [r for r in logs if r["aux_byte"] == aux]
        rows[name + "_sorted"] = sorted(rows[name], key=lambda r: (r["timestamp"], bool(r["rollback"])))
    return rows


def _circuits(out, times):
    """a function that runs one circuit's witness, evaluation and compact
    form as stages and files them under its name in `out`."""
    def circuit(name, gen, evaluate, compact):
        wit = stage(times, f"{name} witness", gen)
        res = stage(times, f"{name} eval", lambda: evaluate(wit))
        out[name] = (wit, res, stage(times, f"{name} compact", lambda: compact(wit)))
        return wit
    return circuit


def _decommit_sorter(circuit, rows, sorter_limit, device):
    ccfg = sd.DecommitSorterConfig(limit=sorter_limit)
    return circuit("sort_decommittments",
                   lambda: sd.generate_witness(DecommitQueries.from_lists(rows["dec"], device),
                                               DecommitQueries.from_lists(rows["dec_sorted"], device),
                                               ccfg),
                   lambda x: sd.eval_constraints(x, ccfg),
                   lambda x: sd.instance_compact_forms(x, ccfg))


def log_path(v, w, limits, device, times=None, *, demux_limit=None, hasher_limit=None,
             skip_empty=False):
    """The block's log and decommit queues after one VM run: `v` the EraVM
    after `run()`, `w` its witness dict, `limits` the instance limits (vm,
    sorter), `device` where the circuits run.  `demux_limit` / `hasher_limit`
    (None: one instance of the next power of two of the rows) pad demux and
    the linear hasher to a multiple of it, one instance; with `skip_empty`
    the storage, events and L1 sorters run only on a nonempty stream and the
    hasher only after the L1 sorter, as the JAX block runtime does.  Returns
    (results: circuit -> (witness, residuals, compact forms), handoffs, the
    L1 digest (None without a hasher), the host keccak of the survivors,
    counts)."""
    vm_limit, sorter_limit = limits
    out, handoffs = {}, {}
    cycles = len(w["ts"]) - 1
    dw = vm.prepare_device_witness(w, device=device)
    res = stage(times, "main_vm eval", lambda: vm.eval_constraints(dw, cycles))
    forms, proto = stage(times, "main_vm compact",
                         lambda: vm.vm_instance_compact_forms(dw, vm_limit))
    out["main_vm"] = (dw, dict(res, **{"protocol_" + k: x for k, x in proto.items()}), forms)
    zeros4 = gf.zeros((4,), dw["ts"].device)
    circuit = _circuits(out, times)

    rows = block_rows(v)
    cw = _decommit_sorter(circuit, rows, sorter_limit, device)
    handoffs["vm_to_decommit_sorter"] = bool(
        (cw.chain_unsorted[cw.n] == dw["dec_q_state"][-1]).all()) and cw.n == int(w["dec_q_len"][-1])

    # type 4: demux of the whole log tape, one instance
    dcfg = dm.DemuxConfig(limit=demux_limit or next_pow2(len(rows["logs"])))
    dmw = circuit("demux_log_queue",
                  lambda: dm.generate_witness(LogQueries.from_lists(rows["logs"], device), dcfg),
                  lambda x: dm.eval_constraints(x, dcfg), lambda x: dm.instance_compact_form(x, dcfg))
    handoffs["vm_to_demux"] = _tails_equal(
        QueueState(zeros4, dmw.input_chain[dmw.n], dmw.n),
        QueueState(zeros4, dw["log_fwd_tail"][-1], dw["log_fwd_len"][-1]))
    out_states = dm.output_queue_states(dmw)

    # type 9, then types 11 / 12
    vcfg = sv.StorageValidityConfig(limit=sorter_limit)
    if rows["storage"] or not skip_empty:
        svw = circuit("storage_validity",
                      lambda: sv.generate_witness(
                          LogQueries.from_lists(rows["storage"], device),
                          LogQueries.from_lists(rows["storage_sorted"], device),
                          rows["storage_ts"], vcfg),
                      lambda x: sv.eval_constraints(x, vcfg),
                      lambda x: sv.instance_compact_forms(x, vcfg))
        handoffs["demux_to_storage_sorter"] = _tails_equal(
            QueueState(zeros4, svw.chain_unsorted[svw.execute.shape[0]], svw.n),
            out_states["rollup_storage"])
    scfg = ls.LogSorterConfig(limit=sorter_limit)
    for ctype, qname in ((11, "events"), (12, "l1_messages")):
        if skip_empty and not rows[qname]:
            continue
        sw = circuit(f"log_sorter_{ctype}",
                     lambda: ls.generate_witness(LogQueries.from_lists(rows[qname], device),
                                                 LogQueries.from_lists(rows[qname + "_sorted"], device),
                                                 scfg),
                     lambda x: ls.eval_constraints(x, scfg),
                     lambda x: ls.instance_compact_forms(x, scfg))
        handoffs[f"demux_to_sorter_{ctype}"] = _tails_equal(
            QueueState(zeros4, sw.chain_unsorted[sw.execute.shape[0]], sw.n), out_states[qname])

    # type 13: the L1 sorter's survivors, one instance
    survivors, digest = [], None
    if "log_sorter_12" in out:
        lw = out["log_sorter_12"][0]
        total = lw.execute.shape[0]
        survivors = soa_rows(lw.result_items, lw.result_add)
        hcfg = lh.LinearHasherConfig(limit=hasher_limit or next_pow2(max(1, len(survivors))))
        hw = circuit("linear_hasher",
                     lambda: lh.generate_witness(LogQueries.from_lists(survivors, device), hcfg),
                     lambda x: lh.eval_constraints(x, hcfg),
                     lambda x: lh.instance_compact_form(x, hcfg))
        handoffs["l1_sorter_to_hasher"] = _tails_equal(
            QueueState(zeros4, hw.input_chain[hw.execute.shape[0]], hw.n),
            QueueState(zeros4, lw.result_chain[total + 1], lw.result_count[total]))
        digest = bytes(hw.digest.cpu().tolist())
    expected = keccak.keccak256_ref(b"".join(lh.serialize_l2_l1_ref(r) for r in survivors))
    counts = {name: len(rows[name]) for name in ("logs", "storage", "events", "l1_messages")}
    counts.update(rollbacks=sum(bool(r["rollback"]) for r in rows["logs"]),
                  decommits=len(rows["dec"]), l1_survivors=len(survivors))
    return out, handoffs, digest, expected, counts


def storage_tree(storage: dict):
    """the tree of the run's initial storage snapshot (the rollup shard's
    nonzero cells, enumeration indices from 1 in key order), and the next index."""
    tree, counter = sa.SparseStorageTree(), 1
    for (shard, addr, key), val in sorted(storage.items()):
        if shard != 0 or val == 0:
            continue
        tree.set_leaf(sa.path_bits(sa.derive_key_ref(addr, key)), counter, val)
        counter += 1
    return tree, counter


def _timed_tree(storage, spent):
    """`storage_tree(storage)` whose own work adds its seconds to spent[0]."""
    tree, counter = storage_tree(storage)
    for name in ("set_leaf", "path_at", "nodes_at", "node", "root"):
        method = getattr(tree, name)

        def timed(*args, _method=method):
            t0 = time.perf_counter()
            try:
                return _method(*args)
            finally:
                spent[0] += time.perf_counter() - t0
        setattr(tree, name, timed)
    return tree, counter


def storage_application(svw, storage: dict, device, times=None, max_rows=None):
    """Type 10 on storage_validity's survivors (`svw` its witness): the tree
    seeded from the initial storage snapshot, one instance of `max_rows`
    stage rows (None: the next power of two of the rows).  With `times`,
    "storage_application tree" holds the seconds of the tree's own work in
    each witness run.  Returns (witness, residuals, compact form,
    survivors)."""
    survivors = soa_rows(svw.push_items, svw.push_flags)
    cfg = sa.StorageApplicationConfig(max_rows=max_rows or next_pow2(sum(
        2 if q["rw_flag"] else 1 for q in survivors)))
    tree_s = []

    def gen():
        if times is None:
            tree, counter = storage_tree(storage)
            return sa.generate_witness(survivors, tree, counter, cfg, device=device)
        spent = [0.0]
        tree, counter = _timed_tree(storage, spent)
        wit = sa.generate_witness(survivors, tree, counter, cfg, device=device)
        tree_s.append(spent[0])
        return wit

    wit = stage(times, "storage_application witness", gen)
    if times is not None:
        times["storage_application tree"] = tree_s
    res = stage(times, "storage_application eval", lambda: sa.eval_constraints(wit, cfg))
    form = stage(times, "storage_application compact", lambda: sa.instance_compact_form(wit, cfg))
    return wit, res, form, survivors


def memory_tapes(parts) -> dict:
    """numpy memory tapes {timestamp, memory_page, index, rw_flag, is_ptr,
    value (n, 8)} from parts, each a list of row dicts or a (MemoryQueries,
    row indices) pair, concatenated in order."""
    cols = {k: [] for k in ("timestamp", "memory_page", "index", "rw_flag", "is_ptr", "value")}
    for part in parts:
        if isinstance(part, list):
            if not part:
                continue
            cols["timestamp"].append(np.array([r["timestamp"] for r in part], np.int64))
            cols["memory_page"].append(np.array([r["memory_page"] for r in part], np.int64))
            cols["index"].append(np.array([r["index"] for r in part], np.int64))
            cols["rw_flag"].append(np.array([bool(r["rw_flag"]) for r in part]))
            cols["is_ptr"].append(np.array([bool(r["is_ptr"]) for r in part]))
            cols["value"].append(np.array([[(int(r["value"]) >> (32 * k)) & 0xFFFFFFFF
                                            for k in range(8)] for r in part], np.int64))
        else:
            q, idx = part
            idx = torch.as_tensor(idx, device=q.timestamp.device)
            for k in cols:
                cols[k].append(getattr(q, k)[idx].cpu().numpy())
    return {k: np.concatenate(v) for k, v in cols.items()}


def _thread_order(reads, read_call, n_reads, writes, per_call, n_calls):
    """One precompile's rows for ram_permutation's union, in the order its
    memory chain absorbed them: each call's executed reads (the first
    `n_reads` rows, `read_call` their call), then its `per_call` writes.
    Returns a (MemoryQueries of reads then writes, row indices) part of
    `memory_tapes`."""
    order = []
    rc = read_call[:n_reads].cpu().tolist()
    j, n_r = 0, reads.shape[0]
    for ci in range(n_calls):
        while j < n_reads and rc[j] == ci:
            order.append(j)
            j += 1
        order += [n_r + per_call * ci + k for k in range(per_call)]
    q = type(reads)(*[torch.cat([getattr(reads, f.name), getattr(writes, f.name)])
                      for f in dataclasses.fields(reads)])
    return q, order


def memory_thread(v, w, code_store: dict, limits, device, times=None, *, done=None,
                  capacities=None, ec_calls=0):
    """The memory thread after one EraVM run: main_vm over the run, the
    decommit sorter, the code unpacker on its result queue, the keccak,
    sha256 and ecrecover circuits, and ram_permutation over the union (in
    `_thread_order`).  `code_store` is the program's ({code hash: words};
    the bootloader's own code is taken from it when there, else from the
    run); `limits` (unpacker and sha256 rounds, keccak blocks, decommit
    sorter rows, ram rows) are the instance sizes: each circuit's `max_*` is
    the next multiple of its limit, ecrecover one instance of the call count
    (at least `ec_calls`).  With `capacities` (unpacker rounds, keccak
    blocks, keccak reads, sha256 rounds), the unpacker, keccak or sha256 runs
    as ONE instance of those sizes when the run's need fits them, as the JAX
    block runtime runs it, and is split into instances of `limits` only
    when it does not.  `done`, results of `log_path` on the same run, gives
    main_vm and the decommit sorter without running them again.

    Returns (results: circuit -> (witness, residuals, compact forms),
    handoffs, counts)."""
    round_limit, block_limit, sorter_limit, ram_limit = limits
    out, handoffs = {}, {}
    circuit = _circuits(out, times)
    rows = block_rows(v)
    if done is not None:
        out["main_vm"], out["sort_decommittments"] = done["main_vm"], done["sort_decommittments"]
        cw = out["sort_decommittments"][0]
    else:
        dw = vm.prepare_device_witness(w, device=device)
        out["main_vm"] = (dw, stage(times, "main_vm eval",
                                    lambda: vm.eval_constraints(dw, len(w["ts"]) - 1)), None)
        # type 2: the decommit sorter over the boot push and the VM's requests
        cw = _decommit_sorter(circuit, rows, sorter_limit, device)

    # type 3: the unpacker on the sorter's result queue, from the VM's last memory state
    vm_final = gf.from_u64(np.asarray(w["mem_q_state"][-1], np.uint64))
    uniq = soa_rows(cw.result_items, cw.result_add)
    store = dict(code_store)
    if v.boot_code_hash not in store:
        store[v.boot_code_hash] = v.code_words
    n_rounds = sum(((int(r["code_hash"]) >> 224 & 0xFFFF) + 1) // 2 for r in uniq)
    split = capacities is None or n_rounds > capacities[0]
    ucfg = cu.CodeUnpackerConfig(
        max_rounds=_ceil_to(n_rounds, round_limit) if split else capacities[0])
    uw = circuit("code_unpacker",
                 lambda: cu.generate_witness(uniq, store, ucfg, mem_init_state=vm_final,
                                             device=device),
                 lambda x: cu.eval_constraints(x, ucfg),
                 lambda x: (cu.instance_compact_forms(x, ucfg, round_limit) if split
                            else cu.instance_compact_form(x, ucfg)))
    total = cw.execute.shape[0]
    handoffs["decommit_sorter_to_unpacker"] = (
        _same(uw.request_chain[-1], cw.result_chain[total + 1])
        and uw.num_requests == int(cw.result_count[total]))
    handoffs["vm_to_unpacker"] = _same(uw.mem_chain[0], vm_final)
    parts = [[dict(r) for r in v.initial_mem_rows], v.memory_tape,
             (uw.writes, torch.nonzero(uw.write_execute).flatten())]
    thread = uw.mem_chain[-1]
    counts = dict(decommits=len(rows["dec"]), unique_codes=len(uniq), unpacker_rounds=n_rounds)

    calls, memory = v.precompile_calls, v.precompile_memory

    # type 5, then 6, then 7, each continuing the thread
    kcalls = calls["keccak"]
    if kcalls:
        spans = [kc._call_span(c, memory) for c in kcalls]
        n_blocks = sum(len(p) // kc.RATE + 1 for _, _, p in spans)
        n_reads = sum(len(wds) for _, wds, _ in spans)
        split = capacities is None or n_blocks > capacities[1] or n_reads > capacities[2]
        kcfg = (kc.KeccakRoundFunctionConfig(max_blocks=_ceil_to(n_blocks, block_limit),
                                             max_reads=n_reads) if split else
                kc.KeccakRoundFunctionConfig(max_blocks=capacities[1], max_reads=capacities[2]))
        init = thread
        kw = circuit("keccak256",
                     lambda: kc.generate_witness(kcalls, memory, kcfg, mem_init_state=init,
                                                 device=device),
                     lambda x: kc.eval_constraints(x, kcfg),
                     lambda x: (kc.instance_compact_forms(x, kcfg, block_limit) if split
                                else kc.instance_compact_form(x, kcfg)))
        handoffs["thread_to_keccak256"] = _same(kw.mem_chain[0], thread)
        parts.append(_thread_order(kw.reads, kw.read_call, n_reads, kw.writes, 1, len(kcalls)))
        thread = kw.mem_chain[-1]
        counts.update(keccak_calls=len(kcalls), keccak_blocks=n_blocks)
    scalls = calls["sha256"]
    if scalls:
        rounds = [(int(c["key"]) >> 192) & 0xFFFFFFFF for c in scalls]
        split = capacities is None or sum(rounds) > capacities[3]
        scfg = sh.Sha256RoundFunctionConfig(
            max_rounds=_ceil_to(sum(rounds), round_limit) if split else capacities[3])
        init = thread
        sw = circuit("sha256",
                     lambda: sh.generate_witness(scalls, memory, scfg, mem_init_state=init,
                                                 device=device),
                     lambda x: sh.eval_constraints(x, scfg),
                     lambda x: (sh.instance_compact_forms(x, scfg, round_limit) if split
                                else sh.instance_compact_form(x, scfg)))
        handoffs["thread_to_sha256"] = _same(sw.mem_chain[0], thread)
        read_call = sw.round_call.repeat_interleave(2)
        parts.append(_thread_order(sw.reads, read_call, 2 * sum(rounds), sw.writes, 1,
                                   len(scalls)))
        thread = sw.mem_chain[-1]
        counts.update(sha256_calls=len(scalls), sha256_rounds=sum(rounds))
    ecalls = calls["ecrecover"]
    if ecalls:
        ecfg = ecr.EcrecoverConfig(max_calls=max(ec_calls, len(ecalls)))
        init = thread
        ew = circuit("ecrecover",
                     lambda: ecr.generate_witness(ecalls, memory, ecfg, mem_init_state=init,
                                                  device=device),
                     lambda x: ecr.eval_constraints(x, ecfg),
                     lambda x: ecr.instance_compact_form(x, ecfg))
        handoffs["thread_to_ecrecover"] = _same(ew.mem_chain[0], thread)
        n_ec = len(ecalls)
        read_call = torch.arange(4 * n_ec, device=ew.reads.timestamp.device) // 4
        parts.append(_thread_order(ew.reads, read_call, 4 * n_ec, ew.writes, 2, n_ec))
        thread = ew.mem_chain[-1]
        counts.update(ecrecover_calls=n_ec,
                      ecrecover_failed=n_ec - int(ew.scalars["call_valid"].sum()))

    # type 8: ram_permutation over the union; its unsorted tail closes the thread
    rcfg = ram.RamPermutationConfig(limit=ram_limit)

    def ram_witness():
        unsorted = memory_tapes(parts)
        order = np.lexsort((unsorted["timestamp"], unsorted["index"], unsorted["memory_page"]))
        return ram.generate_witness_host_tapes(
            unsorted, {k: x[order] for k, x in unsorted.items()}, rcfg, device=device)

    rw = circuit("ram_permutation", ram_witness, lambda x: ram.eval_constraints(x, rcfg),
                 lambda x: ram.instance_compact_forms(x, rcfg))
    handoffs["memory_thread_closes"] = _same(rw.chain_unsorted[rw.n], thread)
    counts.update(ram_rows=rw.n)
    return out, handoffs, counts


# ---------------------------------------------------------------------------
# the circuit STARKs' verdicts (runtime/block2.py:236-257, 723-851)
# ---------------------------------------------------------------------------
#
# Each writer proves and verifies the circuit-specific STARKs of one type
# on the data the paths above return, and returns its verdict.  With
# `verdicts` (a dict) it merges the verdict in as the JAX block runtime
# does: AND with an earlier verdict for types 3, 5, 6, 7, 10 and 13;
# types 1, 4 and 255 are assigned (block2.py:700, :823 and :806, ROADMAP
# Queue 3).
# With `log` (a list) every proof appends a record: name, rows, columns,
# prove and verify seconds (each ended by a synchronize), the proof, the
# prover's other outputs (`rest`, its params last) and the params.  The
# provers pick their own params and the verifiers take them, as in the JAX
# package (ROADMAP Queue 3).  A `limit` proves the first
# `limit` calls only (a cut for a script's time; None: every call, as the
# JAX package).


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _proved(log, name, air, device, prove_fn, verify_fn) -> bool:
    """prove_fn() -> (proof, *rest, params); verify_fn(proof, *rest, params).
    With `log` on a card, the record also holds the peak device memory of
    the proof and the Poseidon2 kernels' launches over it."""
    device = resolve_device(device)
    on_card = log is not None and device.type == "cuda"
    if on_card:
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = KERNEL.counts()
    t0 = time.perf_counter()
    proof, *rest = prove_fn()
    _sync(device)
    t1 = time.perf_counter()
    ok = bool(verify_fn(proof, *rest))
    t2 = time.perf_counter()
    if log is not None:
        params = rest[-1]
        rec = dict(name=name, rows=1 << params.log_n, cols=air.total_cols, prove_s=t1 - t0,
                   verify_s=t2 - t1, ok=ok, proof=proof, rest=rest, params=params)
        if on_card:
            after = KERNEL.counts()
            rec.update(peak_bytes=torch.cuda.max_memory_allocated(device),
                       launches={k: after[k] - before[k] for k in after})
        log.append(rec)
    return ok


def _merge(verdicts, t: int, ok: bool, assign: bool = False) -> bool:
    if verdicts is not None:
        verdicts[t] = ok if assign else (ok and verdicts.get(t, True))
        return verdicts[t]
    return ok


def _sha_chain_verdict(witness, round_call, n_calls: int, device, limit, log, name) -> bool:
    """Per-call raw-block sha256 chain proofs from the round columns
    (block_words / the round's call / round_is_last; block2.py:728-747)."""
    from ..prover import sha256_air as sair

    rexec = witness.round_execute.cpu().numpy().astype(bool)
    rcall = round_call.cpu().numpy()
    rlast = witness.round_is_last.cpu().numpy().astype(bool)
    bw = witness.block_words.cpu().numpy().astype(np.uint64)
    s_after = witness.state_after.cpu().numpy().astype(np.uint64)
    ok = True
    for ci in range(n_calls if limit is None else min(limit, n_calls)):
        sel = rexec & (rcall == ci)
        blocks = bw[sel]
        dig = s_after[sel & rlast][-1]

        def prove_fn(blocks=blocks, dig=dig):
            proof, dwords, prm = sair.prove_sha256_blocks(blocks, device=device)
            return proof, blocks, dwords, prm

        def verify_fn(proof, blocks, dwords, prm, dig=dig):
            return (bool((dwords.astype(np.uint64) == dig).all())
                    and sair.verify_sha256_blocks(proof, blocks, dwords, prm))

        ok &= _proved(log, f"{name} call {ci}", sair.sha256_air(), device, prove_fn, verify_fn)
    return ok


def code_unpacker_verdict(uw, device, verdicts=None, limit=None, log=None) -> bool:
    """Type 3: a sha256 chain proof per unpacked code, its digest against
    the code hash the unpacker's rounds end on.  The JAX block runtime reads
    the round's call from `round_call` (block2.py:732), a field the
    unpacker's witness does not have (its name is `round_request`), so it
    cannot reach this proof (ROADMAP Queue 3); the port reads
    `round_request`."""
    ok = _sha_chain_verdict(uw, uw.round_request, uw.num_requests, device, limit, log,
                            "sha256 (3)")
    return _merge(verdicts, 3, ok)


def sha256_verdict(sw, device, verdicts=None, limit=None, log=None) -> bool:
    """Type 6: a sha256 chain proof per precompile call."""
    ok = _sha_chain_verdict(sw, sw.round_call, sw.num_calls, device, limit, log, "sha256 (6)")
    return _merge(verdicts, 6, ok)


def keccak_verdict(kw, calls: list, memory: dict, device, verdicts=None, limit=None,
                   log=None) -> bool:
    """Type 5: a keccak256 proof per precompile call's payload, its digest
    against the circuit's."""
    from ..prover import keccak_air as kair

    digests = kw.digests.cpu().numpy()
    ok = True
    pairs = list(zip(kc.call_payloads(calls, memory), digests))
    for i, (payload, dig) in enumerate(pairs if limit is None else pairs[:limit]):
        want = bytes(int(b) for b in dig)
        ok &= _proved(log, f"keccak (5) call {i}", kair.keccak_air(), device,
                      lambda p=payload: kair.prove_keccak256(p, device=device),
                      lambda proof, digest, prm, p=payload, want=want: (
                          digest == want and kair.verify_keccak256(proof, p, digest, prm)))
    return _merge(verdicts, 5, ok)


def l1_verdict(hw, l1_hash: bytes, device, verdicts=None, log=None) -> bool:
    """Type 13: one keccak256 proof of the linear hasher's byte stream, its
    digest against the L1 hash."""
    from ..prover import keccak_air as kair

    stream = hw.msg_bytes[:hw.n].cpu().numpy().astype(np.uint8).tobytes()
    ok = _proved(log, "keccak (13)", kair.keccak_air(), device,
                 lambda: kair.prove_keccak256(stream, device=device),
                 lambda proof, digest, prm: (digest == l1_hash
                                             and kair.verify_keccak256(proof, stream, digest,
                                                                       prm)))
    return _merge(verdicts, 13, ok)


def blob_verdict(blobs, device, verdicts=None, log=None) -> bool:
    """Type 255, per blob (witness, chunks, versioned hash, elements): the
    three keccak chains (the blob's linear hash, the z-challenge digest, the
    output commitment; ref eip_4844/mod.rs:157-174, 206-242) and the Horner
    evaluation (horner_air; mod.rs:186-204), z / y / fe recomputed from the
    same public plaintext the chains bind."""
    from ..prover import horner_air as hair
    from ..prover import keccak_air as kair

    def raw(t) -> bytes:
        return t.cpu().numpy().astype(np.uint8).tobytes()

    ok = True
    for b, (bw, chunks, vh, E) in enumerate(blobs):
        data = list(chunks) + [b"\x00" * 31] * (E - len(chunks))
        blob_msg = b"".join(data)
        lin, trunc, opening, outh = (raw(bw.linear_hash), raw(bw.truncated), raw(bw.opening_be),
                                     raw(bw.output_hash))
        for j, (msg, want) in enumerate(((blob_msg, lin), (lin + vh, None),
                                         (vh + trunc + opening, outh))):
            def check(proof, digest, prm, msg=msg, want=want):
                # the challenge digest's last 16 bytes are z
                good = digest == want if want is not None else digest[16:] == trunc
                return good and kair.verify_keccak256(proof, msg, digest, prm)

            ok &= _proved(log, f"keccak (255) blob {b} chain {j}", kair.keccak_air(), device,
                          lambda msg=msg: kair.prove_keccak256(msg, device=device), check)
        pub = dict(E=E, chunks=np.array([list(c) for c in data], np.uint64),
                   truncated=np.frombuffer(trunc, np.uint8),
                   opening_be=np.frombuffer(opening, np.uint8))
        ok &= _proved(log, f"horner (255) blob {b}", hair.horner_air(), device,
                      lambda bw=bw, E=E: hair.prove_horner(bw, E, device=device),
                      lambda proof, _pub, prm, pub=pub: hair.verify_horner(proof, pub, prm))
    return _merge(verdicts, 255, ok, assign=True)


def demux_verdict(log_rows: list, device, verdicts=None, log=None) -> bool:
    """Type 4: the routing proof of the executed log tape; the verifier
    recomputes every stream RLC from the plaintext rows."""
    from ..prover import demux_air as dair

    ok = _proved(log, "demux (4)", dair.demux_air(), device,
                 lambda: dair.prove_demux(log_rows, device=device),
                 lambda proof, _pub, prm: dair.verify_demux(proof, log_rows, prm))
    return _merge(verdicts, 4, ok, assign=True)


def storage_paths_verdict(aw, device, verdicts=None, limit=None, log=None) -> bool:
    """Type 10: one blake2s batch proof of every compression the storage
    paths consume (derived keys, leaves, all path levels), the digests
    against the witness's."""
    from ..prover import blake2s_air as bair

    msgs, digs = sa.blake2s_calls(aw)
    if limit is not None:
        msgs, digs = msgs[:limit], digs[:limit]
    ok = _proved(log, "blake2s (10)", bair.blake2s_air(), device,
                 lambda: bair.prove_blake2s_batch(msgs, device=device),
                 lambda proof, proved, prm: (list(proved) == list(digs)
                                             and bair.verify_blake2s_batch(proof, msgs, digs, prm)))
    return _merge(verdicts, 10, ok)


def ecrecover_verdict(ew, device, verdicts=None, log=None) -> bool:
    """Type 7: the ladder proof of every call (u1 G and u2 R)."""
    from ..prover import ecrecover_air as eair

    ok = _proved(log, "ecrecover (7)", eair.ecrecover_air(), device,
                 lambda: eair.prove_ecrecover(ew, device=device),
                 lambda proof, cp, prm: eair.verify_ecrecover(proof, cp, prm))
    return _merge(verdicts, 7, ok)


def vm_verdict(v, w: dict, limit: int, device, verdicts=None, log=None):
    """Type 1: the committed-trace STARK of the VM's core relations
    (`prover/vm_air.py`) over the run `v` with witness `w`, and the check
    that every code read the proof's macc public binds is a row of the VM's
    memory tape (`vm_code_reads_on_tape`, block2.py:236-257).  Returns
    (verdict, vm_code_reads_on_tape); the verdict is the verifier's, and is
    assigned to `verdicts[1]` (block2.py:700)."""
    from ..base_structures.memory_query import encode_memory_queries_np
    from ..prover import vm_air

    ok = _proved(log, "main_vm (1)", vm_air.vm_core_air(), device,
                 lambda: vm_air.prove_vm_core(w, limit, device=device), vm_air.verify_vm_core)
    rows = v.memory_tape
    tape = set()
    if rows:
        t = memory_tapes([rows])
        tape = {r.tobytes() for r in encode_memory_queries_np(
            t["timestamp"], t["memory_page"], t["index"], t["rw_flag"], t["is_ptr"], t["value"])}
    reads = vm_air.code_read_queries(w, limit)  # the plaintext stream the proof binds
    return _merge(verdicts, 1, ok, assign=True), all(r.tobytes() in tape for r in reads)
