"""The port's entry point: the counterpart of the JAX package's
`__graft_entry__.entry()`.

    fn, (dw,) = entry()          # on the card
    verdicts = fn(dw)            # (K,) bool, one per residual of main_vm

`fn` evaluates the main_vm constraints (`models/vm/circuit.py`) over a short
real-ISA EraVM trace made by the Python oracle (`models/vm/sim.py`) and
returns whether each residual holds on every row.  The witness lies on the
card unless `device="cpu"` is asked for.

`dryrun_multichip(n)` is the counterpart of `__graft_entry__.dryrun_multichip`:
the multi-device layer (`parallel/`) at the main path's widths, one rank a
card.  From the command line, `python3 -m zkevm_circuits_tpu_torch.entry
[n_cards]` runs `entry()` on the card, then the dry run on n cards (all of
them by default).
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from .isa import opcodes as isa
from .models import vm
from .utils.device import resolve_device


def _vm_trace(limit: int = 8, device=None):
    """A three-instruction program through the Python EraVM; its witness on
    `device` (None: the card, or an error without one) and the limit."""
    enc = isa.encode_instruction
    prog = [
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=41, src1=0, dst0=1),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=2),
        enc(isa.RET, isa.RET_OK),
    ]
    w = vm.EraVM(vm.assemble_code_words(prog), limit).run()
    return vm.prepare_device_witness(w, device=device), limit


def entry(device=None):
    """(fn, (dw,)): the main_vm constraint evaluation and its example witness."""
    dw, limit = _vm_trace(limit=8, device=device)

    def fn(witness):
        res = vm.eval_constraints(witness, limit)
        return torch.stack([v.all() for v in res.values()])

    return fn, (dw,)


# ---------------------------------------------------------------------------
# the multi-device dry run
# ---------------------------------------------------------------------------


# the dry run's deadline: its ranks are stopped, and it raises, after this
DRYRUN_DEADLINE_S = 900.0
# phase 3c: circuit j's witness is made from seed CIRCUITS_SEED + j, and each
# evaluation, sharded and unsharded, is timed over CIRCUIT_REPS calls
CIRCUITS_SEED = 0x5EED
CIRCUIT_REPS = 2


@dataclasses.dataclass(frozen=True)
class DryrunSizes:
    """The dry run's sizes; the defaults are the main path's full widths."""

    log2_ram_rows: int = 16     # the sharded ram check ...
    log2_ram_limit: int = 13    # ... in 2^3 instances
    log2_vm_auto: int = 14      # main_vm through auto.eval_sharded
    log2_vm_cycles: int = 16    # main_vm in instances over "inst" ...
    log2_vm_limit: int = 12     # ... of 2^12 cycles
    log2_prove_rows: int = 16   # the sharded-commit proof of the grand product
    chain_stride: int = 512
    bench_rounds: int = 16383   # the bench loop's rounds: it returns at cycle 65,534
    # phase 3c: the eight circuits of `parallel/cases.py` at the block cells' rows
    demux_rows: int = 1 << 15
    decommit_rows: int = 1 << 12
    hasher_queries: int = 1 << 12
    blob_elements: int = 4096
    storage_rows: int = 4096
    sha256_rounds: int = 8192
    unpacker_rounds: int = 4096
    ecrecover_calls: int = 32   # 16,384 steps; the memory thread's 206 cut for host time

    def circuit_rows(self) -> dict:
        """{circuit of `parallel/cases.py`: its rows (ecrecover: calls)}"""
        return dict(demux_log_queue=self.demux_rows,
                    sort_decommittment_requests=self.decommit_rows,
                    linear_hasher=self.hasher_queries, eip_4844=self.blob_elements,
                    storage_application=self.storage_rows,
                    sha256_round_function=self.sha256_rounds,
                    code_unpacker_sha256=self.unpacker_rounds, ecrecover=self.ecrecover_calls)


def ram_tapes(n_rows: int, seed: int = 0x5EED):
    """(unsorted, sorted) numpy tapes of the dry run's ram check: distinct
    cells written in a seeded random order."""
    rng = np.random.default_rng(seed)
    pages = np.sort(rng.integers(16, 1 << 20, size=n_rows, dtype=np.uint32))
    index = np.arange(n_rows, dtype=np.uint32) % 512
    ts = np.arange(n_rows, dtype=np.uint32) + 16
    order = np.lexsort((ts, index, pages))
    sorted_t = dict(
        timestamp=ts[order], memory_page=pages[order], index=index[order],
        rw_flag=np.ones(n_rows, bool), is_ptr=np.zeros(n_rows, bool),
        value=rng.integers(0, 1 << 32, size=(n_rows, 8), dtype=np.uint32),
    )
    perm = rng.permutation(n_rows)
    return {k: v[perm] for k, v in sorted_t.items()}, sorted_t


def _loop_program(rounds: int, xor: bool):
    """The benchmark loop: `rounds` rounds of SUB, MUL (and XOR), JUMP."""
    enc = isa.encode_instruction
    body = [enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=rounds, src1=0, dst0=1),
            enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=1,
                flags=(1 << isa.SET_FLAGS_FLAG_IDX)
                | (1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES)),
            enc(isa.MUL, src0=1, src1=1, dst0=2, dst1=3)]
    if xor:
        body.append(enc(isa.BINOP, isa.BINOP_XOR, src0=2, src1=1, dst0=4))
    return body + [enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=1, condition=isa.COND_NE),
                   enc(isa.RET, isa.RET_OK)]


def card_line(device: torch.device) -> str:
    """the card's name and power limit as nvidia-smi gives them ("cpu" on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


class _Phases:
    """Phase lines from rank 0: seconds, world size, kernel launches, card."""

    def __init__(self, rank: int, world: int, device: torch.device):
        from .ops.poseidon2_cuda import KERNEL

        self.kernel, self.rank, self.world, self.device = KERNEL, rank, world, device
        self.card = card_line(device) if rank == 0 else ""
        self.records = {}
        self._start()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        torch.distributed.barrier()

    def _start(self):
        self._sync()
        self.kernel.reset_counts()
        self.t = time.perf_counter()

    def done(self, name: str, msg: str, **numbers):
        self._sync()
        seconds = time.perf_counter() - self.t
        launches = self.kernel.counts()
        self.records[name] = dict(seconds=seconds, launches=launches, **numbers)
        if self.rank == 0:
            print(f"dryrun phase {name} [{seconds:.3f} s, world {self.world}]: {msg}; "
                  f"rank-0 Poseidon2 launches {launches} [{self.card}]", flush=True)
        self._start()


def _timed(fn, device, reps: int = 3):
    """(the result, [seconds of each of `reps` calls]), every rank in step:
    the first call pays the collectives' first use, the others are steady."""
    seconds = []
    for _ in range(reps):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return out, seconds


def _same_residuals(got: dict, want: dict, what: str) -> None:
    """got == want key for key: the same keys in the same order, shapes,
    dtypes and values; raises otherwise."""
    if list(got) != list(want):
        raise RuntimeError(f"{what}: keys {list(got)} != {list(want)}")
    for key, value in want.items():
        other = got[key]
        if other.shape != value.shape or other.dtype != value.dtype or not torch.equal(other,
                                                                                        value):
            raise RuntimeError(f"{what}: residual {key} differs from the unsharded one")


def _circuits_sharded(phases: _Phases, row_mesh, device: torch.device, sizes: DryrunSizes):
    """Phase 3c: each circuit of `parallel/cases.py` through
    `auto.eval_sharded` over every member of "rows", honest (all true) and
    with one value changed at the first row of the second member (caught),
    each held key for key against the unsharded `eval_constraints` on this
    rank."""
    from .parallel import auto, cases

    d = row_mesh.size("rows")
    for j, (name, rows) in enumerate(sizes.circuit_rows().items()):
        t0 = time.perf_counter()
        c = cases.case(name, rows, CIRCUITS_SEED + j, device)
        witness_s = time.perf_counter() - t0
        res, sharded_s = _timed(
            lambda: auto.eval_sharded(c.eval_fn, c.witness, c.config, row_mesh, c.rows), device,
            CIRCUIT_REPS)
        single, single_s = _timed(lambda: c.eval_fn(c.witness, c.config), device, CIRCUIT_REPS)
        _same_residuals(res, single, f"{name} sharded")
        bad = [key for key, v in res.items() if not bool(v.all())]
        if bad:
            raise RuntimeError(f"sharded {name}: {bad} false")
        row = -(-c.rows // max(d, 2))
        tampered = cases.tamper(name, c.witness, row)
        res = auto.eval_sharded(c.eval_fn, tampered, c.config, row_mesh, c.rows)
        _same_residuals(res, c.eval_fn(tampered, c.config), f"{name} tampered")
        caught = [key for key, v in res.items() if not bool(v.all())]
        if not caught:
            raise RuntimeError(f"sharded {name}: a change at row {row} was not caught")
        phases.done(f"3c.{name}", f"{name} through auto.eval_sharded at {c.rows} rows over {d} "
                                  f"members of 'rows', {len(res)} residuals equal to the "
                                  f"unsharded ones, all true; s of {len(sharded_s)} calls sharded "
                                  + ", ".join(f"{x:.3f}" for x in sharded_s)
                                  + ", unsharded " + ", ".join(f"{x:.3f}" for x in single_s)
                                  + f"; witness {witness_s:.2f} s; a change at row {row} fails "
                                  f"{caught}",
                    rows=c.rows, sharded_s=sharded_s, single_s=single_s, witness_s=witness_s)
        del c, res, tampered


def _dryrun_rank(rank: int, world: int, device: torch.device, sizes: DryrunSizes) -> dict:
    """The phases on one rank of the world (see `dryrun_multichip`)."""
    from .models import ram_permutation as ram
    from .parallel import auto, mesh as meshlib
    from .parallel.prover import make_sharded_commit, sharded_commit_columns
    from .parallel.sharded import sharded_eval_constraints
    from .prover import pipeline, stark
    from .utils.convert import proof_to_ints
    from .utils.tapes import build_tapes_np

    n_inst = 2 if world % 2 == 0 and world > 1 else 1
    mesh = meshlib.make_mesh(n_rows=world // n_inst, n_inst=n_inst, device=device)
    row_mesh = meshlib.make_mesh(n_rows=world, n_inst=1, device=device)
    phases = _Phases(rank, world, device)

    # 1. the row-sharded ram check at the main path's width
    n_rows, limit = 1 << sizes.log2_ram_rows, 1 << sizes.log2_ram_limit
    cfg = ram.RamPermutationConfig(limit=limit)
    w = ram.generate_witness_host_tapes(*ram_tapes(n_rows), cfg, device=device)
    checks = {}
    for name, m in (("mesh", mesh), ("rows", row_mesh)):
        res, eval_s = _timed(lambda m=m: sharded_eval_constraints(m, w, cfg), device)
        bad = [k for k, v in res.items() if not bool(v.all())]
        if bad or len(res) != 9:
            raise RuntimeError(f"sharded ram check at {n_rows} rows: {bad} false")
        checks[name] = [x * 1e3 for x in eval_s]
    phases.done("1", f"ram_permutation sharded check at {n_rows} rows (a ring of halos, "
                     f"all-gathered totals), 9 residuals all true; ms of 3 calls over the "
                     f"{mesh.shape['rows']} members of 'rows' of {mesh.shape} "
                     + ", ".join(f"{x:.2f}" for x in checks["mesh"])
                     + f"; over all {world} members "
                     + ", ".join(f"{x:.2f}" for x in checks["rows"]),
                eval_ms=checks, rows=n_rows)

    # 2. the instances' compact forms, each member of "inst" committing its block
    forms = ram.instance_compact_forms(w, cfg)
    k = n_rows // limit
    mine = meshlib.Layout(mesh, "inst").block(k)
    sub = dataclasses.replace(forms, **{f.name: getattr(forms, f.name)[mine]
                                        for f in dataclasses.fields(forms)})
    gathered = meshlib.all_gather(sub.commitment(), mesh, "inst").reshape(k, 4)
    if not torch.equal(gathered, forms.commitment()):
        raise RuntimeError("the instances' commitments gathered over 'inst' differ")
    phases.done("2", f"{k} instance compact forms, {k // n_inst} committed on each of the "
                     f"{n_inst} members of 'inst', gathered equal to all {k} on one rank")
    del w, res, forms

    # 3a. main_vm row-sharded by its shard plan, then a boundary register tamper
    n_vm = 1 << sizes.log2_vm_auto
    dw = vm.prepare_device_witness(
        vm.NativeEraVM(vm.assemble_code_words(_loop_program(0xFFFF, xor=False)), n_vm).run(),
        device=device)
    res = auto.eval_sharded(vm.eval_constraints, dw, n_vm, mesh, n_vm)
    bad = [key for key, v in res.items() if not bool(v.all())]
    if bad:
        raise RuntimeError(f"sharded main_vm eval failed: {bad}")
    shard_rows = n_vm // mesh.size("rows")
    regs = dw["regs"].clone()
    regs[shard_rows, 0, 0] ^= 1
    res = auto.eval_sharded(vm.eval_constraints, dict(dw, regs=regs), n_vm, mesh, n_vm)
    caught = [key for key, v in res.items() if not bool(v.all())]
    if not caught:
        raise RuntimeError("a boundary-row register tamper was not caught under sharding")
    phases.done("3a", f"main_vm through auto.eval_sharded at {n_vm} cycles, all true; a "
                      f"register limb changed at row {shard_rows} fails {caught}")
    del dw, res

    # 3b. main_vm in instances over "inst" (the bench loop)
    n_cyc, vlimit = 1 << sizes.log2_vm_cycles, 1 << sizes.log2_vm_limit
    dw = vm.prepare_device_witness(
        vm.NativeEraVM(vm.assemble_code_words(_loop_program(sizes.bench_rounds, xor=True)),
                       n_cyc).run(), device=device)
    res, inst_s = _timed(lambda: vm.vm_eval_instances_sharded(dw, vlimit, mesh), device, reps=2)
    bad = [key for key, v in res.items() if not bool(v.all())]
    if bad or next(iter(res.values())).shape[0] != n_cyc // vlimit:
        raise RuntimeError(f"instance-sharded main_vm eval: {bad} false")
    phases.done("3b", f"main_vm at {n_cyc} cycles in {n_cyc // vlimit} instances of {vlimit}, "
                      f"{n_cyc // vlimit // n_inst} on each member of 'inst', all true; first "
                      f"{inst_s[0]:.3f} s, steady {inst_s[1]:.3f} s",
                eval_s=inst_s)
    del dw, res

    # 3c. the eight circuits of parallel/cases.py row-sharded by their plans
    _circuits_sharded(phases, row_mesh, device, sizes)

    # 4. the sharded commit and the proof made through it
    n = 1 << sizes.log2_prove_rows
    pcfg = ram.RamPermutationConfig(limit=n, chain_stride=sizes.chain_stride)
    w = ram.generate_witness_host_tapes(*build_tapes_np(n), pcfg, device=device)
    trace, public = pipeline.permutation_trace(w)
    params = stark.StarkParams(log_n=int(trace.shape[1]).bit_length() - 1)
    stages = []

    def commit():
        stages.append({})
        return sharded_commit_columns(trace, params, row_mesh, times=stages[-1])

    tree, sharded_s = _timed(commit, device)
    single, single_s = _timed(lambda: stark._commit_columns(trace, params), device)
    same = (torch.equal(tree["cap"], single["cap"]) and torch.equal(tree["leaves"], single["leaves"])
            and len(tree["levels"]) == len(single["levels"])
            and all(torch.equal(a, b) for a, b in zip(tree["levels"], single["levels"])))
    if not same:
        raise RuntimeError("the sharded commit differs from the single-device commit")
    del tree, single
    a2a_bytes = int(stages[-1].pop("all_to_all_bytes", 0))
    stages_ms = [{k: v * 1e3 for k, v in st.items() if k != "all_to_all_bytes"}
                 for st in stages]
    phases.done("4a", f"sharded commit of {trace.shape[0]} x {n} (LDE {n << params.log_blowup} "
                      f"rows) over {world} members bit-identical to _commit_columns; ms of 3 "
                      f"calls sharded " + ", ".join(f"{x * 1e3:.2f}" for x in sharded_s)
                      + " (the last one's stages "
                      + ", ".join(f"{k} {v:.3f}" for k, v in stages_ms[-1].items())
                      + f"; the all-to-all sends {a2a_bytes} bytes a member), _commit_columns "
                      + ", ".join(f"{x * 1e3:.2f}" for x in single_s),
                sharded_ms=[x * 1e3 for x in sharded_s], single_ms=[x * 1e3 for x in single_s],
                stages_ms=stages_ms, all_to_all_bytes=a2a_bytes)
    air = pipeline.permutation_air()
    proof, prove_s = _timed(
        lambda: stark.prove(trace, air, params, public, commit_fn=make_sharded_commit(row_mesh)),
        device, reps=1)
    if not pipeline.verify_permutation_argument(proof, public, params):
        raise RuntimeError("the sharded-commit proof does not verify")
    ints = proof_to_ints(proof)
    equal = None
    if rank == 0:
        equal = proof_to_ints(stark.prove(trace, air, params, public)) == ints
        if not equal:
            raise RuntimeError("the sharded-commit proof differs from the single-device proof")
    phases.done("4b", f"the grand-product STARK of {n} rows proven through the sharded "
                      f"commit in {prove_s[0]:.3f} s, verified, equal to the single-device "
                      f"proof", prove_s=prove_s[0])
    return dict(records=phases.records, card=phases.card, mesh=dict(mesh.shape),
                proof=ints if rank == 0 else None, proof_equal=equal)


def dryrun_multichip(n_devices: Optional[int] = None, device=None,
                     sizes: DryrunSizes = DryrunSizes(),
                     deadline_s: float = DRYRUN_DEADLINE_S) -> dict:
    """The port's multi-device dry run: one rank a card (`device=None`: the
    cards, an error without one; "cpu": gloo ranks, `n_devices` of them),
    all `torch.cuda.device_count()` cards when `n_devices` is None.

    On an (inst, rows) mesh (2 x n/2 for an even n > 1, else 1 x n):
      1. the row-sharded ram_permutation check at 2^16 rows in 8 instances,
         all true;
      2. the 8 instance compact forms, committed over "inst";
      3. main_vm through `auto.eval_sharded` at 2^14 cycles, a register
         tamper at a shard boundary caught; and through
         `vm_eval_instances_sharded` at 2^16 cycles in 16 instances; then
         (3c) on a 1 x n mesh, the eight circuits of `parallel/cases.py`
         through `auto.eval_sharded` at the block cells' rows (demux 2^15,
         the decommit sorter 2^12, the linear hasher 2^12 queries, one blob
         of 4,096 elements, storage application 4,096 stage rows, sha256
         8,192 rounds, the code unpacker 4,096, ecrecover 32 calls), each
         equal to the unsharded evaluation, all true, and a change at the
         second member's first row caught;
      4. on a 1 x n mesh, the sharded commit of the grand-product trace of
         2^16 rows bit-identical to `_commit_columns`, and the proof made
         through it verified and equal to the single-device proof.
    Each phase prints a line from rank 0.  Returns rank 0's result: each
    phase's record, the card line, the mesh shape, the proof as ints.
    Raises when a rank fails or the world has not ended `deadline_s`
    seconds after its start."""
    from .parallel import mesh as meshlib

    device = resolve_device(device)
    if n_devices is None:
        if device.type != "cuda":
            raise ValueError("name the number of CPU ranks")
        n_devices = torch.cuda.device_count()
    # CPU ranks share the host's cores: one torch thread each
    return meshlib.run_world(_dryrun_rank, n_devices, device, args=(sizes,),
                             deadline_s=deadline_s,
                             threads=1 if device.type == "cpu" else None)[0]


if __name__ == "__main__":
    import sys

    fn, args = entry()
    print("entry() ok:", fn(*args).tolist(), flush=True)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else None)
