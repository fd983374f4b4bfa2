"""Closed-loop constraint checks of ram_permutation over a resident witness.

Set-up makes the two query tapes from the seed, has the program build its
witness (`generate_witness_host_tapes`: the host chains in the native
runtime, the rest on the card), and makes the tampered instances of the
traffic's plan from it.  One unit of work is `eval_constraints` over one
instance of the cycle, reduced to its verdict (the false entries) and copied
to the host.  After the window the reference works out the witness again
from the tapes and the verdict of every instance, and each check's verdict
is compared with its instance's.
"""

from __future__ import annotations

import dataclasses

import torch

from ..lib import traffic as gen
from ..lib import verdict
from ..reference import ram_permutation as ref


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans: dict):
        from zkevm_circuits_tpu_torch.models import ram_permutation as ram

        self.ram = ram
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans = spans
        self.rows = config["rows"]
        self.stride = config["chain_stride"]
        self.cfg = ram.RamPermutationConfig(limit=self.rows, chain_stride=self.stride)

    def setup(self) -> None:
        import time

        self.tapes = gen.ram_tapes(self.rows, self.seed)
        t = time.perf_counter()
        w = self.ram.generate_witness_host_tapes(*self.tapes, self.cfg, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.spans["witness_s"] = time.perf_counter() - t
        ranges = dict(rows=(0, self.rows), boundaries=(1, self.rows // self.stride))
        self.plan = gen.tamper_plan(self.traffic, ranges, self.seed)
        self.instances = [_tampered(w, faults) for faults in self.plan]
        self.witness = w
        self.layout = verdict.layout(self.ram.eval_constraints(w, self.cfg))
        self.work = dict(
            unit_rows=self.rows,
            chain_rows=2 * int(w.execute.sum()),
            chain_segments=2 * (self.rows // self.stride),
            all_rows=2 * self.rows,
        )
        for i in range(len(self.instances)):  # every instance once, as the window runs them
            self.unit(i)

    def unit(self, i: int):
        k = i % len(self.instances)
        res = self.ram.eval_constraints(self.instances[k], self.cfg)
        return self.rows, (k, verdict.false_positions(res).cpu().numpy())

    def release(self) -> None:
        """drop the program's instances; keep its honest witness to judge."""
        self.judged = as_dict(self.witness)
        del self.instances, self.witness

    def control(self) -> list:
        """the control's answers, one an instance: the reference put in the
        program's place, checking only the first half of the rows."""
        w = as_dict(self.witness)
        return [(k, verdict.positions(v, self.layout))
                for k, v in enumerate(reference_verdicts(w, self.plan, self.stride,
                                                         self.cfg.bootloader_heap_page,
                                                         rows=self.rows // 2))]

    def judge(self, answers: list) -> list:
        """[(name, value, limit)]: the numbers compared."""
        w, heap = self.judged, self.cfg.bootloader_heap_page
        diff, _ = witness_diff(w, self.tapes, heap)
        expected = reference_verdicts(w, self.plan, self.stride, heap)
        wrong = sum(1 for k, pos in answers if verdict.named(pos, self.layout) != expected[k])
        return [("witness_diff", diff, 0), ("honest_rejects", len(expected[0]), 0),
                ("verdicts_wrong", wrong, 0)]


def witness_diff(w: dict, tapes, heap: int) -> tuple:
    """(elements of the program's witness that differ from the reference's
    working-out from the tapes, the reference's final products)."""
    derived = ref.derive(*tapes, heap, w["execute"].device)
    ch = ref.challenges(w["chain_unsorted"][-1], w["chain_sorted"][-1], w["n"])
    lhs, rhs = ref.products(derived, ch)
    diff = sum(int((derived[k] != w[k]).sum()) for k in derived if k != "snapshot_length")
    diff += int(derived["snapshot_length"] != w["snapshot_length"])
    diff += int((ch != w["challenges"]).sum() + (lhs != w["lhs"]).sum() + (rhs != w["rhs"]).sum())
    return diff, lhs[-1]


def reference_verdicts(w: dict, plan: list, stride: int, heap: int, rows=None) -> list:
    """the reference's verdict on the witness with each instance's faults
    (the chains of all instances in one batch); `rows` as in `ref.residuals`."""
    insts = []
    for faults in plan:
        inst = dict(w)
        for f in faults:
            inst[f["field"]] = gen.apply_fault(inst[f["field"]], f)
        insts.append(inst)
    landed = ref.chain_landings(
        [(inst[f"chain_{side}"], inst[f"enc_{side}"], inst["execute"])
         for inst in insts for side in ("unsorted", "sorted")],
        stride, rows)
    return [verdict.of(ref.residuals(inst, landed[2 * k], landed[2 * k + 1], heap, rows))
            for k, inst in enumerate(insts)]


def as_dict(w) -> dict:
    out = {k: getattr(w, k) for k in ("enc_unsorted", "enc_sorted", "chain_unsorted",
                                      "chain_sorted", "challenges", "lhs", "rhs",
                                      "nondet_count", "execute", "n", "snapshot_length")}
    for side in ("unsorted", "sorted"):
        q = getattr(w, side)
        out.update({f"{side}.{f.name}": getattr(q, f.name) for f in dataclasses.fields(q)})
    return out


def _tampered(w, faults: list):
    """the program's witness with the faults applied (a copy of each changed
    tensor; the others shared)."""
    for f in faults:
        if "." in f["field"]:
            side, name = f["field"].split(".")
            q = getattr(w, side)
            q = dataclasses.replace(q, **{name: gen.apply_fault(getattr(q, name), f)})
            w = dataclasses.replace(w, **{side: q})
        else:
            w = dataclasses.replace(w, **{f["field"]: gen.apply_fault(getattr(w, f["field"]), f)})
    return w

