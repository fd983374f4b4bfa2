"""Closed-loop constraint checks of main_vm over a resident witness.

Set-up draws the loop's counts from the seed, runs the program's native
EraVM over its cycles, uploads the witness (`prepare_device_witness`) and
makes the tampered instances of the traffic's plan.  One unit of work is
`eval_constraints` over one instance of the cycle, reduced to its verdict
and copied to the host.  After the window the reference simulates the loop
and holds the program's witness columns and its memory-queue sponge to it,
and holds every check's false (group, cycle) pairs to its faults
(`reference.main_vm.verdict_ok`).
"""

from __future__ import annotations

import time

import torch

from ..lib import traffic as gen
from ..lib import verdict
from ..reference import main_vm as ref

KEPT = ("regs", "regs_ptr", "f_of", "f_eq", "f_gt", "ctx_pc", "cs_depth", "ctx_code_page", "ts",
        "prev_code_page", "prev_super_pc", "prev_code_word", "should_read_opcode",
        "code_word_read", "raw_opcode_lo", "raw_opcode_hi", "mem_q_len", "mem_q_state")


def loop_program(isa, outer: int, inner: int) -> list:
    """the benchmark loop of the program's tests under an outer counter (see
    reference/main_vm.py for the listing)."""
    enc = isa.encode_instruction
    flags = (1 << isa.SET_FLAGS_FLAG_IDX) | (1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES)
    return [
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=outer, src1=0, dst0=5),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=inner, src1=0, dst0=1),
        enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=1, dst0=1, flags=flags),
        enc(isa.MUL, src0=1, src1=1, dst0=2, dst1=3),
        enc(isa.BINOP, isa.BINOP_XOR, src0=2, src1=1, dst0=4),
        enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=2, condition=isa.COND_NE),
        enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=5, dst0=5, flags=flags),
        enc(isa.JUMP, src_mode=isa.SRC_IMM, imm0=1, condition=isa.COND_NE),
        enc(isa.RET, isa.RET_OK),
    ]


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans: dict):
        from zkevm_circuits_tpu_torch.isa import opcodes as isa
        from zkevm_circuits_tpu_torch.models import vm

        self.vm, self.isa = vm, isa
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans = spans
        self.cycles = config["cycles"]

    def setup(self) -> None:
        self.outer, self.inner, ret = gen.loop_counts(self.cycles, self.seed,
                                                      self.config["outer"])
        self.words = self.vm.assemble_code_words(loop_program(self.isa, self.outer, self.inner))
        t = time.perf_counter()
        w = self.vm.NativeEraVM(self.words, self.cycles).run()
        dw = self.vm.prepare_device_witness(w, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.spans["witness_s"] = time.perf_counter() - t
        self.plan = gen.tamper_plan(self.traffic, dict(cycles=(2, ret - 1)), self.seed,
                                    ref.loop_pcs(self.outer, self.inner, self.cycles))
        self.instances = []
        for faults in self.plan:
            inst = dict(dw)
            for f in faults:
                inst[f["field"]] = gen.apply_fault(inst[f["field"]], f)
            self.instances.append(inst)
        self.layout = verdict.layout(self.vm.eval_constraints(dw, self.cycles))
        self.work = dict(unit_rows=self.cycles)
        for i in range(len(self.instances)):  # every instance once, as the window runs them
            self.unit(i)

    def unit(self, i: int):
        k = i % len(self.instances)
        res = self.vm.eval_constraints(self.instances[k], self.cycles)
        return self.cycles, (k, verdict.false_positions(res).cpu().numpy())

    def release(self) -> None:
        """drop the program's instances; keep the honest witness's columns
        the reference judges."""
        self.judged = {k: self.instances[0][k] for k in KEPT}
        del self.instances

    def control(self) -> list:
        """the control's answers, one an instance: the reference's answer with
        the upper half of the cycles left unchecked (the pairs each fault must
        fail, below the half)."""
        half = self.cycles // 2
        return [(k, verdict.positions({(g, f["row"] + o) for f in faults for g, o in f["fails"]
                                       if f["row"] + o < half}, self.layout))
                for k, faults in enumerate(self.plan)]

    def judge(self, answers: list) -> list:
        """[(name, value, limit)]: the numbers compared."""
        sim = ref.simulate(self.outer, self.inner, self.cycles, self.config["boot"])
        diff = ref.witness_diff(sim, self.words, self.judged)
        queue = ref.queue_diff(sim, self.words, self.judged)
        wrong = sum(1 for k, pos in answers
                    if not ref.verdict_ok(verdict.named(pos, self.layout), self.plan[k]))
        return [("witness_diff", diff, 0), ("queue_diff", queue, 0), ("verdicts_wrong", wrong, 0)]
