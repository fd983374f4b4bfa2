"""Closed-loop grand-product proofs of ram_permutation over a resident witness.

Set-up makes the query tapes from the seed and has the program build its
witness, as the check cell does.  One unit of work is what the program's
`prove_sorter_argument` does, called in its three parts so that the two
halves are timed apart: `prove_permutation_argument`, then
`verify_permutation_argument`, then the check that the proven final products
are the witness's.  A unit's rows count when all three hold.  After the
window the reference works out the witness and its final products from the
tapes, judges every proof's public products, and verifies two of the proofs,
drawn from the seed, with its own verifier.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..lib import traffic as gen
from ..reference import grand_product_stark as stark_ref
from .ram_permutation_check import as_dict, reference_verdicts, witness_diff


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device, spans: dict):
        from zkevm_circuits_tpu_torch.models import ram_permutation as ram
        from zkevm_circuits_tpu_torch.prover import pipeline, stark

        self.ram, self.pipeline = ram, pipeline
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans = spans
        self.rows = config["rows"]
        self.stride = config["chain_stride"]
        self.cfg = ram.RamPermutationConfig(limit=self.rows, chain_stride=self.stride)
        self.log_n = self.rows.bit_length() - 1
        self.params = stark.StarkParams(log_n=self.log_n, log_blowup=config["log_blowup"],
                                        num_queries=config["queries"],
                                        cap_log2=config["cap_log2"])

    def setup(self) -> None:
        self.tapes = gen.ram_tapes(self.rows, self.seed)
        t = time.perf_counter()
        self.witness = self.ram.generate_witness_host_tapes(*self.tapes, self.cfg,
                                                            device=self.device)
        self._sync()
        self.spans["witness_s"] = time.perf_counter() - t
        self.work = dict(unit_rows=self.rows)
        self.unit(0)
        self.spans["prove_ms"], self.spans["verify_ms"] = [], []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _proof(self, params):
        t = time.perf_counter()
        proof, public, _ = self.pipeline.prove_permutation_argument(self.witness, params)
        self._sync()
        t_proved = time.perf_counter()
        ok = self.pipeline.verify_permutation_argument(proof, public, params)
        bound = bool(torch.equal(public, self.witness.lhs[-1]))
        self._sync()
        self.spans.setdefault("prove_ms", []).append(1000 * (t_proved - t))
        self.spans.setdefault("verify_ms", []).append(1000 * (time.perf_counter() - t_proved))
        return bool(ok) and bound, public.cpu(), proof

    def unit(self, i: int):
        ok, public, proof = self._proof(self.params)
        return (self.rows if ok else 0), (ok, public, proof)

    def release(self) -> None:
        """keep the program's witness as data to judge, drop its own state."""
        self.judged = as_dict(self.witness)
        del self.witness

    def control(self) -> list:
        """the control's answers: the program's own prover with half the
        queries the configuration states (its `num_queries` option)."""
        import dataclasses

        half = dataclasses.replace(self.params, num_queries=self.params.num_queries // 2)
        return [self._proof(half) for _ in range(2)]

    def judge(self, answers: list) -> list:
        """[(name, value, limit)]: the numbers compared."""
        w, heap = self.judged, self.cfg.bootloader_heap_page
        diff, final = witness_diff(w, self.tapes, heap)
        honest = len(reference_verdicts(w, [[]], self.stride, heap)[0])
        final = [int(v) for v in final.cpu().numpy().view(np.uint64)]
        publics_wrong = sum(1 for _, public, _ in answers
                            if [int(v) for v in public.numpy().view(np.uint64)] != final)
        rejected = sum(1 for ok, _, _ in answers if not ok)
        sample = gen.rng(self.seed, 4).choice(len(answers), min(2, len(answers)), replace=False)
        c = self.config
        ref_rejects = sum(1 for k in sample if not stark_ref.verify(
            answers[int(k)][2], answers[int(k)][1], self.log_n, c["log_blowup"], c["queries"],
            c["cap_log2"]))
        return [("witness_diff", diff, 0), ("honest_rejects", honest, 0),
                ("publics_wrong", publics_wrong, 0), ("proofs_rejected", rejected, 0),
                ("reference_rejects", ref_rejects, 0)]
