"""The plain references against the port at small sizes on the CPU, the
control, and runs with the timed path broken underneath.

The port's own plain versions are used here only as a second witness for the
references; the references import nothing of the port."""

import dataclasses
import random
import time

import pytest
import torch

from benchmark import run
from benchmark.lib import spec
from benchmark.reference import goldilocks as gl
from benchmark.reference import poseidon2 as p2
from benchmark.tests import small

CELLS = [w["name"] for w in small.bench()["workloads"]]


def _runner(cell, seed=11):
    bench = small.bench()
    cfg = small.config(bench, cell)
    traffic = spec.traffic(spec.cell(bench, cell)["traffic"])
    d = spec.runner(cfg["circuit"], traffic["entry"])(cfg, traffic, seed, torch.device("cpu"), {})
    d.setup()
    return d


def test_reference_permutation_is_the_ports():
    from zkevm_circuits_tpu_torch.ops import poseidon2

    rnd = random.Random(5)
    states = [[rnd.randrange(gl.P) for _ in range(12)] for _ in range(32)]
    states += [[0] * 12, [gl.P - 1] * 12]
    x = gl.tensor(states)
    assert torch.equal(p2.permute(x), poseidon2.permutation_plain(x))


def test_field_ops_against_python_ints():
    rnd = random.Random(6)
    a = [rnd.randrange(gl.P) for _ in range(500)] + [gl.P - 1, 0, gl.P - 1]
    b = [rnd.randrange(gl.P) for _ in range(500)] + [gl.P - 1, gl.P - 1, 0]
    ta, tb = gl.tensor(a), gl.tensor(b)
    assert gl.to_ints(gl.mul(ta, tb)) == [x * y % gl.P for x, y in zip(a, b)]
    assert gl.to_ints(gl.add(ta, tb)) == [(x + y) % gl.P for x, y in zip(a, b)]
    run_prod = gl.to_ints(gl.prefix_product(ta[:20]))
    acc = 1
    for x, got in zip(a[:20], run_prod):
        acc = acc * x % gl.P
        assert got == acc


@pytest.mark.parametrize("cell", CELLS)
def test_every_instance_is_judged_right(cell):
    """the port's verdict on every instance (honest and tampered) is the
    reference's, and its witness is the one the reference works out."""
    d = _runner(cell)
    answers = [d.unit(i)[1] for i in range(2 * len(getattr(d, "plan", [[]])))]
    d.release()
    compared = d.judge(answers)
    assert [v for _, v, _ in compared] == [0] * len(compared), compared


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """the control in the program's place: one guarantee broken."""
    d = _runner(cell, seed=12)
    answers = d.control()
    d.release()
    compared = d.judge(answers)
    assert any(v > lim for _, v, lim in compared), compared


def test_every_group_the_loop_reaches_is_held_by_cycle():
    """main_vm: a check that leaves any one group that a fault kind must
    fail always true is judged wrong, and so is a memory-queue sponge that
    the reference's Poseidon2 does not give."""
    from benchmark.lib import verdict

    d = _runner("vm.check-2p20")
    groups = sorted({g for kind in d.traffic["tampers"] for g, _ in kind["fails"]})
    assert len(groups) == 39
    res = [d.vm.eval_constraints(inst, d.cycles) for inst in d.instances]
    d.release()
    for g in groups:
        answers = [(k, verdict.false_positions(dict(r, **{g: torch.ones_like(r[g])})).numpy())
                   for k, r in enumerate(res)]
        assert dict((n, v) for n, v, _ in d.judge(answers))["verdicts_wrong"] > 0, g
    answers = [(k, verdict.false_positions(r).numpy()) for k, r in enumerate(res)]
    assert [v for _, v, _ in d.judge(answers)] == [0, 0, 0]
    state = d.judged["mem_q_state"].clone()
    state[-1, 0] += 1  # a state after the return, where the queue keeps its state
    d.judged["mem_q_state"] = state
    assert dict((n, v) for n, v, _ in d.judge(answers))["queue_diff"] == 1


def _half_rows(res):
    out = {}
    for k, v in res.items():
        if v.dim() == 1:
            v = v.clone()
            v[v.shape[0] // 2:] = True
        out[k] = v
    return out


def _altered(res):
    k = sorted(res)[0]
    v = res[k].clone()
    v.reshape(-1)[0] = ~v.reshape(-1)[0]
    return dict(res, **{k: v})


def _entry(cell):
    return spec.traffic(spec.cell(small.bench(), cell)["traffic"])["entry"]


def _break(cell, fault, monkeypatch):
    """break the cell's timed path underneath: a permutation that returns its
    state unchanged, half of the rows left out, an answer altered where it is
    made."""
    from zkevm_circuits_tpu_torch.models import ram_permutation, vm
    from zkevm_circuits_tpu_torch.ops import poseidon2
    from zkevm_circuits_tpu_torch.prover import pipeline

    if fault == "state_unchanged":
        monkeypatch.setattr(poseidon2, "permutation", lambda state: state)
    elif _entry(cell) == "check":
        module = {"ram_permutation": ram_permutation, "main_vm": vm}[
            small.config(small.bench(), cell)["circuit"]]
        inner = module.eval_constraints
        change = _half_rows if fault == "half_of_the_rows" else _altered
        monkeypatch.setattr(module, "eval_constraints", lambda *a, **k: change(inner(*a, **k)))
    elif fault == "half_of_the_rows":
        inner = pipeline.permutation_trace

        def half_trace(w):
            rows = torch.arange(w.execute.shape[0], device=w.execute.device)
            return inner(dataclasses.replace(w, execute=w.execute & (rows < rows.shape[0] // 2)))

        monkeypatch.setattr(pipeline, "permutation_trace", half_trace)
    else:
        inner = pipeline.prove_permutation_argument

        def altered(*a, **k):
            proof, public, params = inner(*a, **k)
            public = public.clone()
            public[0] ^= 1
            return proof, public, params

        monkeypatch.setattr(pipeline, "prove_permutation_argument", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_of_the_rows", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    _break(cell, fault, monkeypatch)
    bench = small.bench()
    if _entry(cell) == "prove" and fault == "half_of_the_rows":
        # half of the rows leave the products unequal: the prover refuses,
        # and a run that raises prints no result
        with pytest.raises(ValueError, match="not low degree"):
            run.run_cell(bench, cell, 13, small.SECONDS["prove"], False, torch.device("cpu"),
                         time.perf_counter(), config=small.config(bench, cell))
        return
    result = run.run_cell(bench, cell, 13, small.SECONDS[_entry(cell)], False,
                          torch.device("cpu"), time.perf_counter(),
                          config=small.config(bench, cell))
    assert result["attempted"] >= 2
    assert result["correct"] is False, result["compared"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cells_small_on_the_card(cell, card):
    """a whole run of each cell at a small size on the card, traced."""
    bench = small.bench()
    result = run.run_cell(bench, cell, 14, small.SECONDS[_entry(cell)], True, card,
                          time.perf_counter(),
                          config=small.config(bench, cell))
    assert result["correct"], result["compared"]
    assert result["device"]["busy_s"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
