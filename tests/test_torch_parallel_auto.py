"""Row-sharded evaluation by shard plan (`parallel/auto.py`) and the
instance-sharded main_vm evaluation (`models/vm/compact.py:
vm_eval_instances_sharded`) in gloo worlds of 2 and 4 ranks.

On the five circuits of tests/test_auto_sharding.py (log_sorter,
ram_permutation, storage_validity, keccak256_round_function, main_vm, with
that file's inputs) every rank's `auto.eval_sharded` equals the port's
unsharded `eval_constraints` key for key, honest and with one value changed
at the first row of the second member; each rank's evaluation received its
block plus the plan's halo and nothing more.  The instance-sharded main_vm
residuals equal the port's evaluation of each instance's window, and every
instance of the honest run holds, as in the JAX test.  The port's unsharded
evaluations are held to the JAX package's in tests/test_torch_log_sorters.py,
test_torch_ram_eval.py, test_torch_storage_validity.py,
test_torch_keccak_round.py and test_torch_vm_circuit.py; the JAX package's
own `auto.eval_sharded` and `vm_eval_instances_sharded` take minutes of
XLA:CPU compiles and are compared in tests/test_torch_parallel_slow.py.
Each world is started once for the file and joined within
the time limit of the test that waits on it (tests/torch_test_policy.py).
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.parallel import auto
from zkevm_circuits_tpu_torch.utils.convert import residuals_to_numpy
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    worlds = ranks.start_worlds(ranks.auto_rank, (), tmp_path_factory.mktemp("worlds"))
    return {d: f.result() for d, f in worlds.items()}


def _equal(got: dict, want: dict):
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("name", ranks.AUTO_CIRCUITS)
@pytest.mark.parametrize("world", ranks.WORLDS)
def test_eval_sharded_equals_unsharded(ranks_out, world, name):
    eval_fn, w, cfg, rows = ranks.auto_case(name)
    honest = residuals_to_numpy(eval_fn(w, cfg))
    tampered = residuals_to_numpy(eval_fn(ranks.tamper_auto(name, w, rows // world), cfg))
    assert all(v.all() for v in honest.values())
    assert not all(v.all() for v in tampered.values())
    assert len(ranks_out[world]) == world
    for out in ranks_out[world]:
        _equal(out[name]["honest"], honest)
        _equal(out[name]["tampered"], tampered)


@pytest.mark.parametrize("name", ranks.AUTO_CIRCUITS)
@pytest.mark.parametrize("world", ranks.WORLDS)
def test_each_rank_received_its_block_and_the_halo(ranks_out, world, name):
    eval_fn, w, cfg, rows = ranks.auto_case(name)
    plan = auto.plan_of(eval_fn)
    extra = auto._row_fields(w, plan, rows)
    block = rows // world
    full = {k: int(v.shape[0]) for k, v in auto._fields_dict(w).items()
            if isinstance(v, torch.Tensor) and v.dim()}
    for r, out in enumerate(ranks_out[world]):
        before = plan.halo[0] if r > 0 else 0
        after = plan.halo[1] if r < world - 1 else 0
        want = {k: before + block + after + extra[k] if k in extra else n
                for k, n in full.items()}
        assert out[name]["window"] == want
    assert extra, "no field is on the row axis"


def test_a_circuit_without_a_plan_is_not_sharded():
    with pytest.raises(NotImplementedError, match="no shard plan"):
        auto.plan_of(vm.boot_and_exit_residuals)


@pytest.mark.parametrize("world", ranks.WORLDS)
def test_vm_instances_equal_the_windows_evaluations(ranks_out, world):
    dw = ranks.vm_witness("xor", ranks.VM_INSTANCE_CYCLES)
    mono = residuals_to_numpy(vm.eval_constraints(dw, ranks.VM_INSTANCE_CYCLES))
    assert all(v.all() for v in mono.values())
    for n_inst in sorted({2, world}):
        limit = ranks.VM_INSTANCE_CYCLES // n_inst
        windows, axes, n = vm.vm_instance_windows(dw, limit)
        each = [residuals_to_numpy(vm.eval_constraints(
            {k: v[i] if axes[k] == 0 else v for k, v in windows.items()}, limit))
            for i in range(n)]
        for out in ranks_out[world]:
            got = out["instances"][n_inst]
            assert list(got) == list(mono)
            for key in got:
                assert got[key].shape[0] == n_inst, key
                assert np.array_equal(got[key], np.stack([e[key] for e in each])), key
                # a window's rows are the run's rows of that instance
                assert np.array_equal(got[key].reshape(-1), mono[key]), key
