"""The port keeps its own copies of the host-only modules it needs from the
JAX package (`utils/grain.py`, `isa/system_params.py`, `isa/opcodes.py`) and
of the function that makes the benchmark's tapes.  This file imports both sides and holds each
copy equal to its original by value.
"""

import types

import numpy as np
import pytest

import bench
from zkevm_circuits_tpu.isa import opcodes as jopcodes, system_params as jsp
from zkevm_circuits_tpu.ops import poseidon2 as jposeidon2
from zkevm_circuits_tpu.utils import grain as jgrain

from zkevm_circuits_tpu_torch.isa import opcodes, system_params
from zkevm_circuits_tpu_torch.ops import gf, poseidon2
from zkevm_circuits_tpu_torch.utils import grain
from zkevm_circuits_tpu_torch.utils.tapes import build_tapes_np
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


def _public(mod):
    return {
        k: v for k, v in vars(mod).items()
        if not k.startswith("_") and not isinstance(v, types.ModuleType) and k != "annotations"
    }


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if hasattr(a, "__slots__") and hasattr(b, "__slots__"):  # a decode-table row
        return a.__slots__ == b.__slots__ and all(
            _same(getattr(a, n), getattr(b, n)) for n in a.__slots__)
    return a == b


def test_grain_constants_and_instance_id_equal():
    args = (gf.MODULUS, 12, 8, 22)
    assert grain.poseidon2_goldilocks_constants(*args) == \
        jgrain.poseidon2_goldilocks_constants(*args)
    assert poseidon2.INSTANCE_ID == jposeidon2.INSTANCE_ID == 0x6354F5E6501D2929
    assert sorted(_public(grain)) == sorted(_public(jgrain))


@pytest.mark.parametrize("mine,theirs", [(system_params, jsp), (opcodes, jopcodes)],
                         ids=["system_params", "opcodes"])
def test_isa_copy_equals_original(mine, theirs):
    a, b = _public(mine), _public(theirs)
    assert sorted(a) == sorted(b)
    compared = 0
    for name in a:
        if callable(a[name]) or isinstance(a[name], type):
            assert callable(b[name]), name
            continue
        assert _same(a[name], b[name]), name
        compared += 1
    assert compared > 40


def test_opcode_functions_agree():
    for op, variant in ((opcodes.ADD, None), (opcodes.RET, opcodes.RET_PANIC),
                        (opcodes.UMA, opcodes.UMA_HEAP_WRITE), (opcodes.NOP, None)):
        args = (op,) if variant is None else (op, variant)
        assert opcodes.variant_index(*args) == jopcodes.variant_index(*args)
        assert opcodes.encode_instruction(*args, src0=3, dst0=4, imm0=77) == \
            jopcodes.encode_instruction(*args, src0=3, dst0=4, imm0=77)


def test_tapes_equal_bench():
    mine, theirs = build_tapes_np(256), bench.build_tapes_np(256)
    for got, want in zip(mine, theirs):
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
