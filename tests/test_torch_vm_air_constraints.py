"""The port's main_vm AIR constraints (prover/vm_air.py) against the JAX
package's: the alpha-composed constraints equal the JAX prover's
`_compose_rows` on random rows, and a flipped register limb (the tamper of
tests/test_vm_air.py) fails the same constraints, on the same number of
rows, in both.  The JAX side is its jaxpr evaluated with numpy
(tests/torch_jaxpr_numpy.py): tracing the AIR takes most of each test.
"""

import numpy as np
import pytest
import torch

import jax

from torch_air_helpers import composition_pair, u64
from torch_jaxpr_numpy import numpy_jit
from torch_vm_programs import VM_AIR_PROGRAMS, run_vm
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.prover import vm_air as jair
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import vm_air
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


@pytest.fixture(scope="module")
def port_side():
    entry = VM_AIR_PROGRAMS["vm_air_base"]
    _, w = run_vm(vm.EraVM, entry)
    phase1, fixed, _ = vm_air.vm_core_trace(w, entry["limit"], "cpu")
    return dict(phase1=phase1, fixed=fixed, w=w, limit=entry["limit"])


def _jax_failures(fixed, phase1, p2, public, ch):
    """The JAX AIR's failing constraints on a trace, in `debug_residuals`'
    form: its constraint lists from their jaxpr, evaluated with numpy."""
    air = jair.vm_core_air()
    full = np.concatenate([fixed, phase1, p2])
    rows, nxt = jgf.from_u64(full.T.copy()), jgf.from_u64(np.roll(full, -1, axis=1).T.copy())

    def every(rows, nxt, ch, pub):
        return (air.row_constraints(rows, ch), air.constraints(rows, nxt, ch),
                air.first_row(rows[0:1], pub, ch), air.last_row(rows[-1:], pub, ch))

    with numpy_jit():
        vals = jax.jit(every)(rows, nxt, jgf.from_u64(np.array(ch, np.uint64)),
                              jgf.from_u64(public))
    bad = {}
    for kind, group in zip(("row", "transition", "first", "last"), vals):
        got = []
        for i, v in enumerate(group):
            v = u64(jgf.canonicalize(v))
            if kind == "transition":
                v = v[..., :-1]
            if int((v != 0).sum()):
                got.append((i, int((v != 0).sum())))
        if got:
            bad[kind] = got
    return bad


def test_flipped_register_limb_fails_as_in_jax(port_side):
    """tests/test_vm_air.py's tamper: a limb of r3 on the row after the ADD
    wrote it.  The port and the JAX AIR fail the same constraints on the
    same number of rows (phase 2 and the publics rebuilt from the bad
    trace)."""
    got = port_side
    _, p1, _, _ = vm_air.layout()
    bad = got["phase1"].clone()
    bad[p1.at("regs", 8 * 2 + 0), 1] ^= 1
    ch = vm_air._DEBUG_CH
    p2 = vm_air._build_phase2(torch.cat([got["fixed"], bad]), ch)
    s_in, s_out = vm_air.boundary_state_vectors(bad)
    rlc = vm_air.stream_rlc(vm_air.code_read_queries(got["w"], got["limit"]), ch[vm_air._MQ])
    pub = vm_air._boundary_publics(s_in, s_out, ch[vm_air._RLC], rlc, "cpu")
    failures = vm_air.residual_counts(torch.cat([got["fixed"], bad, p2]), pub, ch)
    assert failures and "transition" in failures
    want = _jax_failures(gf.to_u64(got["fixed"]), gf.to_u64(bad), gf.to_u64(p2),
                         gf.to_u64(pub), ch)
    assert failures == want


def test_composition_matches_jax():
    """The constraints of the AIR, alpha-composed by the JAX prover's
    `_compose_rows` and by the port's, agree on random rows."""
    want, got = composition_pair(jair.vm_core_air(), vm_air.vm_core_air(), seed=5)
    np.testing.assert_array_equal(got, want)
