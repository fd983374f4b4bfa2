"""The port's entry point: the counterpart of the JAX package's
`__graft_entry__.entry()`.

    fn, (dw,) = entry()          # on the card
    verdicts = fn(dw)            # (K,) bool, one per residual of main_vm

`fn` evaluates the main_vm constraints (`models/vm/circuit.py`) over a short
real-ISA EraVM trace made by the Python oracle (`models/vm/sim.py`) and
returns whether each residual holds on every row.  The witness lies on the
card unless `device="cpu"` is asked for.
"""

from __future__ import annotations

import torch

from .isa import opcodes as isa
from .models import vm


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
