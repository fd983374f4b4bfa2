"""VmLocalState and the register file, structure of arrays (the JAX
package's `base_structures/vm_state.py`, on torch tensors).

Reference: `src/base_structures/vm_state/mod.rs`: REGISTERS_COUNT = 15
(:30), `VmLocalState` (:92-109); `VMRegister` = {is_ptr, value: u256}
(`register/mod.rs:21-24`); `ArithmeticFlagsPort` = {overflow_or_less_than,
equal, greater_than}.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

REGISTERS_COUNT = 15
FULL_SPONGE_QUEUE_STATE_WIDTH = 12
QUEUE_STATE_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class VmStateColumns:
    """Per-cycle VM state columns (leading axis = cycle rows + 1)."""

    registers: torch.Tensor  # (..., 15, 8) u32 values in int64
    register_is_ptr: torch.Tensor  # (..., 15) bool
    flag_of_lt: torch.Tensor  # (...,) bool  (overflow_or_less_than)
    flag_eq: torch.Tensor  # (...,) bool
    flag_gt: torch.Tensor  # (...,) bool
    pc: torch.Tensor  # (...,) u32
    ergs_remaining: torch.Tensor  # (...,) u32
    timestamp: torch.Tensor  # (...,) u32
    halted: torch.Tensor  # (...,) bool (execution finished / pending exception)

    @staticmethod
    def initial(registers=None, ergs=10**6) -> dict:
        """The state before the first cycle, as host values."""
        regs = np.zeros((REGISTERS_COUNT, 8), np.uint32)
        for idx, val in (registers or {}).items():
            for k in range(8):
                regs[idx, k] = (int(val) >> (32 * k)) & 0xFFFFFFFF
        return dict(registers=regs, register_is_ptr=np.zeros(REGISTERS_COUNT, bool),
                    flag_of_lt=False, flag_eq=False, flag_gt=False, pc=0,
                    ergs_remaining=ergs, timestamp=8, halted=False)
