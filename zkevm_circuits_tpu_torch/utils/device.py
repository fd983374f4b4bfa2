"""The port's one device rule.

Entry points that build tensors from host data (numpy tapes, witness dicts)
take `device=None` and resolve it here: the first CUDA card, or an error when
there is none.  The CPU is used only when the caller names it, as the CPU
parity tests do; functions that take tensors follow their inputs.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """cuda:0; raises when no CUDA card is available (never the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by default; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    if device is None:
        return default_device()
    return torch.device(device)
