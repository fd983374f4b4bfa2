"""Counters the benchmark keeps at the program's kernel boundary in a traced
run: how many states the thread-per-state Poseidon2 kernel permuted.

The program counts its launches (`KERNEL.counts()`); the states a launch
carries are its argument's size.  The counter wraps the launch function for
the traced part of the window only and restores it after.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def permutation_states(counts: dict):
    """while active, counts["permutation_states"] grows by the states of each
    launch of the thread-per-state kernel."""
    from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL

    counts.setdefault("permutation_states", 0)
    launch = KERNEL.permute

    def counted(state, route=None):
        before = KERNEL.launches
        out = launch(state, route)
        if KERNEL.launches > before:
            counts["permutation_states"] += state.numel() // state.shape[-1]
        return out

    KERNEL.permute = counted
    try:
        yield counts
    finally:
        del KERNEL.permute  # the instance attribute; the class method again
