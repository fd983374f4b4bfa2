"""Arithmetic the metric readers share."""

from __future__ import annotations


def idle_pct(ctx: dict):
    """the share of the traced window in which nothing ran on the card."""
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def permutation_roofline_pct(ctx: dict):
    """the thread-per-state kernel's share of its roofline: the least time
    for the states it permuted (counted at its launch) over its summed device
    time."""
    from benchmark.lib import roofline

    states = ctx.get("permutation_states", 0)
    if not states or "clock_hz" not in ctx:
        return None
    bound = roofline.permutation_bound_s(states, ctx["sm_count"], ctx["clock_hz"])
    return kernel_share_pct(ctx, "poseidon2_permute_kernel", bound)


def kernel_share_pct(ctx: dict, kernel: str, bound_s: float):
    """the bound's share of the summed device time of `kernel`."""
    trace = ctx.get("trace")
    if trace is None or not bound_s:
        return None
    spent = trace.kernel_s(kernel)
    return 100.0 * bound_s / spent if spent > 0 else None
