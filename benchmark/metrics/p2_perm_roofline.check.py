"""The thread-per-state Poseidon2 kernel's share of its roofline in the
traced checks (the main_vm queue sponges, 2^20 states a launch)."""

from benchmark.lib.readers import permutation_roofline_pct


def read(ctx):
    return permutation_roofline_pct(ctx)
