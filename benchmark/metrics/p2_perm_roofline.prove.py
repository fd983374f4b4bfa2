"""The thread-per-state Poseidon2 kernel's share of its roofline in the
traced proofs (the Merkle leaves and the wide tree levels)."""

from benchmark.lib.readers import permutation_roofline_pct


def read(ctx):
    return permutation_roofline_pct(ctx)
