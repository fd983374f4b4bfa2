"""The fused segmented-chain Poseidon2 kernel's share of its roofline in
the traced checks: the least time for the chains' permutations and bytes
(benchmark/lib/roofline.py) over the kernel's summed device time."""

from benchmark.lib import roofline
from benchmark.lib.readers import kernel_share_pct


def read(ctx):
    work, units = ctx["work"], ctx.get("traced_units", 0)
    if "chain_rows" not in work or not units or "clock_hz" not in ctx:
        return None
    bound = units * roofline.chain_bound_s(work["chain_rows"], work["all_rows"],
                                           work["chain_segments"], ctx["sm_count"],
                                           ctx["clock_hz"])
    return kernel_share_pct(ctx, "poseidon2_chain_segmented_kernel", bound)
