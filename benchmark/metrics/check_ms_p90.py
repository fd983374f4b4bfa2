"""The 90th percentile of a check's milliseconds over every check of the
window, each from its dispatch to the copy of its verdict to the host, on
the card's clock (CUDA events recorded before the check's first launch and
after the copy): `statistics.quantiles(..., n=10)`, its ninth cut point."""

import statistics


def read(ctx):
    ms = ctx.get("unit_ms")
    return statistics.quantiles(ms, n=10)[8] if ms and len(ms) >= 10 else None
