"""The share of the traced window of back-to-back checks in which nothing
ran on the card: 1 - (union of the device's intervals) / window."""

from benchmark.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
