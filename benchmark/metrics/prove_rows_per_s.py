"""Trace rows of the proofs that were proven, verified and bound to the
witness's final products, over the whole window."""


def read(ctx):
    rows = sum(ctx["unit_rows"])
    return rows / ctx["window_s"] if ctx["unit_rows"] else None
