"""Rows (or VM cycles) whose whole constraint set was evaluated and reduced
to its verdict, over the whole window: all the work over all the time."""


def read(ctx):
    rows = sum(ctx["unit_rows"])
    return rows / ctx["window_s"] if rows else None
