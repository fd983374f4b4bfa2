"""Seconds of the program's witness generation in set-up (the benchmark's
span around the call, ended by a synchronize)."""


def read(ctx):
    return ctx["spans"].get("witness_s")
