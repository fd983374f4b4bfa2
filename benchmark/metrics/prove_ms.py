"""Mean milliseconds of `prove_permutation_argument` over the window's
proofs (the benchmark's span around the call, ended by a synchronize)."""


def read(ctx):
    spans = ctx["spans"].get("prove_ms")
    return sum(spans) / len(spans) if spans else None
