"""Mean milliseconds of `verify_permutation_argument` and the check that
the proven final products are the witness's, over the window's proofs (the
benchmark's span, ended by a synchronize)."""


def read(ctx):
    spans = ctx["spans"].get("verify_ms")
    return sum(spans) / len(spans) if spans else None
