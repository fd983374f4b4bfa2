"""Device kernels launched a check in the traced window (copies and sets
left out)."""


def read(ctx):
    trace, units = ctx.get("trace"), ctx.get("traced_units", 0)
    if trace is None or not units:
        return None
    kernels = sum(1 for name, _, _ in trace.device if not name.startswith(("Memcpy", "Memset")))
    return kernels / units
