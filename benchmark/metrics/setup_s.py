"""Set-up seconds: from the process's start to the window's (imports, the
card's start, builds on a checkout's first run, inputs, the program's
witness, warm-up)."""


def read(ctx):
    return ctx["setup_s"]
