"""Process start to the window opening: imports, weights, the engine,
the kernels' first build in a fresh checkout and the day's first ticks."""


def read(rec):
    return rec["setup_s"]
