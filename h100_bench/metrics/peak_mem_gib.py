"""``torch.cuda.max_memory_allocated()`` after the window, its counter
reset when set-up began: weights, page pools and the steps' temporaries."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
