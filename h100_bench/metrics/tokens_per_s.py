"""Tokens generated by the decode steps of the window's ticks, over the
window's seconds."""


def read(rec):
    return rec["decode_tokens"] / rec["window_s"]
