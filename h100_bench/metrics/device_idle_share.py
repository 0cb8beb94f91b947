"""The share of the traced window with no kernel or copy running on the
device (torch.profiler)."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
