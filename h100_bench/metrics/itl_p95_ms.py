"""The 95th percentile, over every token the window's decode steps
generate, of the gap since the same request's previous token."""
import numpy as np


def read(rec):
    if not rec["itl"]:
        return None
    return float(np.percentile(rec["itl"], 95)) * 1e3
