"""The median wall time of the window's ticks that admitted at least one
request (each admission a prefill and its page rows' scatter)."""
import numpy as np


def read(rec):
    walls = [t["wall"] for t in rec["ticks"] if t["prefills"]]
    return float(np.median(walls)) * 1e3 if walls else None
