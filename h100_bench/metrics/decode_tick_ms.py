"""The median wall time of the window's ticks with a decode step and no
admission: one lane-ragged step of the whole engine."""
import numpy as np


def read(rec):
    walls = [t["wall"] for t in rec["ticks"]
             if t["positions"] is not None and not t["prefills"]]
    return float(np.median(walls)) * 1e3 if walls else None
