"""The whole step's share of the chip's peak: over the window's prefills
and decode steps, the least time the chip could take for each (the larger
of FLOPs over 989 TFLOP/s and bytes over 3.35 TB/s, ``count.py``),
summed, over the window's seconds.  Decode is bound by bytes, so this is
the share of whichever roof binds."""
from h100_bench import count


def read(rec):
    cfg, least = rec["model"], 0.0
    for t in rec["ticks"]:
        for plen in t["prefills"]:
            least += count.least_seconds(*count.prefill(cfg, plen))
        if t["positions"] is not None and len(t["positions"]):
            least += count.least_seconds(*count.decode_step(
                cfg, t["positions"]))
    return 100.0 * least / rec["window_s"]
