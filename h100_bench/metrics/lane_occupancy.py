"""Lanes held over lanes times ticks, over the window's ticks, as
``Scheduler.stats()["lane_occupancy"]`` counts the whole day."""


def read(rec):
    ticks = rec["ticks"]
    return 100.0 * sum(t["held"] for t in ticks) / (rec["lanes"] * len(ticks))
