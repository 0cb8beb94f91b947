"""Host time inside ``Scheduler.tick`` a window tick (completions,
admissions' page allocation, the ragged step's pages and trace blocks),
from ``WindowScheduler``'s span around it."""


def read(rec):
    ticks = rec["ticks"]
    return sum(t["host"] for t in ticks) / len(ticks) * 1e3
