"""The K/V the lanes hold, averaged over the window's ticks: the pages
mapped in the scheduler's page table after each tick, a page being
``page_len`` tokens of K and V over every layer (``count.py``).  Beside
``peak_mem_gib``, which reads the pools the program reserves whole."""
from h100_bench import count


def read(rec):
    ticks = rec["ticks"]
    page = rec["page_len"] * count.kv_bytes_per_token(rec["model"])
    return page * sum(t["pages"] for t in ticks) / len(ticks) / 2 ** 30
