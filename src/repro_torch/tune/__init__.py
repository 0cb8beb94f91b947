"""Architecture autotuning (port of ``repro.tune``).

``tune.search(kernel, workload, space, strategy=..., objective=...,
device=...)`` sweeps bank count × bank map × broadcast × offset shift (plus
the multi-port family) over one workload's address traces, priced on the
card unless ``device="cpu"``, and returns ranked ``TuneResult``s.
Workloads are ISA programs (``bench.Workload``), per-architecture trace
lowerings (``bench.TraceWorkload``, e.g. ``bench.serving_workload``'s
paged-KV traffic), or any registry kernel plus its call args.  Strategies:
``"exhaustive"`` / ``"hillclimb"``; objectives: ``"time_us"`` /
``"cycles"`` / ``"area_time"`` (Fig 9; pass ``capacity_kb``) /
``"us_per_token"``.  See search.py.

``tune.online(engine, window=...)`` is the live counterpart: a
rolling-window re-pricer over ``engine.step_trace()`` blocks that re-ranks
the lattice incrementally (``BlockCostCache``: only new blocks reach the
card, or the host with ``device="cpu"``) and recommends hot-swapping the
winning arch when traffic shifts.  See online.py.
"""
from repro_torch.tune.online import OnlineTuner, online
from repro_torch.tune.search import (EXTENDED_SPACE, PAPER_SPACE, ArchSpace,
                                     TuneResult, search)

__all__ = ["ArchSpace", "TuneResult", "search", "PAPER_SPACE",
           "EXTENDED_SPACE", "OnlineTuner", "online"]
