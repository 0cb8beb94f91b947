"""Online architecture re-pricing over live serving traffic (port of
``repro.tune.online``).

``tune.search`` answers "which memory wins on this workload?" offline, from
a complete trace.  Serving traffic shifts while the system runs — prompt
mixes change, batch shapes drift, banks degrade — so the online question is
"which memory is winning on the traffic of the LAST W steps, right now,
cheap enough to ask every step?".

``OnlineTuner`` keeps a rolling window of observed step traces (live
``engine.step_trace()`` blocks, scheduler tick traces, or any
``AddressTrace``) and re-prices the whole window against an architecture
list after each observation — through ``cost_many`` with a
``BlockCostCache``, so consecutive windows, which share all but the newest
and oldest blocks, only pay device dispatch for the NEW blocks.  The
device is the card unless the caller passes ``device="cpu"``; the
recommendation is the same on either.  A window re-price is bit-equal to
rebuilding from scratch (the cache replays the exact device partials;
``reprice(full_rebuild=True)`` exists to pin that in tests), so the
tuner's ranking is exactly ``tune.search``'s on the window trace — just
incremental.

The tuner tracks the serving engine's current architecture and recommends a
hot swap when another arch has won ``patience`` consecutive re-prices by at
least ``margin`` (hysteresis — one noisy step shouldn't flap the
recommendation).  Runtime-reconfigurable soft GPGPUs make the swap itself
actionable (arXiv:2401.04261); this module only recommends, the serving
layer decides.

    tuner = tune.online(engine, window=32)
    for step in serve_loop():
        rec = tuner.step()          # observe newest step_trace + re-price
        if rec["swap"]:
            hot_swap(rec["winner"])
"""
from __future__ import annotations

from collections import deque

from repro_torch.core.cost_engine import BlockCostCache, cost_many
from repro_torch.core.trace import TraceStream, as_trace

__all__ = ["OnlineTuner", "online"]

_OBJECTIVES = ("cycles", "time_us")


class OnlineTuner:
    """Rolling-window incremental re-pricer (see module docstring).

    ``archs`` is the candidate list (names / specs / arch objects);
    ``window`` the number of most-recent observations ranked; ``current``
    the architecture the serving side is running (defaults to the engine's
    ``mem_arch``, else the first candidate) — the baseline a swap
    recommendation is measured against; ``device`` is where ``cost_many``
    prices the new blocks."""

    def __init__(self, archs, *, window: int = 64, engine=None,
                 objective: str = "cycles", current=None,
                 patience: int = 2, margin: float = 0.0,
                 block_ops: int | None = None,
                 cache: BlockCostCache | None = None, device="cuda"):
        from repro_torch.core import arch as _arch
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if objective not in _OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"use one of {_OBJECTIVES}")
        self.archs = [_arch.resolve(a) for a in archs]
        if not self.archs:
            raise ValueError("need at least one candidate architecture")
        self.window = window
        self.engine = engine
        self.objective = objective
        self.patience = patience
        self.margin = margin
        self.block_ops = block_ops
        self.device = device
        # the window can only share blocks with the previous W-1 re-prices,
        # so a ~2-window LRU keeps every possible hit without growing
        self.cache = cache if cache is not None else BlockCostCache(
            max_entries=max(256, 4 * window))
        if current is None and engine is not None:
            current = getattr(engine, "mem_arch", None)
        if current is None:
            current = self.archs[0]
        self.current = _arch.resolve(current).name
        self._traces: deque = deque(maxlen=window)
        self._streak_arch: str | None = None
        self._streak = 0
        self.n_repriced = 0

    # -- observation -------------------------------------------------------

    def observe(self, trace) -> None:
        """Append one step's traffic (an ``AddressTrace`` or anything
        ``as_trace`` accepts; streams are materialized — a step is small)
        to the rolling window, evicting the oldest beyond ``window``."""
        t = as_trace(trace)
        if isinstance(t, TraceStream):
            # one observation is a single step's traffic — small by
            # definition, and the cache keys on the dense block content
            t = t.materialize()     # lint: allow-materialize
        self._traces.append(t)

    # -- pricing -----------------------------------------------------------

    def window_trace(self) -> TraceStream:
        """The current window as one stream (sources in observation
        order) — exactly what ``reprice`` prices."""
        return TraceStream(list(self._traces))

    def reprice(self, full_rebuild: bool = False) -> list:
        """Price the window under every candidate; returns
        ``[(name, objective_value, TraceCost), ...]`` best-first.

        Incremental by default: blocks already priced in a previous window
        hit the ``BlockCostCache`` and skip device dispatch, so a step that
        slid the window by one block re-prices at ~one block's cost.
        ``full_rebuild=True`` bypasses the cache (prices every block cold)
        — bit-equal to the incremental path by construction, and pinned so
        in tests/test_torch_tune_online.py."""
        if not self._traces:
            raise RuntimeError("nothing observed yet; call observe()/step()")
        costs = cost_many(self.archs, self.window_trace(),
                          block_ops=self.block_ops, device=self.device,
                          cache=None if full_rebuild else self.cache)
        self.n_repriced += 1
        rows = []
        for a, c in zip(self.archs, costs):
            val = (c.total_cycles if self.objective == "cycles"
                   else c.time_us(a.fmax_mhz))
            rows.append((a.name, val, c))
        rows.sort(key=lambda r: r[1])
        return rows

    def recommend(self, full_rebuild: bool = False) -> dict:
        """Re-price and fold the result into the swap hysteresis: the
        winner must beat the CURRENT arch by more than ``margin``
        (relative) for ``patience`` consecutive re-prices before
        ``swap`` turns True."""
        rows = self.reprice(full_rebuild=full_rebuild)
        winner, best, _ = rows[0]
        cur_val = next(v for n, v, _ in rows if n == self.current)
        beats = winner != self.current and best < cur_val * (1 - self.margin)
        if beats and winner == self._streak_arch:
            self._streak += 1
        elif beats:
            self._streak_arch, self._streak = winner, 1
        else:
            self._streak_arch, self._streak = None, 0
        return {
            "winner": winner, "current": self.current,
            "objective": self.objective,
            "winner_value": best, "current_value": cur_val,
            "swap": self._streak >= self.patience,
            "streak": self._streak,
            "window_blocks": len(self._traces),
            "cache": dict(self.cache.stats),
            "ranking": [(n, v) for n, v, _ in rows],
        }

    def step(self, trace=None) -> dict:
        """One online tick: observe the newest step trace (the bound
        engine's ``step_trace()`` when ``trace`` is None) and return
        ``recommend()`` over the slid window."""
        if trace is None:
            if self.engine is None:
                raise RuntimeError("no engine bound; pass a trace or build "
                                   "the tuner with tune.online(engine, ...)")
            trace = self.engine.step_trace()
        self.observe(trace)
        return self.recommend()

    def swap(self, name: str) -> None:
        """Record that the serving side hot-swapped to ``name`` — resets
        the hysteresis against the new baseline."""
        from repro_torch.core import arch as _arch
        self.current = _arch.resolve(name).name
        self._streak_arch, self._streak = None, 0

    def __repr__(self) -> str:
        return (f"OnlineTuner(archs={len(self.archs)}, "
                f"window={self.window}, current={self.current!r}, "
                f"observed={len(self._traces)}, cache={self.cache.stats})")


def online(engine=None, archs=None, *, window: int = 64, **kwargs
           ) -> OnlineTuner:
    """Build an ``OnlineTuner`` over live serving traffic —
    ``tune.online(engine, window=32)`` re-prices the engine's last
    ``window`` decode steps after every ``tuner.step()``.

    ``archs`` defaults to the paper lattice (``PAPER_SPACE.names()``);
    ``engine`` may be None for manual ``observe(trace)`` feeding (e.g.
    scheduler tick traces).  Extra kwargs (``device="cpu"`` among them)
    forward to ``OnlineTuner``."""
    if archs is None:
        from repro_torch.tune.search import PAPER_SPACE
        archs = PAPER_SPACE.names()
    return OnlineTuner(archs, window=window, engine=engine, **kwargs)
