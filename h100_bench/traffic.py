"""Seeded serving days from a traffic mix's parameters (one general
generator; each mix is a file ``traffic/<mix>.json``).

After the program's ``serving.scheduler.synthesize_requests``: arrivals
are in the scheduler's ticks (one tick is one lane-ragged decode step of
the whole engine, ``Request.arrival``), inter-arrival gaps exponential.
Unlike it, lengths are log-uniform over each mix's range, so short
requests are common and long ones form a tail.

Every seed serves the same work in another order: the day is cut into
blocks of ``block`` requests, each block holds the same stratified set of
gaps, prompt lengths and output lengths (the quantiles at (i + 1/2) /
block), and the seed draws each block's three orders anew, and the prompt
tokens.  Drawn independently instead, the arrivals and lengths that a
51 s window holds change the work by about 14 % from seed to seed (two
runs of one seed agree within 1 %), and the window's rate and tails with
it; blocks of 32 leave about 2.5 % (``PERF.md``).

The rate comes from the lane budget: ``load * lanes / mean_output``
arrivals a tick, the mean output of a log-uniform range a..b being
(b - a) / ln(b / a).  The day opens with ``backlog * lanes`` requests at
tick 0 and spans about ``day_ticks`` ticks of arrivals, more than any
window reaches; every seed's day holds the same number of requests.  This module imports nothing of the program.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclass(frozen=True)
class Mix:
    name: str
    lanes: int              # the engine's max_batch
    max_seq: int            # the engine's per-lane context budget
    prompt: tuple           # (shortest, longest) prompt tokens
    output: tuple           # (shortest, longest) generated tokens
    load: float             # offered share of the lane budget
    backlog: float          # requests at tick 0, as a share of the lanes
    day_ticks: int          # ticks of arrivals in a day
    page_len: int           # tokens a KV page holds
    mem_arch: str           # the banked memory the page pools follow
    block: int              # requests a stratified block holds

    @property
    def warm_ticks(self) -> int:
        """Ticks before the window opens: the longest output, by which
        lane occupancy has reached its level."""
        return int(self.output[1])

    @property
    def rate(self) -> float:
        """Arrivals a tick."""
        return self.load * self.lanes / loguniform_mean(*self.output)


def loguniform_mean(lo: float, hi: float) -> float:
    return lo if hi == lo else (hi - lo) / math.log(hi / lo)


def load_mix(name: str) -> Mix:
    raw = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    raw.pop("why", None)
    mix = Mix(name=name, **{k: tuple(v) if isinstance(v, list) else v
                            for k, v in raw.items()})
    if mix.prompt[1] + mix.output[1] > mix.max_seq:
        raise ValueError(f"mix {name}: the longest prompt and output "
                         f"exceed max_seq {mix.max_seq}")
    return mix


def _quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """The log-uniform quantiles of lo..hi at (i + 1/2) / n, as integers."""
    q = (np.arange(n) + 0.5) / n
    return np.clip(np.rint(lo * (hi / lo) ** q), lo, hi).astype(np.int64)


def _gaps(n: int, rate: float) -> np.ndarray:
    """Exponential quantiles at (i + 1/2) / n, scaled to mean 1 / rate."""
    g = -np.log1p(-(np.arange(n) + 0.5) / n)
    return g / g.mean() / rate


@dataclass(frozen=True)
class Day:
    arrival: np.ndarray      # (N,) arrival tick, non-decreasing
    prompt_len: np.ndarray   # (N,)
    max_new: np.ndarray      # (N,)
    tokens: list             # N int32 arrays of prompt ids


def make_day(mix: Mix, seed: int, vocab_size: int) -> Day:
    """The seeded day of ``mix``: the same seed gives the same day."""
    rng = np.random.default_rng(seed % (1 << 64))
    n0 = int(round(mix.backlog * mix.lanes))
    n_blocks = -(-(math.ceil(mix.day_ticks * mix.rate) + n0) // mix.block)
    sets = (_gaps(mix.block, mix.rate), _quantiles(*mix.prompt, mix.block),
            _quantiles(*mix.output, mix.block))
    gaps, prompt_len, max_new = (np.concatenate(
        [rng.permutation(x) for _ in range(n_blocks)]) for x in sets)
    # every day holds the same n_blocks * block requests: the backlog, then
    # the blocks' arrivals, the last n0 of them left out (at tick
    # day_ticks or a little after, far past any window)
    arrival = np.concatenate([np.zeros(n0), np.cumsum(gaps)])[:len(gaps)]
    ids = rng.integers(0, vocab_size, int(prompt_len.sum()), dtype=np.int32)
    tokens = np.split(ids, np.cumsum(prompt_len)[:-1])
    return Day(np.floor(arrival).astype(np.int64), prompt_len, max_new,
               tokens)
