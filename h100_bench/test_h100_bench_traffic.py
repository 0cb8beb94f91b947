"""The traffic generator: a seed names one day, every seed serves the same
work block by block in its own order, the draws follow their
distributions, and the rate follows the lane budget."""
import math

import numpy as np
import pytest

from h100_bench import traffic

MIXES = ["long_prompt-32x2048"]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_day(name):
    mix = traffic.load_mix(name)
    a = traffic.make_day(mix, 2 ** 31 + 99, 1000)
    b = traffic.make_day(mix, 2 ** 31 + 99, 1000)
    c = traffic.make_day(mix, 2 ** 31 + 100, 1000)
    for x, y in ((a.arrival, b.arrival), (a.prompt_len, b.prompt_len),
                 (a.max_new, b.max_new)):
        assert np.array_equal(x, y)
    assert all(np.array_equal(x, y) for x, y in zip(a.tokens, b.tokens))
    assert not np.array_equal(a.prompt_len, c.prompt_len)


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 2 ** 33 + 7])
def test_lengths_and_gaps_follow_their_distributions(name, seed):
    """Log-uniform lengths (their logs' mean mid-way, a quarter below the
    lower quartile), exponential gaps (their spread about their mean), and
    seeds that draw different days."""
    mix = traffic.load_mix(name)
    d = traffic.make_day(mix, seed, 1000)
    other = traffic.make_day(mix, seed + 1, 1000)
    n0 = round(mix.backlog * mix.lanes)
    assert not np.array_equal(d.arrival[n0:n0 + 50],
                              other.arrival[n0:n0 + 50])
    for field, (lo, hi) in (("prompt_len", mix.prompt),
                            ("max_new", mix.output)):
        x = getattr(d, field)
        assert x.min() >= lo and x.max() <= hi
        u = np.log(x / lo) / np.log(hi / lo)
        assert abs(u.mean() - 0.5) < 0.03
        assert abs((u < 0.25).mean() - 0.25) < 0.04
    gaps = np.diff(d.arrival[n0:]).astype(float)
    assert abs(gaps.mean() * mix.rate - 1) < 0.08
    assert abs(gaps.std() / gaps.mean() - 1) < 0.15
    assert (np.diff(d.arrival) >= 0).all()
    assert (d.arrival[:n0] == 0).all()
    assert [len(t) for t in d.tokens] == d.prompt_len.tolist()
    assert all(t.max() < 1000 for t in d.tokens)


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", [2147490017, 2147490019, 2147490035,
                                  2147490001, 2 ** 33 + 7])
def test_every_seed_draws_a_whole_day(name, seed):
    """Every seed's day holds the same number of requests, each with its
    arrival, lengths and prompt (the first three seeds draw gaps whose
    last ones are short, so that more arrivals fall before ``day_ticks``
    than the day holds lengths for)."""
    mix = traffic.load_mix(name)
    d = traffic.make_day(mix, seed, 1000)
    n0 = round(mix.backlog * mix.lanes)
    blocks = -(-(math.ceil(mix.day_ticks * mix.rate) + n0) // mix.block)
    assert len(d.arrival) == len(d.prompt_len) == len(d.max_new) \
        == len(d.tokens) == blocks * mix.block
    assert d.arrival[-1] >= 0.99 * mix.day_ticks


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_work_a_block(name):
    mix = traffic.load_mix(name)
    days = [traffic.make_day(mix, s, 1000) for s in (1, 2 ** 33 + 7)]
    n0 = round(mix.backlog * mix.lanes)
    n = mix.block
    gaps = [np.diff(np.concatenate([[0], d.arrival[n0:]])) for d in days]
    for lo in range(0, len(days[0].prompt_len) - n, n):
        for field in ("prompt_len", "max_new"):
            blocks = [np.sort(getattr(d, field)[lo:lo + n]) for d in days]
            assert np.array_equal(*blocks)
    # a block's gaps sum to the same ticks, but to floor rounding
    for lo in range(0, min(map(len, gaps)) - n, n):
        sums = [g[lo:lo + n].sum() for g in gaps]
        assert abs(sums[0] - sums[1]) <= 2
    assert not np.array_equal(days[0].arrival, days[1].arrival)


def test_rate_follows_the_lane_budget():
    mix = traffic.load_mix("long_prompt-32x2048")
    mean = (128 - 16) / math.log(128 / 16)
    assert mix.rate == pytest.approx(0.8 * 32 / mean)
    assert 53 < mean < 55
    day = traffic.make_day(mix, 5, 1000)
    n0 = round(mix.backlog * mix.lanes)
    ticks = day.arrival[-1] - day.arrival[n0]
    assert (len(day.arrival) - n0) / ticks == pytest.approx(mix.rate,
                                                            rel=0.02)
    assert day.arrival[-1] >= 0.99 * mix.day_ticks
