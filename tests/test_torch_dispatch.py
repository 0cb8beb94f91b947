"""The port's MoE dispatch held to the JAX reference.

``moe_dispatch_positions`` on CPU tensors runs its plain PyTorch version,
which must equal the reference's Pallas kernel (run as the reference's own
tests run it, interpret=True) and its oracle bit for bit, ``pos`` and
``kept`` (tolerance 0: integers), over the reference tests' sweep
(tests/test_kernels.py:103-123) and the edge cases, and refuse what the
reference refuses; its trace, block stream and ``cost_cycles`` equal the
reference's.  ``repro_torch.core.dispatch`` equals ``repro.core.dispatch``
field for field, with and without a mask, over the cases of
tests/test_dispatch.py.  The CUDA kernel is held to the plain version by
the ``cuda`` tests of test_torch_cuda.py (and by chip_smoke.py) on the
card.  Inputs are made with numpy from fixed seeds."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.dispatch as RD
import repro_torch.core.dispatch as PD
from repro import kernels as rk
from repro.core import arch as RA
from repro.core.cost_engine import cost_many as r_cost_many
from repro.kernels.moe_dispatch.ops import moe_dispatch_positions as r_moe
from repro.kernels.moe_dispatch.ref import moe_dispatch_ref as r_moe_ref
from repro_torch import core as PC
from repro_torch import kernels as pk
from repro_torch.core import arch as PA
from repro_torch.core.arbiter import grant_positions
from repro_torch.core.cost_engine import cost_many
from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                  moe_dispatch_positions)
from repro_torch.kernels.moe_dispatch.ref import moe_dispatch_ref

INT32 = np.iinfo(np.int32)


def _moe_equal(ids: np.ndarray, n_experts: int, capacity: int):
    """The port's wrapper (its plain version on a CPU tensor) == the Pallas
    kernel == both oracles: int32 positions and bool kept, bit for bit."""
    got = moe_dispatch_positions(torch.from_numpy(ids), n_experts, capacity)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    wants = (r_moe(jnp.asarray(ids), n_experts, capacity),
             r_moe_ref(jnp.asarray(ids), n_experts, capacity),
             moe_dispatch_ref(torch.from_numpy(ids), n_experts, capacity))
    for want in wants:
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


# ---------------------------------------------------------- the kernel --

@pytest.mark.parametrize("r,e,cap", [(512, 16, 40), (1024, 8, 100),
                                     (2048, 16, 16)])
def test_moe_dispatch_sweep_bit_equal_to_pallas(r, e, cap):
    ids = np.random.default_rng(r).integers(0, e, r).astype(np.int32)
    _moe_equal(ids, e, cap)
    # the registry runs the same function as the reference's registry
    got = pk.get("moe_dispatch").run("16B", torch.from_numpy(ids), e, cap)
    want = rk.get("moe_dispatch").run("16B", jnp.asarray(ids), e, cap,
                                      interpret=True)
    ref = pk.get("moe_dispatch").reference("16B", torch.from_numpy(ids), e,
                                           cap)
    for g, w, o in zip(got, want, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))


MOE_EDGES = {
    # everyone wants expert 0 across three 512-blocks: pos == arange
    "block_boundary": (np.zeros(1536, np.int32), 4, 1000),
    "r300": (np.random.default_rng(1).integers(0, 16, 300), 16, 20),
    "one_expert": (np.zeros(1024, np.int64), 1, 700),
    "e256": (np.random.default_rng(2).integers(0, 256, 2048), 256, 10),
    # more experts than the CUDA kernel counts in one pass (1024)
    "e3000": (np.random.default_rng(9).integers(-3, 3003, 2048), 3000, 2),
    # ids outside [0, E), negative ones among them: pos 0, kept iff 0 < cap
    "out_of_range": (np.random.default_rng(3).integers(-4, 20, 512), 16, 5),
    "capacity_0": (np.random.default_rng(4).integers(0, 8, 512), 8, 0),
    "capacity_above_r": (np.random.default_rng(5).integers(0, 8, 1024), 8,
                         5000),
    "capacity_int32_min": (np.random.default_rng(6).integers(0, 8, 64), 8,
                           int(INT32.min)),
    "capacity_int32_max": (np.random.default_rng(7).integers(0, 8, 64), 8,
                           int(INT32.max)),
    # no experts: every id is out of range
    "no_experts": (np.random.default_rng(8).integers(-2, 3, 100), 0, 1),
}


@pytest.mark.parametrize("case", list(MOE_EDGES))
def test_moe_dispatch_edge_cases_bit_equal_to_pallas(case):
    ids, e, cap = MOE_EDGES[case]
    pos, kept = _moe_equal(ids.astype(np.int32), e, cap)
    # int64 ids narrow to the same int32 ids (as astype(jnp.int32))
    got64 = moe_dispatch_positions(torch.from_numpy(ids.astype(np.int64)), e,
                                   cap)
    assert torch.equal(got64[0], pos) and torch.equal(got64[1], kept)
    if case == "block_boundary":
        assert pos.tolist() == list(range(1536))
    if case == "out_of_range":
        outside = (ids < 0) | (ids >= 16)
        assert outside.any() and (pos.numpy()[outside] == 0).all()
        assert kept.numpy()[outside].all()
    if case in ("capacity_0", "capacity_int32_min"):
        assert not kept.any()
    if case in ("capacity_above_r", "capacity_int32_max"):
        assert kept.all()


def test_cpu_path_launches_no_kernel():
    """A CPU tensor runs the plain version: the one C entry's launch count
    does not move, and no workspace is made."""
    from repro_torch.kernels.moe_dispatch import ops
    before = ops.DISPATCH.launches
    for dtype in (torch.int32, torch.int64, torch.int16):
        moe_dispatch_positions(torch.zeros(512, dtype=dtype), 16, 8)
    assert ops.DISPATCH.launches == before
    assert ops.DISPATCH.symbol == "moe_dispatch_launch"
    assert not ops._WORKSPACES


def test_moe_dispatch_matches_the_arbiter():
    """tests/test_kernels.py:119: positions are the arbiter's grant
    positions."""
    ids = np.random.default_rng(3).integers(0, 16, 512).astype(np.int32)
    pos, _ = moe_dispatch_positions(torch.from_numpy(ids), 16, 512)
    assert torch.equal(pos, grant_positions(torch.from_numpy(ids), 16))
    assert torch.equal(pos, moe_dispatch_plain(torch.from_numpy(ids), 16,
                                               512)[0])


@pytest.mark.parametrize("shape,n_experts,capacity", [
    ((600,), 16, 8), ((1000,), 16, 8), ((0,), 16, 8), ((4, 4), 16, 8),
    ((), 16, 8), ((512,), -1, 8), ((512,), 16, 2 ** 31),
    ((512,), 16, -2 ** 31 - 1)])
def test_moe_dispatch_refuses_what_the_reference_refuses(shape, n_experts,
                                                         capacity):
    ids = np.zeros(shape, np.int32)
    with pytest.raises((AssertionError, ValueError, TypeError,
                        ZeroDivisionError, IndexError, OverflowError)):
        r_moe(jnp.asarray(ids), n_experts, capacity)
    with pytest.raises(ValueError):
        moe_dispatch_positions(torch.from_numpy(ids), n_experts, capacity)


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.integers(-3, 10), min_size=1, max_size=64),
       st.integers(0, 8), st.integers(-2, 40))
def test_moe_dispatch_property_equals_pallas(ids, n_experts, capacity):
    _moe_equal(np.array(ids, np.int32), n_experts, capacity)


# ------------------------- the CUDA kernel's single pass, emulated --
#
# csrc/moe_dispatch.cu runs one launch a pass of experts: tiles taken from a
# ticket counter, per-warp ranks, tile aggregates published as packed
# status words, a warp-wide look-back over windows of 32 predecessors, and
# a header (ticket, done, epoch) that the last block readies for the next
# call.  The emulation below runs that algorithm in numpy on an int64
# workspace laid out as the kernel's, with blocks as generators that a
# seeded scheduler advances in random order (up to `resident` at once), so
# tiles publish, wait and finish in random orders.  The card runs the
# kernel itself against the plain version (test_torch_cuda.py,
# chip_smoke.py).

def _source_constant(name: str) -> int:
    """A ``constexpr`` of csrc/moe_dispatch.cu, read from the source."""
    import re
    from repro_torch.kernels.cuda_lib import CSRC
    text = (CSRC / "moe_dispatch.cu").read_text()
    m = re.search(rf"constexpr \w+ {name} = (0x[0-9a-f]+|\d+)u?;", text)
    assert m, name
    return int(m.group(1), 0)


def _packed(tag, inclusive, counts) -> np.ndarray:
    """Status words of ``counts`` (the kernel's packing) as int64."""
    from repro_torch.kernels.moe_dispatch import ops
    words = (np.uint64(tag) << np.uint64(ops.TAG_SHIFT)) | (
        np.uint64(bool(inclusive)) << np.uint64(ops.FLAG_BIT)) | \
        np.asarray(counts).astype(np.uint64)
    return words.view(np.int64)


def _warp_ranks(wk: np.ndarray, ew: int, rows: int):
    """One warp's requests (keys in stream order; ew: not counted) -> (rank
    of each among the warp's requests with its key, the warp's count of
    each key), as the kernel forms them: with at most 32 experts, lane j
    holds requests rows j .. rows j + rows - 1 (after the transpose) and
    counts them in its own column, then one scan per expert across the
    lanes; with more, row k holds requests 32 k .. 32 k + 31, and each
    request's peers earlier in its row add to the warp's running count."""
    rank = np.zeros(wk.size, np.int64)
    if ew == 0:
        return rank, np.zeros(0, np.int64)
    if ew <= 32:
        lanes = wk.reshape(32, rows)                 # lane j, request k
        col = np.zeros((ew + 1, 32), np.int64)       # + a row for ew
        at = np.arange(32)
        own = np.zeros((32, rows), np.int64)
        for k in range(rows):
            own[:, k] = col[lanes[:, k], at]
            col[lanes[:, k], at] += 1
        col = col[:ew]
        before = np.cumsum(col, 1) - col             # earlier lanes
        counted = lanes < ew
        rank = np.where(counted, before[np.minimum(lanes, ew - 1),
                                        at[:, None]] + own, 0).reshape(-1)
        return rank, col.sum(1)
    running = np.zeros(ew + 1, np.int64)
    earlier = np.tril(np.ones((32, 32), bool), -1)
    grid = wk.reshape(rows, 32)                      # row k, lane j
    for k in range(rows):
        row = grid[k]
        peers = ((row[:, None] == row[None, :]) & earlier).sum(1)
        rank[32 * k:32 * k + 32] = running[row] + peers
        np.add.at(running, row, 1)
    return np.where(wk < ew, rank, 0), running[:ew]


def _dispatch_block(ids32, r, n_experts, capacity, e_lo, ew, n_tiles, ws,
                    pos, kept, warps, rows):
    """One block of the kernel, as a generator: each ``yield`` is a point
    where other blocks may run."""
    from repro_torch.kernels.moe_dispatch import ops
    head = ws[:ops.HEADER_WORDS].view(np.uint32)   # ticket, done, epoch
    status = ws[ops.HEADER_WORDS:]                 # status[e * n_tiles + t]
    tile = int(head[0])
    head[0] += 1
    tag = int(head[2]) + 1
    yield
    size = warps * rows * 32
    lo = tile * size
    idx = lo + np.arange(size)
    ids = np.full(size, e_lo + ew, np.int64)
    ids[idx < r] = ids32[lo:lo + size]
    key = np.where((ids >= e_lo) & (ids < e_lo + ew), ids - e_lo, ew)
    writes = (key < ew) | ((e_lo == 0) & (idx < r) &
                           ((ids < 0) | (ids >= n_experts)))
    rank = np.zeros(size, np.int64)
    count = np.zeros((warps, ew), np.int64)
    for w in range(warps):
        part = slice(w * rows * 32, (w + 1) * rows * 32)
        rank[part], count[w] = _warp_ranks(key[part], ew, rows)
    warp_base = np.cumsum(count, 0) - count          # earlier warps
    agg = count.sum(0)
    cols = np.arange(ew) * n_tiles
    status[cols + tile] = _packed(tag, tile == 0, agg)
    yield
    base = np.zeros(ew, np.int64)
    if tile > 0:
        # warp w looks back for its experts e = w + warps i, m at a time
        # (m a power of two, at most 32), W = 32 / m lanes each
        batches = []
        for w in range(min(warps, ew)):
            mine = np.arange(w, ew, warps)
            m = 1
            while m < min(mine.size, 32):
                m *= 2
            batches.append([mine[i:i + m] for i in range(0, mine.size, m)]
                           + [32 // m])
        state = {w: [b[0], np.full(b[0].size, tile), np.zeros(b[0].size,
                                                             np.int64)]
                 for w, b in enumerate(batches)}
        while state:
            for w in list(state):
                left, frm, total = state[w]
                width = batches[w][-1]
                lanes = np.arange(width)
                t = frm[:, None] - 1 - lanes             # lane j: from-1-j
                words = status[cols[left, None] + np.maximum(t, 0)].view(
                    np.uint64)
                valid = (words >> np.uint64(ops.TAG_SHIFT)) == tag
                incl = valid & ((words >> np.uint64(ops.FLAG_BIT)) & 1 == 1)
                cnt = (words & np.uint64(0xFFFFFFFF)).astype(np.int64)
                below = t < 0                            # below tile 0
                valid, incl = valid | below, incl | below
                cnt[below] = 0
                # lanes below the first unpublished word, and the nearest
                # inclusive prefix among them
                ready = np.cumprod(valid, 1).astype(bool)
                stop = incl & ready
                hit = stop.any(1)
                k = np.argmax(stop, 1)
                got = total + np.where(lanes <= k[:, None], cnt, 0).sum(1)
                done = left[hit]
                status[cols[done] + tile] = _packed(tag, True,
                                                    got[hit] + agg[done])
                base[done] = got[hit]
                move = ~hit & valid.all(1)
                total = np.where(move, total + cnt.sum(1), total)
                frm = np.where(move, frm - width, frm)
                keep = ~hit
                left, frm, total = left[keep], frm[keep], total[keep]
                if left.size:
                    state[w] = [left, frm, total]
                elif len(batches[w]) > 2:                # the next batch
                    batches[w] = batches[w][1:]
                    nxt = batches[w][0]
                    state[w] = [nxt, np.full(nxt.size, tile),
                                np.zeros(nxt.size, np.int64)]
                else:
                    del state[w]
            if state:
                yield
    # done after the look-back: the last block readies the workspace
    done = int(head[1])
    head[1] += 1
    if done == n_tiles - 1:
        head[0] = head[1] = 0
        nxt = int(head[2]) + 1
        if nxt == ops.TAG_LIMIT:
            nxt = 0
            status[:] = 0
        head[2] = nxt
    yield
    w = np.arange(size) // (rows * 32)
    k = np.minimum(key, max(ew - 1, 0))
    p = np.where(key < ew, base[k] + warp_base[w, k] + rank, 0) if ew else \
        np.zeros(size, np.int64)
    out = idx[writes]
    pos[out], kept[out] = p[writes], p[writes] < capacity


def _emulate_dispatch(ids, n_experts, capacity, ws, rng, warps=8, rows=32,
                      resident=None):
    """The kernel's passes over ``ids`` on workspace ``ws`` (int64, shared
    across calls), blocks interleaved at random -> (pos int32, kept
    bool); every output element must be written."""
    from repro_torch.kernels.moe_dispatch import ops
    ids32 = np.asarray(ids).astype(np.int32).astype(np.int64)
    r = len(ids32)
    n_tiles = -(-r // (warps * rows * 32))
    pos = np.full(r, -7, np.int64)
    kept = np.full(r, 7, np.int64)
    for e_lo in range(0, max(n_experts, 1), ops.EXPERT_CHUNK):
        ew = min(ops.EXPERT_CHUNK, n_experts - e_lo)
        assert ws.size >= ops.HEADER_WORDS + n_tiles * ew
        limit = resident or int(rng.integers(1, 9))
        waiting, running = n_tiles, []
        for _ in range(10 ** 6):
            while waiting and len(running) < limit:
                block = _dispatch_block(ids32, r, n_experts, capacity, e_lo,
                                        ew, n_tiles, ws, pos, kept, warps,
                                        rows)
                next(block)                            # takes its ticket
                running.append(block)
                waiting -= 1
            if not running:
                break
            pick = int(rng.integers(len(running)))
            try:
                next(running[pick])
            except StopIteration:
                running.pop(pick)
        else:
            raise AssertionError("the emulated look-back did not end")
        head = ws[:ops.HEADER_WORDS].view(np.uint32)
        assert head[0] == head[1] == 0          # ticket and done readied
    assert (kept <= 1).all() and (pos >= 0).all(), "an output not written"
    return pos.astype(np.int32), kept.astype(bool)


@functools.lru_cache(maxsize=None)
def _pallas_dispatch(case: str):
    ids, e, cap = _EMULATED[case]
    got = r_moe(jnp.asarray(ids.astype(np.int32)), e, cap)
    return tuple(np.asarray(g) for g in got)


_EMULATED = {f"sweep_{r}_{e}_{c}": (np.random.default_rng(r).integers(
    0, e, r), e, c) for r, e, c in ((512, 16, 40), (1024, 8, 100),
                                     (2048, 16, 16))}
_EMULATED.update(MOE_EDGES)
# the two ranking paths' boundary: 32 experts in lane columns, 33 by
# ballots along rows
_EMULATED["e32"] = (np.random.default_rng(14).integers(0, 32, 2048), 32, 40)
_EMULATED["e33"] = (np.random.default_rng(15).integers(-2, 36, 2048), 33, 40)
# int64 ids beyond int32: the kernel keeps their low 32 bits
_EMULATED["int64_beyond_int32"] = (
    np.random.default_rng(12).integers(-3, 19, 2048)
    + np.random.default_rng(13).integers(-4, 5, 2048) * 2 ** 32, 16, 30)

# (warps, rows of 32 a warp): the kernel's own tile of 8192 requests, and
# tiles of 64 so that the sweep spans up to 32 tiles and several windows
_GEOMETRIES = {"tile8192": (8, 32), "tile64": (2, 1)}


@pytest.mark.parametrize("geometry", list(_GEOMETRIES))
@pytest.mark.parametrize("case", list(_EMULATED))
def test_emulated_single_pass_bit_equal_to_plain_and_pallas(case, geometry):
    from repro_torch.kernels.moe_dispatch import ops
    ids, e, cap = _EMULATED[case]
    warps, rows = _GEOMETRIES[geometry]
    rng = np.random.default_rng(abs(hash((case, geometry))) % 2 ** 32)
    n_tiles = -(-len(ids) // (warps * rows * 32))
    ws = np.zeros(ops.HEADER_WORDS + n_tiles * min(e, ops.EXPERT_CHUNK),
                  np.int64)
    pos, kept = _emulate_dispatch(ids, e, cap, ws, rng, warps, rows)
    want = moe_dispatch_plain(torch.from_numpy(np.asarray(ids)), e, cap)
    np.testing.assert_array_equal(pos, want[0].numpy())
    np.testing.assert_array_equal(kept, want[1].numpy())
    for g, w in zip((pos, kept), _pallas_dispatch(case), strict=True):
        np.testing.assert_array_equal(g, w)
    # the epoch advanced once a pass; the workspace is ready for the next
    head = ws[:ops.HEADER_WORDS].view(np.uint32)
    assert head.tolist()[:3] == [0, 0, max(-(-e // ops.EXPERT_CHUNK), 1)]


def test_emulated_calls_share_one_workspace_and_replay():
    """Successive calls of other sizes and expert counts, and a replay of
    the first, on one workspace and its epoch: each bit-equal to the plain
    version, whatever order the tiles run in; stale words of earlier
    calls (their tags are older) are never read as this call's."""
    from repro_torch.kernels.moe_dispatch import ops
    rng = np.random.default_rng(21)
    calls = [(rng.integers(0, 16, 2048), 16, 40),
             (rng.integers(-2, 40, 1024), 40, 7),
             (rng.integers(0, 3000, 2048), 3000, 2),
             (rng.integers(0, 4, 512), 4, 100),
             (rng.integers(-1, 2, 100), 0, 1)]
    calls.append(calls[0])                         # the replay
    # tiles of 64 requests: 32 tiles of 2048 requests, 1024 experts a pass
    ws = np.zeros(ops.HEADER_WORDS + 32 * 1024, np.int64)
    epoch = 0
    for ids, e, cap in calls:
        for resident in (1, 3, 8):
            pos, kept = _emulate_dispatch(ids, e, cap, ws, rng, 2, 1,
                                          resident)
            want = moe_dispatch_plain(torch.from_numpy(ids), e, cap)
            np.testing.assert_array_equal(pos, want[0].numpy())
            np.testing.assert_array_equal(kept, want[1].numpy())
            epoch += max(-(-e // ops.EXPERT_CHUNK), 1)
            assert ws[:2].view(np.uint32)[2] == epoch


def test_emulated_epoch_wrap_clears_stale_words():
    """Across the epoch's wrap (tags run 1 .. 2^31 - 1), the last block
    zeroes every status word: stale words that carry the tags the next
    calls take are not read as theirs."""
    from repro_torch.kernels.moe_dispatch import ops
    rng = np.random.default_rng(22)
    small = (rng.integers(0, 16, 512), 16, 5)
    big = (rng.integers(0, 3000, 2048), 3000, 3)
    ws = np.zeros(ops.HEADER_WORDS + 32 * 1024, np.int64)
    # stale inclusive prefixes under tags 1 to 3, the ones the call after
    # the wrap takes, where the call before it writes nothing
    ws[ops.HEADER_WORDS:] = rng.choice(
        [ops.pack_status(t, True, 12345) for t in (1, 2, 3)],
        ws.size - ops.HEADER_WORDS)
    ws[:2].view(np.uint32)[2] = ops.TAG_LIMIT - 1   # the next tag: LIMIT
    for (ids, e, cap), epoch in ((small, 0), (big, 3), (small, 4)):
        want = moe_dispatch_plain(torch.from_numpy(ids), e, cap)
        pos, kept = _emulate_dispatch(ids, e, cap, ws, rng, 2, 1)
        np.testing.assert_array_equal(pos, want[0].numpy())
        np.testing.assert_array_equal(kept, want[1].numpy())
        assert ws[:2].view(np.uint32)[2] == epoch


def test_status_word_and_workspace_are_pinned():
    """The status word: count in bits 0-31, flag in bit 32, tag in bits
    33-63, as the source packs it; counts up to 2^32 - 1 (a prefix is at
    most R <= 2^31 - 1) and tags 1 .. 2^31 - 1 round-trip.  The workspace
    holds the 16-byte header and one word per (tile, expert of a pass)."""
    from repro_torch.kernels.moe_dispatch import ops
    assert (ops.FLAG_BIT, ops.TAG_SHIFT, ops.TAG_LIMIT,
            ops.HEADER_WORDS) == (32, 33, 2 ** 31 - 1, 2)
    assert (_source_constant("kFlagBit"), _source_constant("kTagShift"),
            _source_constant("kTagLimit"), _source_constant("kHeaderWords"),
            _source_constant("kWarps") * _source_constant("kRows") * 32,
            _source_constant("kChunk"), _source_constant("kWindow")) == (
        ops.FLAG_BIT, ops.TAG_SHIFT, ops.TAG_LIMIT, ops.HEADER_WORDS,
        ops.TILE, ops.EXPERT_CHUNK, 32)
    assert ops.pack_status(1, False, 0) == 1 << 33
    assert ops.pack_status(1, True, 5) == (1 << 33) | (1 << 32) | 5
    assert ops.pack_status(ops.TAG_LIMIT, True, 2 ** 31 - 1) == \
        -(1 << 33) + (1 << 32) + 2 ** 31 - 1
    for tag, incl, count in ((1, False, 0), (ops.TAG_LIMIT, True,
                                             2 ** 31 - 1),
                             (12345, True, 2 ** 32 - 1), (7, False, 4096)):
        word = ops.pack_status(tag, incl, count)
        assert -2 ** 63 <= word < 2 ** 63
        assert ops.unpack_status(word) == (tag, incl, count)
        assert ops.unpack_status(int(np.int64(word))) == (tag, incl, count)
    for bad in ((0, False, 2 ** 32), (2 ** 31, False, 0), (1, True, -1)):
        with pytest.raises(ValueError):
            ops.pack_status(*bad)
    assert _packed(12345, True, [0, 4096, 2 ** 31 - 1]).tolist() == [
        ops.pack_status(12345, True, c) for c in (0, 4096, 2 ** 31 - 1)]
    # a zeroed word is tag 0: never valid
    assert ops.unpack_status(0)[0] == 0
    assert ops.workspace_words(2 ** 24, 16) == 2 + 2048 * 16
    assert ops.workspace_words(2 ** 24, 128) == 2 + 2048 * 128
    assert ops.workspace_words(8192, 3000) == 2 + 1 * 1024
    assert ops.workspace_words(16384, 3000) == 2 + 2 * 1024
    assert ops.workspace_words(100, 0) == 2
    assert ops.workspace_words(8193, 1) == 2 + 2


def test_workspace_is_never_made_during_a_capture(monkeypatch):
    """While the stream captures a CUDA graph, a workspace that is missing
    or too small is refused before anything is allocated (its zero fill
    would run only at that graph's replay); one already made, large
    enough, is used as it is.  Outside a capture a missing one is made
    zeroed and grown to at least twice its size."""
    from repro_torch.kernels.moe_dispatch import ops
    monkeypatch.setattr(ops, "_WORKSPACES", {})
    monkeypatch.setattr(ops, "_RETIRED", [])
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    card = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="eagerly"):
        ops.workspace(card, 7, 10)
    assert not ops._WORKSPACES
    made = torch.zeros(10, dtype=torch.int64)       # made eagerly before
    ops._WORKSPACES[(0, 7)] = made
    assert ops.workspace(card, 7, 10) is made
    with pytest.raises(RuntimeError, match="eagerly"):
        ops.workspace(card, 7, 11)
    with pytest.raises(RuntimeError, match="eagerly"):
        ops.workspace(card, 8, 1)                   # another stream
    assert ops._WORKSPACES == {(0, 7): made} and not ops._RETIRED
    capturing[0] = False
    host = torch.device("cpu")
    first = ops.workspace(host, 7, 6)
    assert first.dtype == torch.int64 and first.numel() == 6
    assert not first.any()
    grown = ops.workspace(host, 7, 7)
    assert grown.numel() == 12 and not grown.any()
    assert ops._RETIRED == [first]


# -------------------------------------------------- traces and pricing --

def _moe_input():
    return (np.random.default_rng(11).integers(0, 512, 1000) % 16, 16, 64)


def test_trace_equals_the_reference():
    args = _moe_input()
    want = rk.get("moe_dispatch").address_trace("16B", *args)
    for ids in (args[0], torch.from_numpy(args[0])):
        got = pk.get("moe_dispatch").address_trace("16B", ids, *args[1:])
        for f in ("addrs", "kinds", "instr", "mask"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.n_instructions == 1


def test_trace_blocks_stream_equals_dense_and_the_reference():
    """Streamed == dense at block_ops 1/7/64 and unblocked, on four
    memories, priced equal to the reference (tests/test_cost_engine.py:
    246-272)."""
    args = _moe_input()
    names = ("16B", "8B-offset", "4R-2W", "4R-1W-VB")
    archs = [PA.get(n) for n in names]
    k = pk.get("moe_dispatch")
    dense = cost_many(archs, k.address_trace(archs[0], *args), device="cpu")
    want = r_cost_many([RA.get(n) for n in names],
                       rk.get("moe_dispatch").address_trace("16B", *args))
    assert [dataclasses.asdict(c) for c in dense] == [
        dataclasses.asdict(c) for c in want]
    for bo in (1, 7, 64, None):
        got = cost_many(archs, k.trace_blocks(archs[0], *args, block_ops=bo),
                        device="cpu")
        assert got == dense, bo


@pytest.mark.parametrize("arch", ["16B", "4R-2W", "16B-offset"])
def test_cost_cycles_equal_the_reference(arch):
    args = _moe_input()
    want = rk.get("moe_dispatch").cost_cycles(arch, *args)
    assert pk.get("moe_dispatch").cost_cycles(arch, *args,
                                              device="cpu") == want


def test_registry_holds_the_seven_reference_kernels():
    """The port's registry holds every kernel package of the reference
    (its traffic kernels, attn_decode and the like, come with models/)."""
    pallas = ("banked_gather", "banked_scatter", "banked_transpose",
              "carry_arbiter", "conflict_popcount", "fft_stage",
              "moe_dispatch")
    assert pk.names() == pallas
    assert set(pallas) <= set(rk.names())
    assert pk.get("moe_dispatch").description == \
        rk.get("moe_dispatch").description


# ----------------------------------------------------- core/dispatch.py --

def _plan_equal(bank, n_banks, capacity, mask=None):
    """The port's plan == the reference's plan, field for field."""
    got = PD.banked_dispatch(torch.from_numpy(np.asarray(bank)), n_banks,
                             capacity, None if mask is None
                             else torch.from_numpy(np.asarray(mask)))
    want = RD.banked_dispatch(jnp.asarray(bank), n_banks, capacity,
                              None if mask is None else jnp.asarray(mask))
    for f in ("bank", "position", "kept", "bank_load", "max_conflicts"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert got.capacity == want.capacity == capacity
    return got, want


def _roundtrip_equal(bank, n_banks, capacity, mask=None, feat=(1,)):
    """scatter_to_banks / gather_from_banks / serialization_factor on the
    same plan and payloads equal the reference's."""
    got, want = _plan_equal(bank, n_banks, capacity, mask)
    r = len(bank)
    vals = (np.arange(r * int(np.prod(feat)), dtype=np.float32) + 1.0
            ).reshape((r,) + feat)
    buf = PD.scatter_to_banks(torch.from_numpy(vals), got, n_banks, capacity)
    rbuf = RD.scatter_to_banks(jnp.asarray(vals), want, n_banks, capacity)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))
    out, kept = PD.gather_from_banks(buf, got)
    rout, rkept = RD.gather_from_banks(rbuf, want)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(rkept))
    sf = PD.serialization_factor(got)
    assert sf.dtype == torch.float32
    assert sf.item() == float(RD.serialization_factor(want))
    return got, out


def test_positions_are_arrival_order():
    plan, _ = _plan_equal(np.array([0, 1, 0, 0, 1, 2], np.int32), 4, 8)
    assert plan.position.tolist() == [0, 0, 1, 2, 1, 0]
    assert plan.bank_load.tolist() == [3, 2, 1, 0]
    assert int(plan.max_conflicts) == 3 and bool(plan.kept.all())


def test_capacity_drops_latest_arrivals():
    plan, _ = _plan_equal(np.zeros(8, np.int32), 2, 3)
    assert plan.kept.tolist() == [True] * 3 + [False] * 5


def test_scatter_gather_roundtrip():
    plan, out = _roundtrip_equal(np.array([3, 1, 3, 0], np.int32), 4, 2)
    assert out[:, 0].tolist() == [1.0, 2.0, 3.0, 4.0]


DISPATCH_CASES = {
    "random_b8": (np.random.default_rng(0).integers(0, 8, 64), 8, 3, None),
    "masked_b8": (np.random.default_rng(1).integers(0, 8, 64), 8, 3,
                  np.random.default_rng(2).random(64) > 0.3),
    "masked_int": (np.random.default_rng(3).integers(0, 4, 32), 4, 4,
                   np.random.default_rng(4).integers(0, 2, 32)),
    # an all-false mask: nothing kept, loads 0
    "mask_off": (np.random.default_rng(5).integers(0, 4, 16), 4, 2,
                 np.zeros(16, bool)),
    # bank ids outside [0, B): the reference's drop / clamp semantics
    "out_of_range": (np.array([0, 3, -1, 5, 1, 1, 4, 2], np.int32), 4, 2,
                     None),
    "feat_2x3": (np.random.default_rng(6).integers(0, 16, 40), 16, 2, None),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch_functions_equal_the_reference(case):
    bank, n_banks, capacity, mask = DISPATCH_CASES[case]
    _roundtrip_equal(bank, n_banks, capacity, mask,
                     feat=(2, 3) if case == "feat_2x3" else (1,))


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.integers(0, 7), min_size=1, max_size=64),
       st.integers(1, 8), st.booleans())
def test_roundtrip_property_equals_the_reference(banks, capacity, masked):
    """tests/test_dispatch.py:38: whatever survives capacity comes back
    bit-exact, drops come back 0, no bank keeps more than the capacity —
    and every function equals the reference."""
    r = len(banks)
    mask = (np.arange(r) % 3 != 1) if masked else None
    plan, out = _roundtrip_equal(np.array(banks, np.int32), 8, capacity,
                                 mask)
    kept = plan.kept.numpy()
    np.testing.assert_array_equal(out[:, 0].numpy(),
                                  np.where(kept, np.arange(r) + 1.0, 0.0))
    for b in range(8):
        assert ((plan.bank.numpy() == b) & kept).sum() <= capacity


def test_serialization_factor_extremes():
    perm = np.arange(16, dtype=np.int32)
    assert PD.serialization_factor(PD.banked_dispatch(
        torch.from_numpy(perm), 16, 16)).item() == 1.0
    _roundtrip_equal(perm, 16, 16)
    hot = np.zeros(16, np.int32)
    assert PD.serialization_factor(PD.banked_dispatch(
        torch.from_numpy(hot), 16, 16)).item() == 16.0
    _roundtrip_equal(hot, 16, 16)


def test_core_reexports_the_dispatch_names():
    import repro.core as RC
    for name in ("DispatchPlan", "banked_dispatch", "gather_from_banks",
                 "scatter_to_banks", "serialization_factor"):
        assert name in PC.__all__ and name in RC.__all__
        assert getattr(PC, name) is getattr(PD, name)
