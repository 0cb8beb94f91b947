"""The row kernels' redesign, checked without a card: the paired wrappers
(``banked_gather_pair`` / ``banked_scatter_pair``) on CPU tensors bit-equal
to the JAX package's kernels run once per table (Pallas in interpret mode),
the host's row-map constants and index width against ``physical_row_of``
on every layout's edge rows, and the scatter's two last-writer rules
(staged indices; claimed workspace words) emulated in numpy against the
plain version over successive calls.  The CUDA kernels themselves are held
to the plain versions by the ``cuda`` tests of test_torch_cuda.py and by
chip_smoke.py on the card."""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as rk
from repro_torch.core import arch as PA
from repro_torch.core.arch import logical_row_of, physical_row_of
from repro_torch.kernels.banked_gather.ops import (CHUNK_BYTES, GATHERS,
                                                   INT32_MAX, MAP_CODES,
                                                   RowMap, banked_gather_pair,
                                                   chunk_bytes, index_bits,
                                                   map_arg, row_map)
from repro_torch.kernels.banked_scatter.ops import (
    SCATTERS, STAGED_MAX, banked_scatter_pair, banked_scatter_plain)
from repro_torch.kernels.banked_scatter.ref import last_writers
from repro_torch.serving import kvcache as KV

#: every bank map, and bank counts that are not powers of two
LAYOUTS = ["16B", "16B-offset", "16B-offset-s2", "16B-xor", "16B-fold", "8B",
           "8B-offset", "8B-offset-s2", "8B-xor", "8B-fold", "12B",
           "12B-offset", "6B", "6B-offset"]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "csrc" / "banked_rows.cu").read_text()


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _layout(arch):
    lay = PA.get(arch).layout
    return lay.n_banks, lay.mapping, lay.shift


def _tables(v, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((v, d)).astype(
        np.float32)).to(DTYPES[dtype][0]) for _ in range(2)]


# ------------------------------------------------------ the pair wrappers --

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", LAYOUTS)
def test_gather_pair_bit_equal_to_pallas_twice(arch, dtype):
    lay = _layout(arch)
    v = lay[0] * 16
    k, vt = _tables(v, 96, dtype, seed=len(arch))
    idx = np.random.default_rng(1).integers(0, v, 40)
    idx[::5] = idx[2]
    before = GATHERS.launches
    got = banked_gather_pair(k, vt, torch.as_tensor(idx), *lay)
    assert GATHERS.launches == before            # the CPU path runs plain
    for table, out in zip((k, vt), got):
        want = rk.get("banked_gather").run(
            arch, jnp.asarray(table.float().numpy()).astype(
                DTYPES[dtype][1]), jnp.asarray(idx), table_banked=True,
            interpret=True)
        assert out.dtype == table.dtype
        np.testing.assert_array_equal(_np32(out), _np32(want))


@pytest.mark.parametrize("n", [24, 300])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", LAYOUTS)
def test_scatter_pair_bit_equal_to_pallas_twice(arch, dtype, n):
    """Duplicates resolve last-writer-wins in index order in both tables;
    300 indices take the claimed (two-launch) path on the card."""
    lay = _layout(arch)
    v = lay[0] * 16
    k, vt = _tables(v, 64, dtype, seed=3 * len(arch) + n)
    rng = np.random.default_rng(n)
    idx = rng.integers(0, v, n)
    idx[::3] = idx[1]
    upd = [torch.from_numpy(rng.standard_normal((n, 64)).astype(
        np.float32)).to(DTYPES[dtype][0]) for _ in range(2)]
    want = [rk.get("banked_scatter").run(
        arch, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1]),
        jnp.asarray(idx), jnp.asarray(u.float().numpy()).astype(
            DTYPES[dtype][1]), table_banked=True, interpret=True)
        for t, u in zip((k, vt), upd)]
    before = SCATTERS.launches
    got = banked_scatter_pair(k, vt, torch.as_tensor(idx), *upd, *lay)
    assert SCATTERS.launches == before
    assert got[0] is k and got[1] is vt                 # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np32(g), _np32(w))


def test_pair_wrappers_check_their_inputs():
    k = torch.zeros((64, 32))
    idx = torch.tensor([1, 2])
    upd = torch.zeros((2, 32))
    with pytest.raises(ValueError):
        banked_gather_pair(k, torch.zeros((64, 16)), idx)
    with pytest.raises(TypeError):
        banked_gather_pair(k, k.to(torch.bfloat16), idx)
    with pytest.raises(ValueError):
        banked_gather_pair(k, torch.zeros((32, 64)).t(), idx)
    with pytest.raises(ValueError):
        banked_scatter_pair(k, k, idx, upd, upd)         # one table twice
    with pytest.raises(ValueError):
        banked_scatter_pair(k, k.clone(), idx, upd, torch.zeros((3, 32)))
    with pytest.raises(TypeError):
        banked_scatter_pair(k, k.clone(), idx, upd, upd.double())


@pytest.mark.parametrize("arch", ["16B", "12B", "8B-xor"])
def test_kvcache_pair_helpers_equal_the_single_helpers(arch):
    """``gather_pages_pair`` / ``scatter_pages_pair`` (the serving path)
    equal two calls of ``gather_pages`` / ``scatter_pages`` (the registry
    path) on the same pools."""
    cfg = KV.PagedKVConfig.from_arch(arch, n_pages=PA.get(
        arch).layout.n_banks * 4, page_len=2, kv_heads=2, head_dim=4)
    k, v = _tables(cfg.n_pages, cfg.row_width, "f32", seed=5)
    ids = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.n_pages, 12))
    got = KV.gather_pages_pair(cfg, k, v, ids)
    for pool, out in zip((k, v), got):
        assert torch.equal(out, KV.gather_pages(arch, cfg, pool, ids))
    rows = _tables(12, cfg.row_width, "f32", seed=6)
    want = [KV.scatter_pages(arch, cfg, p.clone(), ids, r)
            for p, r in zip((k, v), rows)]
    got = KV.scatter_pages_pair(cfg, k, v, ids, *rows)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------ the row map ---------

def _edge_rows(n_banks, mapping, shift, v):
    """0, the last row, and the logical rows at each bank's first and last
    physical slot (the bank boundaries of the bank-major table)."""
    rpb = v // n_banks
    rows = {0, v - 1}
    for bank in range(n_banks):
        for slot in (0, 1, rpb - 2, rpb - 1):
            if 0 <= slot < rpb:
                rows.add(int(logical_row_of(bank, slot, n_banks, mapping,
                                            shift)))
    return np.array(sorted(r for r in rows if 0 <= r < v), np.int64)


def _kernel_rows(m: RowMap, r: np.ndarray) -> np.ndarray:
    """``physical_row_of`` of csrc/banked_rows.cu on logical rows ``r``
    (each in [0, v_rows)), operation for operation in unsigned integers
    of the map's index width."""
    mask = np.uint64((1 << m.index_bits) - 1)
    r = np.asarray(r, np.uint64)
    nb = np.uint64(m.n_banks)

    def div(x):
        if m.log2_banks >= 0:
            return x >> np.uint64(m.log2_banks)
        if m.index_bits == 32:
            q = (x * np.uint64(m.magic)) >> np.uint64(m.magic_shift)
            return q & mask
        return x // nb

    if m.map in (MAP_CODES["lsb"], MAP_CODES["offset"]):
        s = np.uint64(m.shift if m.map == MAP_CODES["offset"] else 0)
        high = r >> s
        q = div(high)
        bank = (high - q * nb) & mask
        slot = (q << s) | (r & ((np.uint64(1) << s) - np.uint64(1)))
    else:
        lg = np.uint64(m.log2_banks)
        mix = (r ^ (r >> lg)) if m.map == MAP_CODES["xor"] else r + (r >> lg)
        bank = mix & (nb - np.uint64(1))
        slot = r >> lg
    return ((bank * np.uint64(m.rows_per_bank) + slot) & mask).astype(
        np.int64)


@pytest.mark.parametrize("arch", LAYOUTS)
def test_row_map_matches_physical_row_of(arch):
    """The kernels' integer path (shift and mask, or the host's
    multiply-shift divisor) equals ``physical_row_of``: every row of small
    tables, and the edge rows of tables up to the 32-bit limit on the
    32-bit path and beyond it on the 64-bit one."""
    n_banks, mapping, shift = _layout(arch)
    step = n_banks << 2                       # keeps rows_per_bank even x 4
    small = [n_banks * k for k in (4, 16, 48)]
    large = [INT32_MAX // step * step, (INT32_MAX // step - 7) * step]
    for v in small + large + [(2 ** 33 // step) * step]:
        bits = index_bits(v, 16)
        assert bits == (32 if v <= INT32_MAX else 64)
        rows = np.arange(v) if v in small else _edge_rows(n_banks, mapping,
                                                          shift, v)
        want = physical_row_of(torch.as_tensor(rows), n_banks, v // n_banks,
                               mapping, shift).numpy()
        np.testing.assert_array_equal(_kernel_rows(
            row_map(v, n_banks, mapping, shift, bits), rows), want)
        if v in small:
            np.testing.assert_array_equal(_kernel_rows(
                row_map(v, n_banks, mapping, shift, 64), rows), want)
            assert sorted(want) == list(range(v))          # a bijection


def test_index_width_and_divisor_constants():
    assert index_bits(INT32_MAX, INT32_MAX) == 32
    assert index_bits(INT32_MAX + 1, 4) == 64
    assert index_bits(64, INT32_MAX + 1) == 64
    rng = np.random.default_rng(0)
    for b in (3, 5, 6, 7, 10, 12, 24, 100, 1000, 65535):
        m = row_map(b * 4, b, "lsb", 1, 32)
        assert m.log2_banks == -1 and m.magic < 2 ** 32
        x = np.concatenate([np.arange(4 * b), rng.integers(0, 2 ** 31, 4096),
                            INT32_MAX - np.arange(4 * b)]).astype(np.uint64)
        q = (x * np.uint64(m.magic)) >> np.uint64(m.magic_shift)
        np.testing.assert_array_equal(q, x // np.uint64(b))
    for b in (1, 2, 4, 8, 16, 32):
        m = row_map(b * 4, b, "lsb", 1, 32)
        assert (m.log2_banks, m.magic) == (b.bit_length() - 1, 0)


def test_host_side_matches_the_source():
    """The wrappers' view of the kernels is the source's: the staged
    scatter's shared index buffer, and ``struct RowMap`` field for field
    (the entries read the host's ``RowMap`` through a pointer)."""
    assert STAGED_MAX == int(re.search(
        r"constexpr int kStagedMax = (\d+);", SOURCE).group(1))
    body = re.search(r"struct RowMap \{(.*?)\};", SOURCE, re.S).group(1)
    fields = re.findall(r"(u64|int) (\w+);", body)
    assert [name for _, name in fields] == [f for f, _ in RowMap._fields_]
    assert [kind for kind, _ in fields] == [
        "u64" if t is ctypes.c_ulonglong else "int"
        for _, t in RowMap._fields_]
    rmap = RowMap.from_address(map_arg(48, 40, 12, "offset", 2))
    assert (rmap.v_rows, rmap.rows_per_bank, rmap.n_banks, rmap.map,
            rmap.shift, rmap.log2_banks, rmap.index_bits) == (
                48, 4, 12, 1, 2, -1, 32)
    assert rmap.magic == -(-(1 << rmap.magic_shift) // 12)
    assert RowMap.from_address(map_arg(2 ** 31, 40, 16, "lsb", 1)
                               ).index_bits == 64


def test_chunk_policy():
    """A small call cuts a row into CHUNK_BYTES pieces; a large call or a
    narrow row gives each warp whole rows."""
    assert chunk_bytes(40, 8192) == CHUNK_BYTES
    assert chunk_bytes(16384, 8192) == 8192
    assert chunk_bytes(40, 144) == 144
    assert chunk_bytes(40, 8192) % 16 == 0


# ------------------------------------------------------ last writer wins ----

def _claimed(words, phys, rng):
    """The claimed scatter in numpy: the claim launch (atomicMax of i + 1),
    then the copy launch's warps in a random order, each winner zeroing
    its word after reading it.  Returns the winners."""
    np.maximum.at(words, phys, np.arange(1, len(phys) + 1))
    won = np.zeros(len(phys), bool)
    for i in rng.permutation(len(phys)):
        if words[phys[i]] == i + 1:
            won[i] = True
            words[phys[i]] = 0
    return won


def _staged(phys):
    """The staged scatter in numpy: row i is written when no later index
    names its row."""
    return np.array([not (phys[i + 1:] == p).any()
                     for i, p in enumerate(phys)], bool)


@pytest.mark.parametrize("arch", ["16B", "12B", "8B-fold", "6B-offset"])
def test_scatter_rules_pick_the_plain_versions_last_writers(arch):
    """Over successive calls sharing one workspace, on duplicate-heavy
    streams of many sizes, both rules pick exactly the updates the plain
    version keeps, the workspace is all zero after every call, and the
    table the winners write equals ``banked_scatter_plain``'s."""
    n_banks, mapping, shift = _layout(arch)
    v = n_banks * 8
    rng = np.random.default_rng(len(arch))
    words = np.zeros(v, np.int64)
    table = torch.zeros((v, 3))
    for call in range(40):
        n = int(rng.integers(1, 4 * v))
        idx = rng.integers(0, int(rng.integers(1, v + 1)), n)
        phys = physical_row_of(torch.as_tensor(idx), n_banks, v // n_banks,
                               mapping, shift).numpy()
        keep = last_writers(torch.as_tensor(phys), v).numpy()
        np.testing.assert_array_equal(_claimed(words, phys, rng), keep)
        assert not words.any()
        np.testing.assert_array_equal(_staged(phys), keep)
        upd = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) + call
        want = banked_scatter_plain(table.clone(), torch.as_tensor(idx), upd,
                                    n_banks, mapping, shift)
        table[phys[keep]] = upd[keep]
        assert torch.equal(table, want)


def test_claim_workspace_is_never_made_during_a_capture(monkeypatch):
    """While the stream captures a CUDA graph, a claim workspace that is
    missing or too small is refused before anything is allocated (its zero
    fill would run only at that graph's replay, and a grown one would drop
    the workspace earlier graphs address); one already made, large enough,
    is used as it is.  Outside a capture a missing one is made zeroed, and
    a grown one keeps the one it replaces alive."""
    from repro_torch.kernels.banked_scatter import ops
    monkeypatch.setattr(ops, "_CLAIMS", {})
    monkeypatch.setattr(ops, "_RETIRED", [])
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    card = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="eagerly"):
        ops.claim_words(card, 300)
    assert not ops._CLAIMS
    made = torch.zeros(300, dtype=torch.int64)      # made eagerly before
    ops._CLAIMS[card] = made
    assert ops.claim_words(card, 300) is made
    assert ops.claim_words(card, 17) is made
    with pytest.raises(RuntimeError, match="eagerly"):
        ops.claim_words(card, 301)
    with pytest.raises(RuntimeError, match="eagerly"):
        ops.claim_words(torch.device("cuda", 1), 1)     # another card
    assert ops._CLAIMS == {card: made} and not ops._RETIRED
    capturing[0] = False
    host = torch.device("cpu")
    first = ops.claim_words(host, 6)
    assert first.dtype == torch.int64 and first.numel() == 6
    assert not first.any()
    assert ops.claim_words(host, 5) is first
    grown = ops.claim_words(host, 7)
    assert grown.numel() == 7 and not grown.any()
    assert ops._RETIRED == [first]
