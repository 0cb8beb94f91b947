"""The port on the CUDA card: the hand-written kernels against their plain
PyTorch versions (the row kernels and the transpose bit-equal: they copy
bytes; the controller and dispatch kernels bit-equal: integers; the FFT
pass within rtol = atol = 1e-5, the reference's tolerance; the FFT
transform bit-equal to the plain passes and within 2e-3·max|X| of the
oracle), one launch a call (for the row kernels, one for both tables of a
pair, and a claim and a copy launch for a scatter of more than 256
indices; for the dispatch, one launch a pass of up to 1024 experts; for
the arbiter, one CUDA kernel in all on int32 or int64 words; for the
transform, one tile launch after log4(n / 4096) wide passes), and the
serving path, the
paper tables, the kernel micro-bench and the cost engine on the card
against the same code on the host.  Every test here needs a card and
skips without one; the file imports no JAX, so it runs where only the port
is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as PK
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import arch as PA
from repro_torch.core.cost_engine import cost_many
from repro_torch.kernels.banked_gather.ops import (GATHER, GATHER_PAIR,
                                                   GATHERS, INT32_MAX,
                                                   banked_gather,
                                                   banked_gather_pair,
                                                   banked_gather_plain,
                                                   index_bits)
from repro_torch.kernels.banked_scatter.ops import (CLAIM, CLAIMED_COPY,
                                                    SCATTER, SCATTER_PAIR,
                                                    SCATTERS, banked_scatter,
                                                    banked_scatter_pair,
                                                    banked_scatter_plain,
                                                    claim_words)
from repro_torch.kernels.banked_scatter.ref import last_writers
from repro_torch.models import init_tree, model_specs
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kvcache import simulate_serving_stream

pytestmark = pytest.mark.cuda

LAYOUTS = ["16B", "16B-offset", "16B-offset-s2", "8B-xor", "8B-fold",
           "4B-offset", "12B", "6B-offset"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", LAYOUTS)
def test_kernels_bit_equal_to_plain(cuda, arch, dtype):
    lay = PA.get(arch).layout
    v = lay.n_banks * 48
    args = (lay.n_banks, lay.mapping, lay.shift)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d in (4096, 1024, 36):
        table = torch.randn((v, d), device=cuda, generator=gen).to(dtype)
        idx = torch.randint(0, v, (40,), device=cuda, generator=gen)
        before = GATHER.launches
        assert torch.equal(banked_gather(table, idx, *args),
                           banked_gather_plain(table, idx, *args))
        assert GATHER.launches == before + 1
        idx[::3] = idx[1]                       # duplicates: last one wins
        upd = torch.randn((40, d), device=cuda, generator=gen).to(dtype)
        got = banked_scatter(table.clone(), idx, upd, *args)
        want = banked_scatter_plain(table.clone(), idx, upd, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["4R-1W", "4R-1W-VB"])
def test_multiport_runs_launch_the_kernels(cuda, arch):
    """A memory with no banked layout runs the same kernels with one bank
    (the identity map) on CUDA tensors, never the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn((96, 4096), device=cuda, generator=gen)
    idx = torch.randint(0, 96, (40,), device=cuda, generator=gen)
    idx[::3] = idx[1]
    upd = torch.randn((40, 4096), device=cuda, generator=gen)
    g0, s0 = GATHER.launches, SCATTER.launches
    got = PK.get("banked_gather").run(arch, table, idx)
    new = PK.get("banked_scatter").run(arch, table, idx, upd)
    assert (GATHER.launches - g0, SCATTER.launches - s0) == (1, 1)
    assert torch.equal(got, table[idx])
    keep = last_writers(idx, 96)
    assert torch.equal(new, table.clone().index_copy_(0, idx[keep],
                                                      upd[keep]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", LAYOUTS)
def test_pair_kernels_bit_equal_to_plain(cuda, arch, dtype):
    """The paired entries: one launch for two tables, each equal to its
    plain version; duplicates at the one-launch size (40) and at the
    claimed size (600: claim, then copy)."""
    lay = PA.get(arch).layout
    v = lay.n_banks * 48
    args = (lay.n_banks, lay.mapping, lay.shift)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for d in (4096, 1024, 36):
        k, vt = (torch.randn((v, d), device=cuda, generator=gen).to(dtype)
                 for _ in range(2))
        idx = torch.randint(0, v, (40,), device=cuda, generator=gen)
        before = GATHER_PAIR.launches
        got = banked_gather_pair(k, vt, idx, *args)
        assert GATHER_PAIR.launches == before + 1
        assert torch.equal(got[0], banked_gather_plain(k, idx, *args))
        assert torch.equal(got[1], banked_gather_plain(vt, idx, *args))
        for n, entries in ((40, [SCATTER_PAIR]), (600, [CLAIM,
                                                        CLAIMED_COPY])):
            idx = torch.randint(0, v, (n,), device=cuda, generator=gen)
            idx[::3] = idx[1]
            upd = [torch.randn((n, d), device=cuda, generator=gen).to(dtype)
                   for _ in range(2)]
            before = [e.launches for e in entries]
            got = banked_scatter_pair(k.clone(), vt.clone(), idx, *upd,
                                      *args)
            assert [e.launches - b for e, b in zip(entries, before)] == [
                1] * len(entries)
            for g, t, u in zip(got, (k, vt), upd):
                assert torch.equal(g, banked_scatter_plain(t.clone(), idx, u,
                                                           *args))


@pytest.mark.parametrize("arch", ["16B", "12B", "8B-offset-s2"])
def test_large_scatter_with_duplicates_is_linear_and_leaves_zero_claims(
        cuda, arch):
    """16384 updates into about 4096 rows (each written about four times):
    the claimed path, single and paired, equal to the plain version, and
    the workspace all zero afterwards."""
    lay = PA.get(arch).layout
    v = lay.n_banks * (4096 // lay.n_banks)
    args = (lay.n_banks, lay.mapping, lay.shift)
    gen = torch.Generator(device=cuda).manual_seed(4)
    table = torch.randn((v, 512), device=cuda, generator=gen).bfloat16()
    idx = torch.randint(0, v, (16384,), device=cuda, generator=gen)
    upd = torch.randn((16384, 512), device=cuda,
                      generator=gen).bfloat16()
    got = banked_scatter(table.clone(), idx, upd, *args)
    assert torch.equal(got, banked_scatter_plain(table.clone(), idx, upd,
                                                 *args))
    k, vt = banked_scatter_pair(table.clone(), table.clone() + 1, idx, upd,
                                upd - 1, *args)
    assert torch.equal(k, got)
    assert torch.equal(vt, banked_scatter_plain(table.clone() + 1, idx,
                                                upd - 1, *args))
    assert not claim_words(table.device, v).any()


def test_claimed_scatter_replays_in_a_cuda_graph(cuda):
    """The claimed scatter keeps no host state between calls: captured
    once in a CUDA graph, each replay writes the updates' current
    contents, last writer winning."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    table = torch.zeros((1024, 64), device=cuda)
    idx = torch.randint(0, 1024, (2048,), device=cuda, generator=gen)
    upd = torch.randn((2048, 64), device=cuda, generator=gen)
    banked_scatter(table, idx, upd)                      # warm-up, eager
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        banked_scatter(table, idx, upd)
    for step in range(3):
        upd.copy_(torch.randn((2048, 64), device=cuda, generator=gen))
        table.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(table, banked_scatter_plain(
            torch.zeros_like(table), idx, upd, 16, "lsb"))


@pytest.mark.parametrize("arch", ["16B", "12B", "6B-offset"])
def test_row_kernels_on_the_64_bit_index_path(cuda, arch):
    """A table of more than 2^31 - 1 rows (one byte each) takes the 64-bit
    index path, a table just below that limit the 32-bit one; both equal
    the plain version on rows at the ends of the table."""
    lay = PA.get(arch).layout
    args = (lay.n_banks, lay.mapping, lay.shift)
    step = lay.n_banks * 4
    for v, bits in (((INT32_MAX // step) * step, 32),
                    ((INT32_MAX // step + 2) * step, 64)):
        assert index_bits(v, 64) == bits
        table = torch.empty((v, 1), dtype=torch.uint8, device=cuda)
        table[:64] = 7
        table[-64:] = torch.arange(64, dtype=torch.uint8,
                                   device=cuda)[:, None]
        idx = torch.cat([torch.arange(32), v - 1 - torch.arange(32)]).to(
            cuda)
        got = banked_gather(table, idx, *args)
        assert torch.equal(got, banked_gather_plain(table, idx, *args))
        upd = torch.arange(64, dtype=torch.uint8, device=cuda)[:, None] + 100
        want = banked_scatter_plain(table.clone(), idx, upd, *args)
        assert torch.equal(banked_scatter(table, idx, upd, *args), want)
        del table, want
        torch.cuda.empty_cache()


def test_wrappers_refuse_mixed_devices(cuda):
    table = torch.zeros((64, 32), device=cuda)
    with pytest.raises(ValueError):
        banked_gather(table, torch.tensor([1]))
    with pytest.raises(ValueError):
        banked_scatter(table, torch.tensor([1], device=cuda),
                       torch.zeros((1, 32)))


def test_serving_on_the_card_matches_the_host(cuda):
    """Smoke-size serving on the card: paged tokens equal the dense cache's
    (float32 compute), the kernels carry the KV traffic, and the traffic
    prices the same on the card as on the host."""
    cfg = get_smoke_config("llama3.2-1b")
    rc = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
    params = init_tree(model_specs(cfg),
                       torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 12))
    kw = dict(max_batch=4, max_seq=32, page_len=8, device=cuda)
    paged = ServeEngine(cfg, rc, params, kv_mode="paged", **kw)
    GATHERS.launches = SCATTERS.launches = 0
    tokens = paged.generate(prompts, max_new_tokens=8).tokens
    # one launch per KV layer for K and V: 2 layers x 7 decode steps, and
    # the prefill ingest's one per layer
    assert GATHERS.launches == GATHER_PAIR.launches == 2 * 7
    assert SCATTERS.launches == SCATTER_PAIR.launches == 2 * 7 + 2
    dense = ServeEngine(cfg, rc, params, kv_mode="dense", **kw)
    np.testing.assert_array_equal(
        tokens, dense.generate(prompts, max_new_tokens=8).tokens)
    archs = PA.PAPER_ARCHITECTURES
    on_card = paged.serving_cost(archs=archs)
    assert on_card == cost_many(archs, paged.serving_stream(), device="cpu")
    assert on_card[3].total_cycles == 2200              # the 16B pin


def test_simulation_on_the_card_matches_the_host(cuda):
    for arch in ("16B", "16B-xor", "12B"):
        card = simulate_serving_stream(arch, 4, 16, 8, page_len=4,
                                       n_kv_layers=2, device=cuda)
        host = simulate_serving_stream(arch, 4, 16, 8, page_len=4,
                                       n_kv_layers=2, device="cpu")
        a, b = card.materialize(), host.materialize()
        np.testing.assert_array_equal(a.addrs, b.addrs)
        np.testing.assert_array_equal(a.mask, b.mask)
    assert cost_many(["16B"], simulate_serving_stream(
        "16B", 4, 16, 8, page_len=4, n_kv_layers=2, device=cuda),
        device=cuda)[0].total_cycles == 2596


# -------------------------------------------------- the paper tables' path --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_transpose_kernel_bit_equal_to_plain(cuda, dtype):
    from repro_torch.kernels.banked_transpose.ops import (TRANSPOSE,
                                                          banked_transpose)
    from repro_torch.kernels.banked_transpose.ref import banked_transpose_ref
    gen = torch.Generator(device=cuda).manual_seed(2)
    for shape in ((32, 32), (64, 64), (128, 128), (256, 512), (512, 128),
                  (16, 48)):
        x = torch.randint(-1000, 1000, shape, device=cuda,
                          generator=gen).to(dtype)
        before = TRANSPOSE.launches
        got = banked_transpose(x)
        assert TRANSPOSE.launches == before + 1
        torch.cuda.synchronize()
        assert got.is_contiguous() and got.shape == shape[::-1]
        assert torch.equal(got, banked_transpose_ref(x))


@pytest.mark.parametrize("n,p", [(4096, 0), (4096, 3), (4096, 5),
                                 (1024, 2)])
def test_fft_stage_kernel_close_to_plain(cuda, n, p):
    from repro_torch.kernels.fft_stage.ops import (STAGE, fft_stage_radix4,
                                                   stage_twiddles)
    from repro_torch.kernels.fft_stage.ref import fft_stage_ref
    gen = torch.Generator(device=cuda).manual_seed(p)
    xr = torch.randn((2, n), device=cuda, generator=gen)
    xi = torch.randn((2, n), device=cuda, generator=gen)
    before = STAGE.launches
    got = fft_stage_radix4(xr, xi, n, p)
    assert STAGE.launches == before + 1
    sub = n // 4 ** (p + 1)
    twr, twi = stage_twiddles(n, p, xr.device)
    want = fft_stage_ref(xr.reshape(-1, 4, sub), xi.reshape(-1, 4, sub),
                         twr, twi)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.reshape(2, n), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", [4, 16, 256, 1024, 4096, 16384, 65536])
def test_fft_kernel_transform_close_to_plain_and_oracle(cuda, n, batch):
    """The transform on the card: bit-equal to the plain passes (torch.equal)
    and within 2e-3·max|X| of the numpy oracle, in one tile launch after
    log4(n / 4096) wide passes (none for n <= 4096), and no planar pass."""
    from repro_torch.kernels.fft_stage import (fft4096_radix4,
                                               fft_oracle_digit_reversed,
                                               fft_radix4_ref)
    from repro_torch.kernels.fft_stage.ops import STAGE, TRANSFORM, WIDE_PASS
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal(
        (batch, n))).astype(np.complex64)
    before = [e.launches for e in (TRANSFORM, WIDE_PASS, STAGE)]
    got = fft4096_radix4(torch.from_numpy(x).to(cuda), n=n)
    ran = [e.launches - b
           for e, b in zip((TRANSFORM, WIDE_PASS, STAGE), before)]
    passes = int(round(np.log(n) / np.log(4)))
    assert ran == [1, max(0, passes - 6), 0]
    plain = fft_radix4_ref(torch.from_numpy(x).to(cuda), n=n)
    torch.cuda.synchronize()
    assert got.dtype == torch.complex64 and torch.equal(got, plain)
    want = np.stack([fft_oracle_digit_reversed(x[b], 4)
                     for b in range(batch)])
    tol = 2e-3 * np.abs(want).max()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=tol)


def test_fft_kernel_transform_takes_strided_and_conjugate_views(cuda):
    from repro_torch.kernels.fft_stage import fft4096_radix4, fft_radix4_ref
    gen = torch.Generator(device=cuda).manual_seed(9)
    wide = torch.complex(torch.randn((6, 8192), device=cuda, generator=gen),
                         torch.randn((6, 8192), device=cuda, generator=gen))
    for x in (wide[::2, 4096:], wide[:3, :4096].conj()):
        assert torch.equal(fft4096_radix4(x), fft_radix4_ref(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
def test_fft_kernel_transform_takes_real_and_complex128_input(cuda, dtype):
    """Real and complex128 input is cast to complex64 before the launch,
    as the reference casts it: one tile launch, equal to the transform of
    the cast input and to the plain passes."""
    from repro_torch.kernels.fft_stage import fft4096_radix4, fft_radix4_ref
    from repro_torch.kernels.fft_stage.ops import TRANSFORM
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((3, 4096), device=cuda, generator=gen,
                    dtype=torch.float64)
    x = (torch.complex(x, x.flip(1)) if dtype.is_complex else x).to(dtype)
    before = TRANSFORM.launches
    got = fft4096_radix4(x)
    assert TRANSFORM.launches == before + 1
    assert got.dtype == torch.complex64
    assert torch.equal(got, fft4096_radix4(x.to(torch.complex64)))
    assert torch.equal(got, fft_radix4_ref(x))


def test_fft_wrapper_refuses_mixed_devices(cuda):
    from repro_torch.kernels.fft_stage.ops import fft_stage
    planes = torch.zeros((8, 4, 16), device=cuda)
    with pytest.raises(ValueError):
        fft_stage(planes, planes, torch.zeros((1, 4, 16)),
                  torch.zeros((1, 4, 16)))


def test_paper_tables_on_the_card_match_the_host(cuda):
    """Both tables priced on the card equal the host pricing; the kernel
    step launches 3 transposes (Table II) and one transform launch per
    Table III workload (3), and no planar pass."""
    from repro_torch.bench import paper_tables as PT
    from repro_torch.kernels.banked_transpose.ops import TRANSPOSE
    from repro_torch.kernels.fft_stage.ops import STAGE, TRANSFORM
    entries = (TRANSPOSE, TRANSFORM, STAGE)
    before = [e.launches for e in entries]
    card2, card3 = PT.table2_rows("cuda"), PT.table3_rows("cuda")
    assert [e.launches - b for e, b in zip(entries, before)] == [3, 3, 0]
    host2, host3 = PT.table2_rows("cpu"), PT.table3_rows("cpu")
    for card, host in ((card2, host2), (card3, host3)):
        for c, h in zip(card, host):
            assert {k: v for k, v in c.items() if k != "kernel_err"} == {
                k: v for k, v in h.items() if k != "kernel_err"}
    assert all(r["kernel_err"] == 0.0 for r in card2)
    assert all(r["kernel_err"] <= 2e-3 for r in card3)
    totals = {r["name"]: r["total"] for r in card2 + card3}
    assert [totals[k] for k in ("transpose32_16B", "transpose64_16B",
                                "transpose128_16B", "fft4096r4_16B")] == [
        1613, 5791, 26087, 64216]


# ------------------------------------------------ the controller kernels --

POPCOUNT_CASES = {
    "sweep_8_b4": ((8, 16), 0, 4, 4), "sweep_256_b8": ((256, 16), 0, 8, 8),
    "sweep_1024_b16": ((1024, 16), 0, 16, 16),
    "ids_out_of_range_b32": ((256, 16), -4, 36, 32),
    "b12": ((512, 16), 0, 12, 12), "b6": ((256, 16), -1, 8, 6),
    "lanes12": ((8, 12), 0, 16, 16), "lanes40": ((8, 40), 0, 16, 16),
}


@pytest.mark.parametrize("case", list(POPCOUNT_CASES))
def test_popcount_kernel_bit_equal_to_plain(cuda, case):
    from repro_torch.kernels.conflict_popcount.ops import (
        POPCOUNT, conflict_popcount, conflict_popcount_plain)
    shape, lo, hi, n_banks = POPCOUNT_CASES[case]
    banks = torch.as_tensor(np.random.default_rng(0).integers(lo, hi, shape),
                            device=cuda)
    before = POPCOUNT.launches
    got = conflict_popcount(banks, n_banks)
    assert POPCOUNT.launches == before + 1
    want = conflict_popcount_plain(banks, n_banks)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g, w)


def test_popcount_kernel_reads_unaligned_rows(cuda):
    from repro_torch.kernels.conflict_popcount.ops import (
        conflict_popcount, conflict_popcount_plain)
    flat = torch.randint(0, 16, (16 * 8 + 1,), dtype=torch.int32,
                         device=cuda)
    banks = flat[1:].view(8, 16)               # rows 4 bytes off 16-byte
    for g, w in zip(conflict_popcount(banks), conflict_popcount_plain(banks)):
        assert torch.equal(g, w)


ARBITER_CASES = {
    "sweep_8_16": ((8, 16), 2 ** 16), "sweep_128_16": ((128, 16), 2 ** 16),
    "sweep_256_8": ((256, 8), 2 ** 16), "words_32bit": ((128, 16), 2 ** 32),
    "ops384_b6": ((384, 6), 2 ** 16),
}


@pytest.mark.parametrize("case", list(ARBITER_CASES))
def test_arbiter_kernel_bit_equal_to_plain(cuda, case):
    from repro_torch.kernels.carry_arbiter.ops import (ARBITER,
                                                       carry_arbiter,
                                                       carry_arbiter_plain)
    shape, hi = ARBITER_CASES[case]
    reqs = torch.as_tensor(np.random.default_rng(1).integers(0, hi, shape),
                           device=cuda)
    before = ARBITER.launches
    got = carry_arbiter(reqs)
    assert ARBITER.launches == before + 1
    want = carry_arbiter_plain(reqs)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_arbiter_kernel_drains_and_takes_int32_words(cuda):
    from repro_torch.kernels.carry_arbiter.ops import carry_arbiter
    drain = torch.zeros((8, 16), dtype=torch.int64, device=cuda)
    drain[:, 0] = 0xFFFF
    assert carry_arbiter(drain)[0, :, 0].tolist() == [1 << c
                                                       for c in range(16)]
    full = torch.full((4, 12), -1, dtype=torch.int32, device=cuda)
    assert carry_arbiter(full)[3, :, 11].tolist() == [1 << c
                                                      for c in range(16)]


def _cuda_kernels(fn, tries: int = 3) -> list[str]:
    """The names of the CUDA kernels one call of ``fn`` runs, by
    torch.profiler (it sees torch's own conversion kernels too), after a
    warm-up call: the session brackets the call between two ``fill_``
    marker kernels and keeps what lies between.  A short session now and
    then records no CUDA event at all; one that lacks its markers is
    taken again."""
    from torch.profiler import ProfilerActivity, profile
    mark = torch.zeros(1, device="cuda")
    fn()                                         # warm: workspaces, builds
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mark.fill_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            mark.fill_(2)
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        # the two markers are the first and the last kernel
        if len(kernels) >= 2 and kernels[0].name == kernels[-1].name:
            return [e.name for e in kernels[1:-1]]
    raise AssertionError("torch.profiler recorded no marker kernels")


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_arbiter_call_runs_one_cuda_kernel(cuda, dtype):
    from repro_torch.kernels.carry_arbiter.ops import (carry_arbiter,
                                                       carry_arbiter_plain)
    reqs = torch.as_tensor(np.random.default_rng(3).integers(
        -2 ** 40, 2 ** 40, (1024, 16)), device=cuda).to(dtype)
    names = _cuda_kernels(lambda: carry_arbiter(reqs))
    assert len(names) == 1 and "arbiter" in names[0], names
    assert torch.equal(carry_arbiter(reqs), carry_arbiter_plain(reqs))


@pytest.mark.parametrize("out_dtype", [torch.int64, torch.int32])
def test_arbiter_bulk_stores_bit_equal_on_wide_words(cuda, out_dtype):
    """The kernel's bulk stores, on int64 words with high bits set and
    negative words (the low 32 bits count) and int32 words, odd bank
    counts, rows of more than 32 KB (written in 32 KB chunks, one of them
    ending inside a cycle's banks), and int64 or 32-bit grants out."""
    from repro_torch.kernels.carry_arbiter.ops import (arbiter_launch,
                                                       carry_arbiter_plain)
    rng = np.random.default_rng(4)
    for shape in ((256, 16), (128, 12), (3, 5), (128, 300), (2, 4100)):
        reqs = torch.as_tensor(rng.integers(-2 ** 40, 2 ** 40, shape),
                               device=cuda)
        reqs[0, :4] = torch.tensor([-1, -2 ** 31, 2 ** 32 + 5, 2 ** 63 - 1])
        want = carry_arbiter_plain(reqs)
        for words in (reqs, reqs.to(torch.int32)):
            got = arbiter_launch(words, out_dtype)
            assert got.dtype == out_dtype
            if out_dtype == torch.int32:            # the uint32 patterns
                got = got.view(torch.uint32).to(torch.int64)
            assert torch.equal(got, want)


# -------------------------------------------------- the dispatch kernel --

DISPATCH_CASES = {
    # (R, ids in [lo, hi), n_experts, capacity)
    "sweep_512_e16": (512, 0, 16, 16, 40),
    "sweep_1024_e8": (1024, 0, 8, 8, 100),
    "sweep_2048_e16": (2048, 0, 16, 16, 16),
    "block_boundary": (1536, 0, 1, 4, 1000),
    "r300": (300, 0, 16, 16, 20),
    "one_expert": (1024, 0, 1, 1, 700),
    "e256": (2048, 0, 256, 256, 10),
    "out_of_range": (512, -4, 20, 16, 5),
    "capacity_0": (512, 0, 8, 8, 0),
    "capacity_above_r": (1024, 0, 8, 8, 5000),
    "no_experts": (100, -2, 3, 0, 1),
    # three passes of up to 1024 experts, the last one ragged
    "e3000": (8192, -3, 3003, 3000, 3),
    "r2_20_e128": (1 << 20, 0, 128, 128, 1 << 13),
    # the two ranking paths' boundary: 32 experts in lane columns (more
    # than 48 KB of shared memory), 33 by ballots along rows
    "e32": (3 * 8192, 0, 32, 32, 500),
    "e33_ids_outside": (33 * 512, -2, 36, 33, 100),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch_kernel_bit_equal_to_plain(cuda, case):
    from repro_torch.kernels.moe_dispatch.ops import (DISPATCH,
                                                      EXPERT_CHUNK,
                                                      moe_dispatch_plain,
                                                      moe_dispatch_positions)
    r, lo, hi, n_experts, cap = DISPATCH_CASES[case]
    ids = torch.as_tensor(np.random.default_rng(2).integers(lo, hi, r),
                          device=cuda)
    before = DISPATCH.launches
    got = moe_dispatch_positions(ids, n_experts, cap)
    # one launch a pass of up to 1024 experts; one with no experts
    assert DISPATCH.launches - before == max(-(-n_experts // EXPERT_CHUNK),
                                             1)
    want = moe_dispatch_plain(ids, n_experts, cap)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(moe_dispatch_positions(ids.to(torch.int32),
                                              n_experts, cap)[0], want[0])
    if case == "block_boundary":
        assert got[0].tolist() == list(range(r))


def test_dispatch_call_runs_one_cuda_kernel(cuda):
    from repro_torch.kernels.moe_dispatch.ops import moe_dispatch_positions
    for dtype in (torch.int32, torch.int64):
        ids = torch.randint(0, 16, (8192,), device=cuda, dtype=dtype)
        names = _cuda_kernels(lambda: moe_dispatch_positions(ids, 16, 1024))
        assert len(names) == 1 and "dispatch_scan" in names[0], names


def test_dispatch_replays_in_a_cuda_graph(cuda):
    """Captured once on a side stream (after an eager call there, which
    makes that stream's workspace), replayed 5 times with eager calls of
    other shapes in between (on the default stream's workspace) and new
    ids copied in before each replay: bit-equal to the plain version every
    time."""
    from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                      moe_dispatch_positions)
    gen = torch.Generator(device=cuda).manual_seed(6)
    ids = torch.randint(0, 128, (1 << 20,), device=cuda, generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_dispatch_positions(ids, 128, 5000)            # warm-up, eager
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        pos, kept = moe_dispatch_positions(ids, 128, 5000)
    for step in range(5):
        ids.copy_(torch.randint(0, 128, ids.shape, device=cuda,
                                generator=gen))
        graph.replay()
        other = torch.randint(-2, 20, (8192,), device=cuda, generator=gen)
        got = moe_dispatch_positions(other, 16, 300)
        want = moe_dispatch_plain(ids, 128, 5000)
        torch.cuda.synchronize()
        assert torch.equal(pos, want[0]) and torch.equal(kept, want[1])
        for g, w in zip(got, moe_dispatch_plain(other, 16, 300)):
            assert torch.equal(g, w)


def test_dispatch_graphs_replay_in_any_order(cuda):
    """Two graphs captured on one stream share its workspace, made eagerly
    before either capture: replaying the second before the first has ever
    run, then the first, then the second again, each is bit-equal."""
    from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                      moe_dispatch_positions)
    gen = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randint(0, 16, (1 << 18,), device=cuda, generator=gen)
    b = torch.randint(-2, 40, (3 * 8192,), device=cuda, generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_dispatch_positions(a, 40, 9000)               # warm-up, eager
    torch.cuda.current_stream().wait_stream(side)
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    with torch.cuda.graph(graphs[0], stream=side):
        first = moe_dispatch_positions(a, 16, 9000)
    with torch.cuda.graph(graphs[1], stream=side):
        second = moe_dispatch_positions(b, 37, 300)
    want = {0: moe_dispatch_plain(a, 16, 9000),
            1: moe_dispatch_plain(b, 37, 300)}
    for g in (1, 0, 1):
        graphs[g].replay()
        torch.cuda.synchronize()
        for got, w in zip((first, second)[g], want[g]):
            assert torch.equal(got, w)


def test_dispatch_refuses_a_first_call_during_a_capture(cuda):
    """On a stream with no workspace yet, a call inside a capture is
    refused before it launches or allocates anything."""
    from repro_torch.kernels.moe_dispatch.ops import moe_dispatch_positions
    ids = torch.randint(0, 16, (8192,), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with pytest.raises(RuntimeError, match="eagerly"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            moe_dispatch_positions(ids, 16, 100)


def test_dispatch_across_the_epoch_wrap(cuda):
    """The epoch set just below its wrap and stale words under the tags
    that follow it: three passes of experts (tags 2^31 - 2, 2^31 - 1, then
    1 after the last block has zeroed the status words) and the calls
    after it stay bit-equal."""
    from repro_torch.kernels.moe_dispatch import ops
    gen = torch.Generator(device=cuda).manual_seed(7)
    small = torch.randint(0, 16, (4096,), device=cuda, generator=gen)
    big = torch.randint(-3, 3003, (1 << 16,), device=cuda, generator=gen)
    ops.moe_dispatch_positions(big, 3000, 20)    # the workspace, this size
    from repro_torch.kernels.cuda_lib import current_stream
    ws = ops.workspace(big.device, current_stream(),
                       ops.workspace_words(1 << 16, 3000))
    stale = torch.tensor([ops.pack_status(t, True, 12345)
                          for t in (1, 2, 3)], device=cuda)
    ws[ops.HEADER_WORDS:] = stale[torch.randint(
        0, 3, (ws.numel() - ops.HEADER_WORDS,), device=cuda, generator=gen)]
    ws[1] = ops.TAG_LIMIT - 2                    # epoch; next tag LIMIT - 1
    for ids, e, cap in ((small, 16, 100), (big, 3000, 20), (small, 16, 7),
                        (big, 3000, 20)):
        got = ops.moe_dispatch_positions(ids, e, cap)
        want = ops.moe_dispatch_plain(ids, e, cap)
        torch.cuda.synchronize()
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
    # tags LIMIT - 1; LIMIT, (wrap) 1, 2; 3; 4, 5, 6: the epoch ends at 6
    head = ws[:ops.HEADER_WORDS].view(torch.int32).tolist()
    assert head[:3] == [0, 0, 6], head


def test_dispatch_wrapper_refuses_what_the_reference_refuses(cuda):
    from repro_torch.kernels.moe_dispatch.ops import moe_dispatch_positions
    for shape, e, cap in (((600,), 16, 8), ((4, 4), 16, 8),
                          ((512,), -1, 8), ((512,), 16, 2 ** 31)):
        with pytest.raises(ValueError):
            moe_dispatch_positions(torch.zeros(shape, dtype=torch.int32,
                                               device=cuda), e, cap)


def test_dispatch_stream_priced_on_the_card_matches_the_host(cuda):
    """``Kernel.cost_cycles`` prices the dispatch stream on the card (its
    default) as on the host, on three memories."""
    ids = np.random.default_rng(11).integers(0, 512, 1000) % 16
    k = PK.get("moe_dispatch")
    for arch in ("16B", "4R-2W", "16B-offset"):
        assert k.cost_cycles(arch, ids, 16, 64) == k.cost_cycles(
            arch, ids, 16, 64, device="cpu")


def test_kernel_bench_cli_on_the_card(cuda):
    """``python -m repro_torch.bench.kernel_bench`` on the card: the six
    rows, each bit-equal to its plain version, each row's kernel
    launched."""
    from repro_torch.bench import kernel_bench as KB
    from repro_torch.kernels.banked_transpose.ops import TRANSPOSE
    from repro_torch.kernels.carry_arbiter.ops import ARBITER
    from repro_torch.kernels.conflict_popcount.ops import POPCOUNT
    from repro_torch.kernels.fft_stage.ops import TRANSFORM
    from repro_torch.kernels.moe_dispatch.ops import DISPATCH
    entries = (GATHER, POPCOUNT, ARBITER, DISPATCH, TRANSFORM, TRANSPOSE)
    before = [e.launches for e in entries]
    rows = KB.main([])
    assert [r["name"] for r in rows] == [
        "banked_gather_1024x512_r256", "conflict_popcount_4096ops",
        "carry_arbiter_1024ops", "moe_dispatch_8192req_e16",
        "fft4096_radix4_b4", "banked_transpose_512"]
    assert all(r["err"] == 0 and r["device_us"] > 0 for r in rows)
    assert all(e.launches > b for e, b in zip(entries, before))
