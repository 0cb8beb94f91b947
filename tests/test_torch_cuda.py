"""The port on the CUDA card: the hand-written kernels against their plain
PyTorch versions (the row kernels and the transpose bit-equal: they copy
bytes; the controller and dispatch kernels bit-equal: integers; the FFT
pass within rtol = atol = 1e-5 per pass and 2e-3·max|X| per transform, the
reference's tolerances), one launch a call (for the dispatch, one launch
of each of its three entries a pass of experts), and the serving path, the
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
from repro_torch.kernels.banked_gather.ops import (GATHER, banked_gather,
                                                   banked_gather_plain)
from repro_torch.kernels.banked_scatter.ops import (SCATTER, banked_scatter,
                                                    banked_scatter_plain)
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
    g0, s0 = GATHER.launches, SCATTER.launches
    tokens = paged.generate(prompts, max_new_tokens=8).tokens
    assert GATHER.launches - g0 == 2 * 2 * 7
    assert SCATTER.launches - s0 == 2 * 2 * 7 + 2 * 2
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


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_fft_kernel_transform_close_to_plain_and_oracle(cuda, n):
    from repro_torch.kernels.fft_stage import (fft4096_radix4,
                                               fft_oracle_digit_reversed,
                                               fft_radix4_ref)
    from repro_torch.kernels.fft_stage.ops import STAGE
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    before = STAGE.launches
    got = fft4096_radix4(torch.from_numpy(x).to(cuda), n=n)
    passes = int(round(np.log(n) / np.log(4)))
    assert STAGE.launches == before + passes
    want = np.stack([fft_oracle_digit_reversed(x[b], 4) for b in range(2)])
    tol = 2e-3 * np.abs(want).max()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=tol)
    plain = fft_radix4_ref(torch.from_numpy(x).to(cuda), n=n)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=0, atol=tol)


def test_fft_wrapper_refuses_mixed_devices(cuda):
    from repro_torch.kernels.fft_stage.ops import fft_stage
    planes = torch.zeros((8, 4, 16), device=cuda)
    with pytest.raises(ValueError):
        fft_stage(planes, planes, torch.zeros((1, 4, 16)),
                  torch.zeros((1, 4, 16)))


def test_paper_tables_on_the_card_match_the_host(cuda):
    """Both tables priced on the card equal the host pricing; the kernel
    step launches 3 transposes (Table II) and 6 passes per radix-4
    transform, one transform per Table III workload (18)."""
    from repro_torch.bench import paper_tables as PT
    from repro_torch.kernels.banked_transpose.ops import TRANSPOSE
    from repro_torch.kernels.fft_stage.ops import STAGE
    t0, s0 = TRANSPOSE.launches, STAGE.launches
    card2, card3 = PT.table2_rows("cuda"), PT.table3_rows("cuda")
    assert (TRANSPOSE.launches - t0, STAGE.launches - s0) == (3, 18)
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
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch_kernel_bit_equal_to_plain(cuda, case):
    from repro_torch.kernels.moe_dispatch.ops import (DISPATCH,
                                                      EXPERT_CHUNK, HIST,
                                                      RANK, SCAN,
                                                      moe_dispatch_plain,
                                                      moe_dispatch_positions)
    r, lo, hi, n_experts, cap = DISPATCH_CASES[case]
    ids = torch.as_tensor(np.random.default_rng(2).integers(lo, hi, r),
                          device=cuda)
    before = [e.launches for e in (HIST, SCAN, RANK, DISPATCH)]
    got = moe_dispatch_positions(ids, n_experts, cap)
    # histogram, scan and rank per pass of up to 1024 experts; the rank
    # launch alone with no experts
    passes = -(-n_experts // EXPERT_CHUNK)
    ran = [e.launches - b
           for e, b in zip((HIST, SCAN, RANK, DISPATCH), before)]
    assert ran == [passes, passes, max(passes, 1), 2 * passes +
                   max(passes, 1)]
    want = moe_dispatch_plain(ids, n_experts, cap)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if case == "block_boundary":
        assert got[0].tolist() == list(range(r))


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
    from repro_torch.kernels.fft_stage.ops import STAGE
    from repro_torch.kernels.moe_dispatch.ops import DISPATCH
    entries = (GATHER, POPCOUNT, ARBITER, DISPATCH, STAGE, TRANSPOSE)
    before = [e.launches for e in entries]
    rows = KB.main([])
    assert [r["name"] for r in rows] == [
        "banked_gather_1024x512_r256", "conflict_popcount_4096ops",
        "carry_arbiter_1024ops", "moe_dispatch_8192req_e16",
        "fft4096_radix4_b4", "banked_transpose_512"]
    assert all(r["err"] == 0 and r["device_us"] > 0 for r in rows)
    assert all(e.launches > b for e, b in zip(entries, before))
