"""The port on the CUDA card: the hand-written kernels against their plain
PyTorch versions (bit-equal: they copy bytes), and the serving path and
the cost engine on the card against the same code on the host.  Every
test here needs a card and skips without one; the file imports no JAX, so
it runs where only the port is installed:

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
