"""The port's paged-KV pool bookkeeping (repro_torch.serving.kvcache) held
to the JAX reference: the arbiter allocator under both preferred-bank
policies, including capacity spill, the occupancy statistics, and the
registry's streamed kernel traces."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cost_engine import cost_many as r_cost_many
from repro.kernels import registry as r_registry
from repro.serving import kvcache as RKV
from repro_torch.core.cost_engine import cost_many
from repro_torch.kernels import registry
from repro_torch.serving import kvcache as PKV


def _cfgs(arch, n_pages, page_len=4):
    kw = dict(n_pages=n_pages, page_len=page_len, kv_heads=1, head_dim=1)
    return PKV.PagedKVConfig.from_arch(arch, **kw), RKV.PagedKVConfig.from_arch(
        arch, **kw)


@pytest.mark.parametrize("policy", ["paper", "seq-skew"])
@pytest.mark.parametrize("arch,n_pages", [("16B", 64), ("8B-xor", 24),
                                          ("12B", 36), ("4B-offset", 16)])
def test_allocate_pages_bit_equal_including_spill(arch, n_pages, policy):
    """A ragged allocation schedule on a pool small enough that banks
    fill and requests spill to the least-loaded banks, then run dry."""
    pc, rc = _cfgs(arch, n_pages)
    batch, max_seq = 6, 48
    ps = PKV.init_pages(pc, batch, max_seq, device="cpu")
    rs = RKV.init_pages(rc, batch, max_seq)
    rng = np.random.default_rng(n_pages)
    for step in range(12):
        need = rng.random(batch) < 0.8
        lens = np.minimum(np.full(batch, step * pc.page_len), max_seq - 1)
        ps = ps._replace(seq_lens=torch.as_tensor(lens))
        rs = rs._replace(seq_lens=jnp.asarray(lens, jnp.int32))
        ps, pid = PKV.allocate_pages(pc, ps, torch.as_tensor(need), policy)
        rs, rid = RKV.allocate_pages(rc, rs, jnp.asarray(need), policy)
        np.testing.assert_array_equal(pid.numpy(), np.asarray(rid))
        np.testing.assert_array_equal(ps.page_table.numpy(),
                                      np.asarray(rs.page_table))
        np.testing.assert_array_equal(ps.bank_used.numpy(),
                                      np.asarray(rs.bank_used))
    assert (pid.numpy() == -1).any()          # the pool did run dry
    got, want = PKV.bank_load_stats(ps), RKV.bank_load_stats(rs)
    assert got.keys() == want.keys()
    for k in got:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)


def test_pool_sizes_and_configs_equal():
    for args in ((16, 4, 80, 8), (12, 3, 50, 4), (4, 1, 7, 8)):
        assert PKV.pool_pages(*args) == RKV.pool_pages(*args)
    p, r = _cfgs("16B-offset-s2", 64)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert p.row_width == r.row_width
    with pytest.raises(ValueError):
        PKV.PagedKVConfig.from_arch("4R-1W", n_pages=16, page_len=8)


@pytest.mark.parametrize("kernel", ["banked_gather", "banked_scatter"])
@pytest.mark.parametrize("block_ops", [1, 7, None])
def test_streamed_kernel_traces_cost_like_the_reference(kernel, block_ops):
    idx = np.random.default_rng(3).integers(0, 512, 300)
    mask = np.arange(300) % 7 != 0
    p = registry.get(kernel).trace_blocks("16B-xor", None,
                                          torch.as_tensor(idx), mask=mask,
                                          block_ops=block_ops)
    r = r_registry.get(kernel).trace_blocks("16B-xor", None, idx, mask=mask,
                                            block_ops=block_ops)
    archs = ["16B-xor", "8B", "4R-2W", "4R-1W-VB"]
    got = [dataclasses.asdict(c) for c in cost_many(archs, p, device="cpu")]
    want = [dataclasses.asdict(c) for c in r_cost_many(archs, r)]
    assert got == want
    dense = registry.get(kernel).address_trace("16B-xor", None, idx,
                                               mask=mask)
    assert dense.n_ops == 19 and dense.n_instructions == 1
