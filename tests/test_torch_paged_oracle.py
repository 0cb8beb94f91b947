"""The paged KV cache's reference path in the port (``PagedKVState``,
``init_state``, ``append_token``, ``gather_kv``) held to the JAX
reference's oracle on the same numpy K/V, and the row kernels' entries
(``gather_pages`` / ``scatter_pages``, their plain versions on the CPU)
held to the port's oracle: the oracle cases of ``tests/test_paged_kv.py``.

Every comparison is bit for bit (tolerance 0): the paths copy values,
they compute nothing.  bfloat16 pools are compared through float32, which
holds every bfloat16 value exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serving import kvcache as RKV
from repro_torch import serving
from repro_torch.core import arch as A
from repro_torch.serving.kvcache import (PagedKVConfig, PagedKVState,
                                         allocate_pages, append_token,
                                         bank_load_stats, gather_kv,
                                         gather_pages, init_pages,
                                         init_state, pool_rows,
                                         scatter_pages)

CFG = PagedKVConfig(n_pages=64, page_len=4, n_banks=8, kv_heads=2, head_dim=4)
R_CFG = RKV.PagedKVConfig(n_pages=64, page_len=4, n_banks=8, kv_heads=2,
                          head_dim=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's host work on one thread (see
    ``_torch_train_parity.one_torch_thread``): the smoke models run many
    small ops, and under parallel test workers a thread pool per worker
    waits at every op for cores the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    """A torch or JAX array as float32 / int64 numpy (exact for bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.is_floating_point() else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or str(
        x.dtype) == "bfloat16" else x


def _states_equal(got: PagedKVState, want):
    np.testing.assert_array_equal(_np(got.k_pool), _np(want.k_pool))
    np.testing.assert_array_equal(_np(got.v_pool), _np(want.v_pool))
    for f in ("page_table", "seq_lens", "bank_used"):
        np.testing.assert_array_equal(_np(getattr(got.pages, f)),
                                      np.asarray(getattr(want.pages, f)))


def _run_both(cfg, r_cfg, b, steps, max_seq, seed, p_dtype=torch.float32,
              r_dtype=jnp.float32, scale=(1.0, 2.0)):
    """The same numpy K/V appended ``steps`` times by both oracles."""
    state = init_state(cfg, batch=b, max_seq=max_seq, dtype=p_dtype,
                       device="cpu")
    r_state = RKV.init_state(r_cfg, batch=b, max_seq=max_seq, dtype=r_dtype)
    ks = np.random.default_rng(seed).standard_normal(
        (steps, b, cfg.kv_heads, cfg.head_dim)).astype(np.float32)
    for t in range(steps):
        state = append_token(cfg, state, torch.from_numpy(ks[t] * scale[0]),
                             torch.from_numpy(ks[t] * scale[1]))
        r_state = RKV.append_token(r_cfg, r_state,
                                   jnp.asarray(ks[t] * scale[0]),
                                   jnp.asarray(ks[t] * scale[1]))
    _states_equal(state, r_state)
    return state, r_state, ks


def test_exported_as_the_reference_exports():
    import repro.serving as RSV
    for name in ("PagedKVState", "init_state", "append_token", "gather_kv"):
        assert name in serving.__all__ and name in RSV.__all__
        assert getattr(serving, name) is getattr(
            __import__("repro_torch.serving.kvcache",
                       fromlist=[name]), name)


def test_init_state_shapes_and_default_dtype():
    state = init_state(CFG, batch=3, max_seq=16, device="cpu")
    want = RKV.init_state(R_CFG, batch=3, max_seq=16)
    assert state.k_pool.dtype == torch.bfloat16
    assert tuple(state.k_pool.shape) == want.k_pool.shape
    _states_equal(state, want)


def test_append_gather_roundtrip():
    b, steps = 3, 10
    state, r_state, ks = _run_both(CFG, R_CFG, b, steps, 32, seed=0)
    k, v, valid = gather_kv(CFG, state, max_seq=16)
    r_k, r_v, r_valid = RKV.gather_kv(R_CFG, r_state, max_seq=16)
    assert tuple(k.shape) == (b, 16, CFG.kv_heads, CFG.head_dim)
    np.testing.assert_array_equal(valid[:, :steps].numpy(), True)
    np.testing.assert_array_equal(valid[:, steps:].numpy(), False)
    want = np.moveaxis(ks, 0, 1)
    np.testing.assert_array_equal(k[:, :steps].numpy(), want)
    np.testing.assert_array_equal(v[:, :steps].numpy(), want * 2)
    for got, ref in ((k, r_k), (v, r_v), (valid, r_valid)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bf16_pools_equal_the_reference():
    """The default pool dtype: appends cast to bfloat16 as the reference
    casts them; the gathered K/V are the reference's bit for bit."""
    state, r_state, _ = _run_both(CFG, R_CFG, 4, 13, 32, seed=8,
                                  p_dtype=torch.bfloat16,
                                  r_dtype=jnp.bfloat16, scale=(3.0, -1.0))
    for got, ref in zip(gather_kv(CFG, state, 24),
                        RKV.gather_kv(R_CFG, r_state, 24)):
        np.testing.assert_array_equal(_np(got), _np(ref))


def test_allocation_spreads_across_banks():
    b = 16
    pages = init_pages(CFG, batch=b, max_seq=32, device="cpu")
    pages, ids = allocate_pages(CFG, pages, torch.ones((b,), dtype=bool))
    r_pages, r_ids = RKV.allocate_pages(
        R_CFG, RKV.init_pages(R_CFG, batch=b, max_seq=32),
        jnp.ones((b,), bool))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    assert int((ids >= 0).sum()) == b
    assert len(set(ids.tolist())) == b
    assert float(bank_load_stats(pages)["max"]) <= CFG.pages_per_bank


def test_page_table_unique_physical_pages():
    b = 4
    state, _, _ = _run_both(CFG, R_CFG, b, 24, 32, seed=1)
    pt = state.pages.page_table.numpy()
    mapped = pt[pt >= 0]
    assert len(mapped) == 4 * 6
    assert len(set(mapped.tolist())) == len(mapped)
    assert float(bank_load_stats(state)["serialization"]) <= 1.5


@given(st.integers(1, 12), st.integers(1, 20))
@settings(max_examples=15, deadline=None, database=None)
def test_property_no_aliasing(batch, steps):
    """The port's oracle alone, as the reference's property test holds its
    own (the cases above compare the two)."""
    cfg = PagedKVConfig(n_pages=128, page_len=2, n_banks=8, kv_heads=1,
                        head_dim=2)
    state = init_state(cfg, batch=batch, max_seq=64, device="cpu")
    for _ in range(steps):
        k = torch.zeros((batch, 1, 2))
        state = append_token(cfg, state, k, k)
    pt = state.pages.page_table.numpy()
    mapped = pt[pt >= 0]
    assert len(set(mapped.tolist())) == len(mapped)
    assert int(state.pages.bank_used.sum()) == len(mapped)


def test_from_arch_pool_allocates_and_roundtrips():
    kw = dict(n_pages=64, page_len=4, kv_heads=2, head_dim=4)
    cfg = PagedKVConfig.from_arch("8B", **kw)
    state = init_state(cfg, batch=4, max_seq=16, dtype=torch.float32,
                       device="cpu")
    k = torch.ones((4, 2, 4))
    for _ in range(6):
        state = append_token(cfg, state, k, k * 3)
    got_k, got_v, valid = gather_kv(cfg, state, max_seq=8)
    np.testing.assert_array_equal(got_k[:, :6].numpy(), 1.0)
    np.testing.assert_array_equal(got_v[:, :6].numpy(), 3.0)
    np.testing.assert_array_equal(valid[:, :6].numpy(), True)
    np.testing.assert_array_equal(valid[:, 6:].numpy(), False)


def test_append_leaves_the_input_state_unchanged():
    state = init_state(CFG, batch=2, max_seq=16, dtype=torch.float32,
                       device="cpu")
    k = torch.ones((2, 2, 4))
    new = append_token(CFG, state, k, k)
    assert float(state.k_pool.abs().sum()) == 0.0
    assert int(state.pages.seq_lens.sum()) == 0
    assert int(new.pages.seq_lens.sum()) == 2


@pytest.mark.parametrize("arch_name", ["8B-xor", "16B-offset", "4B"])
def test_kernel_gather_matches_reference_bitexact(arch_name):
    """``gather_pages`` on the bank-major 2-D view of the oracle's pool
    returns the oracle's page lines, across page boundaries and for every
    bank map; and both equal the JAX reference's."""
    a = A.get(arch_name)
    kw = dict(n_pages=32, page_len=4, kv_heads=2, head_dim=4)
    cfg = PagedKVConfig.from_arch(a, **kw)
    r_cfg = RKV.PagedKVConfig.from_arch(arch_name, **kw)
    state, r_state, _ = _run_both(cfg, r_cfg, 3, 11, 24, seed=7,
                                  scale=(1.0, 1.5))
    ref_k, ref_v, _ = gather_kv(cfg, state, max_seq=12)
    ids = state.pages.page_table[:, :3].clamp(min=0).reshape(-1)
    got_k = gather_pages(a, cfg, pool_rows(state.k_pool), ids)
    got_v = gather_pages(a, cfg, pool_rows(state.v_pool), ids)
    np.testing.assert_array_equal(got_k.reshape(3, 12, 2, 4).numpy(),
                                  ref_k.numpy())
    np.testing.assert_array_equal(got_v.reshape(3, 12, 2, 4).numpy(),
                                  ref_v.numpy())
    r_k, r_v, _ = RKV.gather_kv(r_cfg, r_state, max_seq=12)
    np.testing.assert_array_equal(ref_k.numpy(), np.asarray(r_k))
    np.testing.assert_array_equal(ref_v.numpy(), np.asarray(r_v))


def test_kernel_scatter_then_gather_roundtrip():
    a = A.get("8B-offset")
    cfg = PagedKVConfig.from_arch(a, n_pages=16, page_len=2, kv_heads=1,
                                  head_dim=4)
    pages = init_pages(cfg, batch=4, max_seq=8, device="cpu")
    pages, ids = allocate_pages(cfg, pages, torch.ones((4,), dtype=bool))
    rows = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, cfg.row_width)).astype(np.float32))
    pool = torch.zeros((cfg.n_pages, cfg.row_width))
    pool = scatter_pages(a, cfg, pool, ids, rows)
    np.testing.assert_array_equal(gather_pages(a, cfg, pool, ids).numpy(),
                                  rows.numpy())


def test_kernel_scatter_writes_the_oracle_pool():
    """Appending through ``scatter_pages`` (one page line a sequence, on
    the 2-D view) leaves the pool the oracle's ``append_token`` leaves:
    the kernel's write path against the oracle's, bit for bit."""
    a = A.get("16B")
    cfg = PagedKVConfig.from_arch(a, n_pages=32, page_len=2, kv_heads=1,
                                  head_dim=4)
    state, _, ks = _run_both(cfg, RKV.PagedKVConfig.from_arch(
        "16B", n_pages=32, page_len=2, kv_heads=1, head_dim=4), 3, 6, 8,
        seed=9)
    pool = torch.zeros((cfg.n_pages, cfg.row_width))
    pt = state.pages.page_table
    for p in range(3):                         # each page's two tokens
        lines = torch.from_numpy(np.moveaxis(ks[2 * p:2 * p + 2], 0, 1)
                                 ).reshape(3, -1)
        pool = scatter_pages(a, cfg, pool, pt[:, p].contiguous(), lines)
    np.testing.assert_array_equal(pool.numpy(),
                                  pool_rows(state.k_pool).numpy())


def test_pool_rows_is_a_view():
    state = init_state(CFG, batch=1, max_seq=8, dtype=torch.float32,
                       device="cpu")
    rows = pool_rows(state.k_pool)
    assert tuple(rows.shape) == (CFG.n_pages, CFG.row_width)
    assert rows.data_ptr() == state.k_pool.data_ptr()
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(RKV.pool_rows(jnp.zeros(
            (CFG.n_pages, 4, 2, 4)))))
