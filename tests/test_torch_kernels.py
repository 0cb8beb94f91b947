"""The port's banked_gather / banked_scatter held to the JAX reference's
Pallas kernels (run as the reference's own tests run them, interpret=True):
the plain PyTorch versions the wrappers take on CPU tensors are bit-equal
over bank maps, f32 and bf16, narrow and 512-multiple rows, duplicate
scatter indices, and the persistent bank-major pool mode.  The CUDA
kernels themselves are held to the plain versions by the ``cuda`` tests
of test_torch_cuda.py (and by chip_smoke.py) on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as rk
from repro_torch import kernels as pk
from repro_torch.core import arch as PA
from repro_torch.kernels.banked_gather.ops import banked_gather
from repro_torch.kernels.banked_scatter.ops import banked_scatter

ARCHS = ["16B", "16B-offset", "8B-xor", "8B-fold", "4B-offset", "12B"]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(v, d, n, dtype, seed):
    """f32 values exactly representable in the dtype, made with numpy."""
    rng = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dtype]
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    table = table.to(tdt)
    idx = rng.integers(0, v, n)
    return table, idx, tdt, jdt


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [64, 1024])
@pytest.mark.parametrize("arch", ARCHS)
def test_gather_bit_equal_to_pallas(arch, d, dtype):
    v = PA.get(arch).layout.n_banks * 16
    table, idx, tdt, jdt = _inputs(v, d, 32, dtype, seed=len(arch) + d)
    jt = jnp.asarray(table.float().numpy()).astype(jdt)
    for banked in (False, True):
        want = rk.get("banked_gather").run(arch, jt, jnp.asarray(idx),
                                           table_banked=banked,
                                           interpret=True)
        got = pk.get("banked_gather").run(arch, table, torch.as_tensor(idx),
                                          table_banked=banked)
        assert got.dtype == tdt
        np.testing.assert_array_equal(_np32(got), _np32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [64, 1024])
@pytest.mark.parametrize("arch", ARCHS)
def test_scatter_bit_equal_to_pallas_with_duplicates(arch, d, dtype):
    """Duplicates resolve last-writer-wins in index order, as the Pallas
    grid does; untouched rows keep their contents."""
    v = PA.get(arch).layout.n_banks * 16
    table, idx, tdt, jdt = _inputs(v, d, 24, dtype, seed=3 * d + len(arch))
    idx[::3] = idx[1]
    upd = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (24, d)).astype(np.float32)).to(tdt)
    jt = jnp.asarray(table.float().numpy()).astype(jdt)
    ju = jnp.asarray(upd.float().numpy()).astype(jdt)
    for banked in (False, True):
        want = rk.get("banked_scatter").run(arch, jt, jnp.asarray(idx), ju,
                                            table_banked=banked,
                                            interpret=True)
        got = pk.get("banked_scatter").run(arch, table.clone(),
                                           torch.as_tensor(idx), upd,
                                           table_banked=banked)
        np.testing.assert_array_equal(_np32(got), _np32(want))


@pytest.mark.parametrize("arch", ["4R-1W", "4R-2W", "4R-1W-VB"])
def test_multiport_runs_bit_equal_to_pallas(arch):
    """Multi-port memories have no banked layout: the port runs the same
    wrappers with one bank (the identity map), equal to the reference."""
    table, idx, _, _ = _inputs(64, 128, 24, "f32", seed=5)
    idx[::3] = idx[1]
    upd = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (24, 128)).astype(np.float32))
    before = table.clone()
    jt, ji, ju = (jnp.asarray(table.numpy()), jnp.asarray(idx),
                  jnp.asarray(upd.numpy()))
    np.testing.assert_array_equal(
        pk.get("banked_gather").run(arch, table, torch.as_tensor(idx)),
        np.asarray(rk.get("banked_gather").run(arch, jt, ji,
                                               interpret=True)))
    np.testing.assert_array_equal(
        pk.get("banked_scatter").run(arch, table, torch.as_tensor(idx), upd),
        np.asarray(rk.get("banked_scatter").run(arch, jt, ji, ju,
                                                interpret=True)))
    assert torch.equal(table, before)      # a new table, as in JAX


def test_scatter_updates_the_pool_in_place_and_gathers_back():
    lay = PA.get("16B-xor").layout
    pool = torch.zeros((128, 256))
    idx = torch.tensor([9, 64, 127, 2, 9])
    upd = torch.randn((5, 256))
    out = banked_scatter(pool, idx, upd, lay.n_banks, lay.mapping)
    assert out.data_ptr() == pool.data_ptr()
    back = banked_gather(pool, idx[1:], lay.n_banks, lay.mapping)
    assert torch.equal(back, upd[1:])
    assert torch.count_nonzero(pool.abs().sum(1)) == 4


def test_wrappers_check_their_inputs():
    pool = torch.zeros((64, 32))
    with pytest.raises(TypeError):
        banked_gather(pool, torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError):
        banked_gather(torch.zeros((60, 32)), torch.tensor([1]))
    with pytest.raises(ValueError):
        banked_scatter(pool, torch.tensor([1]), torch.zeros((2, 32)))
    with pytest.raises(TypeError):
        banked_scatter(pool, torch.tensor([1]),
                       torch.zeros((1, 32), dtype=torch.bfloat16))


def test_launches_count_only_kernel_launches():
    """The CPU path runs the plain version and never counts a launch."""
    from repro_torch.kernels.banked_gather.ops import GATHER
    from repro_torch.kernels.banked_scatter.ops import SCATTER
    before = (GATHER.launches, SCATTER.launches)
    pool = torch.zeros((64, 32))
    banked_scatter(pool, torch.tensor([3]), torch.ones((1, 32)))
    banked_gather(pool, torch.tensor([3]))
    assert (GATHER.launches, SCATTER.launches) == before
