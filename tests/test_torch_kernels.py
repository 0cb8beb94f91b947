"""The port's kernels held to the JAX reference's Pallas kernels (run as
the reference's own tests run them, interpret=True): the plain PyTorch
versions the wrappers take on CPU tensors.  banked_gather / banked_scatter
are bit-equal over bank maps, f32 and bf16, narrow and 512-multiple rows,
duplicate scatter indices, and the persistent bank-major pool mode;
banked_transpose is bit-equal over the reference's shapes and dtypes;
fft_stage agrees per pass within rtol = atol = 1e-5 and per transform
within 2e-3·max|X| (the reference's own tolerances,
tests/test_kernels.py:140-154).  The CUDA kernels themselves are held to
the plain versions by the ``cuda`` tests of test_torch_cuda.py (and by
chip_smoke.py) on the card."""
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


# ------------------------------------------------------------- transpose --

TRANSPOSE_DTYPES = {"f32": (torch.float32, jnp.float32),
                    "bf16": (torch.bfloat16, jnp.bfloat16),
                    "int32": (torch.int32, jnp.int32)}


@pytest.mark.parametrize("shape", [(128, 128), (256, 512), (512, 128),
                                   (32, 32)])
@pytest.mark.parametrize("dtype", list(TRANSPOSE_DTYPES))
def test_transpose_plain_bit_equal_to_pallas(shape, dtype):
    """The reference's sweep (tests/test_kernels.py:159-166), through both
    registries; values from a numpy seed, exact in every dtype."""
    from repro_torch.kernels.banked_transpose.ops import banked_transpose
    tdt, jdt = TRANSPOSE_DTYPES[dtype]
    vals = np.random.default_rng(shape[0] + shape[1]).integers(
        -256, 256, shape).astype(np.float32)
    want = rk.get("banked_transpose").run(
        "16B", jnp.asarray(vals).astype(jdt), interpret=True)
    x = torch.from_numpy(vals).to(tdt)
    for got in (banked_transpose(x),
                pk.get("banked_transpose").run("16B", x),
                pk.get("banked_transpose").run("4R-1W", x)):
        assert got.dtype == tdt and got.is_contiguous()
        assert got.shape == (shape[1], shape[0])
        np.testing.assert_array_equal(_np32(got), _np32(want))


def test_transpose_refuses_what_the_reference_refuses():
    """Shapes that are not whole T×T tiles (T = min(128, N, M)) are refused
    on both paths, like the reference's assert; so are types the kernel
    does not take."""
    from repro_torch.kernels.banked_transpose.ops import banked_transpose
    for shape in ((128, 96), (48, 40), (256, 200)):
        with pytest.raises(AssertionError):
            rk.get("banked_transpose").run("16B", jnp.zeros(shape),
                                           interpret=True)
        with pytest.raises(ValueError):
            banked_transpose(torch.zeros(shape))
    with pytest.raises(ValueError):
        banked_transpose(torch.zeros((4, 32, 32)))
    with pytest.raises(ValueError):
        banked_transpose(torch.zeros((64, 32)).t())
    for dtype in (torch.float64, torch.int8, torch.complex64):
        with pytest.raises(TypeError):
            banked_transpose(torch.zeros((32, 32), dtype=dtype))


# ------------------------------------------------------------- fft stage --

def _planes(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)).astype(np.float32),
            rng.standard_normal((batch, n)).astype(np.float32))


def test_stage_twiddles_equal_the_reference():
    from repro.kernels.fft_stage.ops import _stage_twiddles as r_tw
    from repro_torch.kernels.fft_stage.ops import _stage_twiddles as p_tw
    from repro_torch.kernels.fft_stage.ops import stage_twiddles
    for n in (256, 4096):
        for p in range(int(round(np.log(n) / np.log(4)))):
            for got, want, t in zip(p_tw(n, p), r_tw(n, p),
                                    stage_twiddles(n, p, torch.device(
                                        "cpu"))):
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(t.numpy(), want)
                assert t.dtype == torch.float32 and t.is_contiguous()


@pytest.mark.parametrize("n,p", [(4096, 0), (4096, 3), (4096, 5),
                                 (1024, 2)])
def test_fft_stage_plain_equals_pallas(n, p):
    """One pass, rtol = atol = 1e-5 (tests/test_kernels.py:140-143): the
    plain pass against the Pallas kernel and against the reference's jnp
    stage oracle, on the same numpy inputs."""
    from repro.kernels.fft_stage.ops import _stage_twiddles
    from repro.kernels.fft_stage.ops import fft_stage_radix4 as r_stage
    from repro.kernels.fft_stage.ref import fft_stage_ref as r_ref
    from repro_torch.kernels.fft_stage.ops import fft_stage_radix4
    xr, xi = _planes(2, n, seed=p)
    got = fft_stage_radix4(torch.from_numpy(xr), torch.from_numpy(xi), n, p)
    want = r_stage(jnp.asarray(xr), jnp.asarray(xi), n, p)
    sub = n // 4 ** (p + 1)
    twr, twi = _stage_twiddles(n, p)
    oracle = r_ref(jnp.asarray(xr.reshape(-1, 4, sub)),
                   jnp.asarray(xi.reshape(-1, 4, sub)), jnp.asarray(twr),
                   jnp.asarray(twi))
    for g, w, o in zip(got, want, oracle):
        assert g.shape == (2, n) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(o).reshape(2, n),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_fft_full_plain_equals_pallas_and_the_oracle(n):
    """The whole transform, atol 2e-3·max|X| (tests/test_kernels.py:153-154)
    against the Pallas passes and the numpy oracle; the registry route and
    the composed plain passes are the same function on the CPU."""
    from repro.kernels.fft_stage.ops import fft4096_radix4 as r_fft
    from repro_torch.kernels.fft_stage import (fft4096_radix4,
                                               fft_oracle_digit_reversed,
                                               fft_radix4_ref)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    got = fft4096_radix4(torch.from_numpy(x), n=n)
    assert got.dtype == torch.complex64 and got.shape == (2, n)
    want = np.stack([fft_oracle_digit_reversed(x[b], 4) for b in range(2)])
    tol = 2e-3 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(r_fft(
        jnp.asarray(x), n=n)), rtol=0, atol=tol)
    assert torch.equal(got, fft_radix4_ref(torch.from_numpy(x), n=n))
    assert torch.equal(got, pk.get("fft_stage").run("4R-2W",
                                                    torch.from_numpy(x)))
    np.testing.assert_array_equal(
        pk.get("fft_stage").reference("16B", torch.from_numpy(x)).numpy(),
        want)


def test_fft_wrappers_check_their_inputs():
    from repro_torch.kernels.fft_stage.ops import (fft4096_radix4, fft_stage,
                                                   fft_stage_radix4)
    with pytest.raises(ValueError):
        fft4096_radix4(torch.zeros((2, 1000), dtype=torch.complex64), n=1000)
    with pytest.raises(ValueError):
        fft4096_radix4(torch.zeros(256, dtype=torch.complex64), n=256)
    with pytest.raises(ValueError):
        fft_stage_radix4(torch.zeros((2, 256)), torch.zeros((2, 256)), 256, 4)
    planes = torch.zeros((8, 4, 16))
    tw = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError):
        fft_stage(planes, planes, tw[:, :, :8], tw)
    with pytest.raises(TypeError):
        fft_stage(planes.double(), planes.double(), tw, tw)


@pytest.mark.parametrize("name,x", [
    ("banked_transpose", np.zeros((64, 64), np.float32)),
    ("fft_stage", np.zeros((1, 4096), np.complex64))])
def test_table_kernel_traces_equal_the_reference(name, x):
    """The registry's trace and blocks are the Table II/III programs'
    request streams: equal to the reference kernels' and bit-equal in cost
    at any block size."""
    import dataclasses

    from repro.core import cost_engine as RCE
    from repro_torch.core import cost_engine as PCE
    archs = ["16B", "8B-offset", "4R-2W"]
    got = pk.get(name).address_trace("16B", torch.from_numpy(x))
    want = rk.get(name).address_trace("16B", jnp.asarray(x))
    for f in ("addrs", "kinds", "instr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.compute_cycles, got.op_counts) == (want.compute_cycles,
                                                   want.op_counts)
    ref_cost = [dataclasses.asdict(c)
                for c in RCE.cost_many(archs, want)]
    for block_ops in (7, None):
        stream = pk.get(name).trace_blocks("16B", torch.from_numpy(x),
                                           block_ops=block_ops)
        assert [dataclasses.asdict(c) for c in PCE.cost_many(
            archs, stream, device="cpu")] == ref_cost
    with pytest.raises(NotImplementedError):
        pk.get(name).address_trace("16B", torch.zeros(
            (48, 48) if name == "banked_transpose" else (1, 1000)))


def test_table_kernels_count_no_launch_on_the_cpu():
    from repro_torch.kernels.banked_transpose.ops import TRANSPOSE
    from repro_torch.kernels.fft_stage.ops import STAGE, TRANSFORM, WIDE_PASS
    entries = (TRANSPOSE, STAGE, TRANSFORM, WIDE_PASS)
    before = [e.launches for e in entries]
    pk.get("banked_transpose").run("16B", torch.zeros((32, 32)))
    pk.get("fft_stage").run("16B", torch.zeros((1, 64),
                                               dtype=torch.complex64))
    assert [e.launches for e in entries] == before
