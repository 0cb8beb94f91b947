"""The FFT transform kernel's host-side contract, checked without a card:
the twiddle table it reads (bit for bit the per-pass tables of the port and
of the JAX reference), its launch plan, its shared-memory map (every warp
access priced with the port's conflict counter on 32 banks), and its round
schedule, emulated in numpy float32 with the same index functions and held
bit for bit to the plain passes.  The CPU route of ``fft4096_radix4`` is
held to the plain passes (equal) and to the Pallas transform in interpret
mode (the reference's 2e-3·max|X|, tests/test_kernels.py:153-154).  The CUDA
kernels themselves are held to the plain passes by the ``cuda`` tests of
test_torch_cuda.py and by chip_smoke.py on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fft_stage.ops import _stage_twiddles as ref_twiddles
from repro_torch.core.conflicts import max_conflicts_broadcast
from repro_torch.kernels.fft_stage import fft4096_radix4, fft_radix4_ref
from repro_torch.kernels.fft_stage.ops import (ROUND_WINDOWS, TILE,
                                               TILE_THREADS, TRANSFORM,
                                               WIDE_PASS, _stage_twiddles,
                                               _transform_twiddles,
                                               round_passes, smem_word,
                                               tile_point, transform_plan,
                                               twiddle_offset)

ALL_N = [4 ** k for k in range(1, 11)]          # 4 .. 2^20


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _input(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal(
        (batch, n))).astype(np.complex64)


# ------------------------------------------------------------ twiddles --

@pytest.mark.parametrize("n", ALL_N)
def test_transform_twiddles_are_the_stage_tables_bit_for_bit(n):
    """Pass p's block of the kernels' table is ``_stage_twiddles(n, p)`` of
    the port and of the JAX package, bit for bit, for every pass; and the
    pass-p table is the pass-0 table read at stride 4^p (the float64 phase
    scales by a power of two), so the per-pass tables could share it."""
    table = _transform_twiddles(n)
    passes = round(np.log(n) / np.log(4))
    assert table.dtype == np.complex64
    assert table.shape == (twiddle_offset(n, passes),)
    first = table[:n].reshape(4, n // 4)
    for p in range(passes):
        sub = n // 4 ** (p + 1)
        got = table[twiddle_offset(n, p):][:4 * sub].reshape(4, sub)
        for part, mine, ref in zip((got.real, got.imag), _stage_twiddles(n, p),
                                   ref_twiddles(n, p)):
            np.testing.assert_array_equal(_bits(part), _bits(mine[0]))
            np.testing.assert_array_equal(_bits(part), _bits(ref[0]))
        strided = first[:, ::4 ** p]
        np.testing.assert_array_equal(_bits(strided.real), _bits(got.real))
        np.testing.assert_array_equal(_bits(strided.imag), _bits(got.imag))


# --------------------------------------------------------- launch plan --

@pytest.mark.parametrize("n,launches", [
    (4, 1), (16, 1), (64, 1), (256, 1), (1024, 1), (4096, 1), (16384, 2),
    (65536, 3), (4 ** 9, 4), (4 ** 10, 5)])
def test_transform_plan_launch_counts(n, launches):
    """One launch for n <= 4096, log4(n / 4096) + 1 above."""
    assert transform_plan(n) + 1 == launches


# -------------------------------------------------- shared-memory map --

#: the rounds of the tile kernel: the passes of a 4096-point segment each
#: runs in registers between its take and its put (W = 8 is loaded from
#: and stored to device memory, in that same layout)
ROUNDS = {8: (0, 1), 4: (2, 3), 0: (4, 5)}


def _warp_words(w: int, word) -> np.ndarray:
    """(8 warps × 16 accesses, 32 lanes) words of the round at window w."""
    t = np.arange(TILE_THREADS).reshape(-1, 1, 32)     # warp, 1, lane
    j = np.arange(16).reshape(1, -1, 1)
    return word(tile_point(t, j, w)).reshape(-1, 32)


def _degree(words: np.ndarray) -> int:
    addrs = torch.from_numpy(words)
    return int(max_conflicts_broadcast(addrs, addrs % 32, 32).max())


def test_smem_map_is_a_bijection_of_the_tile():
    a = np.arange(TILE)
    assert sorted(smem_word(a)) == list(range(TILE))
    for w in ROUND_WINDOWS:            # each round's threads own the tile
        pts = tile_point(np.arange(TILE_THREADS)[:, None],
                         np.arange(16)[None], w)
        assert sorted(pts.ravel()) == list(range(TILE))
        # the source's addressing: point j's word is thread t's point-0
        # word XOR a constant of j (the map is XOR-linear)
        t = np.arange(TILE_THREADS)[:, None]
        j = np.arange(16)[None]
        np.testing.assert_array_equal(
            smem_word(tile_point(t, j, w)),
            smem_word(tile_point(t, 0, w)) ^ smem_word(j << w))


@pytest.mark.parametrize("w", ROUND_WINDOWS)
def test_smem_map_conflict_degree_per_pass(w):
    """Every warp access (take and put) of the round that runs passes
    ``ROUNDS[w]`` of n = 4096, priced on 32 LSB banks with the port's
    broadcast conflict counter: degree 1 (PERF.md §6, PR 20).  The plain
    linear layout would give 1, 2 and 16 for W = 8, 4 and 0."""
    assert round_passes(6, w) == ROUNDS[w]
    assert _degree(_warp_words(w, smem_word)) == 1
    assert _degree(_warp_words(w, lambda a: a)) == {8: 1, 4: 2, 0: 16}[w]


# ---------------------------------------------------- schedule emulated --

def _radix4(x, w):
    """The butterfly on (re, im) float32 arrays x[k], twiddles w[k]: the
    source's ``radix4``, operation for operation."""
    (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r, x3i) = x
    a_r, a_i, b_r, b_i = x0r + x2r, x0i + x2i, x0r - x2r, x0i - x2i
    c_r, c_i, d_r, d_i = x1r + x3r, x1i + x3i, x1r - x3r, x1i - x3i
    ys = [(a_r + c_r, a_i + c_i), (b_r + d_i, b_i - d_r),
          (a_r - c_r, a_i - c_i), (b_r - d_i, b_i + d_r)]
    return [(yr * wk.real - yi * wk.imag, yr * wk.imag + yi * wk.real)
            for (yr, yi), wk in zip(ys, w)]


def _emulate_tile(re, im, tw, passes):
    """``transform_tile<passes>`` on flat (re, im) float32 points: tiles of
    4096 with a zero-padded ragged end, the W = 8 load, the three rounds
    with their takes and puts through ``smem_word``, the W = 8 store."""
    n_points = re.size
    tiles = -(-n_points // TILE)
    pad = tiles * TILE - n_points
    re = np.concatenate([re, np.zeros(pad, np.float32)]).reshape(tiles, TILE)
    im = np.concatenate([im, np.zeros(pad, np.float32)]).reshape(tiles, TILE)
    t = np.arange(TILE_THREADS)[:, None]
    j = np.arange(16)[None]
    load = tile_point(t, j, 8)
    v = [(re[:, load[:, k]], im[:, load[:, k]]) for k in range(16)]
    smem = np.zeros((2, tiles, TILE), np.float32)
    t = t[:, 0]
    prev = None
    for w in ROUND_WINDOWS:
        if prev is not None:                      # put, sync, take
            for k in range(16):
                s = smem_word(tile_point(t, k, prev))
                smem[0][:, s], smem[1][:, s] = v[k]
            v = [tuple(smem[c][:, smem_word(tile_point(t, k, w))]
                       for c in range(2)) for k in range(16)]
        low = t & ((1 << w) - 1)
        pa = passes - 2 - w // 2
        for p in round_passes(passes, w):
            off = twiddle_offset(4 ** passes, p)
            if p == pa:                           # digit j >> 2
                sub = 1 << (w + 2)
                for jl in range(4):
                    q = (jl << w) | low
                    ks = [jl + 4 * k for k in range(4)]
                    out = _radix4([v[k] for k in ks],
                                  [tw[off + k * sub + q] for k in range(4)])
                    for k, o in zip(ks, out):
                        v[k] = o
            else:                                 # digit j & 3
                sub = 1 << w
                for jh in range(4):
                    ks = [4 * jh + k for k in range(4)]
                    out = _radix4([v[k] for k in ks],
                                  [tw[off + k * sub + low] for k in range(4)])
                    for k, o in zip(ks, out):
                        v[k] = o
        prev = w
    for k in range(16):
        s = smem_word(tile_point(t, k, prev))
        smem[0][:, s], smem[1][:, s] = v[k]
    out = [np.empty((tiles, TILE), np.float32) for _ in range(2)]
    for k in range(16):
        pts = tile_point(t, k, 8)
        for c in range(2):
            out[c][:, pts] = smem[c][:, smem_word(pts)]
    return out[0].ravel()[:n_points], out[1].ravel()[:n_points]


def _emulate_wide_pass(re, im, tw, sub):
    """``wide_pass`` on flat (re, im) points in (rows, 4, sub) order."""
    x = [(re.reshape(-1, 4, sub)[:, k], im.reshape(-1, 4, sub)[:, k])
         for k in range(4)]
    out = _radix4(x, [tw[k * sub:(k + 1) * sub] for k in range(4)])
    return (np.stack([o[0] for o in out], 1).ravel(),
            np.stack([o[1] for o in out], 1).ravel())


@pytest.mark.parametrize("n,batch", [
    (4, 3), (16, 1), (64, 5), (256, 3), (1024, 6), (4096, 2), (16384, 1),
    (65536, 1)])
def test_kernel_schedule_emulated_is_bit_equal_to_the_plain_passes(n, batch):
    """The transform as the source schedules it (``transform_plan``'s wide
    passes, then the tile kernel's rounds, through the same index
    functions and table offsets), in numpy float32, equals the plain passes
    bit for bit; batches that leave a ragged last tile included."""
    x = _input(batch, n, seed=n)
    tw = _transform_twiddles(n)
    passes = round(np.log(n) / np.log(4))
    first = transform_plan(n)
    re, im = x.real.ravel().copy(), x.imag.ravel().copy()
    for p in range(first):
        sub = n // 4 ** (p + 1)
        re, im = _emulate_wide_pass(re, im, tw[twiddle_offset(n, p):], sub)
    re, im = _emulate_tile(re, im, tw[twiddle_offset(n, first):],
                           passes - first)
    want = fft_radix4_ref(torch.from_numpy(x), n=n).numpy()
    np.testing.assert_array_equal(_bits(re), _bits(want.real.ravel()))
    np.testing.assert_array_equal(_bits(im), _bits(want.imag.ravel()))


# ------------------------------------------------------ the CPU route --

@pytest.mark.parametrize("n", [4, 16, 256, 4096, 16384])
def test_cpu_transform_equals_plain_and_pallas(n):
    from repro.kernels.fft_stage.ops import fft4096_radix4 as ref_fft
    x = _input(2, n)
    before = (TRANSFORM.launches, WIDE_PASS.launches)
    got = fft4096_radix4(torch.from_numpy(x), n=n)
    assert (TRANSFORM.launches, WIDE_PASS.launches) == before
    assert got.dtype == torch.complex64 and got.shape == (2, n)
    assert torch.equal(got, fft_radix4_ref(torch.from_numpy(x), n=n))
    want = np.asarray(ref_fft(jnp.asarray(x), n=n))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


def test_transform_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        fft4096_radix4(torch.zeros((0, 64), dtype=torch.complex64), n=64)


DTYPE_INPUTS = {
    "float32": lambda x: x.real.astype(np.float32),
    "float64": lambda x: x.real.astype(np.float64),
    "complex128": lambda x: x.astype(np.complex128),
}


@pytest.mark.parametrize("dtype", list(DTYPE_INPUTS))
@pytest.mark.parametrize("n", [16, 64, 4096])
def test_transform_takes_real_and_complex128_input_as_the_reference(n,
                                                                    dtype):
    """Real and complex128 input is cast to complex64 first, as the
    reference casts its real and imaginary parts to float32: the result is
    complex64, equal to the transform of the cast input, and within the
    reference's 2e-3·max|X| (tests/test_kernels.py:153-154) of the Pallas
    transform in interpret mode on the same numpy input."""
    from repro.kernels.fft_stage.ops import fft4096_radix4 as ref_fft
    x = DTYPE_INPUTS[dtype](_input(2, n, seed=n + 1).astype(np.complex128)
                            * (1 + 1e-9))
    before = (TRANSFORM.launches, WIDE_PASS.launches)
    got = fft4096_radix4(torch.from_numpy(x), n=n)
    assert (TRANSFORM.launches, WIDE_PASS.launches) == before
    assert got.dtype == torch.complex64 and got.shape == (2, n)
    cast = torch.from_numpy(x).to(torch.complex64)
    assert torch.equal(got, fft4096_radix4(cast, n=n))
    assert torch.equal(fft_radix4_ref(torch.from_numpy(x), n=n), got)
    want = np.asarray(ref_fft(jnp.asarray(x), n=n))
    assert want.dtype == np.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


def test_transform_keeps_the_refusals_the_reference_shares():
    """1-D input, an empty batch and n not a power of 4 are refused, as
    the reference refuses them (TypeError, ZeroDivisionError and
    AssertionError there)."""
    for x, n in ((torch.zeros(64), 64),
                 (torch.zeros((0, 64), dtype=torch.float64), 64),
                 (torch.zeros((2, 48), dtype=torch.complex128), 48)):
        with pytest.raises(ValueError):
            fft4096_radix4(x, n=n)
