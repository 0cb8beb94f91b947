"""Cooley-Tukey FFT benchmark programs (paper Table III); port of
``repro.isa.programs.fft``, its symbolic-prover hook (``symbolic_trace``)
included.

Standard in-place DIF Cooley-Tukey, radix R ∈ {4, 8, 16}, N = 4096 points,
complex data **interleaved** I/Q at word addresses (2k, 2k+1) — the layout the
paper's Offset bank map exists for.  Twiddle table W_N^k lives at
``tw_base + 2k``.  Output is left in digit-reversed order (the paper counts no
re-ordering pass: D loads = passes × N·2/16 exactly).

Per pass p (m = N/R^p, sub = m/R; threads = N/R butterflies, t → block
j = t // sub, offset q = t % sub):

    x_k = X[j·m + q + k·sub]              k = 0..R-1    (R complex loads)
    y_i = W_m^{q·i} · Σ_k x_k W_R^{ik}                  (DFT-R + twiddles)
    X[j·m + q + i·sub] = y_i                            (R complex stores)

Twiddle loads are skipped on the last pass (q = 0 ⇒ W = 1), matching the
paper's TW-load op counts (5/6 radix-4, 3/4 radix-8, 2/3 radix-16 passes).

Instruction-count templates (Common Ops) are calibrated against Table III;
deltas are < 3 % of total cycles and reported in EXPERIMENTS.md.
Functional result is asserted against ``numpy.fft.fft`` (digit-reversed).
"""
from __future__ import annotations

import numpy as np

from repro_torch.isa.assembler import Compute, MemLoad, MemStore, Program

# FP instructions per DFT-R core (radix-4 derived from the butterfly template:
# 8 complex adds = 16 + 1 j-rotation fixup = 17; radix-8/16 calibrated to
# Table III's FP rows within 0.5 %).
DFT_FP = {4: 17, 8: 50, 16: 168}
# Addressing INT instructions per pass (≈ 3R: R loads + R stores + R-1
# twiddle indices, strength-reduced); IMM pointer setups; scalar loop control.
INT_PER_PASS = {4: 8, 8: 24, 16: 46}
IMM_PER_PASS = {4: 3, 8: 4, 16: 6}
OTHER_SCALAR_PER_PASS = {4: 40, 8: 27, 16: 30}


def digit_reverse_indices(n: int, radix: int) -> np.ndarray:
    """Digit-reversal permutation for base-`radix` DIF output ordering."""
    L = int(round(np.log(n) / np.log(radix)))
    assert radix ** L == n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(L):
        rev = rev * radix + idx % radix
        idx //= radix
    return rev


def make_fft_memory(n: int, x: np.ndarray) -> tuple[np.ndarray, int]:
    """Memory image: interleaved complex data [0, 2n), twiddles [2n, 4n)."""
    x = np.asarray(x, np.complex64).reshape(n)
    tw = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    mem = np.zeros(4 * n, np.float32)
    mem[0:2 * n:2] = x.real
    mem[1:2 * n:2] = x.imag
    mem[2 * n::2] = tw.real
    mem[2 * n + 1::2] = tw.imag
    return mem, 2 * n


def _pass_fn(radix: int, q: np.ndarray, stage_p: int, last: bool):
    """Vectorized butterfly for one pass: reads x{i}_re/_im (+ tw), writes
    y{i}_re/_im.  Uses the *loaded* twiddle registers so functional
    correctness certifies the twiddle address trace too."""
    wr = np.exp(-2j * np.pi * np.outer(np.arange(radix), np.arange(radix))
                / radix).astype(np.complex64)

    def fn(regs):
        x = np.stack([regs[f"x{k}_re"] + 1j * regs[f"x{k}_im"]
                      for k in range(radix)])           # (R, T)
        y = wr @ x                                      # DFT-R
        for i in range(1, radix):
            if last:
                tw = 1.0
            else:
                tw = regs[f"tw{i}_re"] + 1j * regs[f"tw{i}_im"]
            y[i] = y[i] * tw
        for i in range(radix):
            regs[f"y{i}_re"] = y[i].real.astype(np.float32)
            regs[f"y{i}_im"] = y[i].imag.astype(np.float32)
        return regs

    return fn


def iter_fft_instrs(n: int = 4096, radix: int = 4,
                    tw_base: int | None = None):
    """Lazily yield the radix-R DIF FFT macro-ops pass by pass (validates
    eagerly, then returns a generator).

    The single source of the program's content: ``fft_program``
    materializes it into a ``Program``, while the streaming trace pipeline
    lowers it block-by-block (``isa.vm.instr_trace_blocks``) — each pass's
    (T,) address vectors exist only while their instructions are drawn.
    """
    L = int(round(np.log(n) / np.log(radix)))
    if radix ** L != n:
        raise ValueError(f"n={n} is not a power of radix={radix}")
    tw_base = 2 * n if tw_base is None else tw_base

    def gen():
        T = n // radix
        t = np.arange(T, dtype=np.int64)
        for p in range(L):
            m = n // radix ** p
            sub = m // radix
            j, q = t // sub, t % sub
            base = j * m + q
            last = (p == L - 1)

            yield Compute({"imm": IMM_PER_PASS[radix]}, label=f"p{p} pointers")
            yield Compute({"int": INT_PER_PASS[radix]},
                          label=f"p{p} addressing")
            yield Compute({"other": OTHER_SCALAR_PER_PASS[radix]},
                          scalar=True, label=f"p{p} control")

            # data loads: R two-word (I/Q) complex load instructions
            for k in range(radix):
                a = 2 * (base + k * sub)
                yield MemLoad((f"x{k}_re", f"x{k}_im"),
                              np.asarray(np.stack([a, a + 1]), np.int32))
            # twiddle loads (skipped on the final, trivial pass)
            if not last:
                step = n // m  # = radix**p
                for i in range(1, radix):
                    widx = (q * i * step) % n
                    ta = tw_base + 2 * widx
                    yield MemLoad((f"tw{i}_re", f"tw{i}_im"),
                                  np.asarray(np.stack([ta, ta + 1]), np.int32),
                                  space="TW")

            # butterfly (FP bundle)
            fp = (radix - 1) * 6 + DFT_FP[radix]
            yield Compute({"fp": fp}, fn=_pass_fn(radix, q, p, last),
                          label=f"p{p} butterfly")

            # stores: R two-word complex store instructions (blocking between
            # passes: data is reused immediately — paper §III.A's blocking
            # case)
            for i in range(radix):
                a = 2 * (base + i * sub)
                yield MemStore((f"y{i}_re", f"y{i}_im"),
                               np.asarray(np.stack([a, a + 1]), np.int32),
                               blocking=True)

    return gen()


def symbolic_trace(n: int = 4096, radix: int = 4,
                   tw_base: int | None = None):
    """Closed-form description of this program's traffic for the symbolic
    conflict prover (``repro_torch.analysis.symbolic``).

    Per pass p (m = n/R^p, sub = m/R, T = n/R threads, one op = 16
    consecutive threads × one I/Q word w ∈ {0, 1}):

      * data accesses (loads AND stores — index k/i plays the same role):
        ``2·(j_t·m + q + k·sub) + w`` with thread t → j_t = t//sub,
        q = t%sub.  When 16 | sub, a 16-lane op splits t as
        (j_t, g mod sub/16, j): terms (2sub·k, 2m·j_t, 32·g, w), lane
        offsets 2j.  When sub | 16, j_t/q vary WITHIN the op: lane offsets
        2·(m·(j//sub) + j%sub), terms (2sub·k, (32m/sub)·g, w).
      * twiddle loads (pass < last, i = 1..R-1, step = R^p):
        ``tw_base + 2·((q·i·step) mod n) + w`` — the mod-n index is the
        prover's inner-mod part (modulus n, stride 2); q decomposes per the
        same sub≥16 / sub<16 split.

    Every family is exact (not a bound): the proved ``TraceCost`` matches
    the engine bit-exactly on the whole Table III workload.  Requires
    16 | T (true for all paper/smoke sizes: n ≥ 16·R).
    """
    from repro_torch.analysis.symbolic import AffineFamily, SymbolicTrace
    L = int(round(np.log(n) / np.log(radix)))
    if radix ** L != n:
        raise ValueError(f"n={n} is not a power of radix={radix}")
    T = n // radix
    if T % 16:
        raise NotImplementedError(
            f"symbolic FFT model needs 16 | n/radix, got T={T}")
    tw_base = 2 * n if tw_base is None else tw_base

    lanes = np.arange(16)
    families = []
    compute_cycles = 0
    op_counts: dict = {}
    for p in range(L):
        m = n // radix ** p
        sub = m // radix
        step = radix ** p
        last = (p == L - 1)

        per = max(1, T // 16)
        fp = (radix - 1) * 6 + DFT_FP[radix]
        compute_cycles += (IMM_PER_PASS[radix] + INT_PER_PASS[radix]
                           + fp) * per + OTHER_SCALAR_PER_PASS[radix]
        for key, val in (("imm", IMM_PER_PASS[radix] * per),
                         ("int", INT_PER_PASS[radix] * per),
                         ("fp", fp * per),
                         ("other", OTHER_SCALAR_PER_PASS[radix])):
            op_counts[key] = op_counts.get(key, 0) + val

        # data loads + stores share one address equation (k ↔ i)
        if sub >= 16:
            data_terms = ((2 * sub, radix), (2 * m, T // sub),
                          (32, sub // 16), (1, 2))
            data_offsets = tuple(2 * j for j in lanes)
        else:
            data_terms = ((2 * sub, radix), (2 * m * 16 // sub, T // 16),
                          (1, 2))
            data_offsets = tuple(2 * (m * (j // sub) + j % sub)
                                 for j in lanes)
        for kind, tag in (("load", "loads"), ("store", "stores")):
            families.append(AffineFamily(
                name=f"fft{n}r{radix} p{p} data {tag}", kind=kind,
                const=0, terms=data_terms, offsets=data_offsets,
                n_instructions=radix))

        if last:
            continue
        for i in range(1, radix):
            if sub >= 16:
                mod_terms = ((16 * i * step, sub // 16),)
                mod_offsets = tuple(i * step * j for j in lanes)
                outer = ((0, T // sub), (1, 2))
            else:
                mod_terms = ()
                mod_offsets = tuple(i * step * (j % sub) for j in lanes)
                outer = ((0, T // 16), (1, 2))
            families.append(AffineFamily(
                name=f"fft{n}r{radix} p{p} tw{i}", kind="tw",
                const=tw_base, terms=outer, offsets=(0,) * 16,
                modulus=n, mod_terms=mod_terms, mod_offsets=mod_offsets,
                stride=2, n_instructions=1))

    return SymbolicTrace(
        families=tuple(families), compute_cycles=compute_cycles,
        op_counts=op_counts,
        meta={"program": f"fft{n}r{radix}", "n": n, "radix": radix})


def fft_program(n: int = 4096, radix: int = 4, tw_base: int | None = None) -> Program:
    L = int(round(np.log(n) / np.log(radix)))
    if radix ** L != n:
        raise ValueError(f"n={n} is not a power of radix={radix}")
    prog = Program(f"fft{n}r{radix}", n_threads=n // radix,
                   meta={"n": n, "radix": radix, "passes": L,
                         "tw_base": 2 * n if tw_base is None else tw_base})
    prog.instrs = list(iter_fft_instrs(n, radix, tw_base))
    return prog


def oracle_spectrum(x: np.ndarray, radix: int) -> np.ndarray:
    """FFT of x, permuted into the program's digit-reversed output order."""
    n = x.shape[0]
    X = np.fft.fft(np.asarray(x, np.complex64))
    rev = digit_reverse_indices(n, radix)
    out = np.empty(n, np.complex64)
    out[rev] = X  # program leaves X[k] at position digit_reverse(k)
    return out
