"""The port's symbolic conflict prover (repro_torch.analysis.symbolic) held
to the JAX reference's (repro.analysis.symbolic): a counterpart of every
case of ``tests/test_analysis_symbolic.py``, each also comparing the port's
``prove(...).cost`` with the reference's on the same inputs, field for
field; every port ``symbolic_trace`` (both ISA programs, the ten registered
kernels on the reference CLI's arguments, ``model_step_symbolic`` for the
ten smoke configs) against the reference's, family by family;
``cross_check(..., device="cpu")`` on the points of
``tests/test_model_traces.py``; and the refusal of degraded memories.

Families, proofs and ``TraceCost``s are integers and are compared
exactly.  The port's ``cross_check`` prices the engine's side on the CPU
here (``device="cpu"``); on the card ``chip_smoke.py`` runs it on
``cuda``."""
import dataclasses

import numpy as np
import pytest

from repro.analysis import symbolic as RS
from repro.core import arch as RA
from repro.isa.programs import fft as r_fft
from repro.isa.programs import transpose as r_tr
from repro.kernels import registry as r_kreg
from repro.models import trace as r_mtrace
from repro_torch.analysis.symbolic import (AffineFamily, DataFamily,
                                           SymbolicTrace,
                                           affine_from_indices, cross_check,
                                           prove, prove_many)
from repro_torch.configs import ARCH_IDS
from repro_torch.core import arch as A
from repro_torch.core.trace import AddressTrace
from repro_torch.isa.programs import fft as fft_prog
from repro_torch.isa.programs import transpose as tr_prog
from repro_torch.kernels import registry as kreg
from repro_torch.models.trace import (model_step_symbolic, model_step_trace,
                                      resolve_model_config)

MAP_ARCHS = [f"{b}B{suffix}" for b in (4, 8, 16)
             for suffix in ("", "-offset", "-xor", "-fold")]
EXTRA_ARCHS = ["16B-bcast", "16B-offset-s2", "4R-1W", "4R-2W", "4R-1W-VB"]
NAMES = MAP_ARCHS + EXTRA_ARCHS
ARCHS = [A.get(n) for n in NAMES]
EXTENDED_ARCHS = ("12B", "6B-offset", "4x4B-g64", "2x8B-g32", "4x3B")


def _cross(archs, sym, trace, **kw):
    return cross_check(archs, sym, trace, device="cpu", **kw)


def _same_cost(port_sym, ref_sym, names):
    """The port's proofs equal the reference's on every architecture:
    ``TraceCost`` field for field and every family's bounds."""
    for name in names:
        got, want = prove(A.get(name), port_sym), RS.prove(RA.get(name),
                                                          ref_sym)
        assert got.arch == want.arch
        assert dataclasses.asdict(got.cost) == dataclasses.asdict(
            want.cost), name
        assert [dataclasses.asdict(p) for p in got.proofs] == [
            dataclasses.asdict(p) for p in want.proofs], name


def _same_families(port_sym, ref_sym):
    """Two ``SymbolicTrace``s equal family by family, field for field."""
    assert len(port_sym.families) == len(ref_sym.families)
    for got, want in zip(port_sym.families, ref_sym.families):
        assert type(got).__name__ == type(want).__name__, got.name
        if isinstance(got, AffineFamily):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            continue
        assert (got.name, got.kind, got.n_instructions) == (
            want.name, want.kind, want.n_instructions)
        np.testing.assert_array_equal(got.addrs, want.addrs)
        assert (got.mask is None) == (want.mask is None), got.name
        if got.mask is not None:
            np.testing.assert_array_equal(got.mask, want.mask)
    assert port_sym.compute_cycles == ref_sym.compute_cycles
    assert port_sym.op_counts == ref_sym.op_counts
    assert port_sym.meta == ref_sym.meta


# --------------------------------------------------------------------------
# Acceptance sweep: prover == engine, bit-exact, on all Table II/III points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", (32, 64, 128))
def test_prover_matches_engine_table2(n):
    sym = tr_prog.symbolic_trace(n)
    _cross(ARCHS, sym, AddressTrace.from_program(tr_prog.transpose_program(n)))
    _same_cost(sym, r_tr.symbolic_trace(n), NAMES)


@pytest.mark.parametrize("radix", (4, 8, 16))
def test_prover_matches_engine_table3(radix):
    sym = fft_prog.symbolic_trace(4096, radix)
    _cross(ARCHS, sym,
           AddressTrace.from_program(fft_prog.fft_program(4096, radix)))
    _same_cost(sym, r_fft.symbolic_trace(4096, radix), NAMES)


def test_cross_check_detects_divergence():
    """The oracle bites: dropping a family fails the check."""
    sym = tr_prog.symbolic_trace(32)
    bad = SymbolicTrace(
        families=tuple(f for f in sym.families if f.kind != "store"),
        compute_cycles=sym.compute_cycles, op_counts=sym.op_counts,
        meta=sym.meta)
    trace = AddressTrace.from_program(tr_prog.transpose_program(32))
    with pytest.raises(AssertionError, match="divergence under 16B"):
        _cross([A.get("16B")], bad, trace)


# --------------------------------------------------------------------------
# The paper's analytic facts, proved
# --------------------------------------------------------------------------

def test_xor_transpose_loads_proved_conflict_free():
    proof = prove(A.get("16B-xor"), tr_prog.symbolic_trace(64))
    assert proof.family("transpose64 row loads").conflict_free
    assert proof.family("transpose64 column stores").max_cycles == 16
    _same_cost(tr_prog.symbolic_trace(64), r_tr.symbolic_trace(64),
               ["16B-xor"])


@pytest.mark.parametrize("b,load_cycles", ((4, 16), (8, 8), (16, 4)))
def test_lsb_transpose_bounds_proved_exactly(b, load_cycles):
    proof = prove(A.get(f"{b}B"), tr_prog.symbolic_trace(64))
    loads = proof.family("transpose64 row loads")
    assert loads.max_cycles == load_cycles == loads.min_cycles
    stores = proof.family("transpose64 column stores")
    assert stores.max_cycles == 16 and stores.min_cycles == 16
    _same_cost(tr_prog.symbolic_trace(64), r_tr.symbolic_trace(64),
               [f"{b}B"])


def test_prove_many_orders_and_totals():
    proofs = prove_many(ARCHS, tr_prog.symbolic_trace(32))
    assert [p.arch for p in proofs] == [a.name for a in ARCHS]
    t = AddressTrace.from_program(tr_prog.transpose_program(32))
    for a, p in zip(ARCHS, proofs):
        assert p.cost == a.cost(t, device="cpu"), a.name
    want = RS.prove_many([RA.get(n) for n in NAMES], r_tr.symbolic_trace(32))
    assert [dataclasses.asdict(p.cost) for p in proofs] == [
        dataclasses.asdict(p.cost) for p in want]


# --------------------------------------------------------------------------
# Registry: every kernel contributes a symbolic_trace that proves correct
# --------------------------------------------------------------------------

def _kernel_args(rng):
    table = rng.standard_normal((128, 16)).astype(np.float32)
    idx = rng.integers(0, 128, size=64).astype(np.int32)
    return table, idx, {
        "banked_gather": (table, idx),
        "banked_scatter": (table, idx),
        "banked_transpose": (np.zeros((32, 32), np.float32),),
        "carry_arbiter": (rng.integers(0, 1 << 16, (32, 16))
                          .astype(np.uint32),),
        "conflict_popcount": (rng.integers(0, 16, (32, 16))
                              .astype(np.int32),),
        "fft_stage": (np.zeros((1, 256), np.complex64),),
        "moe_dispatch": (rng.integers(0, 8, 128).astype(np.int32), 8, 32),
        "attn_decode": (np.array([[0, 3, 6, -1], [1, 4, -1, -1],
                                  [2, 5, 7, -1]], np.int32),
                        np.array([17, 9, 21]), 64, 4, 8),
        "moe_a2a": (rng.integers(0, 8, 64).astype(np.int32), 8, 16),
        "ssm_scan": (2, 64, 16, 4),
    }


def _torch_args(name, args):
    """The port's kernels take tensors where the reference takes arrays;
    the traffic lowerings take arrays in both."""
    import torch
    if name in ("attn_decode", "moe_a2a", "ssm_scan"):
        return args
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def test_every_registered_kernel_symbolic_cross_checks():
    rng = np.random.default_rng(1)
    table, idx, args = _kernel_args(rng)
    mask = rng.random(64) > 0.2
    assert set(kreg.names()) == set(args) == set(r_kreg.names())
    a16 = A.get("16B")
    for name in kreg.names():
        k = kreg.get(name)
        sym = k.symbolic_trace(a16, *_torch_args(name, args[name]))
        _cross(ARCHS, sym, k.trace(a16, *args[name]))
        ref = r_kreg.get(name).symbolic_trace(RA.get("16B"), *args[name])
        _same_families(sym, ref)
        _same_cost(sym, ref, ("16B", "8B-offset", "4R-1W-VB"))
    # masked gather proves too (ragged active sets through first-occurrence)
    k = kreg.get("banked_gather")
    sym = k.symbolic_trace(a16, table, idx, mask=mask)
    _cross(ARCHS, sym, k.trace(a16, table, idx, mask=mask))
    _same_families(sym, r_kreg.get("banked_gather").symbolic_trace(
        RA.get("16B"), table, idx, mask=mask))


def test_kernel_without_symbolic_refuses():
    def _probe(arch, x):
        return x

    k = kreg.Kernel(name="_probe", cuda=_probe, ref=_probe)
    with pytest.raises(NotImplementedError, match="no symbolic trace"):
        k.symbolic_trace("16B", 0)


def test_cli_kernel_args_symbolic_equal_the_reference():
    """The reference CLI's ``kernel_args`` (seed 0, its draw order), every
    registered kernel's families against the reference's."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((256, 16)).astype(np.float32)
    idx = rng.integers(0, 256, size=64).astype(np.int32)
    args = {
        "banked_gather": (table, idx),
        "banked_scatter": (table, idx),
        "banked_transpose": (np.arange(32 * 32, dtype=np.float32)
                             .reshape(32, 32),),
        "carry_arbiter": (rng.integers(0, 1 << 16, size=(48, 16))
                          .astype(np.uint32),),
        "conflict_popcount": (rng.integers(0, 16, size=(48, 16))
                              .astype(np.int32),),
        "fft_stage": (np.zeros((1, 256), np.complex64),),
        "moe_dispatch": (rng.integers(0, 8, size=128).astype(np.int32),
                         8, 32),
        "attn_decode": (np.array([[0, 3, 6, -1], [1, 4, -1, -1],
                                  [2, 5, 7, -1]], np.int32),
                        np.array([17, 9, 21]), 64, 4, 8),
        "moe_a2a": (rng.integers(0, 8, size=64).astype(np.int32), 8, 16),
        "ssm_scan": (2, 64, 16, 4),
    }
    for name, a in args.items():
        _same_families(kreg.get(name).symbolic_trace("16B", *a),
                       r_kreg.get(name).symbolic_trace("16B", *a))


@pytest.mark.parametrize("n", (16, 32, 64, 128, 256))
def test_transpose_symbolic_trace_equals_the_reference(n):
    _same_families(tr_prog.symbolic_trace(n), r_tr.symbolic_trace(n))


@pytest.mark.parametrize("n,radix,tw_base", [
    (64, 4, None), (256, 4, None), (256, 16, None), (4096, 4, None),
    (4096, 8, None), (4096, 16, None), (1024, 4, 100)])
def test_fft_symbolic_trace_equals_the_reference(n, radix, tw_base):
    _same_families(fft_prog.symbolic_trace(n, radix, tw_base),
                   r_fft.symbolic_trace(n, radix, tw_base))


def test_fft_symbolic_trace_refusals_equal_the_reference():
    for args, exc in (((100, 4), ValueError), ((16, 4), NotImplementedError)):
        with pytest.raises(exc):
            r_fft.symbolic_trace(*args)
        with pytest.raises(exc):
            fft_prog.symbolic_trace(*args)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_model_step_symbolic_equals_the_reference(arch_id):
    """The ten smoke configs' whole decode step: the port's families equal
    the reference's, and the port's proof its proof."""
    kw = dict(batch=2, prompt_len=12)
    got = model_step_symbolic(resolve_model_config(arch_id, smoke=True),
                              "16B-offset", device="cpu", **kw)
    want = r_mtrace.model_step_symbolic(
        r_mtrace.resolve_model_config(arch_id, smoke=True), "16B-offset",
        **kw)
    _same_families(got, want)
    _same_cost(got, want, ("16B-offset", "4R-2W"))


# --------------------------------------------------------------------------
# Building blocks: affine detection and the data-family fallback
# --------------------------------------------------------------------------

def test_affine_from_indices_detects_progressions():
    fam = affine_from_indices(np.arange(0, 320, 5), kind="load", name="ap")
    assert isinstance(fam, AffineFamily)
    assert fam.const == 0 and (5 * 16, 4) in fam.terms
    assert dataclasses.asdict(fam) == dataclasses.asdict(
        RS.affine_from_indices(np.arange(0, 320, 5), kind="load", name="ap"))

    rng = np.random.default_rng(2)
    idx = rng.integers(0, 999, 64)
    fam = affine_from_indices(idx, kind="store", name="scatter")
    assert isinstance(fam, DataFamily) and fam.addrs.shape == (4, 16)
    np.testing.assert_array_equal(
        fam.addrs, RS.affine_from_indices(idx, kind="store",
                                          name="scatter").addrs)


def test_affine_from_indices_takes_tensors():
    import torch
    idx = np.arange(37) * 3
    mask = np.arange(37) % 5 != 0
    got = affine_from_indices(torch.from_numpy(idx), "load", "t",
                              mask=torch.from_numpy(mask))
    want = RS.affine_from_indices(idx, "load", "t", mask=mask)
    np.testing.assert_array_equal(got.addrs, want.addrs)
    np.testing.assert_array_equal(got.mask, want.mask)


def test_data_family_ragged_tail_matches_engine():
    idx = np.arange(37) * 3          # 37 % 16 != 0
    fam = affine_from_indices(idx, kind="load", name="ragged")
    sym = SymbolicTrace(families=(fam,))
    trace = AddressTrace.from_ops(
        np.pad(idx, (0, 48 - 37), mode="edge").reshape(3, 16), kind="load")
    _cross(ARCHS, sym, trace)
    _same_cost(sym, RS.SymbolicTrace(families=(RS.affine_from_indices(
        idx, kind="load", name="ragged"),)), NAMES)


def test_family_proof_serialization_label():
    proof = prove(A.get("16B"), tr_prog.symbolic_trace(64))
    fam = proof.family("transpose64 column stores")
    assert fam.serialization == 16
    assert not fam.conflict_free
    assert repr(fam) == repr(RS.prove(RA.get("16B"), r_tr.symbolic_trace(
        64)).family("transpose64 column stores"))
    with pytest.raises(KeyError):
        proof.family("nope")


def test_family_validation_equals_the_reference():
    for kw in ({"kind": "read"}, {"offsets": (0,) * 15},
               {"modulus": 12}):
        with pytest.raises(ValueError):
            RS.AffineFamily(name="f", **{"kind": "load", **kw})
        with pytest.raises(ValueError):
            AffineFamily(name="f", **{"kind": "load", **kw})
    with pytest.raises(ValueError):
        DataFamily(name="d", kind="tw2", addrs=np.zeros(16))


# --------------------------------------------------------------------------
# Non-pow2 / two-level lattice: proved, not declined
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", (32, 64))
def test_prover_covers_non_pow2_and_two_level_transpose(n):
    archs = [A.get(a) for a in EXTENDED_ARCHS]
    trace = AddressTrace.from_program(tr_prog.transpose_program(n))
    proofs = _cross(archs, tr_prog.symbolic_trace(n), trace)
    assert len(proofs) == len(EXTENDED_ARCHS)
    _same_cost(tr_prog.symbolic_trace(n), r_tr.symbolic_trace(n),
               EXTENDED_ARCHS)


def test_prover_covers_extended_lattice_fft():
    archs = [A.get(a) for a in EXTENDED_ARCHS]
    trace = AddressTrace.from_program(fft_prog.fft_program(4096, 4))
    _cross(archs, fft_prog.symbolic_trace(4096, 4), trace)
    _same_cost(fft_prog.symbolic_trace(4096, 4), r_fft.symbolic_trace(4096,
                                                                      4),
               EXTENDED_ARCHS)


def test_two_level_default_granule_proof_equals_flat():
    sym = tr_prog.symbolic_trace(64)
    assert prove(A.get("4x4B"), sym).cost == prove(A.get("16B"), sym).cost


def test_prover_declines_degraded_explicitly():
    sym = tr_prog.symbolic_trace(32)
    for base, dead in (("16B", (2,)), ("12B", (1,))):
        with pytest.raises(NotImplementedError, match="degraded") as got:
            prove(A.get(base).degrade(dead), sym)
        with pytest.raises(NotImplementedError) as want:
            RS.prove(RA.get(base).degrade(dead), r_tr.symbolic_trace(32))
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# The model-trace points (tests/test_model_traces.py), cross-checked
# --------------------------------------------------------------------------

CROSS_ARCHS = [A.get(f"{b}B{s}") for b in (4, 8, 16)
               for s in ("", "-offset", "-xor", "-fold")]
_PT = np.array([[0, 3, 6, -1], [1, 4, -1, -1], [2, 5, 7, -1]], np.int32)
KERNEL_POINTS = {
    "attn_decode": (_PT, np.array([17, 9, 21]), 64, 4, 8),
    "moe_a2a": (np.random.default_rng(0).integers(0, 8, size=64)
                .astype(np.int32), 8, 16),
    "ssm_scan": (2, 64, 16, 4),
}
MODEL_CONFIGS = ("llama3_2_1b", "mixtral_8x22b", "jamba_v0_1_52b")


@pytest.mark.parametrize("name", sorted(KERNEL_POINTS))
def test_kernel_symbolic_cross_check(name):
    k = kreg.get(name)
    args = KERNEL_POINTS[name]
    sym = k.symbolic_trace("16B", *args)
    _cross(CROSS_ARCHS, sym, k.address_trace("16B", *args))
    _same_families(sym, r_kreg.get(name).symbolic_trace("16B", *args))


def test_ssm_scan_state_streams_closed_form():
    sym = kreg.get("ssm_scan").symbolic_trace(
        "16B", *KERNEL_POINTS["ssm_scan"])
    state = [f for f in sym.families if f.name.startswith("h state")]
    assert len(state) == 2
    assert all(isinstance(f, AffineFamily) for f in state)


@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_model_step_symbolic_cross_check(config):
    cfg = resolve_model_config(config, smoke=True)
    a = A.get("16B-offset")
    _cross(CROSS_ARCHS,
           model_step_symbolic(cfg, a, batch=2, prompt_len=12, device="cpu"),
           model_step_trace(cfg, a, batch=2, prompt_len=12, device="cpu"),
           block_ops=64)
