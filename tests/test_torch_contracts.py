"""The port's trace-contract checker (``repro_torch.analysis.contracts``)
held to the JAX reference's (``repro.analysis.contracts``): the same
traces, built from numpy in both packages, give equal reports (every
field, violation messages included) and raise the same messages; valid
streams of every producer the port has pass; ``checked_blocks`` and
``cost_many(checked=)`` / ``arch.cost(checked=)`` behave as the
reference's, a checked call pricing bit-equal to an unchecked one; and the
``checking()`` switch arms ``cost_many``.  All of it is host numpy and
integer results, compared exactly."""
import dataclasses
import types

import numpy as np
import pytest

from repro.analysis import contracts as RC
from repro.core import arch as RA
from repro.core import cost_engine as RCE
from repro.core import trace as RT
from repro_torch import analysis as PAN
from repro_torch.analysis import contracts as PC
from repro_torch.core import arch as PA
from repro_torch.core import cost_engine as PCE
from repro_torch.core import trace as PT

REF = types.SimpleNamespace(tr=RT, c=RC, arch=RA, ce=RCE, device={})
PORT = types.SimpleNamespace(tr=PT, c=PC, arch=PA, ce=PCE,
                             device={"device": "cpu"})


def _ops(m, n_ops, kind="load", base=0, instr=None, mask=None):
    addrs = (np.arange(n_ops * 16) % 251).reshape(n_ops, 16) + base
    t = m.tr.AddressTrace.from_ops(addrs, kind=kind, mask=mask)
    t.instr[:] = np.arange(n_ops) if instr is None else np.asarray(instr)
    return t


class _RawBlocks:
    """A trace whose ``blocks`` replays pre-built blocks verbatim: the way
    to hand the validator a protocol-level violation, since ``TraceStream``
    renumbers source-local ids into legality."""

    def __init__(self, blocks, meta=None):
        self._blocks = blocks
        self.meta = meta or {}

    def blocks(self, block_ops=None):
        yield from self._blocks


def _report(rep) -> dict:
    return dataclasses.asdict(rep) | {"ok": rep.ok}


# -- one constructor per case: (trace, validate kwargs), built in either package

def _dense(m):
    return _ops(m, 40), {}


def _stream_two_kinds(m):
    return m.tr.TraceStream([_ops(m, 8), _ops(m, 8, kind="store")]), {
        "block_ops": 4}


def _empty(m):
    return m.tr.AddressTrace.empty(), {}


def _empty_stream(m):
    return m.tr.TraceStream([]), {}


def _all_false_mask(m):
    return _ops(m, 6, mask=np.zeros((6, 16), bool)), {}


def _masked_junk(m):
    return m.tr.AddressTrace.from_ops(np.full((3, 16), -7), kind="load",
                                      mask=np.zeros((3, 16), bool)), {}


def _block_ops_one(m):
    return _ops(m, 17), {"block_ops": 1}


def _carry_chain(m):
    addrs = np.arange(10 * 16).reshape(10, 16)
    return m.tr.TraceStream(lambda: m.tr.iter_op_chunks(
        addrs, kind="load", block_ops=3)), {}


def _uncarried_kind_sharing(m):
    b1, b2 = _ops(m, 4), _ops(m, 4, kind="store")
    b2.instr[:] = b1.instr.max()
    return _RawBlocks([b1, b2]), {}


def _compute_only(m):
    t = m.tr.AddressTrace.empty().with_compute(12, {"fp": 3})
    return m.tr.TraceStream([t, _ops(m, 5)]), {}


VALID = [_dense, _stream_two_kinds, _empty, _empty_stream, _all_false_mask,
         _masked_junk, _block_ops_one, _carry_chain,
         _uncarried_kind_sharing, _compute_only]


def _decrease_across(m):                          # instrs
    return _RawBlocks([_ops(m, 4, instr=[10, 11, 12, 13]),
                       _ops(m, 4, instr=[5, 6, 7, 8])]), {}


def _decrease_within(m):                          # instrs
    b = _ops(m, 4)
    object.__setattr__(b, "instr", np.array([3, 2, 1, 0], np.int32))
    return _RawBlocks([b]), {}


def _negative_id(m):                              # instrs
    return _RawBlocks([_ops(m, 3, instr=[-2, -1, 0])]), {}


def _bad_carry(m):                                # instrs
    b1, b2 = _ops(m, 4), _ops(m, 4)
    b2.instr[:] = b1.instr.max() + 5
    b2.meta["instr_carry"] = True
    return _RawBlocks([b1, b2]), {}


def _carry_first(m):                              # instrs
    b = _ops(m, 4)
    b.meta["instr_carry"] = True
    return _RawBlocks([b]), {}


def _bad_shapes(m):                               # shapes
    b = _ops(m, 4)
    object.__setattr__(b, "instr", b.instr[:, None])
    return _RawBlocks([b]), {}


def _bad_mask_dtype(m):                           # shapes
    b = _ops(m, 4)
    object.__setattr__(b, "mask", np.ones((4, 16), np.int8))
    return _RawBlocks([b]), {}


def _bad_kind(m):                                 # kinds
    b = _ops(m, 4)
    b.kinds[1:3] = 7
    return _RawBlocks([b]), {}


def _negative_addr(m):                            # addrs
    return m.tr.AddressTrace.from_ops(np.full((2, 16), -3), kind="load"), {}


def _out_of_bounds(m):                            # addrs
    return _ops(m, 4, base=10**9), {"n_words": 1 << 20}


def _bound_from_meta(m):                          # addrs
    t = _ops(m, 4, base=4090)
    t.meta["n_words"] = 4096
    return t, {}


def _negative_compute(m):                         # blocks
    t = m.tr.AddressTrace.empty().with_compute(-5)
    return _RawBlocks([t, _ops(m, 2)]), {}


def _not_a_block(m):                              # blocks
    return _RawBlocks([_ops(m, 2), "junk", _ops(m, 2, instr=[2, 3])]), {}


def _source_kind_change(m):                       # sources
    b1, b2 = _ops(m, 4), _ops(m, 4, kind="store")
    b2.meta["instr_carry"] = True
    return m.tr.TraceStream([b1, b2]), {}


def _source_carry_first(m):                       # sources
    b = _ops(m, 4)
    b.meta["instr_carry"] = True
    return m.tr.TraceStream([m.tr.AddressTrace.empty().with_compute(3), b]), {}


def _source_carry_compute_only(m):                # sources
    c = m.tr.AddressTrace.empty().with_compute(3)
    c.meta["instr_carry"] = True
    return m.tr.TraceStream([_ops(m, 2), c]), {}


CORRUPT = [_decrease_across, _decrease_within, _negative_id, _bad_carry,
           _carry_first, _bad_shapes, _bad_mask_dtype, _bad_kind,
           _negative_addr, _out_of_bounds, _bound_from_meta,
           _negative_compute, _not_a_block, _source_kind_change,
           _source_carry_first, _source_carry_compute_only]


def _validate(m, case, **kw):
    trace, args = case(m)
    return m.c.validate(trace, m.arch.get("16B"), **args, **kw)


def _raised(m, fn):
    with pytest.raises(m.tr.TraceContractError) as exc:
        fn()
    return str(exc.value)


def test_exports_equal_the_reference():
    import repro.analysis as RAN
    assert PAN.__all__ == RAN.__all__
    assert PAN.TraceContractError is PT.TraceContractError


@pytest.mark.parametrize("case", VALID, ids=lambda c: c.__name__[1:])
def test_valid_traces_report_as_the_reference(case):
    got, want = _validate(PORT, case), _validate(REF, case)
    assert got.ok and _report(got) == _report(want)


@pytest.mark.parametrize("case", CORRUPT, ids=lambda c: c.__name__[1:])
def test_corrupted_traces_report_and_raise_as_the_reference(case):
    """One corrupted block (or source) per check: the collected report and
    the first violation's message are the reference's."""
    got = _validate(PORT, case, strict=False)
    want = _validate(REF, case, strict=False)
    assert not got.ok and _report(got) == _report(want)
    assert (_raised(PORT, lambda: _validate(PORT, case))
            == _raised(REF, lambda: _validate(REF, case)))


def test_validate_resolves_the_arch_and_reads_meta_bounds():
    with pytest.raises(KeyError):
        PC.validate(_ops(PORT, 2), "nonsense")
    assert PC.validate(_ops(PORT, 4, base=10**9)).ok   # no bound known


def test_validate_streams_of_every_producer():
    """Serving, scheduler, ISA and kernel streams of the port pass, with
    the reference's report on the same inputs."""
    from repro.isa.programs.transpose import transpose_program as r_prog
    from repro.isa.vm import program_trace_stream as r_stream
    from repro.kernels import registry as r_reg
    from repro.serving.kvcache import simulate_serving_stream as r_serve
    from repro.serving.scheduler import Request as RReq
    from repro.serving.scheduler import simulate_scheduler_stream as r_sched
    from repro_torch.isa.programs.transpose import \
        transpose_program as p_prog
    from repro_torch.isa.vm import program_trace_stream as p_stream
    from repro_torch.kernels import registry as p_reg
    from repro_torch.serving.kvcache import simulate_serving_stream as p_serve
    from repro_torch.serving.scheduler import Request as PReq
    from repro_torch.serving.scheduler import \
        simulate_scheduler_stream as p_sched
    spec = ((0, 12, 8), (0, 5, 6), (1, 8, 4), (2, 3, 0))
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 128, size=48).astype(np.int32)
    table = np.zeros((128, 16), np.float32)
    pairs = [
        (p_stream(p_prog(16)), r_stream(r_prog(16))),
        (p_serve("16B", batch=2, prompt_len=9, decode_steps=4, page_len=8,
                 device="cpu"),
         r_serve("16B", batch=2, prompt_len=9, decode_steps=4, page_len=8)),
        (p_sched("16B-xor", [PReq(i, *s) for i, s in enumerate(spec)],
                 n_lanes=2, max_seq=32, n_kv_layers=2,
                 prefill_chunk_pages=1),
         r_sched("16B-xor", [RReq(i, *s) for i, s in enumerate(spec)],
                 n_lanes=2, max_seq=32, n_kv_layers=2,
                 prefill_chunk_pages=1))]
    for name in ("banked_gather", "banked_scatter"):
        pairs.append((
            PT.TraceStream(lambda n=name: p_reg.get(n).trace_blocks(
                PA.get("16B"), table, idx, block_ops=16)),
            RT.TraceStream(lambda n=name: r_reg.get(n).trace_blocks(
                RA.get("16B"), table, idx, block_ops=16))))
    for got, want in pairs:
        for kw in ({}, {"block_ops": 7}):
            g, w = PC.validate(got, "16B", **kw), RC.validate(want, "16B",
                                                              **kw)
            assert g.ok and _report(g) == _report(w)


def test_checked_blocks_passes_blocks_through_as_the_reference():
    reports = []
    for m in (PORT, REF):
        blocks = [_ops(m, 4), _ops(m, 3, kind="store", instr=[3, 3, 4])]
        rep = m.c.ValidationReport()
        out = list(m.c.checked_blocks(iter(blocks), report=rep))
        assert all(a is b for a, b in zip(out, blocks, strict=True))
        reports.append(_report(rep))
    assert reports[0] == reports[1]
    msgs = [_raised(m, lambda m=m: list(m.c.checked_blocks(
        iter([_ops(m, 4, instr=[3, 2, 1, 0])])))) for m in (PORT, REF)]
    assert msgs[0] == msgs[1]


def _bad_stream(m):
    b1, b2 = _ops(m, 4), _ops(m, 4)
    b2.instr[:] = b1.instr[:] - 1
    return _RawBlocks([b1, b2])


def test_checked_costing_equals_unchecked_and_raises_as_the_reference():
    archs = ["16B", "4R-2W", "8B-xor"]
    t = _ops(PORT, 64)
    for kw in ({}, {"block_ops": 5}):
        checked = PCE.cost_many(archs, t, checked=True, device="cpu", **kw)
        assert checked == PCE.cost_many(archs, t, checked=False,
                                        device="cpu", **kw)
        assert [dataclasses.asdict(c) for c in checked] == [
            dataclasses.asdict(c) for c in RCE.cost_many(
                archs, _ops(REF, 64), checked=True, **kw)]
    a16 = PA.get("16B")
    assert a16.cost(t, checked=True, device="cpu") == a16.cost(
        t, device="cpu")
    assert (_raised(PORT, lambda: PCE.cost_many(
        archs, _bad_stream(PORT), checked=True, device="cpu"))
        == _raised(REF, lambda: RCE.cost_many(archs, _bad_stream(REF),
                                              checked=True)))
    with pytest.raises(PT.TraceContractError):
        a16.cost(_bad_stream(PORT), checked=True, device="cpu")
    # an explicit False trusts the stream, as the reference's does
    PCE.cost_many(archs, _bad_stream(PORT), checked=False, device="cpu")


def test_the_checking_switch_arms_cost_many():
    bad = _bad_stream(PORT)
    assert not PC.is_checking()
    PCE.cost_many(["16B"], bad, device="cpu")          # off: trusted
    with PC.checking():
        assert PC.is_checking() and PAN.is_checking()
        with pytest.raises(PT.TraceContractError):
            PCE.cost_many(["16B"], _bad_stream(PORT), device="cpu")
        with PC.checking(False):
            assert not PC.is_checking()
            PCE.cost_many(["16B"], _bad_stream(PORT), device="cpu")
        assert PC.is_checking()
    assert not PC.is_checking()
    PC.set_checking(True)
    try:
        with pytest.raises(PT.TraceContractError):
            PCE.cost_many(["16B"], _bad_stream(PORT), device="cpu")
    finally:
        PC.set_checking(False)
    assert not PC.is_checking()
