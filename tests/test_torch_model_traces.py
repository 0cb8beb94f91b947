"""Whole-model decode traffic (``repro_torch.models.trace``) held to the JAX
reference (``repro.models.trace``) on the CPU.

The three traffic kernels (``attn_decode`` / ``moe_a2a`` / ``ssm_scan``):
their dense traces, their streamed blocks at ``block_ops`` None, 64 and
4096, and their host ``_run`` results bit-equal to the reference's, and
each priced to the reference's ``TraceCost`` at every block size.  The
whole-step ``model_step_trace`` of llama3_2_1b, mixtral_8x22b and
jamba_v0_1_52b, smoke and full: the same page tables (from the port's own
allocator, under every banked layout and the canonical pool), the same
streams and the same ``TraceCost``s, field for field.  Then the Trace
protocol (re-iteration, the arch-dependent lowering, the contract check
of ``analysis/contracts.py``), the registry's ten kernels, the pinned flip
(a whole llama step is won by 16B, ``attn_decode`` alone by 4R-1W) and
every config's whole-step ranking equal to the reference's, and the
engine-equals-loop properties of the reference's suite."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import kernels as rk
from repro import tune as RTune
from repro.bench import model_workload as r_model_workload
from repro.core import arch as RA
from repro.core.cost_engine import cost_many as r_cost_many
from repro.models import trace as RT
from repro_torch import configs as PC
from repro_torch import kernels as pk
from repro_torch import tune as PTune
from repro_torch.analysis.contracts import validate
from repro_torch.bench import model_workload as p_model_workload
from repro_torch.core import arch as PA
from repro_torch.core.cost_engine import cost_many as p_cost_many
from repro_torch.core.trace import TraceStream
from repro_torch.models import trace as PT

#: canonical kernel points (the reference suite's): a paged KV table with
#: unmapped tails, mid-page and page-boundary positions
_PT = np.array([[0, 3, 6, -1], [1, 4, -1, -1], [2, 5, 7, -1]], np.int32)
_POS = np.array([17, 9, 21])
KERNEL_POINTS = {
    "attn_decode": (_PT, _POS, 64, 4, 8),
    "moe_a2a": (np.random.default_rng(0).integers(0, 8, size=64)
                .astype(np.int32), 8, 16),
    "ssm_scan": (2, 64, 16, 4),
}
MODEL_CONFIGS = ("llama3_2_1b", "mixtral_8x22b", "jamba_v0_1_52b")
STEP_ARCHS = ("16B-offset", "16B", "4R-2W", "4R-1W-VB")
COST_ARCHS = ("16B", "8B-offset", "16B-xor", "4B-fold", "4R-2W", "4R-1W-VB")
#: every banked layout the paper's memories give the page pool, and the
#: multi-port memories' canonical pool
LAYOUT_ARCHS = ("16B", "16B-offset", "8B", "8B-offset", "4B", "4B-offset",
                "4R-1W", "4R-2W", "4R-1W-VB")
FIELDS = ("addrs", "kinds", "instr", "mask")


def _same_trace(got, want) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


def _same_blocks(got, want) -> None:
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_trace(g, w)
        assert bool(g.meta.get("instr_carry")) == bool(
            w.meta.get("instr_carry"))


def _costs(costs) -> list:
    return [vars(c) for c in costs]


def _p_archs(names):
    return [PA.get(n) for n in names]


def _r_archs(names):
    return [RA.get(n) for n in names]


# ------------------------------------------------------- traffic kernels --

def test_registry_holds_the_reference_ten():
    assert pk.names() == rk.names()
    assert len(pk.names()) == 10
    assert set(PT.MODEL_TRACE_KERNELS) <= set(pk.names())
    for name in PT.MODEL_TRACE_KERNELS:
        assert pk.get(name).description == rk.get(name).description


@pytest.mark.parametrize("name", sorted(KERNEL_POINTS))
def test_kernel_trace_equals_the_reference(name):
    args = KERNEL_POINTS[name]
    got = pk.get(name).address_trace("16B", *args)
    want = rk.get(name).address_trace("16B", *args)
    _same_trace(got, want)
    assert got.meta == want.meta == {"kernel": name}


@pytest.mark.parametrize("block_ops", [None, 64, 4096])
@pytest.mark.parametrize("name", sorted(KERNEL_POINTS))
def test_kernel_blocks_and_costs_equal_the_reference(name, block_ops):
    args = KERNEL_POINTS[name]
    p, r = pk.get(name), rk.get(name)
    _same_blocks(p.blocks(PA.get("16B"), *args, block_ops=block_ops),
                 r.blocks(RA.get("16B"), *args, block_ops=block_ops))
    got = p_cost_many(_p_archs(COST_ARCHS),
                      p.trace_blocks("16B", *args, block_ops=block_ops),
                      device="cpu")
    want = r_cost_many(_r_archs(COST_ARCHS),
                       r.trace_blocks("16B", *args, block_ops=block_ops))
    assert _costs(got) == _costs(want)


@pytest.mark.parametrize("name", sorted(KERNEL_POINTS))
def test_kernel_run_equals_the_reference(name):
    """The host ``_run`` (the ``cuda`` entry, the reference's ``pallas``)
    and the ``ref`` give the reference's arrays bit for bit."""
    args = KERNEL_POINTS[name]
    want = rk.get(name).run("16B", *args)
    for got in (pk.get(name).run("16B", *args),
                pk.get(name).reference("16B", *args)):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        elif isinstance(want, tuple):
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, np.asarray(w))
        else:
            np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name", sorted(KERNEL_POINTS))
def test_kernel_cost_cycles_equal_the_reference(name):
    args = KERNEL_POINTS[name]
    for a in ("16B", "4B-offset", "4R-1W"):
        assert (pk.get(name).cost_cycles(a, *args, device="cpu")
                == rk.get(name).cost_cycles(a, *args))


@pytest.mark.parametrize("name", sorted(KERNEL_POINTS))
def test_kernel_contract_clean_and_stream_reiterates(name):
    k = pk.get(name)
    args = KERNEL_POINTS[name]
    a = PA.get("16B")
    validate(k.address_trace(a, *args), a)
    assert validate(k.trace_blocks(a, *args, block_ops=7), a).n_ops > 0
    s = k.trace_blocks("16B", *args, block_ops=7)
    _same_trace(s.materialize(), s.materialize())
    one_shot = TraceStream(iter(list(s)))
    one_shot.materialize()
    with pytest.raises(RuntimeError, match="one-shot"):
        one_shot.materialize()


def test_moe_a2a_calls_the_dispatch_ref_not_the_kernel(monkeypatch):
    """``moe_a2a`` takes its grant positions from the registered
    ``moe_dispatch`` kernel's ``ref``, as the reference does."""
    disp = pk.get("moe_dispatch")
    calls = []

    def ref(*a, **kw):
        calls.append(a[2])
        return disp.ref(*a, **kw)
    monkeypatch.setitem(pk.registry._KERNELS, "moe_dispatch",
                        pk.Kernel(name="moe_dispatch", cuda=None, ref=ref))
    pk.get("moe_a2a").run("16B", *KERNEL_POINTS["moe_a2a"])
    assert calls == [8]


# ------------------------------------------------------- whole decode step --

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_resolved_config_equals_the_reference(config, smoke):
    got = PT.resolve_model_config(config, smoke=smoke)
    want = RT.resolve_model_config(config, smoke=smoke)
    assert vars(got) == vars(want)
    arch_id = {m: a for a, m in PC._MODULES.items()}[config]
    assert vars(PT.resolve_model_config(arch_id, smoke=smoke)) == vars(want)
    with pytest.raises(KeyError, match="unknown model config"):
        PT.resolve_model_config("no-such-model")


def test_page_tables_equal_the_reference_under_every_layout():
    """The decode point's page table comes from the port's allocator:
    every page id equal to the reference's, under each banked layout and
    the multi-port memories' canonical pool (the table depends on the
    layout and the (batch, prompt, page) point, not on the model)."""
    points = [(a, (4, 32, 8)) for a in LAYOUT_ARCHS] + [
        (a, (3, 13, 4)) for a in ("16B-offset", "8B", "4R-2W")]
    for a, (batch, prompt, page) in points:
        got = PT._decode_point("llama3_2_1b", a, batch, prompt, page,
                               device="cpu")
        want = RT._decode_point("llama3_2_1b", a, batch, prompt, page)
        np.testing.assert_array_equal(got[3], np.asarray(want[3]))
        np.testing.assert_array_equal(got[4], want[4])
        assert vars(got[2]) == vars(want[2])
        assert got[1].name == want[1].name


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_model_step_streams_and_costs_equal_the_reference(config, smoke):
    """The same streams and the same ``TraceCost``s on 16B-offset, 16B,
    4R-2W and 4R-1W-VB: each memory's own lowering priced under all
    four."""
    cfg_p = PT.resolve_model_config(config, smoke=smoke)
    cfg_r = RT.resolve_model_config(config, smoke=smoke)
    for a in STEP_ARCHS:
        got_s = PT.model_step_trace(cfg_p, a, device="cpu")
        want_s = RT.model_step_trace(cfg_r, a)
        assert got_s.meta == want_s.meta
        got, want = got_s.materialize(), want_s.materialize()
        _same_trace(got, want)
        assert _costs(p_cost_many(_p_archs(STEP_ARCHS), got,
                                  device="cpu")) == _costs(
            r_cost_many(_r_archs(STEP_ARCHS), want))


@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_model_step_block_size_invariance(config):
    cfg = PT.resolve_model_config(config, smoke=True)
    a = PA.get("16B-offset")
    archs = _p_archs(COST_ARCHS)
    dense = PT.model_step_trace(cfg, a, batch=2, prompt_len=12,
                                device="cpu").materialize()
    want = p_cost_many(archs, dense, device="cpu")
    for block_ops in (1, 7, 64, dense.n_ops):
        s = PT.model_step_trace(cfg, a, batch=2, prompt_len=12,
                                block_ops=block_ops, device="cpu")
        assert p_cost_many(archs, s, device="cpu") == want, block_ops


@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_model_step_contract_clean(config):
    cfg = PT.resolve_model_config(config, smoke=True)
    for name in ("16B-offset", "4R-2W"):
        rep = validate(PT.model_step_trace(cfg, name, batch=2, prompt_len=12,
                                           block_ops=16, device="cpu"),
                       name)
        assert rep.ok and rep.n_ops > 0


@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_model_step_reiterates(config):
    """The routing replays from the seed, so two passes are bit-identical
    (and instruction ids non-decreasing); other seeds route differently on
    MoE configs, as the reference's do."""
    cfg = PT.resolve_model_config(config, smoke=True)
    s = PT.model_step_trace(cfg, "16B", batch=2, prompt_len=12,
                            block_ops=16, device="cpu")
    t1, t2 = s.materialize(), s.materialize()
    _same_trace(t1, t2)
    assert (np.diff(t1.instr) >= 0).all()
    if cfg.n_experts:
        other = PT.model_step_trace(cfg, "16B", batch=2, prompt_len=12,
                                    block_ops=16, seed=1,
                                    device="cpu").materialize()
        want = RT.model_step_trace(
            RT.resolve_model_config(config, smoke=True), "16B", batch=2,
            prompt_len=12, block_ops=16, seed=1).materialize()
        assert not np.array_equal(t1.addrs, other.addrs)
        _same_trace(other, want)


def test_model_step_arch_dependent_lowering():
    cfg = PT.resolve_model_config("llama3_2_1b", smoke=True)
    lsb = PT.model_step_trace(cfg, "16B", batch=2, prompt_len=12,
                              device="cpu").materialize()
    off = PT.model_step_trace(cfg, "16B-offset", batch=2, prompt_len=12,
                              device="cpu").materialize()
    assert not np.array_equal(lsb.addrs, off.addrs)


def test_model_workload_equals_the_reference():
    got = p_model_workload("mixtral_8x22b", device="cpu")
    want = r_model_workload("mixtral_8x22b")
    assert got.name == want.name and got.meta == want.meta
    for a in LAYOUT_ARCHS:
        assert got._key(PA.get(a)) == want._key(RA.get(a))
    small = p_model_workload("llama3_2_1b", batch=2, prompt_len=8,
                             device="cpu")
    _same_trace(small.trace(PA.get("8B")),
                r_model_workload("llama3_2_1b", batch=2,
                                 prompt_len=8).trace(RA.get("8B")))


# ----------------------------------------------------- headline, pinned --

def _ranking(results) -> list:
    return [(r.arch, r.total_cycles, r.time_us, r.objective)
            for r in results]


def test_whole_step_winner_flips_attention_kernel_winner():
    kernel_rank = PTune.search(kernel="attn_decode",
                               workload=KERNEL_POINTS["attn_decode"],
                               device="cpu")
    model_rank = PTune.search(workload=p_model_workload("llama3_2_1b",
                                                        device="cpu"),
                              device="cpu")
    assert len(model_rank) == 9
    assert kernel_rank[0].arch == "4R-1W"
    assert model_rank[0].arch == "16B"
    assert _ranking(kernel_rank) == _ranking(RTune.search(
        kernel="attn_decode", workload=KERNEL_POINTS["attn_decode"]))


@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_whole_step_ranking_equals_the_reference(config):
    """Every config's full whole-step ranking over the nine paper
    memories, point for point: llama and mixtral are won by 16B, jamba by
    16B-offset."""
    got = PTune.search(workload=p_model_workload(config, device="cpu"),
                       device="cpu")
    want = RTune.search(workload=r_model_workload(config))
    assert _ranking(got) == _ranking(want)
    assert got[0].arch == {"llama3_2_1b": "16B", "mixtral_8x22b": "16B",
                           "jamba_v0_1_52b": "16B-offset"}[config]


@pytest.mark.parametrize("name", sorted(KERNEL_POINTS))
def test_kernel_rankings_equal_the_reference(name):
    got = PTune.search(kernel=name, workload=KERNEL_POINTS[name],
                       device="cpu")
    want = RTune.search(kernel=name, workload=KERNEL_POINTS[name])
    assert _ranking(got) == _ranking(want)


# ------------------------------------------------------ property testing --

@settings(max_examples=15, deadline=None, database=None)
@given(st.integers(4, 64), st.integers(1, 8),
       st.sampled_from([4, 8, 16]), st.integers(0, 2 ** 20))
def test_property_attn_decode_engine_equals_loop(seq_len, n_heads,
                                                 page_len, seed):
    """Random (seq_len, n_heads, page_len) attention points: engine ==
    loop, instruction ids non-decreasing at every block size, and the
    trace equal to the reference's."""
    rng = np.random.default_rng(seed)
    batch = int(rng.integers(1, 5))
    lens = rng.integers(1, seq_len + 1, batch)
    max_pages = -(-(seq_len + 1) // page_len)
    pt = np.full((batch, max_pages), -1, np.int64)
    pool = rng.permutation(2 * batch * max_pages)
    nxt = 0
    for b, ln in enumerate(lens):
        n_mapped = ln // page_len + 1
        pt[b, :n_mapped] = pool[nxt:nxt + n_mapped]
        nxt += n_mapped
    k = pk.get("attn_decode")
    args = (pt, lens, 32, n_heads, page_len)
    t = k.address_trace("16B", *args)
    _same_trace(t, rk.get("attn_decode").address_trace("16B", *args))
    assert (np.diff(t.instr) >= 0).all()
    archs = _p_archs(("16B", "8B-offset", "4B-xor", "4R-2W"))
    batched = p_cost_many(archs, t, device="cpu")
    assert batched == p_cost_many(
        archs, k.trace_blocks("16B", *args, block_ops=7), device="cpu")
    for a, c in zip(archs, batched):
        assert c == a._cost_loop(t, device="cpu"), a.name


@settings(max_examples=15, deadline=None, database=None)
@given(st.sampled_from([2, 4, 8]), st.integers(1, 96),
       st.integers(0, 2 ** 20))
def test_property_moe_a2a_engine_equals_loop(n_experts, n_req, seed):
    """Random MoE routing draws: arbiter-granted slot streams keep engine
    == loop parity, non-decreasing instruction ids, and the reference's
    trace."""
    rng = np.random.default_rng(seed)
    experts = rng.integers(0, n_experts, n_req).astype(np.int32)
    capacity = int(rng.integers(1, 5)) * 4
    k = pk.get("moe_a2a")
    args = (experts, n_experts, capacity)
    t = k.address_trace("16B", *args)
    _same_trace(t, rk.get("moe_a2a").address_trace("16B", *args))
    assert (np.diff(t.instr) >= 0).all()
    archs = _p_archs(("16B", "8B-fold", "4B-offset", "4R-1W-VB"))
    batched = p_cost_many(archs, t, device="cpu")
    assert batched == p_cost_many(
        archs, k.trace_blocks("16B", *args, block_ops=3), device="cpu")
    for a, c in zip(archs, batched):
        assert c == a._cost_loop(t, device="cpu"), a.name


def test_entry_points_default_to_the_card():
    """The lowering allocates its pages on the card unless the caller
    passes ``device="cpu"``; without a card it fails instead of running
    on the host."""
    import inspect

    import torch
    for fn in (PT.model_step_trace, PT._decode_point, p_model_workload):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            PT.model_step_trace("llama3_2_1b", "16B")
