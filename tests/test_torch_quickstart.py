"""The quickstart surface of the port held to the JAX reference on the CPU:
``repro_torch.core`` exports every name of ``repro.core.__all__``; the
seven functions this surface adds (``op_cycles_from_addrs``,
``total_cycles``, ``bank_efficiency``, ``imbalance_factor``,
``op_conflict_cycles``, ``instruction_cycles``, ``cost_trace``) and the
functional ``Memory`` equal the reference's on the reference tests' inputs
(``tests/test_memsim.py``, ``tests/test_arch.py``'s legacy shims) and on
random ones; ``python -m repro_torch.examples.quickstart`` prints what
``examples/quickstart.py`` prints, both run in this process; the ten model
configurations equal the reference's field for field, the serving CLI
and example refuse the modality frontends before they make any weight, serves the
SSM, hybrid and MoE families with the reference CLI's lines, and the
other dense configurations it builds give the reference's prefill
logits."""
import dataclasses
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as PC
from repro import configs as RCF
from repro.core import conflicts as RCon
from repro.core import memsim as RM
from repro_torch import configs as PCF
from repro_torch.core import conflicts as PCon
from repro_torch.core import memsim as PM
from repro_torch.examples import quickstart as PQ

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def test_core_exports_the_references_all():
    assert len(RC.__all__) == 44
    assert sorted(PC.__all__) == sorted(RC.__all__)
    missing = [n for n in RC.__all__ if not hasattr(PC, n)]
    assert not missing


# ---------------------------------------------------- core/conflicts.py --

@pytest.mark.parametrize("mapping", ["lsb", "offset", "xor", "fold"])
@pytest.mark.parametrize("n_banks", [4, 8, 16])
def test_op_cycles_and_totals_equal_the_reference(n_banks, mapping):
    addrs = RNG.integers(0, 4096, (37, 16)).astype(np.int32)
    mask = RNG.random((37, 16)) > 0.3
    for m in (None, mask):
        want = RCon.op_cycles_from_addrs(
            jnp.asarray(addrs), n_banks, mapping,
            None if m is None else jnp.asarray(m))
        got = PC.op_cycles_from_addrs(_t(addrs), n_banks, mapping,
                                      None if m is None else _t(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(PCon.total_cycles(
            _t(addrs), n_banks, mapping,
            None if m is None else _t(m))) == int(RCon.total_cycles(
                jnp.asarray(addrs), n_banks, mapping,
                None if m is None else jnp.asarray(m)))
    if mapping == "offset":
        want = RCon.op_cycles_from_addrs(jnp.asarray(addrs), n_banks,
                                         mapping, shift=3)
        got = PC.op_cycles_from_addrs(_t(addrs), n_banks, mapping, shift=3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bank_efficiency_and_imbalance_equal_the_reference():
    for actual, n_ops in ((100, 64), (0, 5), (64, 64)):
        got = PC.bank_efficiency(actual, n_ops)
        want = RC.bank_efficiency(actual, n_ops)
        assert got.dtype == torch.float32
        assert float(got) == float(want)
    actual = RNG.integers(0, 50, 12)
    np.testing.assert_array_equal(
        PC.bank_efficiency(_t(actual), 32).numpy(),
        np.asarray(RC.bank_efficiency(jnp.asarray(actual), 32)))
    for n_banks in (4, 8, 16):
        banks = RNG.integers(0, n_banks, (9, 16)).astype(np.int32)
        mask = RNG.random((9, 16)) > 0.5
        for m in (None, mask):
            got = PC.imbalance_factor(_t(banks), n_banks,
                                      None if m is None else _t(m))
            want = RC.imbalance_factor(jnp.asarray(banks), n_banks,
                                       None if m is None else jnp.asarray(m))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
    assert float(PC.imbalance_factor(torch.zeros(16, dtype=torch.int32),
                                     4)) == 4.0


# ------------------------------------------------------- core/memsim.py --

def test_multiport_read_write_determinism():
    addrs = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    m41 = PM.multiport(4, 1)
    assert PM.op_conflict_cycles(m41, addrs).tolist() == [4, 4, 4, 4]
    assert PM.op_conflict_cycles(m41, addrs,
                                 is_write=True).tolist() == [16] * 4
    m42 = PM.multiport(4, 2)
    assert PM.op_conflict_cycles(m42, addrs,
                                 is_write=True).tolist() == [8] * 4
    assert m42.fmax_mhz == 600.0 and m41.fmax_mhz == 771.0


def test_vb_write_is_4bank_arbitrated():
    vb = PM.multiport(4, 1, vb=True)
    seq = torch.arange(16, dtype=torch.int32)[None, :]
    assert PM.op_conflict_cycles(vb, seq, is_write=True).tolist() == [4]
    same = torch.zeros((1, 16), dtype=torch.int32)
    assert PM.op_conflict_cycles(vb, same, is_write=True).tolist() == [16]
    assert PM.op_conflict_cycles(vb, same).tolist() == [4]


def test_banked_conflict_extremes_and_the_offset_map():
    b16 = PM.banked(16)
    unit = torch.arange(16, dtype=torch.int32)[None, :]
    assert PM.op_conflict_cycles(b16, unit).tolist() == [1]
    assert PM.op_conflict_cycles(b16, unit * 16).tolist() == [16]
    assert PM.op_conflict_cycles(
        b16, torch.full((1, 16), 42, dtype=torch.int32)).tolist() == [16]
    i_words = 2 * unit
    assert int(PM.op_conflict_cycles(PM.banked(16, "lsb"), i_words)[0]) == 2
    assert int(PM.op_conflict_cycles(PM.banked(16, "offset"),
                                     i_words)[0]) == 1


def test_instruction_overheads_calibrated():
    """A store of 64 fully conflicted ops reproduces Table II's 1054."""
    addrs = torch.zeros((64, 16), dtype=torch.int32) + 16 * torch.arange(
        16, dtype=torch.int32)
    assert PM.instruction_cycles(PM.banked(16), addrs, True) == 64 * 16 + 30
    assert PM.instruction_cycles(PM.banked(8), addrs, True) == 64 * 16 + 24
    assert PM.instruction_cycles(PM.banked(4), addrs, True) == 64 * 16 + 22


def test_spec_level_shims_equal_the_reference_on_every_paper_memory():
    addrs = np.arange(64, dtype=np.int32).reshape(4, 16) * 3
    mask = RNG.random((4, 16)) > 0.25
    for pspec, rspec in zip(PM.PAPER_MEMORIES, RM.PAPER_MEMORIES,
                            strict=True):
        for m in (None, mask):
            pm = None if m is None else _t(m)
            rm = None if m is None else jnp.asarray(m)
            for is_write in (False, True):
                np.testing.assert_array_equal(
                    PM.op_conflict_cycles(pspec, _t(addrs), pm,
                                          is_write).numpy(),
                    np.asarray(RM.op_conflict_cycles(
                        rspec, jnp.asarray(addrs), rm, is_write)))
                assert PM.instruction_cycles(
                    pspec, _t(addrs), is_write, pm) == RM.instruction_cycles(
                    rspec, jnp.asarray(addrs), is_write, rm)
        loads = [RNG.integers(0, 512, (n, 16)).astype(np.int32)
                 for n in (3, 5)]
        stores = [RNG.integers(0, 512, (4, 16)).astype(np.int32)]
        tws = [np.zeros((2, 16), np.int32)]
        counts = {"fp": 5, "int": 2}
        got = PM.cost_trace(pspec, [_t(a) for a in loads], stores, tws,
                            compute_cycles=7, op_counts=counts,
                            device="cpu")
        want = RM.cost_trace(rspec, [jnp.asarray(a) for a in loads], stores,
                             tws, compute_cycles=7, op_counts=counts)
        assert vars(got) == vars(want)


def test_functional_memory_roundtrip_and_predicated_write():
    mem = PM.Memory.zeros(128, device="cpu")
    addrs = torch.arange(0, 32, 2, dtype=torch.int32)
    vals = torch.arange(16, dtype=torch.float32) + 1
    mem = mem.write(addrs, vals)
    assert torch.equal(mem.read(addrs), vals)
    assert torch.equal(mem.read(addrs + 1), torch.zeros(16))
    # masked-off lanes, out-of-range and negative addresses as the
    # reference's predicated scatter treats them
    a = np.array([5, 7, 130, -1, 9, 11], np.int32)
    v = np.arange(6, dtype=np.float32) + 10
    mask = np.array([True, False, True, True, True, False])
    for m in (None, mask):
        got = mem.write(_t(a), _t(v), None if m is None else _t(m))
        want = RM.Memory(jnp.asarray(mem.words.numpy())).write(
            jnp.asarray(a), jnp.asarray(v),
            None if m is None else jnp.asarray(m))
        assert got.words.dtype == torch.float32
        np.testing.assert_array_equal(got.words.numpy(),
                                      np.asarray(want.words))
    assert torch.equal(mem.words[:4], torch.tensor([1., 0., 2., 0.]))


# ------------------------------------------------------------ quickstart --

def test_quickstart_prints_what_the_reference_prints(capsys):
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    got = PQ.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert got["arbitration"] == {
        "cycles": 3, "grants": [[(0, 0), (1, 1), (3, 3), (4, 5), (6, 7)],
                                [(1, 2), (3, 6)], [(1, 4)]]}
    assert [r["total_cycles"] for r in got["transpose32"]] == [1549, 1613,
                                                               1159]
    table, idx, rows = got["gather"]
    assert rows[:, 0].tolist() == [1536.0, 30720.0, 3584.0, 3584.0]
    assert torch.equal(rows, table[idx])
    assert got["gather_cost"] == 54
    assert got["dispatch"]["kept"] == [True, True, True, False, True, True,
                                       False, True]
    assert got["dispatch"]["factor"] == 2.0


def test_quickstart_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            PQ.main([])


# -------------------------------------------------------------- configs --

def test_ten_configs_equal_the_reference_field_for_field():
    assert PCF.ARCH_IDS == RCF.ARCH_IDS and len(PCF.ARCH_IDS) == 10
    assert PCF.LONG_CONTEXT_ARCHS == RCF.LONG_CONTEXT_ARCHS
    assert PCF._MODULES == RCF._MODULES
    for a in RCF.ARCH_IDS:
        for p, r in ((PCF.get_config(a), RCF.get_config(a)),
                     (PCF.get_smoke_config(a), RCF.get_smoke_config(a))):
            assert dataclasses.asdict(p) == dataclasses.asdict(r)
            assert p.block_pattern() == r.block_pattern()
            assert (p.n_superblocks, p.padded_vocab(), p.d_inner) == (
                r.n_superblocks, r.padded_vocab(), r.d_inner)
    with pytest.raises(KeyError, match="unknown arch"):
        PCF.get_config("no-such-arch")


REFUSED = {"musicgen-medium": "16 (audio_frames)",
           "phi-3-vision-4.2b": "16 (vision_patches)"}


@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_serve_refuses_unported_families_before_any_weight(arch,
                                                           monkeypatch,
                                                           capsys):
    """``launch/serve.py`` and ``examples/serve_lm.py`` on a smoke config
    with a modality frontend: the serving path passes no frontend
    embeddings (the reference's ``_embed`` asserts them), so both refuse,
    saying so, before ``init_tree`` makes a weight."""
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    made = []
    for module in (serve, serve_lm):
        monkeypatch.setattr(module, "init_tree",
                            lambda *a, **kw: made.append(a) or {})
    for main, argv in ((serve.main, ["--smoke"]), (serve_lm.main, [])):
        with pytest.raises(SystemExit):
            main(["--arch", arch, "--device", "cpu"] + argv)
        err = capsys.readouterr().err
        assert "the serving path passes no frontend embeddings" in err
        assert f"needs {REFUSED[arch]} before its tokens" in err
    assert not made


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b",
                                  "mixtral-8x22b", "phi3.5-moe-42b-a6.6b"])
def test_serve_families_equal_the_reference(arch, capsys):
    """``serve --arch <id> --smoke --cost --device cpu`` for the SSM,
    hybrid and MoE families: on the reference's weights (``from_jax``) in
    float32 compute, the batch's ``run_batch`` prints the reference CLI's
    lines, tokens and cost table, line for line; the CLI's own run (its
    seeded weights, bfloat16 compute) prints the same cost table and four
    requests of 32 tokens in the vocabulary.  (Its tokens are not held to
    the reference's in bfloat16: the two backends' bfloat16 layers differ
    by an ulp, which moves a routing or a later argmax within a few dozen
    tokens.)"""
    import argparse

    import jax

    from repro.configs.base import RunConfig as RRun
    from repro.launch import serve as r_serve
    from repro.launch.sharding import NO_AXES
    from repro.models import init_tree as r_init
    from repro.models import model_specs as r_specs
    from repro.serving.engine import ServeEngine as RServe
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve
    from repro_torch.launch.sharding import NO_AXES as P_NO_AXES
    from repro_torch.models import from_jax, model_specs
    from repro_torch.serving.engine import ServeEngine
    serve.main(["--arch", arch, "--smoke", "--cost", "--device", "cpu"])
    cli = capsys.readouterr().out.splitlines()

    cfg, rcfg = PCF.get_smoke_config(arch), RCF.get_smoke_config(arch)
    r_params = r_init(r_specs(rcfg), jax.random.PRNGKey(0))
    params = from_jax(model_specs(cfg), jax.tree.map(np.asarray, r_params),
                      device="cpu")
    args = argparse.Namespace(batch=4, prompt_len=16, new_tokens=32,
                              page_len=8, cost=True, seed=0)
    kw = dict(max_batch=4, max_seq=16 + 32 + 4)
    serve.run_batch(args, ServeEngine(
        cfg, RunConfig(remat="none", attn_impl="dense",
                       compute_dtype="float32"), params, P_NO_AXES,
                       device="cpu", **kw),
        cfg)
    got = capsys.readouterr().out.splitlines()
    r_serve.run_batch(args, RServe(
        rcfg, RRun(remat="none", attn_impl="dense", compute_dtype="float32"),
        r_params, NO_AXES, **kw), rcfg)
    want = capsys.readouterr().out.splitlines()
    assert got == want
    assert cli[4:] == want[4:]             # the traffic line and cost table
    assert [ln.split(":")[0] for ln in cli[:4]] == [f"req{b}"
                                                    for b in range(4)]
    for ln in cli[:4]:
        toks = [int(t) for t in ln.split("[")[1].rstrip("]").split(",")]
        assert len(toks) == 32 and 0 <= min(toks) <= max(toks) < (
            cfg.vocab_size)
    assert [ln.split()[0] for ln in cli[-6:]] == list(serve.COST_MEMORIES)


@pytest.mark.parametrize("arch", ["gemma2-9b", "minicpm-2b",
                                  "qwen1.5-110b"])
def test_dense_configs_serve_runs_equal_the_reference(arch):
    """The other dense configs, which ``launch/serve.py`` now builds (local
    and global windows and softcaps, an odd vocab, QKV bias): the port's
    prefill logits equal the reference's on the reference's weights, at
    the model tests' float32 tolerance."""
    import jax

    from repro.configs.base import RunConfig as RRun
    from repro.launch.sharding import NO_AXES
    from repro.models import init_tree as r_init
    from repro.models import model_specs as r_specs
    from repro.models import transformer as RTm
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import from_jax, model_specs
    from repro_torch.models import transformer as PTm
    cfg, rcfg = PCF.get_smoke_config(arch), RCF.get_smoke_config(arch)
    r_params = r_init(r_specs(rcfg), jax.random.PRNGKey(1))
    params = from_jax(model_specs(cfg), jax.tree.map(np.asarray, r_params),
                      device="cpu")
    tokens = RNG.integers(0, cfg.vocab_size, (2, 32))
    got, _ = PTm.prefill(cfg, RunConfig(remat="none", attn_impl="dense",
                                        compute_dtype="float32"),
                         params, torch.tensor(tokens))
    want, _ = RTm.prefill(rcfg, RRun(remat="none", attn_impl="dense",
                                     compute_dtype="float32"),
                          r_params, jnp.asarray(tokens), NO_AXES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
