"""Serving the MoE, SSM and hybrid families on the port, held to the JAX
reference on the CPU: the smoke configs of falcon-mamba (SSM), jamba
(hybrid: Mamba, attention and MoE layers), mixtral and phi3.5-moe (MoE)
with the reference's weights carried across by ``from_jax`` and the same
numpy prompts, in float32 compute.

Tolerances: prefill and decode logits within atol 1e-4 (float32 sums in
another order on the two backends, through a few layers of O(1)
activations; the serving tests' bound), the SSM state within rtol 2e-4 /
atol 2e-5 and the K/V and conv caches within atol 1e-5.  Tokens (argmaxes
of those logits), traces and cycle counts are equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.core import arch as RA
from repro.launch.sharding import NO_AXES
from repro.models import init_tree as r_init
from repro.models import model_specs as r_specs
from repro.models import transformer as RT
from repro.serving.engine import ServeEngine as RServe
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import arch as PA
from repro_torch.launch.sharding import NO_AXES as P_NO_AXES
from repro_torch.models import from_jax, model_specs
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import ServeEngine

ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b", "mixtral-8x22b",
         "phi3.5-moe-42b-a6.6b")
PLEN, NEW, BATCH = 12, 6, 3
KW = dict(max_batch=BATCH, max_seq=PLEN + NEW + 6, page_len=4)
FIELDS = ("addrs", "kinds", "instr", "mask")


def _rc(impl="gshard"):
    return (RRun(remat="none", attn_impl="dense", compute_dtype="float32",
                 moe_impl=impl),
            RunConfig(remat="none", attn_impl="dense",
                      compute_dtype="float32", moe_impl=impl))


_MODELS: dict = {}


def _model(arch):
    """(port cfg, reference cfg, port params, reference params, prompts),
    the reference's weights from ``PRNGKey(0)``."""
    if arch not in _MODELS:
        cfg, rcfg = get_smoke_config(arch), r_smoke(arch)
        rp = r_init(r_specs(rcfg), jax.random.PRNGKey(0))
        pp = from_jax(model_specs(cfg), jax.tree.map(np.asarray, rp),
                      device="cpu")
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (BATCH, PLEN)).astype(np.int32)
        _MODELS[arch] = (cfg, rcfg, pp, rp, prompts)
    return _MODELS[arch]


def _close(got, want, atol=1e-4, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_steps_equal_the_reference(arch):
    """``prefill``'s logits and its caches of both kinds ({"k", "v"} for
    attention blocks, {"h", "conv"} for SSM blocks, stacked over
    superblocks), then three dense-cache ``decode_step``s: logits and
    every cache leaf against the reference's."""
    cfg, rcfg, pp, rp, prompts = _model(arch)
    rrc, prc = _rc()
    with torch.inference_mode():
        pl, pc = PT.prefill(cfg, prc, pp, torch.tensor(prompts).long())
    rl, rc_ = RT.prefill(rcfg, rrc, rp, jnp.asarray(prompts), NO_AXES)
    _close(pl, rl)
    kinds = {kind for kind, _ in cfg.block_pattern()}

    def same_caches(p_cache, r_cache):
        assert set(p_cache["blocks"]) == set(r_cache["blocks"])
        for key, leaves in p_cache["blocks"].items():
            assert set(leaves) == set(r_cache["blocks"][key])
            for name, leaf in leaves.items():
                want = np.asarray(r_cache["blocks"][key][name])
                assert tuple(leaf.shape) == want.shape, (key, name)
                if name == "h":
                    _close(leaf, want, atol=2e-5, rtol=2e-4)
                else:
                    _close(leaf, want, atol=1e-5)
    same_caches(pc, rc_)
    names = {n for c in pc["blocks"].values() for n in c}
    assert names == ({"k", "v"} if "attn" in kinds else set()) | (
        {"h", "conv"} if "ssm" in kinds else set())

    max_seq = PLEN + 3
    pe = ServeEngine(cfg, prc, pp, P_NO_AXES, kv_mode="dense", max_batch=BATCH,
                     max_seq=max_seq, device="cpu")
    re_ = RServe(rcfg, rrc, rp, NO_AXES, kv_mode="dense", max_batch=BATCH,
                 max_seq=max_seq)
    pc, rc_ = pe._pad_cache(pc, PLEN), re_._pad_cache(rc_, PLEN)
    tok = np.asarray(jnp.argmax(rl[:, -1, :cfg.vocab_size], -1))[:, None]
    for i in range(3):
        pos = PLEN + i
        with torch.inference_mode():
            pl, pc = PT.decode_step(cfg, prc, pp, torch.tensor(tok).long(),
                                    pc, torch.tensor(pos))
        rl, rc_ = RT.decode_step(rcfg, rrc, rp, jnp.asarray(tok, jnp.int32),
                                 rc_, jnp.asarray(pos, jnp.int32), NO_AXES)
        _close(pl, rl)
        same_caches(pc, rc_)
        tok = np.asarray(jnp.argmax(rl[:, -1, :cfg.vocab_size], -1))[:, None]


_REF_RUNS: dict = {}


def _ref_generate(arch, kv_mode, impl="gshard"):
    """The reference engine's greedy tokens (and, paged, its traces and
    serving cost on the nine paper memories), cached per case."""
    key = (arch, kv_mode, impl)
    if key not in _REF_RUNS:
        _, rcfg, _, rp, prompts = _model(arch)
        eng = RServe(rcfg, _rc(impl)[0], rp, NO_AXES, kv_mode=kv_mode,
                     mem_arch="16B", **KW)
        tokens = eng.generate(prompts, max_new_tokens=NEW).tokens
        extra = None
        if kv_mode == "paged":
            names = [a.name for a in RA.PAPER_ARCHITECTURES]
            extra = (eng.step_trace(), eng.serving_trace(),
                     [c.total_cycles for c in eng.serving_cost(names)])
        _REF_RUNS[key] = (tokens, extra)
    return _REF_RUNS[key]


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_the_reference(arch, kv_mode):
    cfg, _, pp, _, prompts = _model(arch)
    eng = ServeEngine(cfg, _rc()[1], pp, P_NO_AXES,
                      kv_mode=kv_mode, mem_arch="16B",
                      device="cpu", **KW)
    got = eng.generate(prompts, max_new_tokens=NEW).tokens
    np.testing.assert_array_equal(got, _ref_generate(arch, kv_mode)[0])
    if kv_mode == "paged":
        n_attn = sum(kind == "attn" for kind, _ in cfg.block_pattern())
        assert eng.n_kv_layers == n_attn * cfg.n_superblocks
        # the decode state: a pool pair per attention layer, the SSM
        # state per SSM layer
        for key, state in eng.last_pools.items():
            j = int(key[1:key.index("s")])
            kind = cfg.block_pattern()[j][0]
            assert set(state) == ({"k", "v"} if kind == "attn"
                                  else {"h", "conv"})


@pytest.mark.parametrize("arch", ARCHS)
def test_traces_and_cost_rows_equal_the_reference(arch):
    """``step_trace`` / ``serving_trace`` bit-equal to the reference
    engine's, and the generation priced on the nine paper memories equal
    (an attention-free model records empty traces and prices 0 cycles, as
    the reference does)."""
    cfg, _, pp, _, prompts = _model(arch)
    eng = ServeEngine(cfg, _rc()[1], pp, P_NO_AXES,
                      kv_mode="paged", mem_arch="16B",
                      device="cpu", **KW)
    eng.generate(prompts, max_new_tokens=NEW)
    _, (r_step, r_full, r_cycles) = _ref_generate(arch, "paged")
    for got, want in ((eng.step_trace(), r_step),
                      (eng.serving_trace(), r_full)):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    names = [a.name for a in PA.PAPER_ARCHITECTURES]
    cycles = [c.total_cycles for c in eng.serving_cost(names)]
    assert cycles == r_cycles
    if eng.n_kv_layers == 0:
        assert eng.serving_trace().n_ops == 0 and set(cycles) == {0}
    else:
        assert min(cycles) > 0


@pytest.mark.parametrize("impl", ["scatter", "a2a"])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x22b"])
def test_moe_impls_generate_the_references_tokens(arch, impl):
    """``moe_impl`` "scatter" and "a2a" (with no mesh, the reference's
    gshard fallback) serve the reference's tokens, and gshard's."""
    cfg, _, pp, _, prompts = _model(arch)
    eng = ServeEngine(cfg, _rc(impl)[1], pp, P_NO_AXES, kv_mode="paged",
                      mem_arch="16B", device="cpu", **KW)
    got = eng.generate(prompts, max_new_tokens=NEW).tokens
    np.testing.assert_array_equal(got, _ref_generate(arch, "paged", impl)[0])
    np.testing.assert_array_equal(got, _ref_generate(arch, "paged")[0])


def test_pad_cache_pads_attention_leaves_by_name():
    """A dense-mode prompt as long as the conv window (``ssm_conv - 1``)
    or as ``d_inner``: axis 2 of the stacked ``conv`` (K-1) or ``h``
    (Di) then equals the prompt length, and only ``k`` / ``v`` may grow.
    Generation from such prompts equals the reference's dense run and the
    port's paged run."""
    cfg, rcfg, pp, rp, _ = _model("jamba-v0.1-52b")
    rrc, prc = _rc()
    for plen in (cfg.ssm_conv - 1, cfg.d_inner):
        prompts = np.random.default_rng(plen).integers(
            0, cfg.vocab_size, (2, plen)).astype(np.int32)
        kw = dict(max_batch=2, max_seq=plen + 4, page_len=4)
        eng = ServeEngine(cfg, prc, pp, P_NO_AXES,
                          kv_mode="dense", device="cpu", **kw)
        with torch.inference_mode():
            _, cache = PT.prefill(cfg, prc, pp, torch.tensor(prompts).long())
        padded = eng._pad_cache(cache, plen)
        for key, leaves in padded["blocks"].items():
            for name, leaf in leaves.items():
                before = cache["blocks"][key][name]
                if name in ("k", "v"):
                    assert leaf.shape[2] == plen + 4
                else:
                    assert leaf.shape == before.shape
                    assert torch.equal(leaf, before)
        got = eng.generate(prompts, max_new_tokens=3).tokens
        want = RServe(rcfg, rrc, rp, NO_AXES, kv_mode="dense",
                      **kw).generate(prompts, max_new_tokens=3).tokens
        paged = ServeEngine(cfg, prc, pp, P_NO_AXES,
                            kv_mode="paged", device="cpu",
                            **kw).generate(prompts, max_new_tokens=3).tokens
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, paged)


def test_bf16_serving_runs_every_family():
    """The serving CLI's compute dtype (bfloat16) on each family: finite
    logits, tokens in the vocabulary, paged equal to dense."""
    for arch in ARCHS:
        cfg, _, pp, _, prompts = _model(arch)
        rc = dataclasses.replace(_rc()[1], compute_dtype="bfloat16")
        got = {mode: ServeEngine(cfg, rc, pp, P_NO_AXES,
                                 kv_mode=mode, device="cpu",
                                 **KW).generate(prompts,
                                                max_new_tokens=4).tokens
               for mode in ("paged", "dense")}
        assert got["paged"].shape == (BATCH, 4)
        assert ((got["paged"] >= 0) & (got["paged"] < cfg.vocab_size)).all()
        np.testing.assert_array_equal(got["paged"], got["dense"])
