"""The port's forward model (repro_torch.models) held to the JAX reference
in float32 on the same numpy inputs: norms, RoPE, dense and decode
attention (sliding window, softcap), the gated MLP, prefill and dense
decode.  atol 1e-5 on O(1) activations: float32 sums in another order on
the two CPU backends, nothing else differs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.launch.sharding import NO_AXES
from repro.models import init_tree as r_init
from repro.models import layers as RL
from repro.models import model_specs as r_specs
from repro.models import transformer as RT
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import count_params, from_jax, init_tree, model_specs
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

CFG = get_smoke_config("llama3.2-1b")
RCFG = r_smoke("llama3.2-1b")
R_PARAMS = r_init(r_specs(RCFG), jax.random.PRNGKey(1))
NP_PARAMS = jax.tree.map(np.asarray, R_PARAMS)
PARAMS = from_jax(model_specs(CFG), NP_PARAMS, device="cpu")
RRC = RRun(remat="none", attn_impl="dense", compute_dtype="float32")
PRC = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
RNG = np.random.default_rng(0)
ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_specs_and_init_mirror_the_reference():
    assert count_params(model_specs(CFG)) == sum(
        a.size for a in jax.tree.leaves(NP_PARAMS))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = init_tree(model_specs(CFG), g1, device="cpu")
    b = init_tree(model_specs(CFG), g2, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["final_norm"], torch.ones(CFG.d_model))
    bad = dict(NP_PARAMS, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError):
        from_jax(model_specs(CFG), bad, device="cpu")


def test_norm_rope_mlp():
    x = RNG.standard_normal((2, 5, CFG.d_model)).astype(np.float32)
    w = RNG.standard_normal(CFG.d_model).astype(np.float32)
    _close(PL.rmsnorm(torch.tensor(w), torch.tensor(x), 1e-5),
           RL.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-5))
    q = RNG.standard_normal((2, 5, 4, 16)).astype(np.float32)
    for pos in (np.arange(5), np.arange(10).reshape(2, 5) + 3):
        _close(PL.apply_rope(torch.tensor(q), torch.tensor(pos), 500000.0),
               RL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 500000.0))
    p = {k: v[0] for k, v in NP_PARAMS["blocks"]["b0"]["ffn"].items()}
    for act in ("silu", "gelu"):
        cfg = dataclasses.replace(CFG, act=act)
        rcfg = dataclasses.replace(RCFG, act=act)
        _close(PL.mlp(cfg, {k: torch.tensor(v) for k, v in p.items()},
                      torch.tensor(x)),
               RL.mlp(rcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                      NO_AXES))
    _close(PL.softcap(torch.tensor(x * 40), 30.0),
           RL.softcap(jnp.asarray(x * 40), 30.0), atol=1e-4)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (4, 0.0), (0, 20.0)])
def test_attention_prefill_and_decode(window, cap):
    cfg = dataclasses.replace(CFG, attn_softcap=cap)
    rcfg = dataclasses.replace(RCFG, attn_softcap=cap)
    p_np = {k: v[0] for k, v in NP_PARAMS["blocks"]["b0"]["mixer"].items()}
    p_t = {k: torch.tensor(v) for k, v in p_np.items()}
    p_j = jax.tree.map(jnp.asarray, p_np)
    x = RNG.standard_normal((2, 8, CFG.d_model)).astype(np.float32)
    out_p, (k_p, v_p) = PL.attention(cfg, PRC, p_t, torch.tensor(x),
                                     window=window, return_kv=True)
    out_r, (k_r, v_r) = RL.attention(rcfg, RRC, p_j, jnp.asarray(x),
                                     NO_AXES, window=window, return_kv=True)
    _close(out_p, out_r)
    _close(k_p, k_r)
    t = window or 12
    cache = {h: RNG.standard_normal((2, t, 2, 16)).astype(np.float32)
             for h in ("k", "v")}
    x1 = x[:, :1]
    for pos in (3, 9):
        o_p, c_p = PL.attention_decode(
            cfg, p_t, torch.tensor(x1),
            {h: torch.tensor(c) for h, c in cache.items()},
            torch.tensor(pos), window=window)
        o_r, c_r = RL.attention_decode(
            rcfg, p_j, jnp.asarray(x1),
            {h: jnp.asarray(c) for h, c in cache.items()},
            jnp.asarray(pos), NO_AXES, window=window)
        _close(o_p, o_r)
        _close(c_p["k"], c_r["k"])


def test_prefill_and_dense_decode_logits():
    tokens = RNG.integers(0, CFG.vocab_size, (3, 10))
    lp, cp = PT.prefill(CFG, PRC, PARAMS, torch.tensor(tokens))
    lr, cr = RT.prefill(RCFG, RRC, R_PARAMS, jnp.asarray(tokens), NO_AXES)
    _close(lp, lr, atol=1e-4)
    _close(cp["blocks"]["b0"]["k"], cr["blocks"]["b0"]["k"])
    pad = lambda c: {"blocks": {"b0": {h: torch.cat(  # noqa: E731
        [c["blocks"]["b0"][h], torch.zeros((2, 3, 6, 2, 16))], dim=2)
        for h in ("k", "v")}}}
    rpad = {"blocks": {"b0": {h: jnp.pad(cr["blocks"]["b0"][h],
                                         [(0, 0), (0, 0), (0, 6), (0, 0),
                                          (0, 0)]) for h in ("k", "v")}}}
    tok = RNG.integers(0, CFG.vocab_size, (3, 1))
    dp, _ = PT.decode_step(CFG, PRC, PARAMS, torch.tensor(tok), pad(cp),
                           torch.tensor(10))
    dr, _ = RT.decode_step(RCFG, RRC, R_PARAMS, jnp.asarray(tok, jnp.int32),
                           rpad, jnp.asarray(10, jnp.int32), NO_AXES)
    _close(dp, dr, atol=1e-4)


def test_non_dense_families_name_their_slice():
    """MoE, SSM and frontend configs now train and score (ROADMAP item
    21b is done): ``forward``, ``hidden_states``, ``loss_fn`` and
    ``init_train_state`` run on them; a frontend config given no frontend
    raises with the reference's message, as the reference's assert does,
    and the serve path's token-only decode needs none."""
    from repro_torch.train.step import init_train_state
    moe = dataclasses.replace(CFG, n_experts=4, experts_per_token=2)
    ssm = dataclasses.replace(CFG, family="ssm", n_heads=0, ssm_state=4)
    audio = dataclasses.replace(CFG, frontend="audio_frames",
                                n_frontend_tokens=3)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    frontend = torch.ones((1, 3, CFG.d_model))
    for cfg in (moe, ssm, audio):
        state = init_train_state(cfg, PRC, torch.Generator().manual_seed(0),
                                 "cpu")
        fe = frontend if cfg.frontend else None
        logits, aux = PT.forward(cfg, PRC, state.params, tokens, fe)
        s = 7 if cfg.frontend else 4
        assert logits.shape == (1, s, cfg.padded_vocab())
        h, aux_h = PT.hidden_states(cfg, PRC, state.params, tokens, fe)
        assert h.shape == (1, s, cfg.d_model) and float(aux_h) == float(aux)
        assert (float(aux) > 0) == bool(cfg.n_experts)
        batch = {"tokens": tokens, **({"frontend": fe} if cfg.frontend
                                      else {})}
        total, met = PT.loss_fn(cfg, PRC, state.params, batch)
        assert torch.isfinite(total) and float(met["aux"]) == float(aux)
    r_audio = dataclasses.replace(RCFG, frontend="audio_frames",
                                  n_frontend_tokens=3)
    with pytest.raises(AssertionError) as want:
        RT.forward(r_audio, RRC, R_PARAMS, jnp.zeros((1, 4), jnp.int32),
                   NO_AXES)
    with pytest.raises(ValueError) as got:
        PT.forward(audio, PRC, PARAMS, tokens)
    assert str(got.value) == str(want.value) == (
        f"{audio.name} needs frontend embeddings")
    logits, _ = PT.decode_step(audio, PRC, PARAMS, tokens[:, :1], {
        "blocks": {"b0": {h: torch.zeros((CFG.n_superblocks, 1, 4,
                                          CFG.n_kv_heads, CFG.hd))
                          for h in ("k", "v")}}}, torch.tensor(0))
    assert logits.shape == (1, 1, CFG.padded_vocab())


#: the reference layer tests' flash cases (``tests/test_layers.py``):
#: rtol = atol = 2e-5 against the reference and against dense attention
FCFG = dataclasses.replace(CFG, name="t", n_layers=1, vocab_size=64)
RFCFG = dataclasses.replace(RCFG, name="t", n_layers=1, vocab_size=64)
_r_flash = jax.jit(RL.attention_flash, static_argnums=(0, 6, 7, 8))


def _close2(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _qkv(s=64, b=2, seed=0):
    rng = np.random.default_rng(seed)
    kv, g, hd = FCFG.n_kv_heads, FCFG.n_heads // FCFG.n_kv_heads, FCFG.hd
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, kv, g, hd), (b, s, kv, hd), (b, s, kv, hd))]


@pytest.mark.parametrize("window", [0, 16, 40])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_flash_equals_the_reference_and_dense(window, block):
    q, k, v = _qkv()
    pos = np.arange(64)
    got = PL.attention_flash(FCFG, *map(torch.tensor, (q, k, v)),
                             torch.tensor(pos), torch.tensor(pos), window,
                             block, block)
    want = _r_flash(RFCFG, *map(jnp.asarray, (q, k, v)), jnp.asarray(pos),
                    jnp.asarray(pos), window, block, block)
    dense = PL.attention_dense(FCFG, *map(torch.tensor, (q, k, v)),
                               torch.tensor(pos), torch.tensor(pos), window)
    _close2(got, want)
    _close2(got, dense)


@pytest.mark.parametrize("block", [8, 12])
def test_flash_with_softcap_and_ragged_blocks(block):
    cfg = dataclasses.replace(FCFG, attn_softcap=30.0)
    rcfg = dataclasses.replace(RFCFG, attn_softcap=30.0)
    q, k, v = _qkv(s=32, seed=1)
    pos = np.arange(32)
    got = PL.attention_flash(cfg, *map(torch.tensor, (q, k, v)),
                             torch.tensor(pos), torch.tensor(pos), 0, block,
                             block)
    want = _r_flash(rcfg, *map(jnp.asarray, (q, k, v)), jnp.asarray(pos),
                    jnp.asarray(pos), 0, block, block)
    dense = PL.attention_dense(cfg, *map(torch.tensor, (q, k, v)),
                               torch.tensor(pos), torch.tensor(pos), 0)
    _close2(got, want)
    _close2(got, dense)


@pytest.mark.parametrize("impl,flash_calls", [("flash", 1), ("auto", 1),
                                              ("dense", 0)])
def test_attention_takes_flash_past_twice_the_block(impl, flash_calls,
                                                    monkeypatch):
    """``attn_impl="flash"``, and ``"auto"`` on a sequence longer than 2 x
    ``flash_block`` (32 > 2 x 8), run ``attention_flash``; the result is
    the reference's with the same ``RunConfig``."""
    rng = np.random.default_rng(2)
    p = {name: (0.1 * rng.standard_normal(shape)).astype(np.float32)
         for name, shape in (("wq", (64, 4, 16)), ("wk", (64, 2, 16)),
                             ("wv", (64, 2, 16)), ("wo", (4, 16, 64)))}
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    calls = []
    flash = PL.attention_flash
    monkeypatch.setattr(PL, "attention_flash",
                        lambda *a: calls.append(1) or flash(*a))
    rc = RunConfig(attn_impl=impl, flash_block=8, compute_dtype="float32")
    rrc = RRun(attn_impl=impl, flash_block=8, compute_dtype="float32")
    for window in (0, 12):
        got = PL.attention(FCFG, rc, {k: torch.tensor(a) for k, a in
                                     p.items()}, torch.tensor(x),
                           window=window)
        want = RL.attention(RFCFG, rrc, jax.tree.map(jnp.asarray, p),
                            jnp.asarray(x), NO_AXES, window=window)
        _close2(got, want)
    assert len(calls) == 2 * flash_calls
    short = RunConfig(attn_impl="auto", flash_block=16)
    PL.attention(FCFG, short, {k: torch.tensor(a) for k, a in p.items()},
                 torch.tensor(x))
    assert len(calls) == 2 * flash_calls       # 32 = 2 x 16: dense
