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
    moe = dataclasses.replace(CFG, n_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError, match="MoE"):
        model_specs(moe)
    with pytest.raises(NotImplementedError, match="flash"):
        PL.attention(CFG, dataclasses.replace(PRC, attn_impl="flash"),
                     {}, torch.zeros((1, 4, CFG.d_model)))
