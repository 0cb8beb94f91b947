"""The decode token's embedding held to the JAX reference where the config
scales embeddings (gemma2's ``embed_scale``): the reference's prefill scales
the prompt rows by sqrt(d_model), while its ``decode_step`` and both serving
steps (paged and ragged) embed the decode token unscaled.  The port follows
it on every path.

gemma2's smoke config leaves ``embed_scale`` unset, so the tests switch it
on in both packages with ``dataclasses.replace``.  Weights come from the
reference's ``init_tree`` through ``from_jax``; compute is float32.
Tolerance: logits agree to atol 1e-4, the model tests' bound for float32
sums taken in another order on the two CPU backends.  Tokens, argmaxes of
those logits, must be equal."""
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
from repro.models import model_specs as r_specs
from repro.models import transformer as RT
from repro.serving.engine import ServeEngine as RServe
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.sharding import NO_AXES as P_NO_AXES
from repro_torch.models import from_jax, model_specs
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import ServeEngine

CFG = dataclasses.replace(get_smoke_config("gemma2-9b"), embed_scale=True)
RCFG = dataclasses.replace(r_smoke("gemma2-9b"), embed_scale=True)
R_PARAMS = r_init(r_specs(RCFG), jax.random.PRNGKey(3))
PARAMS = from_jax(model_specs(CFG), jax.tree.map(np.asarray, R_PARAMS),
                  device="cpu")
RRC = RRun(remat="none", attn_impl="dense", compute_dtype="float32")
PRC = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
PROMPTS = np.random.default_rng(5).integers(
    0, CFG.vocab_size, size=(3, 10)).astype(np.int32)
KW = dict(max_batch=3, max_seq=24, page_len=8)
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's host work on one thread (see
    ``_torch_train_parity.one_torch_thread``): the smoke models run many
    small ops, and under parallel test workers a thread pool per worker
    waits at every op for cores the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_configs_scale_embeddings():
    assert CFG.embed_scale and RCFG.embed_scale
    assert dataclasses.asdict(CFG) == dataclasses.asdict(RCFG)


def test_prefill_then_decode_steps_equal_the_reference():
    """``prefill`` (scaled) and three ``decode_step``s (unscaled) on a
    dense cache padded to the decode buffer."""
    ref = RServe(RCFG, RRC, R_PARAMS, NO_AXES, kv_mode="dense", **KW)
    eng = ServeEngine(CFG, PRC, PARAMS, P_NO_AXES,
                      kv_mode="dense", device="cpu", **KW)
    plen = PROMPTS.shape[1]
    toks = np.random.default_rng(6).integers(0, CFG.vocab_size, (3, 3, 1))
    r_logits, r_cache = RT.prefill(RCFG, RRC, R_PARAMS, jnp.asarray(PROMPTS),
                                   NO_AXES)
    r_cache = ref._pad_cache(r_cache, plen)
    with torch.inference_mode():
        p_logits, p_cache = PT.prefill(CFG, PRC, PARAMS,
                                       torch.as_tensor(PROMPTS).long())
        _close(p_logits, r_logits)
        p_cache = eng._pad_cache(p_cache, plen)
        for i in range(3):
            pos = plen + i
            r_logits, r_cache = RT.decode_step(
                RCFG, RRC, R_PARAMS, jnp.asarray(toks[i], jnp.int32), r_cache,
                jnp.asarray(pos, jnp.int32), NO_AXES)
            p_logits, p_cache = PT.decode_step(
                CFG, PRC, PARAMS, torch.as_tensor(toks[i]).long(), p_cache,
                torch.tensor(pos))
            _close(p_logits, r_logits)


def test_decode_embeds_unscaled_and_prefill_scaled():
    """The two embeddings differ by exactly sqrt(d_model) on one token."""
    tok = torch.as_tensor(PROMPTS[:, :1]).long()
    rows = PT._token_rows(PARAMS, tok, torch.float32)
    scaled = PT._embed(CFG, PARAMS, tok, None, torch.float32)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(PARAMS["embed"][tok].numpy()))
    torch.testing.assert_close(scaled, rows * CFG.d_model ** 0.5, rtol=0,
                               atol=0)


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_generate_tokens_equal_the_reference(kv_mode):
    want = RServe(RCFG, RRC, R_PARAMS, NO_AXES, kv_mode=kv_mode,
                  **KW).generate(PROMPTS, max_new_tokens=6).tokens
    got = ServeEngine(CFG, PRC, PARAMS, P_NO_AXES,
                      kv_mode=kv_mode, device="cpu",
                      **KW).generate(PROMPTS, max_new_tokens=6).tokens
    np.testing.assert_array_equal(got, want)
