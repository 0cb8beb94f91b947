"""The port's serving slice end to end, held to the JAX reference on the
smoke config: the same parameters (converted with ``from_jax``) and the
same numpy prompts go through both engines in float32 compute.

Tolerance: logits agree to atol 1e-4.  Both sides compute in float32 but
sum in different orders (XLA:CPU's dot kernels vs torch's CPU BLAS); the
smoke logits are O(10), and float32's 2^-24 relative rounding accumulated
over the model's few hundred-term reductions stays below 1e-5, so 1e-4
bounds reduction order while catching any real difference.  Tokens, which
are argmaxes of those logits, and the recorded traces must be equal."""
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
from repro.serving.engine import ServeEngine as RServe
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import arch as PA
from repro_torch.models import from_jax, model_specs
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kvcache import simulate_serving_trace

CFG = get_smoke_config("llama3.2-1b")
RCFG = r_smoke("llama3.2-1b")
R_PARAMS = r_init(r_specs(RCFG), jax.random.PRNGKey(0))
PARAMS = from_jax(model_specs(CFG), jax.tree.map(np.asarray, R_PARAMS),
                  device="cpu")
PROMPTS = np.random.default_rng(0).integers(
    0, CFG.vocab_size, size=(4, 12)).astype(np.int32)
KW = dict(max_batch=4, max_seq=32, page_len=8)


def _rc(compute):
    return (RRun(remat="none", attn_impl="dense", compute_dtype=compute),
            RunConfig(remat="none", attn_impl="dense",
                      compute_dtype=compute))


def test_config_copy_equals_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(RCFG)
    from repro.configs import get_config as r_get
    from repro_torch.configs import get_config
    assert dataclasses.asdict(get_config("llama3.2-1b")) == (
        dataclasses.asdict(r_get("llama3.2-1b")))


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_generate_tokens_equal_reference(kv_mode):
    rrc, prc = _rc("float32")
    want = RServe(RCFG, rrc, R_PARAMS, NO_AXES, kv_mode=kv_mode,
                  **KW).generate(PROMPTS, max_new_tokens=8).tokens
    got = ServeEngine(CFG, prc, PARAMS, kv_mode=kv_mode, device="cpu",
                      **KW).generate(PROMPTS, max_new_tokens=8).tokens
    np.testing.assert_array_equal(got, want)


def test_paged_step_logits_match_reference():
    """Prefill and five paged decode steps: the port's logits against the
    reference engine's (atol 1e-4, see the module docstring), and the
    port's paged against its own dense path."""
    rrc, prc = _rc("float32")
    ref = RServe(RCFG, rrc, R_PARAMS, NO_AXES, kv_mode="paged", **KW)
    eng = ServeEngine(CFG, prc, PARAMS, kv_mode="paged", device="cpu", **KW)
    plen, b = PROMPTS.shape[1], PROMPTS.shape[0]
    r_logits, r_cache = ref._prefill(ref.params, jnp.asarray(PROMPTS))
    r_pools, r_pages, r_ssm = ref._ingest_prefill(r_cache, plen, b)
    with torch.inference_mode():
        p_logits, p_cache = T.prefill(CFG, prc, PARAMS,
                                      torch.as_tensor(PROMPTS).long())
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits),
                                   atol=1e-4, rtol=0)
        pools, pages = eng._ingest_prefill(p_cache, plen, b)
        dense = eng._pad_cache(p_cache, plen)
        tok = np.asarray(jnp.argmax(r_logits[:, -1, :CFG.vocab_size], -1))
        for i in range(1, 6):
            pos = plen + i - 1
            t_r = jnp.asarray(tok, jnp.int32)[:, None]
            t_p = torch.tensor(tok).long()[:, None]
            rl, r_pools, r_pages, r_ssm = ref._decode_paged(
                ref.params, t_r, r_pools, r_pages, r_ssm,
                jnp.asarray(pos, jnp.int32))
            pl, pools, pages = eng._paged_step(PARAMS, t_p, pools, pages,
                                               pos)
            dl, dense = T.decode_step(CFG, prc, PARAMS, t_p, dense,
                                      torch.tensor(pos))
            np.testing.assert_allclose(pl.numpy(), np.asarray(rl),
                                       atol=1e-4, rtol=0)
            np.testing.assert_allclose(pl.numpy(), dl.numpy(), atol=1e-4,
                                       rtol=0)
            np.testing.assert_array_equal(pages.page_table.numpy(),
                                          np.asarray(r_pages.page_table))
            tok = np.asarray(jnp.argmax(rl[:, -1, :CFG.vocab_size], -1))


def test_traces_equal_reference_and_cost_pins():
    """The serving-cost gates of tests/test_serving_paged.py on the port:
    16B step/full = 296/2200 cycles, 4R-2W full = 140; the step and full
    traces are bit-equal to the reference engine's and to the model-free
    simulation of the same point."""
    rrc, prc = _rc("bfloat16")
    ref = RServe(RCFG, rrc, R_PARAMS, NO_AXES, kv_mode="paged",
                 mem_arch="16B", **KW)
    ref.generate(PROMPTS, max_new_tokens=8)
    eng = ServeEngine(CFG, prc, PARAMS, kv_mode="paged", mem_arch="16B",
                      device="cpu", **KW)
    eng.generate(PROMPTS, max_new_tokens=8)
    step, full = eng.step_trace(), eng.serving_trace()
    sim = simulate_serving_trace("16B", batch=4, prompt_len=12,
                                 decode_steps=7, page_len=8,
                                 n_kv_layers=eng.n_kv_layers, max_seq=32,
                                 device="cpu")
    for got, want in ((step, ref.step_trace()), (full, ref.serving_trace()),
                      (full, sim)):
        for f in ("addrs", "kinds", "instr", "mask"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert PA.get("16B").cost(step, device="cpu").total_cycles == 296
    assert PA.get("16B").cost(full, device="cpu").total_cycles == 2200
    assert PA.get("4R-2W").cost(full, device="cpu").total_cycles == 140
    costs = eng.serving_cost(archs=[a.name for a in PA.PAPER_ARCHITECTURES])
    assert [c.total_cycles for c in costs] == [
        ref.serving_cost(archs=[a.name for a in PA.PAPER_ARCHITECTURES])[i]
        .total_cycles for i in range(9)]


def test_dense_mode_records_no_traces():
    _, prc = _rc("float32")
    eng = ServeEngine(CFG, prc, PARAMS, kv_mode="dense", device="cpu", **KW)
    eng.generate(PROMPTS, max_new_tokens=3)
    with pytest.raises(RuntimeError):
        eng.step_trace()
    with pytest.raises(ValueError):
        ServeEngine(CFG, prc, PARAMS, kv_mode="paged", mem_arch="4R-1W",
                    device="cpu", **KW)
