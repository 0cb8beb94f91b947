"""Training and scoring the audio and vision frontends on the port
(musicgen and phi-3-vision smoke configs: F frontend embeddings before
the text tokens, the loss over the text region only), held to the JAX
reference in float32 on the same numpy weights, tokens and frontend
embeddings (``tests/_torch_train_parity.py``), at the tolerances of
``test_torch_train_families.py``; also a train step at microbatches 2,
which slices the frontend with the tokens, and ``prefill(frontend=)``'s
last-position logits and caches (rtol 2e-5, atol 2e-5 of the largest)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_parity as P
from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.launch.sharding import NO_AXES
from repro.models import transformer as RT
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import transformer as PT

ARCHS = ("musicgen-medium", "phi-3-vision-4.2b")


@pytest.fixture(autouse=True)
def _one_thread():
    with P.one_torch_thread():
        yield


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_the_reference(arch):
    P.check_forward(arch)


@pytest.mark.parametrize("ce_impl", ["sharded", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_the_reference(arch, ce_impl):
    P.check_loss_and_grads(arch, ce_impl, atol_share=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_gradients(arch):
    P.check_remat_policies(arch)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_the_reference(arch, microbatches):
    P.check_train_step(arch, microbatches)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_frontend_equals_the_reference(arch):
    cfg, ref = get_smoke_config(arch), P.reference(arch)
    batch = P.to_torch(ref["batch"])
    with torch.no_grad():
        logits, cache = PT.prefill(cfg, RunConfig(**P.F32),
                                   P.port_params(arch, ref["params"]),
                                   batch["tokens"], batch["frontend"])
    jb = P.to_jax(ref["batch"])
    r_logits, r_cache = RT.prefill(r_smoke(arch), RRun(**P.F32),
                                   jax.tree.map(jnp.asarray, ref["params"]),
                                   jb["tokens"],
                                   NO_AXES, jb["frontend"])
    want = np.asarray(r_logits)[..., :cfg.vocab_size]
    assert logits.shape == (P.B, 1, cfg.padded_vocab())
    P.close(logits[..., :cfg.vocab_size], want, 2e-5,
            2e-5 * float(np.abs(want).max()))
    # the cache spans the frontend's positions too
    k = cache["blocks"]["b0"]["k"]
    assert k.shape[2] == P.S
    r_k = np.asarray(r_cache["blocks"]["b0"]["k"])
    P.close(k, r_k, 2e-5, 2e-5 * float(np.abs(r_k).max()))
