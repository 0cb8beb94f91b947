"""The reference's per-architecture smoke tests (``tests/test_models_smoke.py``)
on the port: every config's reduced version runs the training forward,
the loss and its gradient (shapes, a finite loss, a gradient norm above 0),
and for the text configs prefill then one decode step reproduces the
forward's logits of the next position, at the reference test's
tolerance (rtol = atol = 2e-2, float32, MoE capacity drops disabled)."""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_train_parity as P

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import (decode_step, forward, init_tree, loss_fn,
                                model_specs, prefill)
from repro_torch.models.params import leaves

RC = RunConfig(remat="none", attn_impl="dense")
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    with P.one_torch_thread():
        yield


def _batch(cfg, gen):
    f = cfg.n_frontend_tokens if cfg.frontend else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - f),
                                     generator=gen)}
    if f:
        batch["frontend"] = torch.randn((B, f, cfg.d_model), generator=gen)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_loss_grad(arch):
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = init_tree(model_specs(cfg), gen, device="cpu")
    batch = _batch(cfg, gen)
    with torch.no_grad():
        logits, aux = forward(cfg, RC, params, batch["tokens"],
                              batch.get("frontend"))
    assert logits.shape == (B, S, cfg.padded_vocab())
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size].float()).all())

    diff = leaves(params)
    for t in diff:
        t.requires_grad_(True)
    loss, metrics = loss_fn(cfg, RC, params, batch)
    grads = torch.autograd.grad(loss, diff)
    assert bool(torch.isfinite(loss))
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    assert bool(torch.isfinite(gnorm)) and float(gnorm) > 0


def _cache_len(cfg, j: int, seq_len: int) -> int:
    """An attention block's decode-cache length at ``seq_len``, as the
    reference's ``cache_specs`` sizes it."""
    t = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    if cfg.local_global and j % 2 == 0:
        t = min(seq_len, cfg.local_window)
    return t


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if not get_smoke_config(a).frontend])
def test_prefill_then_decode_matches_forward(arch):
    """Decode applied after prefill reproduces the forward logits of the
    next position (the KV / SSM cache correctness gate)."""
    cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=16.0)
    rc = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
    gen = torch.Generator().manual_seed(1)
    params = init_tree(model_specs(cfg), gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    v = cfg.vocab_size
    with torch.no_grad():
        logits_full, _ = forward(cfg, rc, params, tokens)
        logits_pre, cache = prefill(cfg, rc, params, tokens[:, :S - 1])
        assert logits_pre.shape == (B, 1, cfg.padded_vocab())
        np.testing.assert_allclose(logits_pre[:, 0, :v].numpy(),
                                   logits_full[:, S - 2, :v].numpy(),
                                   rtol=2e-2, atol=2e-2)
        # grow each attention cache to its decode length at S
        for j, (kind, _) in enumerate(cfg.block_pattern()):
            if kind == "attn":
                c = cache["blocks"][f"b{j}"]
                pad = _cache_len(cfg, j, S) - c["k"].shape[2]
                for name in ("k", "v"):
                    c[name] = torch.nn.functional.pad(
                        c[name], (0, 0, 0, 0, 0, pad))
        logits_dec, _ = decode_step(cfg, rc, params, tokens[:, S - 1:S],
                                    cache, torch.tensor(S - 1))
    np.testing.assert_allclose(logits_dec[:, 0, :v].numpy(),
                               logits_full[:, S - 1, :v].numpy(),
                               rtol=2e-2, atol=2e-2)
