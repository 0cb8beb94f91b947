"""The port's MoE layer (``repro_torch.models.moe``) and Mamba block
(``repro_torch.models.ssm``) on the CPU: every case of
``tests/test_moe_ssm.py`` run on the port, and the port held to the JAX
reference in float32 on the same numpy weights and inputs.

Tolerances: integers (expert ids, grant positions, kept masks) are equal;
the router's combine weights within rtol 1e-6 (one float32 softmax),
with an absolute floor of two float32 ulps of 1.0 for small weights; MoE
outputs within 2e-5 and the aux loss within rtol 1e-6 (float32 einsums
summed in another order); the Mamba scan within rtol 2e-4 / atol 2e-5 and
the conv window within rtol 1e-5 / atol 1e-6, the reference test's own
tolerances (the doubling scan and XLA's associative scan pair the
products in other orders).  Gradients (the MoE layers with capacity
drops, the zero router's ties, the Mamba prefill at three chunk sizes)
against ``jax.grad`` of the reference's within rtol 1e-4 and 1e-6 of each
gradient's largest magnitude."""
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
from repro.models import moe as RM
from repro.models import ssm as RS
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.arbiter import grant_positions
from repro_torch.models import from_jax
from repro_torch.models import moe as PM
from repro_torch.models import ssm as PS

CFG = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                          capacity_factor=8.0)  # no drops for equivalence
RCFG = dataclasses.replace(r_smoke("phi3.5-moe-42b-a6.6b"),
                           capacity_factor=8.0)


def _moe_params(cfg, rcfg, key=0):
    """The reference's MoE weights from ``PRNGKey(key)`` and the port's
    copy of them."""
    rp = r_init(RM.moe_specs(rcfg), jax.random.PRNGKey(key))
    return from_jax(PM.moe_specs(cfg), jax.tree.map(np.asarray, rp),
                    device="cpu"), rp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


P_MOE, R_MOE = _moe_params(CFG, RCFG)


# -- tests/test_moe_ssm.py's cases on the port ------------------------------

def test_gshard_equals_scatter():
    x = torch.tensor(_x((2, 64, CFG.d_model), 1))
    y1, a1 = PM.moe_gshard(CFG, P_MOE, x)
    y2, a2 = PM.moe_scatter(CFG, P_MOE, x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-6)


def test_arbiter_positions_priority_order():
    """All first choices (token order) rank before all second choices."""
    top_e = torch.tensor([[[0, 0], [0, 0], [1, 0]]], dtype=torch.int32)
    pos = PM.arbiter_positions(top_e, 4)[0]
    # expert 0 requests in priority order: t0c0, t1c0, t0c1, t1c1, t2c1
    assert pos[0, 0] == 0 and pos[1, 0] == 1     # first choices first
    assert pos[0, 1] == 2 and pos[1, 1] == 3 and pos[2, 1] == 4
    assert pos[2, 0] == 0                        # expert 1's first request


def test_arbiter_positions_match_core():
    """GShard flat order == the port's grant_positions on the same stream,
    and bit-equal to the reference's ``arbiter_positions``."""
    g, s, k, e = 2, 32, 2, 8
    top_e = np.random.default_rng(0).integers(0, e, (g, s, k)).astype(
        np.int32)
    pos = PM.arbiter_positions(torch.tensor(top_e), e)
    for gi in range(g):
        flat = torch.cat([torch.tensor(top_e[gi, :, 0]),
                          torch.tensor(top_e[gi, :, 1])])
        want = grant_positions(flat, e)
        got = torch.cat([pos[gi, :, 0], pos[gi, :, 1]])
        assert torch.equal(got, want)
    ref = RM.arbiter_positions(jnp.asarray(top_e), e)
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref))


def test_capacity_drops_bound_expert_load():
    cfg = dataclasses.replace(CFG, capacity_factor=0.5)
    p, _ = _moe_params(cfg, dataclasses.replace(RCFG, capacity_factor=0.5))
    y, _ = PM.moe_gshard(cfg, p, torch.tensor(_x((1, 64, cfg.d_model), 2)))
    assert bool(torch.isfinite(y).all())
    cap = PM.capacity(cfg, 64)
    assert cap <= int(0.5 * 2 * 64 / cfg.n_experts) + 4


def test_moe_zero_router_is_uniformish():
    """With tiny routing logits the output stays bounded (no NaN from the
    top-p normalization)."""
    p = dict(P_MOE, router=P_MOE["router"] * 0.0)
    y, aux = PM.moe_gshard(CFG, p, torch.tensor(_x((1, 32, CFG.d_model), 3)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))


SSM_CFG = get_smoke_config("falcon-mamba-7b")
SSM_RCFG = r_smoke("falcon-mamba-7b")
R_SSM = r_init(RS.ssm_specs(SSM_RCFG), jax.random.PRNGKey(0))
P_SSM = from_jax(PS.ssm_specs(SSM_CFG), jax.tree.map(np.asarray, R_SSM),
                 device="cpu")
X_SSM = _x((2, 32, SSM_CFG.d_model), 1) * 0.1


def _naive_selective_scan(cfg, p, x):
    """Sequential-token oracle: the port's decode step position by
    position."""
    b, s, _ = x.shape
    cache = {"h": torch.zeros((b, cfg.d_inner, cfg.ssm_state)),
             "conv": torch.zeros((b, cfg.ssm_conv - 1, cfg.d_inner),
                                 dtype=x.dtype)}
    ys = []
    for t in range(s):
        y, cache = PS.mamba_decode(cfg, p, x[:, t:t + 1], cache)
        ys.append(y)
    return torch.cat(ys, dim=1), cache


def _close_scan(got, want):
    """y and h at rtol 2e-4 / atol 2e-5, the conv window at 1e-5 / 1e-6."""
    (y1, c1), (y2, c2) = got, want
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(c1["h"]), np.asarray(c2["h"]),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(c1["conv"]),
                               np.asarray(c2["conv"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mamba_chunked_scan_matches_sequential(chunk):
    """The chunked prefill against the port's own sequential decode and
    against the reference's chunked prefill at the same chunk."""
    x = torch.tensor(X_SSM)
    got = PS.mamba_prefill(SSM_CFG, P_SSM, x, chunk=chunk)
    _close_scan(got, _naive_selective_scan(SSM_CFG, P_SSM, x))
    y, c = RS.mamba_prefill(SSM_RCFG, R_SSM, jnp.asarray(X_SSM), NO_AXES,
                            chunk=chunk)
    _close_scan(got, (y, c))


# -- parity with the reference ----------------------------------------------

def test_router_ids_and_weights_equal_the_reference():
    x = _x((2, 64, CFG.d_model), 4)
    e_p, w_p, a_p = PM._router(CFG, P_MOE, torch.tensor(x))
    e_r, w_r, a_r = RM._router(RCFG, R_MOE, jnp.asarray(x))
    assert e_p.dtype == torch.int32
    np.testing.assert_array_equal(e_p.numpy(), np.asarray(e_r))
    # weights lie in [0, 1]; a small weight also gets an absolute floor of
    # two float32 ulps of 1.0 (the logits' float32 sums run in another
    # order on the two backends)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_r), rtol=1e-6,
                               atol=2.4e-7)
    np.testing.assert_allclose(float(a_p), float(a_r), rtol=1e-6)


def test_zero_router_tie_order_equals_the_reference():
    """A zero router gives every expert the same probability: the top-k
    ids are the k lowest, in order, as ``jax.lax.top_k`` returns them
    (``torch.topk`` orders ties otherwise), and the layer equals the
    reference's."""
    p = dict(P_MOE, router=torch.zeros_like(P_MOE["router"]))
    rp = dict(R_MOE, router=R_MOE["router"] * 0.0)
    x = _x((1, 32, CFG.d_model), 3)
    e_p, w_p, _ = PM._router(CFG, p, torch.tensor(x))
    e_r, _, _ = RM._router(RCFG, rp, jnp.asarray(x))
    k = CFG.experts_per_token
    assert (e_p.numpy() == np.arange(k)).all()
    np.testing.assert_array_equal(e_p.numpy(), np.asarray(e_r))
    np.testing.assert_allclose(w_p.numpy(), 1.0 / k, rtol=1e-6)
    y_p, a_p = PM.moe_gshard(CFG, p, torch.tensor(x))
    y_r, a_r = RM.moe_gshard(RCFG, rp, jnp.asarray(x), NO_AXES)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(float(a_p), float(a_r), rtol=1e-6)


@pytest.mark.parametrize("impl", ["gshard", "scatter"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_layers_equal_the_reference(impl, capacity_factor):
    """``moe_gshard`` / ``moe_scatter`` against the reference's on the same
    weights and tokens, with no drops (capacity factor 8) and with drops
    (0.5): the same requests dropped, outputs within 2e-5, aux within
    rtol 1e-6."""
    cfg = dataclasses.replace(CFG, capacity_factor=capacity_factor)
    rcfg = dataclasses.replace(RCFG, capacity_factor=capacity_factor)
    x = _x((2, 64, CFG.d_model), 5)
    pos = PM.arbiter_positions(PM._router(cfg, P_MOE, torch.tensor(
        x).reshape(1, 128, -1))[0], cfg.n_experts)
    kept = (pos < PM.capacity(cfg, 128)).numpy()
    r_pos = RM.arbiter_positions(RM._router(rcfg, R_MOE, jnp.asarray(
        x).reshape(1, 128, -1))[0], rcfg.n_experts)
    np.testing.assert_array_equal(kept, np.asarray(r_pos)
                                  < RM.capacity(rcfg, 128))
    assert kept.all() == (capacity_factor == 8.0)
    fn_p = PM.moe_gshard if impl == "gshard" else PM.moe_scatter
    fn_r = RM.moe_gshard if impl == "gshard" else RM.moe_scatter
    y_p, a_p = fn_p(cfg, P_MOE, torch.tensor(x))
    y_r, a_r = fn_r(rcfg, R_MOE, jnp.asarray(x), NO_AXES)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(float(a_p), float(a_r), rtol=1e-6)


@pytest.mark.parametrize("impl", ["gshard", "scatter", "a2a"])
def test_moe_impl_picks_the_references_layer(impl):
    """``moe`` under each ``moe_impl``: "a2a" with no mesh is the
    reference's gshard fallback; each equals the reference's ``moe``."""
    x = _x((2, 32, CFG.d_model), 6)
    y_p, a_p = PM.moe(CFG, RunConfig(moe_impl=impl), P_MOE, torch.tensor(x))
    y_r, a_r = RM.moe(RCFG, RRun(moe_impl=impl), R_MOE, jnp.asarray(x),
                      NO_AXES)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(float(a_p), float(a_r), rtol=1e-6)


def test_moe_gelu_experts_use_the_tanh_approximation():
    """A GELU config's experts take ``jax.nn.gelu``'s tanh form."""
    cfg = dataclasses.replace(CFG, act="gelu")
    x = _x((1, 32, CFG.d_model), 7)
    y_p, _ = PM.moe_gshard(cfg, P_MOE, torch.tensor(x))
    y_r, _ = RM.moe_gshard(dataclasses.replace(RCFG, act="gelu"), R_MOE,
                           jnp.asarray(x), NO_AXES)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), atol=2e-5,
                               rtol=0)


def test_mamba_decode_equals_the_reference():
    """Eight decode steps from a prefill state, the port's against the
    reference's: outputs and both state leaves."""
    x = X_SSM
    _, c_p = PS.mamba_prefill(SSM_CFG, P_SSM, torch.tensor(x[:, :16]))
    _, c_r = RS.mamba_prefill(SSM_RCFG, R_SSM, jnp.asarray(x[:, :16]),
                              NO_AXES)
    for t in range(16, 24):
        y_p, c_p = PS.mamba_decode(SSM_CFG, P_SSM,
                                   torch.tensor(x[:, t:t + 1]), c_p)
        y_r, c_r = RS.mamba_decode(SSM_RCFG, R_SSM, jnp.asarray(
            x[:, t:t + 1]), c_r, NO_AXES)
        _close_scan((y_p, c_p), (y_r, c_r))


def test_mamba_prefill_needs_whole_chunks_and_specs_mirror_the_reference():
    with pytest.raises(ValueError, match="multiple"):
        PS.mamba_prefill(SSM_CFG, P_SSM, torch.tensor(X_SSM[:, :12]),
                         chunk=8)
    r_specs = RS.ssm_specs(SSM_RCFG)
    for name, leaf in PS.ssm_specs(SSM_CFG).items():
        assert leaf.shape == r_specs[name].shape
        assert (leaf.init, leaf.scale) == (r_specs[name].init,
                                           r_specs[name].scale)
    r_moe = RM.moe_specs(RCFG)
    for name, leaf in PM.moe_specs(CFG).items():
        assert leaf.shape == r_moe[name].shape
        assert (leaf.init, leaf.scale) == (r_moe[name].init,
                                           r_moe[name].scale)


def test_mamba_prefill_cache_holds_no_chunk_states():
    """The prefill cache's leaves own their memory: neither is a view of
    the chunk's (B, L, Di, N) states or of the input projection, which a
    many-layer prefill would otherwise keep alive layer after layer."""
    _, cache = PS.mamba_prefill(SSM_CFG, P_SSM, torch.tensor(X_SSM), chunk=8)
    for leaf in cache.values():
        assert leaf.is_contiguous()
        assert leaf.untyped_storage().nbytes() == (leaf.numel()
                                                   * leaf.element_size())


# -- gradients against jax.grad ---------------------------------------------

def _grads_close(got: dict, want: dict, atol_share=1e-6) -> None:
    """Every gradient within rtol 1e-4 and ``atol_share`` of its largest
    reference magnitude."""
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=atol_share * float(np.abs(w).max()),
                                   err_msg=name)


def _port_grads(fn, params: dict, x: np.ndarray) -> dict:
    """d fn(params, x) / d (every parameter and x), on the port."""
    leaves_ = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    total = fn(leaves_, xt)
    names = sorted(leaves_)
    grads = torch.autograd.grad(total, [leaves_[k] for k in names] + [xt])
    return dict(zip(names + ["x"], grads))


def _ref_grads(fn, params: dict, x: np.ndarray) -> dict:
    g_p, g_x = jax.grad(fn, argnums=(0, 1))(params, jnp.asarray(x))
    return {**g_p, "x": g_x}


@pytest.mark.parametrize("impl", ["gshard", "scatter"])
def test_moe_layer_grads_equal_the_reference(impl):
    """The gradient of sum(y * w) + aux through ``moe_gshard`` /
    ``moe_scatter`` with capacity drops (factor 0.5), to the router (by
    the top-k weights and the load-balance loss), every expert and the
    input, against ``jax.grad`` of the reference's layer."""
    cfg = dataclasses.replace(CFG, capacity_factor=0.5)
    rcfg = dataclasses.replace(RCFG, capacity_factor=0.5)
    x = _x((2, 64, CFG.d_model), 8)
    w = _x((2, 64, CFG.d_model), 9)
    fn_p = PM.moe_gshard if impl == "gshard" else PM.moe_scatter
    fn_r = RM.moe_gshard if impl == "gshard" else RM.moe_scatter

    def port(p, xt):
        y, aux = fn_p(cfg, p, xt)
        return (y * torch.tensor(w)).sum() + aux

    def ref(p, xj):
        y, aux = fn_r(rcfg, p, xj, NO_AXES)
        return (y * w).sum() + aux
    kept = PM.arbiter_positions(PM._router(cfg, P_MOE, torch.tensor(
        x).reshape(1, 128, -1))[0], cfg.n_experts) < PM.capacity(cfg, 128)
    assert not kept.all()
    _grads_close(_port_grads(port, P_MOE, x), _ref_grads(ref, R_MOE, x))


def test_zero_router_tie_grads_equal_the_reference():
    """A zero router ties every expert: the stable sort passes the
    gradient to the k lowest ids' probabilities only, as ``jax.lax.top_k``
    does, so the router's and the input's gradients equal the
    reference's."""
    p = dict(P_MOE, router=torch.zeros_like(P_MOE["router"]))
    rp = dict(R_MOE, router=R_MOE["router"] * 0.0)
    x = _x((1, 32, CFG.d_model), 3)
    w = _x((1, 32, CFG.d_model), 10)

    def port(q, xt):
        y, aux = PM.moe_gshard(CFG, q, xt)
        return (y * torch.tensor(w)).sum() + aux

    def ref(q, xj):
        y, aux = RM.moe_gshard(RCFG, q, xj, NO_AXES)
        return (y * w).sum() + aux
    got = _port_grads(port, p, x)
    assert float(got["router"].abs().max()) > 0
    _grads_close(got, _ref_grads(ref, rp, x))


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mamba_prefill_grads_equal_the_reference(chunk):
    """The gradient of sum(y * w) + sum(h * v) through ``mamba_prefill``
    (the doubling scan, the chunk loop, the causal conv, the SSM inputs)
    to every SSM parameter and the input, against ``jax.grad`` of the
    reference's at the same chunk."""
    w = _x((2, 32, SSM_CFG.d_model), 11)
    v = _x((2, SSM_CFG.d_inner, SSM_CFG.ssm_state), 12)

    def port(p, xt):
        y, c = PS.mamba_prefill(SSM_CFG, p, xt, chunk=chunk)
        return (y * torch.tensor(w)).sum() + (c["h"] * torch.tensor(v)).sum()

    def ref(p, xj):
        y, c = RS.mamba_prefill(SSM_RCFG, p, xj, NO_AXES, chunk=chunk)
        return (y * w).sum() + (c["h"] * v).sum()
    _grads_close(_port_grads(port, P_SSM, X_SSM), _ref_grads(ref, R_SSM,
                                                             X_SSM))
