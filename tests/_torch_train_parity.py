"""Shared by the family training tests (``tests/test_torch_train_*.py``):
the reference's loss, aux, logits and every leaf's gradient on a smoke
config, computed once a process per config (jitted), and the port's on
the same numpy weights and inputs, in float32 compute.

The batch is ``tests/test_models_smoke.py``'s shape: B 2 and S 32
positions in all, the frontend's (F of them) first."""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.launch.sharding import NO_AXES
from repro.models import init_tree as r_init
from repro.models import transformer as RT
from repro.train import init_train_state as r_init_state
from repro.train.step import make_train_step as r_make_step
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.data import SyntheticLM
from repro_torch.models import from_jax, model_specs
from repro_torch.models import transformer as PT
from repro_torch.models.params import leaves
from repro_torch.train import make_train_step
from repro_torch.train.step import train_state_from_jax

F32 = dict(remat="none", attn_impl="dense", compute_dtype="float32")
B, S = 2, 32


@contextlib.contextmanager
def one_torch_thread():
    """The port's host work on one thread inside the block.  The smoke
    models run thousands of small ops a step; under parallel test workers
    sharing the host's cores, a thread pool per worker waits at every
    op's barrier for threads the other workers hold, and a step takes
    tens of times longer than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def batch_np(cfg, seed: int = 4) -> dict:
    """B x S positions: ``tokens`` (B, S - F) and, for a frontend config,
    ``frontend`` (B, F, d_model) float32."""
    rng = np.random.default_rng(seed)
    f = cfg.n_frontend_tokens if cfg.frontend else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S - f))}
    if f:
        out["frontend"] = rng.standard_normal(
            (B, f, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def in_port_order(like, tree) -> list:
    """``tree``'s leaves (a reference tree: dicts by the same keys) in the
    order ``leaves(like)`` gives the port's."""
    if isinstance(like, dict):
        return [x for k in like for x in in_port_order(like[k], tree[k])]
    return [np.asarray(tree)]


def leaf_names(like, prefix="") -> list:
    if isinstance(like, dict):
        return [n for k in like for n in leaf_names(like[k],
                                                     f"{prefix}/{k}")]
    return [prefix]


def reference(arch: str, moe_impl: str = "gshard") -> dict:
    """The reference on ``arch``'s smoke config (weights from
    ``PRNGKey(1)``, ``batch_np``): forward logits and aux; for each
    ``ce_impl`` the total, loss and aux; and every leaf's gradient of the
    "sharded" total (numpy, in the port's leaf order), from one jitted
    function, computed once a process."""
    return _reference(arch, moe_impl)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, moe_impl: str) -> dict:
    rcfg = r_smoke(arch)
    params = jax.tree.map(np.asarray, r_init(RT.model_specs(rcfg),
                                             jax.random.PRNGKey(1)))
    batch = batch_np(rcfg)
    jb = to_jax(batch)
    rcs = {ce: RRun(ce_impl=ce, moe_impl=moe_impl, **F32)
           for ce in ("sharded", "dense")}

    def run(p):
        logits, aux = RT.forward(rcfg, rcs["sharded"], p, jb["tokens"],
                                 NO_AXES, jb.get("frontend"))
        sharded, grads = jax.value_and_grad(
            lambda q: RT.loss_fn(rcfg, rcs["sharded"], q, jb, NO_AXES),
            has_aux=True)(p)
        dense = RT.loss_fn(rcfg, rcs["dense"], p, jb, NO_AXES)
        return logits, aux, {"sharded": sharded, "dense": dense}, grads
    logits, aux, losses, grads = jax.jit(run)(
        jax.tree.map(jnp.asarray, params))
    out = {"params": params, "batch": batch, "logits": np.asarray(logits),
           "aux": float(aux), "grads": in_port_order(
               model_specs(get_smoke_config(arch)), grads)}
    for ce, (total, met) in losses.items():
        out[ce] = {"total": float(total), "loss": float(met["loss"]),
                   "aux": float(met["aux"])}
    return out


def port_params(arch: str, params_np) -> dict:
    return from_jax(model_specs(get_smoke_config(arch)), params_np,
                    device="cpu")


def port_loss_and_grads(arch: str, rc: RunConfig, params_np=None,
                        batch=None):
    """The port's (total, {"loss", "aux"}, gradients in leaf order) on
    the reference's weights and batch."""
    ref = reference(arch)
    params = port_params(arch, ref["params"] if params_np is None
                         else params_np)
    diff = leaves(params)
    for t in diff:
        t.requires_grad_(True)
    total, met = PT.loss_fn(get_smoke_config(arch), rc, params,
                            to_torch(ref["batch"] if batch is None
                                     else batch))
    grads = torch.autograd.grad(total, diff)
    return total.detach(), {k: v.detach() for k, v in met.items()}, grads


def check_grads(arch: str, got, want, atol_share: float) -> None:
    """Every leaf within rtol 1e-4 and ``atol_share`` x the leaf's largest
    reference magnitude (a leaf of size 0 is skipped)."""
    names = leaf_names(model_specs(get_smoke_config(arch)))
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        if w.size:
            np.testing.assert_allclose(
                g.numpy(), w, rtol=1e-4,
                atol=atol_share * float(np.abs(w).max()), err_msg=name)


def _filled_state(rcfg, rrc, step: int = 5):
    """The reference's fresh ``TrainState`` at ``step``, its moments
    filled as a running job's are (m ~ 1e-3, sqrt(v) ~ 1e-2)."""
    state = r_init_state(rcfg, rrc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(step)

    def fill(tree, moment):
        return jax.tree.map(lambda a: jnp.asarray(
            1e-3 * rng.standard_normal(a.shape) if moment == "m"
            else 1e-4 * rng.uniform(0.5, 1.5, a.shape), jnp.float32), tree)
    opt = state.opt._replace(m=fill(state.opt.m, "m"),
                             v=fill(state.opt.v, "v"))
    return state._replace(step=jnp.asarray(step, jnp.int32), opt=opt)


def step_kw(microbatches: int = 1, remat: str = "none") -> dict:
    return dict(remat=remat, attn_impl="dense", compute_dtype="float32",
                microbatches=microbatches, warmup_steps=2,
                learning_rate=3e-3)


def step_data(cfg) -> SyntheticLM:
    """The step tests' data: 4 sequences of 16 text tokens, after the
    config's frontend positions when it has a frontend."""
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                       seed=3, branching=2,
                       frontend_tokens=cfg.n_frontend_tokens
                       if cfg.frontend else 0, d_model=cfg.d_model)


def check_train_step(arch: str, microbatches: int = 1) -> None:
    """One ``make_train_step`` step from the reference's filled state at
    step 5 against the reference's jitted step on the same batch: loss
    rtol 1e-5; aux, grad_norm and lr, params, m and v rtol 1e-4 / atol
    1e-6."""
    rcfg, cfg = r_smoke(arch), get_smoke_config(arch)
    rrc, rc = RRun(**step_kw(microbatches)), RunConfig(**step_kw(
        microbatches))
    r_state = _filled_state(rcfg, rrc)
    ds = step_data(cfg)
    start = jax.tree.map(np.asarray, r_state)
    r_state, r_met = jax.jit(r_make_step(rcfg, rrc, NO_AXES))(
        r_state, to_jax(ds.batch_np(0)))
    state = train_state_from_jax(cfg, rc, start, device="cpu")
    state, met = make_train_step(cfg, rc)(state, ds.batch(0, device="cpu"))
    assert set(met) == set(r_met) == {"loss", "aux", "grad_norm", "lr"}
    close(met["loss"], r_met["loss"], 1e-5)
    for k in ("aux", "grad_norm", "lr"):
        close(met[k], r_met[k], 1e-4, 1e-6)
    assert int(state.step) == int(r_state.step) == 6
    for got, want in ((state.params, r_state.params),
                      (state.opt.m, r_state.opt.m),
                      (state.opt.v, r_state.opt.v)):
        for g, w in zip(leaves(got), in_port_order(got, want)):
            close(g, w, 1e-4, 1e-6)


def check_forward(arch: str) -> None:
    """``forward``'s logits (the real vocab) within rtol 2e-5 and 2e-5 of
    the largest logit's magnitude, its aux within rtol 1e-6."""
    ref = reference(arch)
    cfg = get_smoke_config(arch)
    batch = to_torch(ref["batch"])
    with torch.no_grad():
        logits, aux = PT.forward(cfg, RunConfig(**F32),
                                 port_params(arch, ref["params"]),
                                 batch["tokens"], batch.get("frontend"))
    want = ref["logits"][..., :cfg.vocab_size]
    assert logits.shape == ref["logits"].shape == (B, S, cfg.padded_vocab())
    close(logits[..., :cfg.vocab_size], want, 2e-5,
          2e-5 * float(np.abs(want).max()))
    close(aux, ref["aux"], 1e-6)


def check_loss_and_grads(arch: str, ce_impl: str, atol_share: float,
                         moe_impl: str = "gshard") -> None:
    """The total, loss and aux within rtol 1e-5 (aux atol 1e-7: a config
    with no MoE layer has aux 0 in both) of the reference's under the same
    ``ce_impl``, and every leaf's gradient (see ``check_grads``) of the
    reference's "sharded" total: the two forms compute one function."""
    ref = reference(arch, moe_impl)
    total, met, grads = port_loss_and_grads(
        arch, RunConfig(ce_impl=ce_impl, moe_impl=moe_impl, **F32))
    want = ref[ce_impl]
    close(total, want["total"], 1e-5)
    close(met["loss"], want["loss"], 1e-5)
    close(met["aux"], want["aux"], 1e-5, 1e-7)
    check_grads(arch, grads, ref["grads"], atol_share)


def check_remat_policies(arch: str) -> None:
    """Remat "dots" and "full" recompute the forward's own operations in
    the same order, so their gradients equal remat "none"'s (rtol 1e-6)."""
    got = {remat: port_loss_and_grads(
        arch, RunConfig(**{**F32, "remat": remat}))
        for remat in ("none", "dots", "full")}
    for remat in ("dots", "full"):
        close(got[remat][0], got["none"][0], 1e-6)
        close(got[remat][1]["aux"], got["none"][1]["aux"], 1e-6)
        for g, w in zip(got[remat][2], got["none"][2]):
            close(g, w, 1e-6, 1e-9)
