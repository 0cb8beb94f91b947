"""The port's training path (``repro_torch.models`` training half,
``repro_torch.train``, ``repro_torch.runtime.elastic``, the train CLI and
example) held to the JAX reference on the same numpy inputs in float32
(the reference jitted): ``loss_fn`` with both cross-entropy forms on the dense smoke configs (loss
rtol 1e-5, every leaf's gradient rtol 1e-4 / atol 1e-6), one
``make_train_step`` from the same ``TrainState`` at microbatches 1 and 2
under each remat policy (rtol 1e-4 / atol 1e-6, as
``tests/test_runtime.py``), the trainer's learning, resume and int8-EF
runs, ``TrainState`` checkpoints across the packages, and the CLI's
metrics on the six non-dense smoke configs against the reference CLI's
(bfloat16 tolerances, ``CLI_RTOL``)."""
import dataclasses
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint.checkpoint import save_checkpoint as r_save
from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.launch.sharding import NO_AXES
from repro.models import init_tree as r_init
from repro.models import transformer as RT
from repro.train import init_train_state as r_init_state
from repro.train.step import make_train_step as r_make_step
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.data import SyntheticLM
from repro_torch.examples import train_lm
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as PT
from repro_torch.launch.mesh import init_distributed
from repro_torch.runtime import elastic_restore, make_current_mesh
from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                               make_train_step)
from repro_torch.train.step import train_state_from_jax

DENSE = ("llama3.2-1b", "gemma2-9b", "minicpm-2b", "qwen1.5-110b")
F32 = dict(remat="none", attn_impl="dense", compute_dtype="float32")


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _reference_params(arch, seed=1):
    rcfg = r_smoke(arch)
    params = jax.tree.map(np.asarray, r_init(RT.model_specs(rcfg),
                                             jax.random.PRNGKey(seed)))
    return rcfg, params


@pytest.mark.parametrize("ce_impl", ["sharded", "dense"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_equal_the_reference(arch, ce_impl):
    """Loss at rtol 1e-5 and every leaf's gradient at rtol 1e-4 / atol
    1e-6 (gemma2: local/global windows, both softcaps, post norms;
    minicpm: a padded vocab; qwen: qkv biases, an untied head)."""
    cfg = get_smoke_config(arch)
    rcfg, np_params = _reference_params(arch)
    rc = RunConfig(ce_impl=ce_impl, **F32)
    rrc = RRun(ce_impl=ce_impl, **F32)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40))
    leaves, treedef = jax.tree.flatten(np_params)
    p_leaves = [torch.tensor(a, requires_grad=True) for a in leaves]
    p_params = jax.tree.unflatten(treedef, p_leaves)
    total, met = PT.loss_fn(cfg, rc, p_params,
                            {"tokens": torch.tensor(tokens)})
    grads = torch.autograd.grad(total, p_leaves)

    def r_loss(params):
        return RT.loss_fn(rcfg, rrc, params,
                          {"tokens": jnp.asarray(tokens, jnp.int32)},
                          NO_AXES)
    (r_total, r_met), r_grads = jax.jit(jax.value_and_grad(
        r_loss, has_aux=True))(jax.tree.map(jnp.asarray, np_params))
    _close(total.detach(), r_total, 1e-5, 0)
    _close(met["loss"].detach(), r_met["loss"], 1e-5, 0)
    assert float(met["aux"]) == float(r_met["aux"]) == 0.0
    for g, rg in zip(grads, jax.tree.leaves(r_grads)):
        _close(g, rg, 1e-4, 1e-6)


def _ref_state(cfg_arch, rrc, step=5):
    """The reference's fresh ``TrainState`` at ``step``, its moments
    filled as a run's are after some steps (m ~ 1e-3, sqrt(v) ~ 1e-2)."""
    rcfg = r_smoke(cfg_arch)
    state = r_init_state(rcfg, rrc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(step)

    def fill(tree, moment):
        return jax.tree.map(lambda a: jnp.asarray(
            1e-3 * rng.standard_normal(a.shape) if moment == "m"
            else 1e-4 * rng.uniform(0.5, 1.5, a.shape), jnp.float32), tree)
    opt = state.opt._replace(m=fill(state.opt.m, "m"),
                             v=fill(state.opt.v, "v"))
    return rcfg, state._replace(step=jnp.asarray(step, jnp.int32), opt=opt)


def test_remat_policies_recompute_what_they_should():
    """In the backward, "dots" recomputes only the attention matmuls (two
    batched einsums a layer) and keeps the weight matmuls' outputs, as
    ``dots_with_no_batch_dims_saveable`` does; "full" recomputes the whole
    superblock; "none" recomputes nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountBmm(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func == torch.ops.aten.bmm.default
            return func(*args, **(kwargs or {}))

    cfg = get_smoke_config("llama3.2-1b")
    tokens = torch.tensor(np.random.default_rng(5).integers(0, 512, (2, 16)))
    counts = {}
    for remat in ("none", "dots", "full"):
        state = init_train_state(cfg, RunConfig(**F32), torch.Generator()
                                 .manual_seed(0), device="cpu")
        leaf = state.params["embed"].requires_grad_(True)
        total, _ = PT.loss_fn(cfg, RunConfig(**{**F32, "remat": remat}),
                              state.params, {"tokens": tokens})
        with CountBmm() as mode:
            torch.autograd.grad(total, [leaf])
        counts[remat] = mode.n
    assert counts["dots"] - counts["none"] == 2 * cfg.n_layers, counts
    assert counts["full"] > counts["dots"], counts


STEP_DS = SyntheticLM(vocab_size=512, seq_len=16, global_batch=4, seed=3,
                      branching=2)


def _step_kw(microbatches, remat):
    return dict(remat=remat, attn_impl="dense", compute_dtype="float32",
                microbatches=microbatches, warmup_steps=2,
                learning_rate=3e-3)


@functools.lru_cache(maxsize=None)
def _reference_steps(microbatches):
    """The reference's two jitted train steps (remat "none": its remat
    policies recompute the same operations, so they give the same values)
    from ``_ref_state``: the start state and each step's state and
    metrics, as numpy."""
    rrc = RRun(**_step_kw(microbatches, "none"))
    rcfg, r_state = _ref_state("llama3.2-1b", rrc)
    r_step = jax.jit(r_make_step(rcfg, rrc, NO_AXES))
    out = [jax.tree.map(np.asarray, r_state)]
    for i in range(2):
        r_state, r_met = r_step(r_state, {"tokens": jnp.asarray(
            STEP_DS.batch_np(i)["tokens"])})
        out.append(jax.tree.map(np.asarray, (r_state, r_met)))
    return out


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_the_reference(microbatches, remat):
    """Two train steps from one ``TrainState`` (step 5, past the warmup,
    so the learning rate is not 0): loss rtol 1e-5; params, m, v and the
    metrics rtol 1e-4 / atol 1e-6.  The state's moments are a running
    job's, not zeros: from zero moments the first Adam update is
    g / (|g| + eps / 0.43) of each element, so where |g| is near eps (1e-8)
    a float32 rounding difference in g moves that element's update by up
    to a percent, in either package against itself."""
    rc = RunConfig(**_step_kw(microbatches, remat))
    cfg = get_smoke_config("llama3.2-1b")
    start, *steps = _reference_steps(microbatches)
    state = train_state_from_jax(cfg, rc, start, device="cpu")
    step = make_train_step(cfg, rc)
    for i, (r_state, r_met) in enumerate(steps):
        state, met = step(state, STEP_DS.batch(i, device="cpu"))
        assert set(met) == set(r_met) == {"loss", "aux", "grad_norm", "lr"}
        _close(met["loss"], r_met["loss"], 1e-5, 0)
        for k in ("aux", "grad_norm", "lr"):
            _close(met[k], r_met[k], 1e-4, 1e-6)
    assert int(state.step) == int(r_state.step) == 7
    for got, want in ((state.params, r_state.params),
                      (state.opt.m, r_state.opt.m),
                      (state.opt.v, r_state.opt.v)):
        jax.tree.map(lambda g, w: _close(g, w, 1e-4, 1e-6), got, want)


DS = SyntheticLM(vocab_size=512, seq_len=32, global_batch=8, seed=3,
                 branching=2)
RC = RunConfig(remat="none", attn_impl="dense", learning_rate=3e-3,
               warmup_steps=5, schedule="wsd")
SMOKE = get_smoke_config("llama3.2-1b")


def test_trainer_loss_decreases(tmp_path):
    tc = TrainerConfig(total_steps=30, ckpt_dir=str(tmp_path / "ck"),
                       ckpt_every=10, log_every=5)
    out = Trainer(SMOKE, RC, tc, DS, device="cpu").run()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    assert np.isfinite(last) and last < first - 0.5, (first, last)
    assert latest_step(str(tmp_path / "ck")) == 30
    assert [h["step"] for h in out["history"]] == [0, 5, 10, 15, 20, 25, 29]
    assert out["stragglers"] >= 0 and out["final"]["loss"] == last


def test_resume_matches_a_straight_run(tmp_path):
    """10 straight steps == 5 steps + checkpoint + resume + 5 steps."""
    ckdir = str(tmp_path / "ck")
    straight = Trainer(SMOKE, RC, TrainerConfig(total_steps=10, log_every=1),
                       DS, device="cpu").run()["final"]["loss"]
    Trainer(SMOKE, RC, TrainerConfig(total_steps=5, ckpt_dir=ckdir,
                                     ckpt_every=5, log_every=1), DS,
            device="cpu").run()
    assert latest_step(ckdir) == 5
    resumed = Trainer(SMOKE, RC, TrainerConfig(
        total_steps=10, ckpt_dir=ckdir, ckpt_every=50, log_every=1), DS,
        device="cpu").run()
    assert resumed["history"][0]["step"] == 5
    np.testing.assert_allclose(resumed["final"]["loss"], straight, rtol=1e-5)


def test_int8_ef_compression_trains():
    rc = dataclasses.replace(RC, grad_compression="int8_ef")
    out = Trainer(SMOKE, rc, TrainerConfig(total_steps=12, log_every=2), DS,
                  device="cpu").run()
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert out["state"].opt.ef is not None


def test_preemption_takes_a_checkpoint(tmp_path):
    """SIGTERM mid-run -> drain with a checkpoint at the interrupted
    step."""
    ckdir = str(tmp_path / "ck")

    def cb(step, metrics):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
    out = Trainer(SMOKE, RC, TrainerConfig(total_steps=1000, ckpt_dir=ckdir,
                                           ckpt_every=10**6, log_every=1),
                  DS, metrics_cb=cb, device="cpu").run()
    assert latest_step(ckdir) == 4 and out["final"]["loss"] > 0
    # on a (one-rank) mesh the ranks agree to stop and gather the shards
    init_distributed("cpu")
    try:
        ckdir = str(tmp_path / "ck_mesh")
        Trainer(SMOKE, RC, TrainerConfig(total_steps=1000, ckpt_dir=ckdir,
                                         ckpt_every=10**6, log_every=1),
                DS, mesh=make_current_mesh(), metrics_cb=cb,
                device="cpu").run()
        assert latest_step(ckdir) == 4
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_train_state_checkpoints_cross_restore(tmp_path, compression):
    """A ``TrainState`` written by either package restores bit-equal in
    the other, with the same leaf paths (``.step``, ``.params[...]``,
    ``.opt.m[...]``, ...)."""
    rrc = RRun(grad_compression=compression, **F32)
    rc = RunConfig(grad_compression=compression, **F32)
    _, r_state = _ref_state("gemma2-9b", rrc, step=3)
    cfg = get_smoke_config("gemma2-9b")
    state = train_state_from_jax(cfg, rc, jax.tree.map(np.asarray, r_state),
                                 device="cpu")
    r_save(str(tmp_path / "r"), 3, r_state)
    save_checkpoint(str(tmp_path / "p"), 3, state)
    for name in ("r", "p"):
        with open(tmp_path / name / "step_00000003" / "manifest.json") as f:
            text = f.read()
        assert '".opt.m[' in text and '".step"' in text
    template = init_train_state(cfg, rc, torch.Generator().manual_seed(9),
                                device="cpu")
    mine = restore_checkpoint(str(tmp_path / "r"), 3, template)
    theirs = r_restore(str(tmp_path / "p"), 3, r_state)
    assert type(mine) is type(template) and mine.step.dtype == torch.int32
    assert (mine.opt.ef is None) == (compression == "none")
    flat_mine = jax.tree.leaves(mine)
    for a, b, c in zip(flat_mine, jax.tree.leaves(theirs),
                       jax.tree.leaves(r_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(c))
    assert len(flat_mine) == len(jax.tree.leaves(r_state))


def test_elastic_restore(tmp_path):
    rc = RunConfig(**F32)
    first = init_train_state(SMOKE, rc, torch.Generator().manual_seed(1),
                             device="cpu")
    template = init_train_state(SMOKE, rc, torch.Generator().manual_seed(2),
                                device="cpu")
    assert elastic_restore(str(tmp_path), template) == (template, None)
    save_checkpoint(str(tmp_path), 3, first)
    restored, step = elastic_restore(str(tmp_path), template)
    assert step == 3
    assert torch.equal(restored.params["embed"], first.params["embed"])
    assert not torch.equal(template.params["embed"], first.params["embed"])


#: the CLI's metrics computed in bfloat16: 8 significant bits, an ulp of
#: 2^-8 = 3.9e-3 relative.  The loss and the aux are means over many
#: positions and hold within rtol 2e-3; the gradient norm after one
#: update within 1e-2 (a routing near a tie can flip in bfloat16)
CLI_RTOL = {"loss": 2e-3, "aux": 2e-3, "grad_norm": 1e-2}


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).family != "dense"])
def test_non_dense_smoke_archs_train_as_the_reference(arch, monkeypatch,
                                                      capsys):
    """``python -m repro_torch.launch.train --arch <id> --smoke --steps 2
    --device cpu`` from the reference CLI's initial state (its
    ``init_train_state`` from ``PRNGKey(0)``, carried across): the final
    loss, aux and grad_norm against the reference CLI's (``CLI_RTOL``);
    then ``examples/train_lm.py --arch <id> --smoke`` trains 25 steps on
    its own weights and its loss falls."""
    import ast
    import sys

    from _torch_train_parity import one_torch_thread
    from repro.launch import train as r_cli
    from repro_torch.train import trainer as TR
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--smoke",
                                      "--steps", "2"])
    r_cli.main()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("final:")][-1]
    want = ast.literal_eval(line[len("final:"):].strip())
    start = jax.tree.map(np.asarray, r_init_state(
        r_smoke(arch), RRun(), jax.random.PRNGKey(0)))
    monkeypatch.setattr(TR, "init_train_state", lambda cfg, rc, gen, device:
                        train_state_from_jax(cfg, rc, start, device))
    with one_torch_thread():
        got = train_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                              "--device", "cpu"])["final"]
    for k, rtol in CLI_RTOL.items():
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    monkeypatch.undo()
    with one_torch_thread():
        out = train_lm.main(["--arch", arch, "--smoke", "--steps", "25",
                             "--batch", "4", "--seq", "32", "--device",
                             "cpu"])
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]


def test_cli_refuses_mesh_and_needs_the_card_by_default(capsys):
    # --mesh trains on a one-rank group it starts and ends
    out = train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--mesh",
                          "--device", "cpu", "--steps", "1"])
    assert out["final"]["loss"] > 0 and not dist.is_initialized()
    with pytest.raises(SystemExit):
        train_lm.main(["--arch", "llama3.2-1b", "--device", "cpu"])
    if not torch.cuda.is_available():
        for main in (train_cli.main, train_lm.main):
            with pytest.raises(SystemExit, match="no CUDA device"):
                main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
    out = train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "3",
                          "--device", "cpu", "--global-batch", "4", "--seq",
                          "16", "--remat", "dots", "--microbatches", "2"])
    assert [h["step"] for h in out["history"]] == [0, 2]
    assert out["history"][0]["lr"] == 0.0 and out["final"]["lr"] > 0
    assert np.isfinite(out["final"]["loss"])
    assert "final:" in capsys.readouterr().out
