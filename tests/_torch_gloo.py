"""Run a function on N gloo ranks of the port, each a subprocess, for the
mesh tests (``tests/test_torch_moe_a2a.py``, ``test_torch_pipeline.py``,
``test_torch_trainer_on_mesh.py``).

``run_ranks(case, n, tmp_path, **kw)`` starts ``n`` processes that each
join a gloo group on a ``FileStore`` under ``tmp_path`` (so concurrent test
workers never share a port), call ``case(rank, out_dir, **kw)`` from this
module on one torch thread, and exit.  A rank writes what the test reads
under ``out_dir``.  The ranks import neither ``jax`` nor ``repro``; the
test process holds their results to the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

_MAIN = """
import json, sys
sys.path.insert(0, {here!r})
import _torch_gloo
_torch_gloo._rank_main({rank}, {n}, {store!r}, {out!r}, {case!r},
                       json.loads({kw!r}))
"""


class Ranks:
    """``n`` rank processes started by ``start_ranks``; ``wait`` returns
    their output directory once every one has exited cleanly."""

    def __init__(self, procs: list, logs: list, out: str):
        self.procs, self.logs, self.out = procs, logs, out

    def wait(self, timeout: float = 120) -> str:
        try:
            for p in self.procs:
                p.wait(timeout=timeout)
        finally:
            self.kill()
        bad = [(r, p.returncode) for r, p in enumerate(self.procs)
               if p.returncode]
        if bad:
            text = []
            for log in self.logs:
                with open(log) as f:
                    text.append(f.read()[-3000:])
            raise AssertionError((bad, "\n".join(text)))
        return self.out

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def start_ranks(case: str, n: int, tmp_path, **kw) -> Ranks:
    """Start ``case`` on ``n`` ranks, each writing its log to a file (no
    pipe to fill while the test works meanwhile)."""
    out = os.path.join(str(tmp_path), f"{case}_out")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(str(tmp_path), f"{case}_store")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(n):
        logs.append(os.path.join(str(tmp_path), f"{case}_rank{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _MAIN.format(
                    here=HERE, rank=r, n=n, store=store, out=out, case=case,
                    kw=json.dumps(kw))],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return Ranks(procs, logs, out)


def run_ranks(case: str, n: int, tmp_path, timeout: float = 120, **kw):
    """Run ``case`` on ``n`` ranks; returns the output directory."""
    return start_ranks(case, n, tmp_path, **kw).wait(timeout)


def _rank_main(rank, n, store, out, case, kw):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        globals()[case](rank, out, **kw)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- cases --

#: parity runs compute in float32: in bfloat16 a matmul over a data rank's
#: rows rounds apart from one over the whole batch, and 8 steps of
#: training carry that to 1e-3 of the loss
F32 = {"compute_dtype": "float32"}

def _moe_cfg(experts: int, k: int, capacity_factor=16.0):
    """phi3.5-moe's smoke config with ``experts`` of which ``k`` a token;
    ``capacity_factor`` None keeps the config's own (16: no drops)."""
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                              n_experts=experts, experts_per_token=k)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def _moe_layer_setup(experts, k, capacity_factor, inputs):
    """A (2, 2) mesh, its axes, the config, the MoE weights and this
    rank's data rows of the test's ``x``."""
    import torch
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.sharding import make_axes
    from repro_torch.models.moe import moe_specs
    from repro_torch.models.params import from_jax
    cfg = _moe_cfg(experts, k, capacity_factor)
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    data = np.load(inputs)
    p = from_jax(moe_specs(cfg), {n: data[n] for n in
                                  ("router", "w1", "w2", "w3")}, "cpu")
    x = torch.from_numpy(data["x"])
    i = mesh.get_local_rank("data")
    rows = x.shape[0] // 2
    return (mesh, make_axes(mesh, None), cfg, p,
            x[i * rows:(i + 1) * rows], i)


def moe_a2a(rank, out, experts, k, inputs, capacity_factor=16.0):
    """``moe_a2a`` on a (2, 2) mesh: the rows of this rank's data
    coordinate in, its output and aux out."""
    from repro_torch.models.moe_a2a import a2a_applicable
    from repro_torch.models.moe_a2a import moe_a2a as run
    mesh, ax, cfg, p, x, i = _moe_layer_setup(experts, k, capacity_factor,
                                              inputs)
    assert a2a_applicable(cfg, ax, x.shape[1])
    y, aux = run(cfg, p, x, ax)
    np.savez(os.path.join(out, f"rank{rank}.npz"), y=y.numpy(),
             aux=aux.numpy(), data=i, model=mesh.get_local_rank("model"))


def moe_cases(rank, out, layer, runs):
    """``layer`` (``moe_a2a``, ``moe_grouped`` or ``moe_step``) once a
    keyword dict of ``runs``, the i-th writing under ``out``/``i``."""
    for i, kw in enumerate(runs):
        sub = os.path.join(out, str(i))
        os.makedirs(sub, exist_ok=True)
        globals()[layer](rank, sub, **kw)


def moe_grouped(rank, out, impl, group_len, inputs):
    """``moe_gshard`` or ``moe_scatter`` on a (2, 2) mesh at the config's
    own capacity factor: this rank's rows in, its output and aux out."""
    from repro_torch.models import moe as M
    mesh, ax, cfg, p, x, i = _moe_layer_setup(4, 2, None, inputs)
    y, aux = getattr(M, f"moe_{impl}")(cfg, p, x, ax, group_len)
    np.savez(os.path.join(out, f"rank{rank}.npz"), y=y.numpy(),
             aux=aux.numpy(), data=i)


def pipeline(rank, out, inputs, n_stages):
    """``pipelined`` over an ``n_stages`` mesh on the test's stages."""
    import torch
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.train.pipeline import pipelined, stack_stage_params
    data = np.load(inputs)
    stages = [{"w": torch.from_numpy(data[f"w{s}"]),
               "b": torch.from_numpy(data[f"b{s}"])}
              for s in range(n_stages)]
    mesh = compat_make_mesh((n_stages,), ("stage",))

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    got = pipelined(stage_fn, mesh, "stage")(stack_stage_params(stages),
                                             torch.from_numpy(data["xs"]))
    np.save(os.path.join(out, f"rank{rank}.npy"), got.numpy())


def _smoke_trainer(arch, steps, ckpt_dir, ckpt_every, mesh, rc_kw,
                   batch, seq):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_smoke_config(arch)
    rc = RunConfig(remat="none", attn_impl="dense", learning_rate=3e-3,
                   warmup_steps=2, **rc_kw)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                     global_batch=batch, seed=1, branching=2)
    tc = TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                       ckpt_every=ckpt_every, log_every=1)
    return Trainer(cfg, rc, tc, ds, mesh=mesh, device="cpu").run(), cfg, rc


def trainer(rank, out, steps, ckpt_dir, ckpt_every):
    """llama3.2-1b's smoke config trained on (2, 2), checkpointed; then
    the checkpoint restored onto (4, 1)."""
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.sharding import make_axes, to_placements
    from repro_torch.models.params import tree_map
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.train.step import init_train_state, state_placements
    from torch.distributed.tensor import distribute_tensor
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    res, cfg, rc = _smoke_trainer("llama3.2-1b", steps, ckpt_dir,
                                  ckpt_every, mesh, F32, 8, 32)
    mesh2 = compat_make_mesh((4, 1), ("data", "model"))
    specs = state_placements(cfg, rc, make_axes(mesh2, rc))
    fresh = init_train_state(cfg, rc, torch.Generator().manual_seed(7),
                             "cpu")
    template = tree_map(lambda t, spec: distribute_tensor(
        t, mesh2, to_placements(spec, mesh2)), fresh, specs)
    state, step = elastic_restore(ckpt_dir, template)
    full = {name: t.full_tensor().numpy()
            for name, t in _flatten_with_paths(state)}
    np.savez(os.path.join(out, f"restored{rank}.npz"), **full)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"history": res["history"], "step": step,
                   "placements": {name: str(t.placements) for name, t in
                                  _flatten_with_paths(state)}}, f)


def moe_step_setup(moe_impl: str, state_dir: str, capacity_factor=None,
                   batch: int = 4, seq: int = 16):
    """phi3.5-moe's smoke config (at ``capacity_factor``, None for its
    own), the state saved in ``state_dir`` (the test writes the
    reference's there, its moments filled: from zero moments Adam's first
    update turns float32 rounding near eps into percent-level
    differences), and ``SyntheticLM(seed=2)``'s first batch: the same on
    every rank and in the test process."""
    import torch
    from repro_torch.checkpoint.checkpoint import (latest_step,
                                                   restore_checkpoint)
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.step import init_train_state
    cfg = _moe_cfg(4, 2, capacity_factor)
    rc = RunConfig(**moe_step_kw(moe_impl))
    like = init_train_state(cfg, rc, torch.Generator().manual_seed(0),
                            "cpu")
    state = restore_checkpoint(state_dir, latest_step(state_dir), like)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                     global_batch=batch, seed=2)
    return cfg, rc, state, ds.batch(0, device="cpu")


def moe_step_kw(moe_impl: str) -> dict:
    """The ``RunConfig`` of the MoE step tests, in either package."""
    return dict(moe_impl=moe_impl, remat="none", attn_impl="dense",
                compute_dtype="float32", learning_rate=1e-3)


def step_with_grads(cfg, rc, state, batch, ax=None, whole=None):
    """One train step; returns (new state, metrics, the gradients the
    update was given), the gradients made whole by ``whole``."""
    from repro_torch.train import step as S
    seen = {}
    real = S.adamw_update

    def spy(params, grads, opt, step, **kw):
        seen["g"] = whole(grads) if whole else grads
        return real(params, grads, opt, step, **kw)

    S.adamw_update = spy
    try:
        kw = {"ax": ax} if ax is not None else {}
        new, metrics = S.make_train_step(cfg, rc, **kw)(state, batch)
    finally:
        S.adamw_update = real
    return new, metrics, seen["g"]


def moe_step(rank, out, moe_impl, state_dir, capacity_factor, seq):
    """One phi3.5-moe smoke step on (2, 2) with ``moe_impl`` ("a2a": the
    all-to-all layer; "gshard" / "scatter": groups of the whole batch's
    tokens, routed on each data rank where its rows hold whole groups,
    else on the gathered batch): every leaf's gradient and updated
    parameter, made whole."""
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.sharding import (gather_shard, local_shard,
                                             make_axes)
    from repro_torch.models.params import tree_map
    from repro_torch.train.step import state_placements
    cfg, rc, state, batch = moe_step_setup(moe_impl, state_dir,
                                           capacity_factor, seq=seq)
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    ax = make_axes(mesh, rc)
    specs = state_placements(cfg, rc, ax)
    state = tree_map(lambda t, s: local_shard(t, s, mesh).clone(), state,
                     specs)
    batch = {k: local_shard(v, (ax.batch,), mesh) for k, v in batch.items()}

    def whole(tree):
        return tree_map(lambda t, s: gather_shard(t, s, mesh), tree,
                        specs.params)

    new, metrics, g = step_with_grads(cfg, rc, state, batch, ax, whole)
    with torch.no_grad():
        params = whole(new.params)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{"g" + n: t.numpy() for n, t in _flatten_with_paths(g)},
             **{"p" + n: t.numpy() for n, t in _flatten_with_paths(params)},
             loss=metrics["loss"].numpy(), aux=metrics["aux"].numpy(),
             grad_norm=metrics["grad_norm"].numpy())
