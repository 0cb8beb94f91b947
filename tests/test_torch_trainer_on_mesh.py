"""The port's trainer on a mesh of gloo ranks, held to the reference's
(tests/test_trainer_on_mesh.py runs the reference's on a (2, 2) device
mesh): explicit FSDP resumed from the reference's step-0 state, its losses
and its step-8 state equal to the reference Trainer's on a (2, 2) host
mesh and to the port's one-device Trainer's, checkpoints of full arrays,
an elastic restore onto a (4, 1) mesh; the mesh init and restore drawn
leaf by leaf, each rank keeping its block; expert-parallel (``a2a``),
``gshard`` and ``scatter`` train steps whose gradients and updates equal
the reference's one-device ``gshard`` step's; and ``train --mesh`` under
``torch.distributed.run``."""
import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_gloo as G
from _torch_train_parity import _filled_state, to_jax
from repro.checkpoint.checkpoint import save_checkpoint as r_save
from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.launch.sharding import NO_AXES
from repro.models import transformer as RT
from repro.train import init_train_state as r_init_state
from repro.train.step import make_train_step as r_make_step
from repro_torch.checkpoint.checkpoint import (_flatten_with_paths,
                                               latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.sharding import local_shard, make_axes, to_placements
from repro_torch.models import model_specs
from repro_torch.models.params import from_jax, tree_map
from repro_torch.train.step import (init_train_state, state_placements,
                                    train_state_specs)
from repro_torch.train.trainer import _own_block


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


class RankMesh(FakeMesh):
    """A stand-in mesh seen from the rank at ``coords``."""

    def __init__(self, shape: dict, coords: dict):
        super().__init__(shape)
        self.coords = coords

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]


SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

#: the Trainer's run config in both packages (float32: see ``G.F32``)
TRAIN_KW = dict(remat="none", attn_impl="dense", learning_rate=3e-3,
                warmup_steps=2, **G.F32)

#: the reference's Trainer on a (2, 2) mesh of 4 host devices from its
#: fresh state (``PRNGKey(0)``), checkpointing into argv[1]: its logged
#: losses.  (It cannot resume on a mesh: its ``elastic_restore`` places
#: the state on one device, which its jitted mesh step refuses.)
REF_TRAINER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
from repro.configs import get_smoke_config
from repro.configs.base import RunConfig
from repro.data.pipeline import SyntheticLM
from repro.launch.mesh import compat_make_mesh
from repro.train import Trainer, TrainerConfig

cfg = get_smoke_config("llama3.2-1b")
rc = RunConfig(**json.loads(sys.argv[2]))
ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                 seed=1, branching=2)
mesh = compat_make_mesh((2, 2), ("data", "model"))
tc = TrainerConfig(total_steps=8, ckpt_dir=sys.argv[1], ckpt_every=4,
                   log_every=1)
out = Trainer(cfg, rc, tc, ds, mesh=mesh).run()
print("RESULT " + json.dumps([h["loss"] for h in out["history"]]))
"""


def _state_arrays(ckpt_dir: str, step: int, cfg, rc) -> dict:
    """A checkpoint's leaves by name, read with the port's template."""
    state = restore_checkpoint(ckpt_dir, step, init_train_state(
        cfg, rc, torch.Generator().manual_seed(0), "cpu"))
    return {name: t.numpy() for name, t in _flatten_with_paths(state)}


def test_trainer_mesh_and_elastic(tmp_path):
    rc_ref = RRun(**TRAIN_KW)
    start = r_init_state(r_smoke("llama3.2-1b"), rc_ref,
                         jax.random.PRNGKey(0))
    dirs = {n: str(tmp_path / n) for n in ("mesh", "one", "ref")}
    for n in ("mesh", "one"):
        r_save(dirs[n], 0, start)           # the port's runs resume from it
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_TRAINER, dirs["ref"],
         json.dumps(TRAIN_KW)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out = G.run_ranks("trainer", 4, tmp_path, timeout=240, steps=8,
                          ckpt_dir=dirs["mesh"], ckpt_every=4)
        torch.set_num_threads(1)
        one, cfg, rc = G._smoke_trainer("llama3.2-1b", 8, dirs["one"], 50,
                                        None, G.F32, 8, 32)
        ref_out, ref_err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, ref_err[-4000:]
    want = json.loads([ln for ln in ref_out.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])
    ones = [h["loss"] for h in one["history"]]
    assert len(want) == len(ones) == 8

    saved = _state_arrays(dirs["mesh"], 8, cfg, rc)
    ref_saved = _state_arrays(dirs["ref"], 8, cfg, rc)
    assert sorted(saved) == sorted(ref_saved)
    worst_state = 0.0
    for name, arr in ref_saved.items():
        err = float(np.abs(saved[name] - arr).max()) if arr.size else 0.0
        scale = max(float(np.abs(arr).max()) if arr.size else 0.0, 1e-30)
        worst_state = max(worst_state, err / scale)
        assert err <= 1e-4 * scale, (name, err, scale)
    mesh41 = FakeMesh({"data": 4, "model": 1})
    specs = state_placements(cfg, rc, make_axes(mesh41, rc))
    placements = dict(_flatten_with_paths(tree_map(
        lambda spec: str(to_placements(spec, mesh41)), specs)))
    worst_ref = worst_one = 0.0
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            r = json.load(f)
        got = [h["loss"] for h in r["history"]]
        assert [h["step"] for h in r["history"]] == list(range(8))
        rel_ref = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        rel_one = max(abs(a - b) / abs(b) for a, b in zip(got, ones))
        worst_ref, worst_one = max(worst_ref, rel_ref), max(worst_one,
                                                            rel_one)
        assert rel_ref < 1e-4, (rank, got, want)
        assert rel_one < 1e-4, (rank, got, ones)
        assert got[-1] < got[0]                 # trained on the mesh
        assert r["step"] == 8
        restored = np.load(os.path.join(out, f"restored{rank}.npz"))
        assert sorted(restored.files) == sorted(saved)
        for name, arr in saved.items():
            np.testing.assert_array_equal(restored[name], arr, name)
        # every leaf restored with its placements on (4, 1)
        assert r["placements"] == placements
    assert latest_step(dirs["mesh"]) == 8
    print(f"largest relative loss difference, (2, 2): against the "
          f"reference's (2, 2) {worst_ref:.3e}, against one device "
          f"{worst_one:.3e}; step-8 state against the reference's "
          f"{worst_state:.3e} of a leaf's largest")


def test_mesh_init_and_restore_keep_each_ranks_block(tmp_path):
    """``init_train_state(place=)`` and ``restore_checkpoint(place=)``, as
    the mesh Trainer calls them, give each rank of a (2, 2) mesh exactly
    its block of the one-device state (ZeRO-1 moments included)."""
    cfg = get_smoke_config("llama3.2-1b")
    rc = RunConfig(zero1=True)
    whole = init_train_state(cfg, rc, torch.Generator().manual_seed(0),
                             "cpu")
    save_checkpoint(str(tmp_path), 3, whole)
    like = tree_map(lambda leaf: torch.empty(leaf.shape, device="meta"),
                    train_state_specs(cfg, rc))
    like = like._replace(step=torch.empty((), dtype=torch.int32,
                                          device="meta"))
    split = []

    def check(want, spec, a, b, mesh):
        block = local_shard(want, spec, mesh)
        split.append(block.shape != want.shape)
        assert torch.equal(a, block) and torch.equal(b, block)
    for d, m in itertools.product(range(2), range(2)):
        mesh = RankMesh({"data": 2, "model": 2}, {"data": d, "model": m})
        specs = state_placements(cfg, rc, make_axes(mesh, rc))
        keep = tree_map(lambda spec: functools.partial(
            _own_block, spec=spec, mesh=mesh), specs)
        fresh = init_train_state(cfg, rc, torch.Generator().manual_seed(0),
                                 "cpu", place=keep)
        back = restore_checkpoint(str(tmp_path), 3, like, device="cpu",
                                  place=keep)
        tree_map(functools.partial(check, mesh=mesh), whole, specs, fresh,
                 back)
    assert any(split)
    assert len(split) == 4 * len(_flatten_with_paths(whole))


#: (moe_impl, seq) of the MoE step cases
MOE_STEPS = [("a2a", 16), ("gshard", 16), ("scatter", 16), ("gshard", 1024)]


def _named(cfg, tree) -> dict:
    """A reference parameter tree's leaves by the port's names."""
    return {n: t.numpy() for n, t in _flatten_with_paths(from_jax(
        model_specs(cfg), jax.tree.map(np.asarray, tree), "cpu"))}


@pytest.fixture(scope="module")
def moe_steps(tmp_path_factory):
    """Every MoE step case on one launch of 4 gloo ranks, and meanwhile,
    for each, the reference's one-device step (gradients and updated
    parameters, in one jit) and the port's: (wants, rank output dir)."""
    tmp = tmp_path_factory.mktemp("moe_steps")
    cases, runs = [], []
    for i, (moe_impl, seq) in enumerate(MOE_STEPS):
        cf = 16.0 if moe_impl == "a2a" else None
        impl = "gshard" if moe_impl == "a2a" else moe_impl
        rcfg = r_smoke("phi3.5-moe-42b-a6.6b")
        if cf is not None:
            rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
        rrc = RRun(**G.moe_step_kw(impl))
        r_state = _filled_state(rcfg, rrc)
        state_dir = str(tmp / f"state{i}")
        r_save(state_dir, int(r_state.step), r_state)
        cases.append((impl, cf, seq, rcfg, rrc, r_state, state_dir))
        runs.append(dict(moe_impl=moe_impl, state_dir=state_dir,
                         capacity_factor=cf, seq=seq))
    ranks = G.start_ranks("moe_cases", 4, tmp, layer="moe_step", runs=runs)
    try:
        torch.set_num_threads(1)
        wants = []
        for impl, cf, seq, rcfg, rrc, r_state, state_dir in cases:
            cfg, rc, state, batch = G.moe_step_setup(impl, state_dir, cf,
                                                     seq=seq)
            jb = to_jax({"tokens": batch["tokens"].numpy()})

            def ref_step(st, b, rcfg=rcfg, rrc=rrc):
                g = jax.grad(lambda p: RT.loss_fn(rcfg, rrc, p, b,
                                                  NO_AXES)[0])(st.params)
                return g, r_make_step(rcfg, rrc, NO_AXES)(st, b)
            r_grads, (r_new, r_met) = jax.jit(ref_step)(r_state, jb)
            before = {n: t.clone().numpy() for n, t in
                      _flatten_with_paths(state.params)}
            one_new, one_met, one_g = G.step_with_grads(cfg, rc, state,
                                                        batch)
            wants.append((before, {
                "reference": (_named(cfg, r_grads),
                              _named(cfg, r_new.params), r_met),
                "one device": ({n: t.numpy() for n, t in
                                _flatten_with_paths(one_g)},
                               {n: t.numpy() for n, t in
                                _flatten_with_paths(one_new.params)},
                               one_met)}))
        out = ranks.wait(240)
    finally:
        ranks.kill()
    return wants, out


@pytest.mark.parametrize("case", range(len(MOE_STEPS)),
                         ids=["a2a", "gshard", "scatter", "gshard-seq1024"])
def test_moe_step_on_mesh_equals_one_device_gshard(moe_steps, case):
    """One phi3.5-moe smoke step on (2, 2) from the reference's state
    (seed 0, moments filled, step 5), held leaf by leaf to the reference's
    one-device step on the same state and batch: ``jax.grad`` of its
    ``loss_fn`` and its ``make_train_step`` (the updated parameters at
    ``check_train_step``'s rtol 1e-4 / atol 1e-6); and to the port's
    one-device step.  Its gradients are clipped (norm 2.29 > 1), so the
    mesh's global norm counts.  ``gshard`` and ``scatter`` run at the
    config's own capacity factor, so requests are dropped: at seq 16 a
    group (the whole batch's 64 tokens) spans both data ranks, at seq
    1024 each data rank holds two whole groups of 1024.  ``a2a`` runs at
    capacity factor 16, without drops: its capacity is each rank's own
    tokens', as in the reference, so only then is it gshard's."""
    wants, out = moe_steps
    before, by_whom = wants[case]
    for rank in range(4):
        got = np.load(os.path.join(out, str(case), f"rank{rank}.npz"))
        for who, (g, p, met) in by_whom.items():
            assert abs(float(got["loss"]) - float(met["loss"])) < \
                1e-5 * abs(float(met["loss"])), (who, rank)
            assert abs(float(got["aux"]) - float(met["aux"])) < 1e-5, \
                (who, rank)
            assert abs(float(got["grad_norm"]) - float(met["grad_norm"])) \
                < 1e-5 * float(met["grad_norm"]), (who, rank)
            for name, want in g.items():
                tol = 1e-4 * np.abs(want).max()
                err = np.abs(got["g" + name] - want).max()
                assert err <= tol, (who, rank, name, err, tol)
            for name, want in p.items():
                if who == "reference":          # as check_train_step
                    np.testing.assert_allclose(got["p" + name], want,
                                               rtol=1e-4, atol=1e-6,
                                               err_msg=f"{rank} {name}")
                    continue
                step = np.abs(want - before[name]).max()
                err = np.abs(got["p" + name] - want).max()
                assert err <= 1e-4 * max(step, np.abs(want).max() * 1e-3), \
                    (who, rank, name, err, step)


def test_train_cli_mesh_under_torchrun(tmp_path):
    """Two CPU ranks through ``torch.distributed.run``; every process
    has JAX and the reference blocked (``sitecustomize``)."""
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro', "
        "'benchmarks'):\n"
        "    sys.modules[name] = None\n")
    env = dict(os.environ, PYTHONPATH=f"{block}{os.pathsep}"
               f"{os.path.abspath(SRC)}", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "llama3.2-1b", "--smoke", "--steps", "2", "--mesh",
         "--device", "cpu", "--global-batch", "4", "--seq", "16"],
        env=env, capture_output=True, text=True, timeout=180,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-4000:]
    finals = [ln for ln in out.stdout.splitlines()
              if ln.startswith("final:")]
    assert len(finals) == 1 and "'loss'" in finals[0]      # rank 0's
