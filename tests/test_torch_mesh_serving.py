"""The serving engine on a mesh: ``ServeEngine`` with ``ax`` on 4 gloo
ranks of a (2, 2) data x model mesh, held to the reference's
``ServeEngine`` with ``make_axes(mesh, rc)`` on a (2, 2) mesh of 4 host
devices (its weights placed by its ``Axes.resolve``) and to the port's own
one-device engine.  Float32 compute on float32 weights.

``generate`` cases, a 12-token prompt and 6 new tokens each: llama3.2-1b
paged and dense at batch 4 (rows over "data") and batch 1 (positions over
both axes), gemma2-9b paged (local and global windows, softcaps) and
jamba paged (attention, Mamba and MoE).  The scheduled day: llama3.2-1b's
``run_scheduler`` on ``tests/test_scheduler.py``'s pinned traffic with
1-page prefill chunks, under the reference's chaos plan (a bank offline,
a corrupt page, a flaky decode step), and chunked, preempted at tick 3
and resumed.

Against the reference: greedy tokens, each decode step's trace, the
serving trace, ``last_pages``, the day's outputs, ``scheduler_stream`` and
``stats()`` (integers equal, floats at float32's tolerance); the
reference's tokens are never one repeated value.  Against one device:
``last_pools`` within atol 1e-5 and a sampled ``generate`` (temperature
0.8, seed 3) token-equal.  Collective bytes, per rank, equal
``_torch_gloo.serving_collectives``: a paged decode step gathers every
weight once (and a Mamba block's state over ``dinner``), an admission
adds its prompt's K/V once, no pool byte moves.

Weights are drawn at each leaf's spec scale times ``GAIN``: at scale 1
the llama smoke config answers one repeated token a lane.

One gloo launch and one reference subprocess serve every case (a
module-scoped fixture); the port's one-device runs go on meanwhile.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_gloo as G
import _torch_train_parity as P
from repro_torch import runtime
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import StandInMesh
from repro_torch.launch.sharding import NO_AXES, make_axes
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax, tree_map
from repro_torch.serving import scheduler
from repro_torch.serving.engine import ServeEngine

HERE = os.path.dirname(os.path.abspath(__file__))
#: (arch, batch, kv_mode) of each ``generate`` case
CASES = (("llama3.2-1b", 4, "paged"), ("llama3.2-1b", 4, "dense"),
         ("llama3.2-1b", 1, "paged"), ("llama3.2-1b", 1, "dense"),
         ("gemma2-9b", 4, "paged"), ("jamba-v0.1-52b", 4, "paged"))
#: weight scale over each leaf's: tokens that vary, in every config
GAIN = {"llama3.2-1b": 4.0, "gemma2-9b": 1.0, "jamba-v0.1-52b": 1.0}
RUNS = ("chunked", "faults", "preempted", "resumed")
POOL_TOL = 1e-5

REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
sys.path.insert(0, sys.argv[1])
import _torch_gloo as G
from repro import runtime
from repro.configs import get_smoke_config
from repro.configs.base import RunConfig
from repro.launch.mesh import compat_make_mesh
from repro.launch.sharding import make_axes
from repro.models import transformer as RT
from repro.serving import scheduler
from repro.serving.engine import ServeEngine

mesh = compat_make_mesh((2, 2), ("data", "model"))
cases, day, out = json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]


def engine(arch, data, **kw):
    cfg, rc = get_smoke_config(arch), RunConfig(**G.MESH_RC)
    ax = make_axes(mesh, rc)

    def place(leaf, a):
        a = jnp.asarray(a)
        return jax.device_put(a, NamedSharding(mesh, ax.resolve(leaf.axes,
                                                                a.shape)))
    params = jax.tree.map(place, RT.model_specs(cfg),
                          G.unflatten(data, "p/"))
    return ServeEngine(cfg, rc, params, ax, **kw)


for i, (arch, batch, kv_mode, inputs) in enumerate(cases):
    data = dict(np.load(inputs))
    eng = engine(arch, data, max_batch=G.MESH_SERVE["max_batch"],
                 max_seq=G.MESH_SERVE["max_seq"], kv_mode=kv_mode,
                 page_len=G.MESH_SERVE["page_len"])
    res = eng.generate(data["prompts"].astype(np.int32),
                       G.MESH_SERVE["new"])
    rec = {"tokens": res.tokens}
    if kv_mode == "paged":
        rec.update(G.generate_record(eng))
    np.savez(os.path.join(out, f"case{i}.npz"), **rec)
data = dict(np.load(day))
eng = engine("llama3.2-1b", data, kv_mode="paged", **G.SERVE_DAY)
meta, arrays = G.serve_day(eng, scheduler, runtime,
                           [data[f"tokens/{r}"] for r in
                            range(len(G.TRAFFIC))],
                           os.path.join(out, "ckpt"))
np.savez(os.path.join(out, "day.npz"), **arrays)
with open(os.path.join(out, "day.json"), "w") as f:
    json.dump(meta, f, default=lambda o: np.asarray(o).tolist())
print("REFERENCE DONE")
"""


def _weights(arch: str, rng) -> dict:
    """Whole weights, each leaf drawn at its spec's scale times
    ``GAIN``, flattened under "p/"."""
    def draw(leaf):
        if leaf.init == "zeros":
            return np.zeros(leaf.shape, np.float32)
        if leaf.init == "ones":
            return np.ones(leaf.shape, np.float32)
        return (GAIN[arch] * leaf.scale * rng.standard_normal(
            leaf.shape)).astype(np.float32)
    return G.flatten(tree_map(draw, T.model_specs(get_smoke_config(arch))),
                     "p/")


def _one_device(arch: str, data: dict, **kw) -> ServeEngine:
    cfg = get_smoke_config(arch)
    return ServeEngine(cfg, RunConfig(**G.MESH_RC),
                       from_jax(T.model_specs(cfg), G.unflatten(data, "p/"),
                                "cpu"), NO_AXES, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the gloo ranks, in the reference and on one device:
    {"ranks": dir, "ref": dir, "one": [per case], "day": one device's
    (meta, arrays)}."""
    tmp = tmp_path_factory.mktemp("mesh_serving")
    cases = []
    for i, (arch, batch, kv_mode) in enumerate(CASES):
        cfg = get_smoke_config(arch)
        rng = np.random.default_rng(i)
        path = str(tmp / f"inputs{i}.npz")
        np.savez(path, **_weights(arch, rng), prompts=rng.integers(
            0, cfg.vocab_size, (batch, G.MESH_SERVE["prompt"])))
        cases.append([arch, batch, kv_mode, path])
    rng = np.random.default_rng(len(CASES))
    day = {**_weights("llama3.2-1b", rng),
           **{f"tokens/{r}": rng.integers(
               0, get_smoke_config("llama3.2-1b").vocab_size, p)
              for r, (_, p, _) in enumerate(G.TRAFFIC)}}
    day_path = str(tmp / "day.npz")
    np.savez(day_path, **day)
    ranks = G.start_ranks("mesh_serving", 4, tmp, cases=cases, day=day_path)
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=os.path.abspath(G.SRC),
               JAX_PLATFORMS="cpu")
    with open(tmp / "ref.log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, HERE, json.dumps(cases),
             day_path, str(ref_dir)], env=env, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        one = []
        with P.one_torch_thread():
            for arch, batch, kv_mode, path in cases:
                data = dict(np.load(path))
                eng = _one_device(arch, data, kv_mode=kv_mode,
                                  max_batch=G.MESH_SERVE["max_batch"],
                                  max_seq=G.MESH_SERVE["max_seq"],
                                  page_len=G.MESH_SERVE["page_len"])
                rec = {"sampled": eng.generate(
                    data["prompts"], G.MESH_SERVE["new"], temperature=0.8,
                    seed=3).tokens}
                rec["tokens"] = eng.generate(data["prompts"],
                                             G.MESH_SERVE["new"]).tokens
                if kv_mode == "paged":
                    rec.update(G.whole_pools(eng, batch))
                one.append(rec)
            eng = _one_device("llama3.2-1b", day, kv_mode="paged",
                              **G.SERVE_DAY)
            meta, arrays = G.serve_day(
                eng, scheduler, runtime,
                [day[f"tokens/{r}"] for r in range(len(G.TRAFFIC))],
                str(tmp / "one_ckpt"))
            arrays.update(G.whole_pools(eng, G.SERVE_DAY["max_batch"]))
        ref.wait(timeout=400)
        with open(tmp / "ref.log") as f:
            assert ref.returncode == 0, f.read()[-3000:]
    finally:
        if ref.poll() is None:
            ref.kill()
        rank_dir = ranks.wait(timeout=400)
    return {"ranks": rank_dir, "ref": str(ref_dir), "one": one,
            "day": (json.loads(json.dumps(
                meta, default=lambda o: np.asarray(o).tolist())), arrays)}


def _ranks(runs, stem: str) -> list:
    """Each rank's (arrays, meta) of ``stem``."""
    out = []
    for r in range(4):
        base = os.path.join(runs["ranks"], f"{stem}_rank{r}")
        with open(base + ".json") as f:
            out.append((dict(np.load(base + ".npz")), json.load(f)))
    return out


def _ax():
    return make_axes(StandInMesh({"data": 2, "model": 2}),
                     RunConfig(**G.MESH_RC))


def _moved(step: dict, want: dict, what: str) -> None:
    """A call's collective bytes by kind equal to ``want`` (0 where
    ``want`` has none)."""
    got = {k: v for k, v in step.items() if k not in ("total", "count")}
    assert {k: got.get(k, 0) for k in set(got) | set(want)} == \
        {k: want.get(k, 0) for k in set(got) | set(want)}, what


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-b{b}-{m}" for a, b, m in CASES])
def test_mesh_generate_equals_the_reference_and_one_device(runs, case):
    arch, batch, kv_mode = CASES[case]
    cfg = get_smoke_config(arch)
    want = dict(np.load(os.path.join(runs["ref"], f"case{case}.npz")))
    one = runs["one"][case]
    assert len(np.unique(want["tokens"])) > 1, "one repeated token"
    np.testing.assert_array_equal(one["tokens"], want["tokens"])
    ax = _ax()
    new = G.MESH_SERVE["new"]
    for r, (got, meta) in enumerate(_ranks(runs, f"case{case}")):
        what = f"{arch} batch {batch} {kv_mode} rank {r}"
        np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                      err_msg=what)
        np.testing.assert_array_equal(got["sampled"], one["sampled"],
                                      err_msg=what)
        (total,) = meta["generate"]
        if kv_mode == "dense":
            admit = G.serving_collectives(cfg, ax, "dense admission",
                                          batch, G.MESH_SERVE["prompt"])
            step = G.serving_collectives(cfg, ax, "dense step", batch)
            _moved(total, {k: admit.get(k, 0) + (new - 1) * step.get(k, 0)
                           for k in set(admit) | set(step)}, what)
            continue
        keys = sorted(k for k in want if k != "tokens")
        assert keys == sorted(k for k in got if k.split("/")[0] in
                              ("full", "pages") or k.startswith("step")), \
            what
        for key in keys:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{what} {key}")
        pools = sorted(k for k in got if k.startswith("pool/"))
        assert pools and pools == sorted(k for k in one
                                         if k.startswith("pool/"))
        for key in pools:
            np.testing.assert_allclose(got[key], one[key], rtol=0,
                                       atol=POOL_TOL,
                                       err_msg=f"{what} {key}")
        # a paged step moves weights (and a Mamba state), no pool byte;
        # the admission the prompt's K/V once
        paged = G.serving_collectives(cfg, ax, "paged step", batch)
        assert len(meta["steps"]) == new - 1, what
        for s in meta["steps"]:
            _moved(s["bytes"], paged, what)
        admit = G.serving_collectives(cfg, ax, "admission", batch,
                                      G.MESH_SERVE["prompt"])
        _moved({k: v - sum(s["bytes"].get(k, 0) for s in meta["steps"])
                for k, v in total.items()}, admit, what)


def _stats_equal(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for key, w in want.items():
        if isinstance(w, float):
            assert got[key] == pytest.approx(w, rel=1e-6), (what, key)
        else:
            assert got[key] == w, (what, key)


@pytest.mark.parametrize("run", RUNS)
def test_mesh_day_equals_the_reference_and_one_device(runs, run):
    with open(os.path.join(runs["ref"], "day.json")) as f:
        want = json.load(f)[run]
    want_arrays = dict(np.load(os.path.join(runs["ref"], "day.npz")))
    one = runs["day"][0][run]
    toks = [t for v in want["outputs"].values() for t in v]
    if run == "preempted":                  # stopped before any finished
        assert want["preempted"] and not toks
    else:
        assert len(set(toks)) > 1, "one repeated token"
    assert one["outputs"] == want["outputs"]
    for r, (got, meta) in enumerate(_ranks(runs, "day")):
        what = f"{run} rank {r}"
        mine = meta["runs"][run]
        assert mine["outputs"] == want["outputs"], what
        assert (mine["ticks"], mine["preempted"]) == (
            want["ticks"], want["preempted"]), what
        _stats_equal(mine["stats"], want["stats"], what)
        for field in G.TRACE_FIELDS:
            key = f"{run}/{field}"
            np.testing.assert_array_equal(got[key], want_arrays[key],
                                          err_msg=what)


def test_mesh_day_moves_weights_and_prompts_never_a_pool(runs):
    """The day's admissions (re-prefills and resumed prefills included)
    each move the weights and the prompt's K/V once, each decode step
    the weights alone; the last pools equal one device's."""
    cfg = get_smoke_config("llama3.2-1b")
    ax = _ax()
    one = runs["day"][1]
    step = G.serving_collectives(cfg, ax, "paged step",
                                 G.SERVE_DAY["max_batch"])
    for r, (got, meta) in enumerate(_ranks(runs, "day")):
        what = f"rank {r}"
        # every prompt once a run, the corrupt page's re-prefill and the
        # resumed lane's rows once more
        assert len(meta["admissions"]) >= len(G.TRAFFIC), what
        for a in meta["admissions"]:
            _moved(a["bytes"], G.serving_collectives(
                cfg, ax, "admission", 1, a["plen"]), f"{what} {a['plen']}")
        assert meta["steps"], what
        for s in meta["steps"]:
            _moved(s["bytes"], step, what)
        pools = sorted(k for k in got if k.startswith("pool/"))
        assert pools and pools == sorted(k for k in one
                                         if k.startswith("pool/"))
        for key in pools:
            np.testing.assert_allclose(got[key], one[key], rtol=0,
                                       atol=POOL_TOL, err_msg=what)


def test_serve_mesh_example_runs_on_one_rank():
    """``python -m repro_torch.examples.serve_mesh --device cpu`` without
    a launcher: a one-rank group and (1, 1) mesh, paged, dense and a
    scheduled day equal to one device's."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(G.SRC),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_mesh",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh={'data': 1, 'model': 1}" in out.stdout
    assert out.stdout.rstrip().endswith("serving on a mesh verified ✓")
