"""Inference on a mesh: ``prefill`` and ``decode_step`` with ``ax`` on 4
gloo ranks of a (2, 2) data x model mesh, held to the reference's jitted
``prefill`` / ``decode_step`` on a (2, 2) mesh of 4 host devices (its
inputs placed by its ``Axes.resolve``) and to the port's own one-device
step, on the smoke configs of llama3.2-1b, gemma2-9b (local / global
windows, softcaps, post norms), jamba (attention, Mamba and MoE),
falcon-mamba, phi3.5-moe and musicgen (a frontend in the prefill), each at
batch 4 (rows split over "data", positions over "model"), and llama3.2-1b
at batch 1 (positions over both axes).

Each case prefills 24 positions, grows the cache to a 56-position decode
buffer and runs 12 greedy decode steps: position 28 starts the second
model rank's slice of a full cache, and gemma2's 32-position local ring
wraps at 32.  Float32 compute on float32 weights.

Tolerances, those of the port's one-device decode tests against the
reference (``tests/test_torch_families.py``): logits within atol 1e-4,
the SSM state within rtol 2e-4 / atol 2e-5, the K/V and conv caches
within atol 1e-5; greedy tokens equal.  Each rank's cache is its block of
the reference's, placed by ``Axes.resolve``.  A rank all-gathers no whole
stacked weight leaf, and a decode step's collective bytes equal
``_torch_gloo.inference_collectives`` exactly: every weight once, an SSM
state over ``dinner``, a MoE input whose routing group spans ranks, the
softmax statistics; no KV cache byte.

One gloo launch and one reference subprocess serve every case (a
module-scoped fixture); the port's one-device steps run meanwhile.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_gloo as G
import _torch_train_parity as P
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import StandInMesh
from repro_torch.launch.sharding import NO_AXES, make_axes
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("llama3.2-1b", "gemma2-9b", "jamba-v0.1-52b", "falcon-mamba-7b",
         "phi3.5-moe-42b-a6.6b", "musicgen-medium")
#: (arch, batch): batch 4 splits over "data"; batch 1 puts seq on both
CASES = tuple((a, 4) for a in ARCHS) + (("llama3.2-1b", 1),)
LOGIT_TOL = 1e-4
MESH = {"data": 2, "model": 2}

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
from repro.configs import get_smoke_config
from repro.configs.base import RunConfig
from repro.launch.mesh import compat_make_mesh
from repro.launch.sharding import make_axes
from repro.models import transformer as RT

mesh = compat_make_mesh((2, 2), ("data", "model"))
steps, buffer = G.MESH_INFER["steps"], G.MESH_INFER["buffer"]
for i, (arch, batch, inputs) in enumerate(json.loads(sys.argv[2])):
    cfg, rc = get_smoke_config(arch), RunConfig(**G.MESH_RC)
    ax = make_axes(mesh, rc)

    def place(a, axes):
        a = jnp.asarray(a)
        return jax.device_put(a, NamedSharding(mesh, ax.resolve(axes,
                                                                a.shape)))

    def place_tree(tree, specs):
        return jax.tree.map(lambda l, a: place(a, l.axes), specs, tree)

    data = dict(np.load(inputs))
    params = place_tree(G.unflatten(data, "p/"), RT.model_specs(cfg))
    tokens = place(data["tokens"].astype(np.int32), ("batch", None))
    frontend = place(data["frontend"], ("batch", None, None)) \
        if "frontend" in data else None
    prefill = jax.jit(lambda p, t, f: RT.prefill(cfg, rc, p, t, ax, f))
    decode = jax.jit(lambda p, t, c, pos: RT.decode_step(cfg, rc, p, t, c,
                                                         pos, ax))
    logits, cache = prefill(params, tokens, frontend)
    specs = RT.cache_specs(cfg, batch, buffer)
    cache = jax.tree.map(
        lambda l, a: place(jnp.pad(a, [(0, w - h) for h, w in
                                       zip(a.shape, l.shape)]), l.axes),
        specs, cache)
    start = G.MESH_INFER["positions"]
    toks, outs = [], [logits[:, -1]]
    for s in range(steps + 1):
        tok = jnp.argmax(outs[-1][:, :cfg.vocab_size], -1)[:, None]
        toks.append(tok.astype(jnp.int32))
        if s == steps:
            break
        logits, cache = decode(params, toks[-1], cache,
                               jnp.int32(start + s))
        outs.append(logits[:, -1])
    np.savez(os.path.join(sys.argv[3], f"case{i}.npz"),
             tokens=np.concatenate([np.asarray(t) for t in toks], 1),
             logits=np.stack([np.asarray(o) for o in outs]),
             **G.flatten(jax.tree.map(np.asarray, cache), "c/"))
print("REFERENCE DONE")
"""


def _inputs(arch: str, batch: int, seed: int) -> dict:
    """Whole weights (each leaf drawn at its spec's scale), prompt tokens
    and a frontend's frames, from numpy's generator at ``seed``."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)

    def draw(leaf):
        if leaf.init == "zeros":
            return np.zeros(leaf.shape, np.float32)
        if leaf.init == "ones":
            return np.ones(leaf.shape, np.float32)
        return (leaf.scale * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    out = G.flatten(tree_map(draw, T.model_specs(cfg)), "p/")
    f = cfg.n_frontend_tokens if cfg.frontend else 0
    out["tokens"] = rng.integers(
        0, cfg.vocab_size, (batch, G.MESH_INFER["positions"] - f))
    if f:
        out["frontend"] = rng.standard_normal(
            (batch, f, cfg.d_model)).astype(np.float32)
    return out


def _block(full: np.ndarray, spec, coords: dict) -> np.ndarray:
    """The block of ``full`` that the rank at ``coords`` holds under the
    resolved ``spec`` (major axis first, as ``local_shard``)."""
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (
            (entry,) if entry else ())
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * MESH[a] + coords[a], n * MESH[a]
        if n > 1:
            full = np.array_split(full, n, axis=d)[idx]
    return full


def _stand_in(batch: int):
    rc = RunConfig(**G.MESH_RC)
    return make_axes(StandInMesh(dict(MESH)), rc).for_batch(batch), rc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on the gloo ranks, in the reference and on one device:
    {"ranks": dir, "ref": dir, "one": [greedy results]}."""
    tmp = tmp_path_factory.mktemp("mesh_inference")
    cases = []
    for i, (arch, batch) in enumerate(CASES):
        path = str(tmp / f"inputs{i}.npz")
        np.savez(path, **_inputs(arch, batch, seed=i))
        cases.append([arch, batch, path])
    ranks = G.start_ranks("mesh_inference", 4, tmp, cases=cases,
                          steps=G.MESH_INFER["steps"],
                          buffer=G.MESH_INFER["buffer"])
    ref_dir = tmp / "ref"
    ref_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=os.path.abspath(G.SRC),
               JAX_PLATFORMS="cpu")
    with open(tmp / "ref.log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, HERE, json.dumps(cases),
             str(ref_dir)], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        one = []
        with P.one_torch_thread():
            for arch, batch, path in cases:
                cfg, rc = get_smoke_config(arch), RunConfig(**G.MESH_RC)
                data = dict(np.load(path))
                params = from_jax(T.model_specs(cfg),
                                  G.unflatten(data, "p/"), "cpu")
                frontend = torch.from_numpy(data["frontend"]) \
                    if "frontend" in data else None
                one.append(G.greedy(cfg, rc, params,
                                    torch.from_numpy(data["tokens"]),
                                    frontend, NO_AXES,
                                    G.MESH_INFER["steps"],
                                    G.MESH_INFER["buffer"]))
        ref.wait(timeout=300)
        with open(tmp / "ref.log") as f:
            assert ref.returncode == 0, f.read()[-3000:]
    finally:
        if ref.poll() is None:
            ref.kill()
        rank_dir = ranks.wait(timeout=300)
    return {"ranks": rank_dir, "ref": str(ref_dir), "one": one}


def _close_cache(got: np.ndarray, want: np.ndarray, name: str, what: str):
    if name == "h":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{a}-b{b}" for a, b in CASES])
def test_mesh_steps_equal_the_reference_and_one_device(runs, case):
    arch, batch = CASES[case]
    cfg = get_smoke_config(arch)
    ax, rc = _stand_in(batch)
    want = dict(np.load(os.path.join(runs["ref"], f"case{case}.npz")))
    one = runs["one"][case]
    one_cache = G.flatten(one["cache"], "c/")
    cache_specs = G.flatten(T.cache_specs(cfg, batch, G.MESH_INFER["buffer"]),
                            "c/", leaf=lambda l: l)
    rows_entry = ax.resolve(("batch",), (batch,))
    moved = G.inference_collectives(cfg, ax, "decode", batch, 0, 4, 4, 4)
    np.testing.assert_array_equal(one["tokens"], want["tokens"])
    np.testing.assert_allclose(one["logits"], want["logits"], rtol=0,
                               atol=LOGIT_TOL)
    for r in range(4):
        with open(os.path.join(runs["ranks"],
                               f"case{case}_rank{r}.json")) as f:
            meta = json.load(f)
        got = dict(np.load(os.path.join(runs["ranks"],
                                        f"case{case}_rank{r}.npz")))
        coords = {"data": meta["data"], "model": meta["model"]}
        what = f"{arch} batch {batch} rank {r}"

        def rows(a, axis=0):
            return _block(a, (None,) * axis + rows_entry, coords)
        np.testing.assert_array_equal(got["tokens"], rows(want["tokens"]),
                                      err_msg=what)
        np.testing.assert_array_equal(got["tokens"], rows(one["tokens"]),
                                      err_msg=what)
        for ref_logits in (want["logits"], one["logits"]):
            np.testing.assert_allclose(got["logits"], rows(ref_logits, 1),
                                       rtol=0, atol=LOGIT_TOL, err_msg=what)
        names = sorted(k for k in got if k.startswith("c/"))
        assert names == sorted(cache_specs) == sorted(
            k for k in want if k.startswith("c/")), what
        for key in names:
            leaf = cache_specs[key]
            spec = ax.resolve(leaf.axes, leaf.shape)
            block = _block(want[key], spec, coords)
            assert got[key].shape == block.shape, (what, key)
            if leaf.axes[2] == "seq":                # a rank's positions
                assert got[key].shape[2] < leaf.shape[2], (what, key)
            _close_cache(got[key], block, key.split("/")[-1],
                         f"{what} {key}")
            _close_cache(got[key], _block(one_cache[key], spec, coords),
                         key.split("/")[-1], f"{what} {key} (one device)")
        # no gather takes a whole stacked weight leaf, and a decode step
        # moves the weights, an SSM state and a MoE input, no KV cache
        assert meta["whole_stacked"] == 0, what
        for step in meta["moved"]:
            assert {k: step.get(k, 0) for k in moved} == moved, what
            assert set(step) - {"total", "count"} <= set(moved), what


PLACEMENT_MESHES = ({"data": 2, "model": 2}, {"data": 1, "model": 4},
                    {"data": 16, "model": 16})


@pytest.mark.parametrize("shape", PLACEMENT_MESHES,
                         ids=lambda m: f"{m['data']}x{m['model']}")
def test_decode_inputs_are_the_blocks_the_step_keeps(shape):
    """``decode_specs`` / ``batch_specs`` hand each rank the blocks that
    ``prefill`` returns and ``decode_step`` keeps: its rows of the batch
    (over ``for_batch``'s axes), an attention cache's positions over
    ``layers.seq_axes`` and an SSM state's ``dinner`` as ``resolve``
    places ``cache_specs``' logical axes, for every config at
    decode_32k's batch and at batch 1 (long_500k's)."""
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch.inputs import batch_specs, decode_specs
    from repro_torch.models import layers as L
    mesh = StandInMesh(dict(shape))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name in ("decode_32k", "long_500k", "prefill_32k"):
            sh = SHAPES[name]
            ax = make_axes(mesh, RunConfig()).for_batch(sh.global_batch)
            seq = L.seq_axes(ax)
            rows = sh.global_batch // ax.batch_size()
            if sh.kind == "prefill":
                tok = batch_specs(cfg, sh, ax, train=False)["tokens"]
                assert tok.local_shape[0] == rows, (arch, name)
                continue
            d = decode_specs(cfg, sh, ax)
            assert d["token"].local_shape == (rows, 1)
            specs = T.cache_specs(cfg, sh.global_batch, sh.seq_len)
            for key, block in d["cache"]["blocks"].items():
                for leaf_name, st in block.items():
                    leaf = specs["blocks"][key][leaf_name]
                    assert st.spec == ax.resolve(leaf.axes, leaf.shape)
                    assert st.local_shape[1] == rows, (arch, name, key)
                    if leaf_name in ("k", "v"):
                        n = int(np.prod([mesh.shape[a] for a in seq]))
                        assert st.spec[2:] == (
                            (seq if len(seq) > 1 else seq[0])
                            if seq else None, None, None), (arch, name)
                        assert st.local_shape[2] * n == leaf.shape[2]
