"""The dry run (``launch/dryrun.py``) and its block module
(``launch/blocks.py``) on the CPU:

* the blocks on four smoke configs against the reference's
  (``repro.launch.blocks``), on the reference's weights (``from_jax``), in
  float32: the train block's gradients within rtol 1e-4 and 1e-6 of each
  leaf's largest magnitude (1e-5 for jamba: ``tests/_torch_train_parity.py``
  and ``test_torch_train_hybrid.py``'s tolerances), the prefill and
  decode blocks' outputs within rtol 2e-5 and 2e-5 of the largest
  (``check_forward``'s);
* the reference e2e test's three cells (``tests/test_dryrun_e2e.py``) on a
  (2, 4) stand-in with smoke configs;
* on a (1, 1) stand-in, ``adjusted`` FLOPs and bytes and the argument
  bytes equal the same counting of a real step of the same function on
  the CPU, exactly;
* on a (2, 2) stand-in, the collective bytes by kind equal those that
  ``CollectiveLog`` records of one real step on 4 gloo ranks, and a train
  step's all-gather bytes equal an analytic sum over the sharded leaves;
  on a (2, 4) stand-in an inference step's all-gather and all-reduce
  bytes equal an analytic sum (weights once, no KV cache term);
* the counted matmul FLOPs equal an analytic sum of 2·M·N·K over the
  model's matmuls, exactly, on a (1, 1) stand-in for every family and
  step kind;
* against the reference's own dry run (``repro.launch.dryrun.lower_cell``
  on a one-device mesh, in a subprocess): its dot FLOPs, read from the
  compiled HLO, equal the port's matmul FLOPs exactly on an inference cell
  of every family; on a train cell they differ by the forward that the
  reference's block module drops (within 1 %); total FLOPs differ by the
  two counts' elementwise conventions (bounds in the test);
* one full-width run of the CLI.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gloo as G
import _torch_train_parity as P
from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.launch import blocks as RB
from repro.launch.sharding import NO_AXES as R_NO_AXES
from repro.models import transformer as RT
from repro.models.params import init_tree as r_init
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import blocks as B
from repro_torch.launch.dryrun import _default_rc, artifact_path, lower_cell
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import StandInMesh
from repro_torch.launch.roofline import adjusted, cell_roofline
from repro_torch.launch.sharding import NO_AXES, make_axes, spec_axes
from repro_torch.models.params import from_jax, leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

#: arch -> the train block's gradient atol, a share of a leaf's largest
BLOCK_ARCHS = {"llama3.2-1b": 1e-6, "jamba-v0.1-52b": 1e-5,
               "phi3.5-moe-42b-a6.6b": 1e-6, "falcon-mamba-7b": 1e-6}
E2E_CELLS = (("llama3.2-1b", "train_4k"), ("jamba-v0.1-52b", "decode_32k"),
             ("phi3.5-moe-42b-a6.6b", "prefill_32k"))


@pytest.fixture(autouse=True)
def _one_thread():
    with P.one_torch_thread():
        yield


def _cut(name: str, batch: int = 8, seq: int = 64):
    return dataclasses.replace(SHAPES[name], global_batch=batch,
                               seq_len=seq)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree)}


def _close(got, want, rtol, share, what):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for path, w in want.items():
        assert got[path].shape == w.shape, (what, path)
        if w.size:
            np.testing.assert_allclose(
                got[path], w, rtol=rtol,
                atol=share * float(np.abs(w).max()), err_msg=f"{what}{path}")


@pytest.mark.parametrize("arch", sorted(BLOCK_ARCHS))
def test_blocks_equal_the_reference(arch):
    rcfg, cfg = r_smoke(arch), get_smoke_config(arch)
    kw = {**P.F32, "remat": "full"}
    rrc, rc = RRun(**kw), RunConfig(**kw)
    specs = RT.superblock_param_specs(rcfg)
    bp_np = jax.tree.map(np.asarray, r_init(specs, jax.random.PRNGKey(3)))
    bp = tuple(from_jax(s, p, "cpu") for s, p in
               zip(B.T.superblock_param_specs(cfg), bp_np))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    want = jax.jit(RB.train_block_fn(rcfg, rrc, R_NO_AXES, 16))(bp_np, x)
    got = B.train_block_fn(cfg, rc, NO_AXES, 16)(bp, torch.tensor(x))
    _close(got, want, 1e-4, BLOCK_ARCHS[arch], "train")

    want = jax.jit(RB.prefill_block_fn(rcfg, rrc, R_NO_AXES, 16))(bp_np, x)
    with torch.no_grad():
        got = B.prefill_block_fn(cfg, rc, NO_AXES, 16)(bp, torch.tensor(x))
    _close(got, want, 2e-5, 2e-5, "prefill")

    cache_np = jax.tree.map(
        lambda l: rng.standard_normal(l.shape).astype(np.float32),
        RT.cache_specs(rcfg, 2, 24, stacked=False)["blocks"],
        is_leaf=lambda l: hasattr(l, "axes"))
    x1 = x[:, :1]
    want = jax.jit(RB.decode_block_fn(rcfg, rrc, R_NO_AXES))(
        bp_np, x1, cache_np, jnp.int32(5))
    with torch.no_grad():
        got = B.decode_block_fn(cfg, rc, NO_AXES)(
            bp, torch.tensor(x1),
            {k: {n: torch.tensor(a) for n, a in v.items()}
             for k, v in cache_np.items()}, torch.tensor(5, dtype=torch.int32))
    _close(got, want, 2e-5, 2e-5, "decode")


@pytest.mark.parametrize("arch,shape", E2E_CELLS)
def test_lower_cell_on_a_2x4_stand_in(arch, shape):
    res = lower_cell(arch, _cut(shape), multi_pod=False, verbose=False,
                     mesh=StandInMesh({"data": 2, "model": 4}),
                     cfg=get_smoke_config(arch), device="cpu")
    assert res["full"]["flops"] > 0 and res["full"]["matmul_flops"] > 0
    assert res["full"]["memory"]["argument_bytes"] > 0
    assert res["full"]["collectives"]["total"] > 0
    assert res["n_superblocks"] >= 1 and res["chips"] == 8
    # one trace of the whole step: the scan adjustment adds nothing
    assert res["block"] == {}
    for key in ("flops", "bytes_accessed", "collectives.total", "ops"):
        whole = res["full"]
        for part in key.split("."):
            whole = whole[part]
        assert adjusted(res, key) == whole, key
    # every cell traces the step the port runs on the mesh
    assert "modelled" not in res


@functools.lru_cache(maxsize=None)
def _one_device_cell(arch, name, batch, seq) -> dict:
    """The dry run of a smoke cell on a (1, 1) stand-in (read only)."""
    return lower_cell(arch, _cut(name, batch, seq), False, verbose=False,
                      mesh=StandInMesh({"data": 1, "model": 1}),
                      cfg=get_smoke_config(arch), device="cpu")


#: the (1, 1) cells: (arch, shape, batch, seq)
EXACT_CELLS = (("llama3.2-1b", "train_4k", 4, 32),
               ("phi3.5-moe-42b-a6.6b", "train_4k", 4, 32),
               ("jamba-v0.1-52b", "decode_32k", 4, 32),
               ("llama3.2-1b", "decode_32k", 4, 32),
               ("musicgen-medium", "prefill_32k", 2, 48))


@pytest.mark.parametrize("cell", EXACT_CELLS, ids=lambda c: "-".join(
    map(str, c[:2])))
def test_counts_equal_a_real_step_exactly(cell):
    arch, name, batch, seq = cell
    art = _one_device_cell(*cell)
    step, args = G.dryrun_cell(arch, name, batch, seq,
                               StandInMesh({"data": 1, "model": 1}))
    real = analyze(step, *G.real_inputs(args))[1]
    assert adjusted(art, "flops") == real["flops"] > 0
    assert adjusted(art, "bytes_accessed") == real["bytes_accessed"] > 0
    assert art["full"]["memory"]["argument_bytes"] == \
        real["memory"]["argument_bytes"] > 0
    assert adjusted(art, "collectives.total") == 0


#: the (2, 2) cells: (arch, shape, batch, seq, RunConfig overrides)
MESH_CELLS = [["llama3.2-1b", "train_4k", 4, 32, None],
              ["phi3.5-moe-42b-a6.6b", "train_4k", 4, 32, None],
              ["phi3.5-moe-42b-a6.6b", "train_4k", 4, 32,
               {"moe_impl": "a2a"}],
              ["jamba-v0.1-52b", "decode_32k", 4, 32, None],
              ["phi3.5-moe-42b-a6.6b", "prefill_32k", 4, 32, None]]


def test_dry_collectives_equal_a_gloo_step(tmp_path):
    ranks = G.start_ranks("dryrun_cells", 4, tmp_path, cells=MESH_CELLS)
    try:
        dry = [lower_cell(arch, _cut(name, batch, seq), False, over,
                          verbose=False,
                          mesh=StandInMesh({"data": 2, "model": 2}),
                          cfg=get_smoke_config(arch), device="cpu")
               for arch, name, batch, seq, over in MESH_CELLS]
    finally:
        out = ranks.wait(timeout=240)
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            observed = json.load(f)
        for cell, art, seen in zip(MESH_CELLS, dry, observed):
            assert art["full"]["collectives"] == seen["collectives"], cell
            assert art["full"]["collective_counts"] == \
                seen["collective_counts"], cell
            assert adjusted(art, "collectives.total") == \
                seen["collectives"]["total"] > 0, cell


def test_cli_full_width_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "train_4k", "--device", "cpu", "--out",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dry-run complete" in out.stdout
    with open(artifact_path(str(tmp_path), "llama3.2-1b", "train_4k",
                            "single")) as f:
        art = json.load(f)
    assert art["chips"] == 256 and art["n_superblocks"] == 16
    assert art["compile_s"] > 0 and "modelled" not in art
    assert adjusted(art, "flops") == art["full"]["flops"] > 0
    assert art["full"]["collectives"]["all-gather"] > 0
    r = cell_roofline(art)
    assert r.compute_s > 0 and r.memory_s > 0 and r.collective_s > 0
    assert r.dominant in ("compute", "memory", "collective")


# -- the counts against independent ones -------------------------------------

def _moe_dims(cfg, tokens: int) -> tuple:
    """(groups, capacity) of the GShard dispatch of ``tokens`` tokens:
    groups of up to 1024 tokens, capacity_factor x k x group / E slots an
    expert, rounded up to a multiple of 4, at least 4."""
    group = min(1024, tokens)
    c = cfg.capacity_factor * cfg.experts_per_token * group / cfg.n_experts
    return tokens // group, max(4, -(-int(c) // 4) * 4)


def _block_matmuls(cfg, kind: str, is_moe: bool, b: int, s: int, t: int,
                   decode: bool) -> tuple:
    """(forward, backward) matmul FLOPs of one block on ``b`` x ``s``
    tokens against ``t`` keys, each matmul 2·M·N·K.  The backward runs a
    product for each operand that needs a gradient: both for a weight or
    activation product; one for the 0/1 dispatch masks' products (the
    mask needs none) and none for the mask's own."""
    n = b * s
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if kind == "attn":
        proj = 2 * n * d * hd * (2 * h + 2 * kv)        # q, k, v, o
        scores = 2 * 2 * b * h * s * t * hd             # q·k, then p·v
        fwd, bwd = proj + scores, 2 * (proj + scores)
    else:
        di, ns, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        proj = 2 * n * (d * 2 * di + di * (r + 2 * ns) + r * di + di * d)
        read = 2 * n * di * ns                          # y = h·C
        conv = 2 * b * cfg.ssm_conv * di if decode else 0
        fwd, bwd = proj + read + conv, 2 * (proj + read)
    if is_moe:
        e, k = cfg.n_experts, cfg.experts_per_token
        g, cap = _moe_dims(cfg, n)
        router = 2 * n * d * e
        mask = 2 * n * k * e * cap                      # dispatch, combine
        move = 2 * n * e * cap * d                      # in, and out
        ffn = 3 * 2 * e * g * cap * d * cfg.d_ff
        fwd += router + 2 * mask + 2 * move + ffn
        bwd += 2 * router + mask + 3 * move + 2 * ffn
    else:
        mlp = 3 * 2 * n * d * cfg.d_ff
        fwd, bwd = fwd + mlp, bwd + 2 * mlp
    return fwd, bwd


def _forward_per_superblock(cfg, kind: str, batch: int, seq: int) -> int:
    decode = kind == "decode"
    s = 1 if decode else seq
    return sum(_block_matmuls(cfg, k, m, batch, s, seq, decode)[0]
               for k, m in cfg.block_pattern())


def analytic_matmul_flops(cfg, kind: str, batch: int, seq: int) -> int:
    """The step's matmul FLOPs from the config alone (default
    ``RunConfig``: dense attention at these lengths, GShard MoE, full
    remat, the sharded cross-entropy).  A train step runs each
    superblock's forward, recomputes it in the backward up to its last
    saved tensor (so the last block's FFN output product is not run
    again), and runs the backward; the head's product runs with both
    gradients.  Inference runs the forward and the head on the last
    position."""
    decode = kind == "decode"
    s, vp, d = (1 if decode else seq), cfg.padded_vocab(), cfg.d_model
    fwd = bwd = 0
    for k, m in cfg.block_pattern():
        f, b_ = _block_matmuls(cfg, k, m, batch, s, seq, decode)
        fwd, bwd = fwd + f, bwd + b_
    fwd, bwd = fwd * cfg.n_superblocks, bwd * cfg.n_superblocks
    if kind != "train":
        return fwd + 2 * batch * d * vp
    f = cfg.n_frontend_tokens if cfg.frontend else 0
    head = 2 * batch * (seq - f if f else seq - 1) * d * vp
    n = batch * seq
    if cfg.block_pattern()[-1][1]:
        g, cap = _moe_dims(cfg, n)
        last = 2 * n * cfg.n_experts * cap * d
    else:
        last = 2 * n * cfg.d_ff * d
    return 2 * fwd - cfg.n_superblocks * last + bwd + 3 * head


#: every family (dense, MoE, SSM, hybrid, audio frontend) at the step
#: kinds it runs: (arch, shape, batch, seq)
ANALYTIC_CELLS = (("llama3.2-1b", "train_4k", 4, 32),
                  ("llama3.2-1b", "prefill_32k", 2, 48),
                  ("llama3.2-1b", "decode_32k", 4, 32),
                  ("phi3.5-moe-42b-a6.6b", "train_4k", 4, 32),
                  ("phi3.5-moe-42b-a6.6b", "prefill_32k", 2, 48),
                  ("phi3.5-moe-42b-a6.6b", "decode_32k", 4, 32),
                  ("falcon-mamba-7b", "train_4k", 2, 32),
                  ("falcon-mamba-7b", "prefill_32k", 2, 48),
                  ("jamba-v0.1-52b", "train_4k", 2, 32),
                  ("jamba-v0.1-52b", "decode_32k", 4, 32),
                  ("musicgen-medium", "train_4k", 2, 32),
                  ("musicgen-medium", "prefill_32k", 2, 48))


@pytest.mark.parametrize("cell", ANALYTIC_CELLS, ids=lambda c: "-".join(
    map(str, c[:2])))
def test_matmul_flops_equal_an_analytic_count(cell):
    arch, name, batch, seq = cell
    art = _one_device_cell(*cell)
    want = analytic_matmul_flops(get_smoke_config(arch), SHAPES[name].kind,
                                 batch, seq)
    assert adjusted(art, "matmul_flops") == want > 0


#: the (2, 2) cells of the all-gather sum: (arch, batch, seq)
GATHER_CELLS = (("llama3.2-1b", 4, 32), ("phi3.5-moe-42b-a6.6b", 4, 32),
                ("jamba-v0.1-52b", 4, 32))
#: the (2, 4) inference cells: (arch, shape, batch, seq); at batch 1 the
#: cache's positions split over both axes
INFERENCE_GATHER_CELLS = (("llama3.2-1b", "decode_32k", 8, 64),
                          ("llama3.2-1b", "decode_32k", 1, 64),
                          ("gemma2-9b", "decode_32k", 8, 64),
                          ("jamba-v0.1-52b", "decode_32k", 8, 64),
                          ("falcon-mamba-7b", "decode_32k", 8, 64),
                          ("phi3.5-moe-42b-a6.6b", "decode_32k", 8, 64),
                          ("phi3.5-moe-42b-a6.6b", "prefill_32k", 8, 64),
                          ("musicgen-medium", "prefill_32k", 8, 64))


@pytest.mark.parametrize("cell", GATHER_CELLS + INFERENCE_GATHER_CELLS,
                         ids=lambda c: c[0] if len(c) == 3 else "-".join(
                             map(str, c)))
def test_all_gather_bytes_equal_an_analytic_sum(cell):
    """A train step on a (2, 2) stand-in gathers each sharded f32 weight
    whole before the forward, one mesh axis at a time: a gather's output
    is the leaf's whole bytes over the sizes of the axes still to gather.
    A MoE layer whose routing groups span the data ranks gathers its bf16
    input over them, in the forward and again in the remat recompute.

    An inference step on a (2, 4) stand-in gathers each bf16 weight once,
    a superblock at a time, and moves no KV cache byte: its all-gather
    and all-reduce bytes are ``_torch_gloo.inference_collectives``'
    (the weights, a decode step's SSM state over ``dinner``, a spanning
    MoE input; the decode softmax statistics, a local MoE's load-balance
    statistics) exactly."""
    if len(cell) == 4:
        arch, name, batch, seq = cell
        cfg = get_smoke_config(arch)
        mesh = StandInMesh({"data": 2, "model": 4})
        art = lower_cell(arch, _cut(name, batch, seq), False,
                         verbose=False, mesh=mesh, cfg=cfg, device="cpu")
        kind = SHAPES[name].kind
        ax = make_axes(mesh, _default_rc(kind)).for_batch(batch)
        want = G.inference_collectives(cfg, ax, kind, batch, seq, 2, 2, 2)
        got = art["full"]["collectives"]
        assert {k: got.get(k, 0) for k in want} == want
        assert want["all-gather"] > 0
        assert set(got) - {"total", "count"} <= set(want)
        return
    arch, batch, seq = cell
    cfg = get_smoke_config(arch)
    mesh = StandInMesh({"data": 2, "model": 2})
    art = lower_cell(arch, _cut("train_4k", batch, seq), False,
                     verbose=False, mesh=mesh, cfg=cfg, device="cpu")
    ax = make_axes(mesh, _default_rc("train"))
    want = 0
    for leaf in leaves(B.T.model_specs(cfg)):
        whole = int(np.prod(leaf.shape)) * 4
        sizes = [mesh.shape[a] for entry in ax.resolve(leaf.axes, leaf.shape)
                 for a in reversed(spec_axes((entry,)))]
        sizes = [n for n in sizes if n > 1]
        want += sum(whole // int(np.prod(sizes[i + 1:]))
                    for i in range(len(sizes)))
    n_moe = cfg.n_superblocks * sum(m for _, m in cfg.block_pattern())
    want += 2 * n_moe * batch * seq * cfg.d_model * 2
    assert art["full"]["collectives"]["all-gather"] == want > 0


REF_SCRIPT = r"""
import dataclasses, json, re, sys
import jax
jax.devices()        # one host device, before repro.launch.dryrun's flag
import repro.launch.dryrun as RD
from repro.configs import SHAPES, get_smoke_config
from repro.launch.mesh import compat_make_mesh
from repro.launch.roofline import adjusted

INST = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = [a-z0-9]+\[([\d,]*)\]")
DOT = re.compile(r"= [a-z0-9]+\[([\d,]*)\][^ ]* dot\(([^,)]*)")

def dot_flops(text):
    # 2 x output elements x contracted size, for every dot of the module
    dims = {}
    for line in text.splitlines():
        m = INST.match(line)
        if m:
            dims[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    total = 0
    for line in text.splitlines():
        m = DOT.search(line)
        if not m:
            continue
        out = 1
        for d in m.group(1).split(","):
            out *= int(d) if d else 1
        lhs = dims[m.group(2).strip().split(" ")[-1].lstrip("%")]
        k = 1
        c = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
        for i in (c.group(1).split(",") if c and c.group(1) else []):
            k *= lhs[int(i)]
        total += 2 * out * k
    return total

analyze = RD._analyze
def with_dots(compiled):
    out = analyze(compiled)
    out["dot_flops"] = dot_flops(compiled.as_text())
    return out
RD._analyze = with_dots

mesh = compat_make_mesh((1, 1), ("data", "model"))
out = {}
for arch, name, b, s in json.loads(sys.argv[1]):
    shape = dataclasses.replace(SHAPES[name], global_batch=b, seq_len=s)
    res = RD.lower_cell(arch, shape, multi_pod=False, verbose=False,
                        mesh=mesh, cfg=get_smoke_config(arch))
    out[f"{arch}:{name}"] = {"flops": adjusted(res, "flops"),
                             "dot_flops": adjusted(res, "dot_flops")}
print("RESULT " + json.dumps(out))
"""

#: an inference cell of every family, and two train cells
REF_CELLS = (("llama3.2-1b", "prefill_32k", 2, 48),
             ("phi3.5-moe-42b-a6.6b", "prefill_32k", 2, 48),
             ("falcon-mamba-7b", "prefill_32k", 2, 48),
             ("jamba-v0.1-52b", "decode_32k", 4, 32),
             ("musicgen-medium", "prefill_32k", 2, 48),
             ("llama3.2-1b", "train_4k", 4, 32),
             ("phi3.5-moe-42b-a6.6b", "train_4k", 4, 32))


@pytest.fixture(scope="module")
def reference_counts():
    """The reference's dry run of ``REF_CELLS`` on a one-device mesh (its
    FLOPs and, from each compiled module's HLO, its dot FLOPs, both
    scan-adjusted), in a subprocess of its own: the reference's dry run
    sets ``XLA_FLAGS`` when imported."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          json.dumps(REF_CELLS)], capture_output=True,
                         text=True, env=env, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines()
            if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("cell", REF_CELLS, ids=lambda c: "-".join(
    map(str, c[:2])))
def test_counts_against_the_reference_dry_run(cell, reference_counts):
    """Matmuls: the reference's dot FLOPs equal the port's matmul FLOPs
    exactly on an inference cell.  On a train cell the reference's
    adjusted count lacks (n_superblocks - 1) superblock forwards: its
    block module is the gradient of a remat'd superblock whose own output
    is never read, so XLA keeps only the recompute, while each scan step
    also runs the forward.  What remains, within 1 % of the port's, is
    which forward ops each remat recomputes (torch stops at the last saved
    tensor, JAX recomputes what the backward reads).

    Total FLOPs of an inference cell lie between the reference's dot
    FLOPs and its total: both count 2·M·N·K a matmul, and XLA counts more
    elementwise FLOPs than the port's one per output element of each
    pointwise or reduction op (a reduction per input element, the softmax
    as its component ops, selects and converts), so its total is the
    larger."""
    arch, name, batch, seq = cell
    ref = reference_counts[f"{arch}:{name}"]
    art = _one_device_cell(*cell)
    matmul, flops = adjusted(art, "matmul_flops"), adjusted(art, "flops")
    cfg = get_smoke_config(arch)
    kind = SHAPES[name].kind
    if kind == "train":
        dropped = (cfg.n_superblocks - 1) * _forward_per_superblock(
            cfg, kind, batch, seq)
        assert abs(matmul - ref["dot_flops"] - dropped) <= 0.01 * matmul
    else:
        assert matmul == ref["dot_flops"] > 0
        assert ref["dot_flops"] < flops <= ref["flops"]
