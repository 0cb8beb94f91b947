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


def real_inputs(tree, seed: int = 0):
    """Tensors for a tree of ``ShapeStruct``s (``launch/dryrun.py``'s
    cells): each struct's local shape and dtype on the host, floats drawn
    at 0.02 scale, integers in [0, 8) (valid token ids and positions)."""
    import torch
    from repro_torch.models.params import ShapeStruct
    gen = torch.Generator().manual_seed(seed)

    def make(s):
        if isinstance(s, ShapeStruct):
            if s.dtype.is_floating_point:
                return (0.02 * torch.randn(s.local_shape, generator=gen)
                        ).to(s.dtype)
            return torch.randint(0, 8, s.local_shape, generator=gen,
                                 dtype=s.dtype)
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, tuple):
            parts = [make(v) for v in s]
            return type(s)(*parts) if hasattr(s, "_fields") else tuple(parts)
        return s
    return make(tree)


def dryrun_cell(arch: str, shape_name: str, batch: int, seq: int, mesh,
                overrides=None):
    """The dry run's step of one cell (``arch``'s smoke config, the
    shape cut to ``batch`` x ``seq``, ``RunConfig`` ``overrides``) on
    ``mesh`` and its inputs' structs."""
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch.dryrun import _default_rc, cell_inputs
    from repro_torch.launch.sharding import make_axes
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch,
                                seq_len=seq)
    rc = _default_rc(shape.kind, overrides)
    return cell_inputs(get_smoke_config(arch), rc, shape,
                       make_axes(mesh, rc))


def dryrun_cells(rank, out, cells):
    """Each cell's step (``dryrun_cell``) run on real tensors on a (2, 2)
    mesh under ``analyze``: its collective bytes and counts."""
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    rec = []
    for arch, shape_name, batch, seq, overrides in cells:
        step, args = dryrun_cell(arch, shape_name, batch, seq, mesh,
                                 overrides)
        got = analyze(step, *real_inputs(args, seed=rank))[1]
        rec.append({"collectives": got["collectives"],
                    "collective_counts": got["collective_counts"]})
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


# ------------------------------------------------------ mesh inference --

#: inference on a mesh (``tests/test_torch_mesh_inference.py``): float32
#: compute on float32 weights, dense attention
MESH_RC = {"remat": "none", "attn_impl": "dense", "compute_dtype": "float32"}
#: the prompt's positions (a frontend's included), the greedy decode steps
#: after the prefill's token and the decode buffer: on (2, 2) the model
#: ranks' slices of a full cache meet at position 28 and gemma2's
#: 32-position local ring wraps at 32, both inside positions 24..35
MESH_INFER = {"positions": 24, "steps": 12, "buffer": 56}


def unflatten(flat: dict, prefix: str = "") -> dict:
    """{"a/b/c": array} (the keys under ``prefix``) as nested dicts."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *path, last = key[len(prefix):].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def flatten(tree, prefix: str = "", leaf=np.asarray) -> dict:
    """{"prefix/a/b": leaf(value)} of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/", leaf))
        return out
    return {prefix[:-1]: leaf(tree)}


def grow_cache(cfg, cache: dict, buffer: int, ax) -> dict:
    """The prefill cache with each attention leaf's positions padded to
    the ``buffer``-position decode cache (``cache_specs``), as the
    reference's tests pad theirs: on a mesh each rank gathers its rows'
    positions, pads them and keeps its block again (the test's step
    between prefill and decode, not the model's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.launch.sharding import gather_shard, own_block
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    want = T.cache_specs(cfg, 1, buffer)["blocks"]
    spec = (None, None, L.seq_axes(ax))
    out = {}
    for key, block in cache["blocks"].items():
        out[key] = dict(block)
        if "k" not in block:
            continue
        for name, t in block.items():
            if ax.mesh is not None:
                t = gather_shard(t, spec, ax.mesh)
            t = F.pad(t, (0, 0, 0, 0, 0, want[key][name].shape[2]
                          - t.shape[2]))
            out[key][name] = own_block(t, spec, ax.mesh) \
                if ax.mesh is not None else t
    return {"blocks": out}


def greedy(cfg, rc, params, tokens, frontend, ax, steps: int,
           buffer: int) -> dict:
    """``prefill`` then ``steps`` greedy ``decode_step``s on ``ax``, the
    cache grown between them (``grow_cache``): the tokens (B, steps + 1), the
    logits (steps + 1, B, Vp), the last cache and each decode step's
    collective bytes by kind."""
    import torch
    from repro_torch.launch.hlo_analysis import CollectiveLog
    from repro_torch.models import transformer as T
    with torch.no_grad():
        logits, cache = T.prefill(cfg, rc, params, tokens, frontend, ax=ax)
        cache = grow_cache(cfg, cache, buffer, ax)
        start = tokens.shape[1] + (0 if frontend is None
                                   else frontend.shape[1])
        toks, outs, moved = [], [logits[:, -1]], []
        for i in range(steps + 1):
            tok = outs[-1][:, :cfg.vocab_size].argmax(-1, keepdim=True)
            toks.append(tok)
            if i == steps:
                break
            with CollectiveLog() as log:
                logits, cache = T.decode_step(cfg, rc, params, tok, cache,
                                              torch.tensor(start + i), ax=ax)
            outs.append(logits[:, -1])
            moved.append(log.bytes())
    return {"tokens": torch.cat(toks, 1).numpy(),
            "logits": torch.stack(outs).numpy(), "cache": cache,
            "moved": moved}


def mesh_inference(rank, out, cases, steps, buffer):
    """Each case (arch, batch, inputs .npz: the whole weights under "p/",
    "tokens" and "frontend") on a (2, 2) mesh: this rank's shards of the
    weights and rows of the batch in, ``greedy``'s tokens, logits, cache
    blocks and collective bytes out, and how many of the step's gathers
    took a whole stacked leaf (its shard as it is, not a superblock's
    block of it)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import (from_jax, leaves, spec_tree,
                                           tree_map)
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    stacked, whole = set(), [0]
    real = sharding.all_gather

    def spy(x, *args):
        whole[0] += (x.data_ptr(), tuple(x.shape)) in stacked
        return real(x, *args)
    sharding.all_gather = spy
    for i, (arch, batch, inputs) in enumerate(cases):
        cfg, rc = get_smoke_config(arch), RunConfig(**MESH_RC)
        ax = sharding.make_axes(mesh, rc).for_batch(batch)
        data = dict(np.load(inputs))
        specs = spec_tree(T.model_specs(cfg), ax.resolve)
        params = tree_map(lambda t, s: sharding.own_block(t, s, mesh),
                          from_jax(T.model_specs(cfg), unflatten(data, "p/"),
                                   "cpu"), specs)
        stacked = {(t.data_ptr(), tuple(t.shape))
                   for t in leaves(params["blocks"])}
        rows = (ax.batch,)
        tokens = sharding.local_shard(torch.from_numpy(data["tokens"]),
                                      rows, mesh)
        frontend = sharding.local_shard(torch.from_numpy(
            data["frontend"]), rows, mesh) if "frontend" in data else None
        whole[0] = 0
        res = greedy(cfg, rc, params, tokens, frontend, ax, steps, buffer)
        np.savez(os.path.join(out, f"case{i}_rank{rank}.npz"),
                 tokens=res["tokens"], logits=res["logits"],
                 **flatten(res["cache"], "c/"))
        with open(os.path.join(out, f"case{i}_rank{rank}.json"), "w") as f:
            json.dump({"moved": res["moved"], "whole_stacked": whole[0],
                       "data": mesh.get_local_rank("data"),
                       "model": mesh.get_local_rank("model")}, f)


def _gathered(ax, whole: int, spec) -> int:
    """The bytes ``gather_shard`` records making ``whole`` bytes whole from
    its blocks under ``spec``: one gather a mesh axis, each output the
    whole over the sizes of the axes still to gather."""
    sizes = [ax.size(a) for e in spec
             for a in reversed(e if isinstance(e, tuple) else (e,))
             if e and ax.size(a) > 1]
    return sum(whole // int(np.prod(sizes[i + 1:]))
               for i in range(len(sizes)))


def inference_collectives(cfg, ax, kind: str, batch: int, seq: int,
                          param_bytes: int, act_bytes: int,
                          cache_bytes: int) -> dict:
    """An inference step's collective bytes by kind, per rank, from the
    config alone, on ``ax``'s mesh (``ax.batch`` already narrowed by
    ``for_batch(batch)``); ``kind`` "prefill" over ``seq`` positions or
    "decode".  All-gather: every weight gathered once, one mesh axis at a
    time (a gather's output is the leaf's whole bytes over the sizes of
    the axes still to gather); on a decode step an SSM block's state over
    ``dinner`` (h float32, conv in the cache's dtype); a MoE block's input
    over the batch axes where its routing group spans data ranks.
    All-reduce, once a mesh axis: a decode step's attention softmax
    statistics over each seq axis (the maximum, B·H float32, then the
    weighted V and the sum, B·H·(HD + 1)); a MoE block routed on this
    rank's rows, its two load-balance statistics (E float32 each) over
    each batch axis; counted twice, as ``CollectiveLog`` counts an
    all-reduce.  No KV cache byte moves."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.models.params import leaves

    def gathered(whole: int, spec) -> int:
        return _gathered(ax, whole, spec)

    weights = sum(gathered(int(np.prod(leaf.shape)) * param_bytes,
                           ax.resolve(leaf.axes, leaf.shape))
                  for leaf in leaves(T.model_specs(cfg)))
    decode = kind == "decode"
    rows = batch // ax.batch_size()
    tokens = rows * (1 if decode else seq)
    n_batch = len([a for a in ax.batch if ax.size(a) > 1])
    gather = reduce = 0                      # one superblock's
    for block, is_moe in cfg.block_pattern():
        if decode and block == "attn":
            reduce += len(L.seq_axes(ax)) * rows * cfg.n_heads * (
                cfg.hd + 2) * 4
        elif decode:
            for name, leaf in S.state_specs(cfg, batch).items():
                spec = (None,) + ax.resolve(leaf.axes, leaf.shape)[1:]
                per_row = int(np.prod(leaf.shape[1:]))
                gather += gathered(rows * per_row * (
                    4 if name == "h" else cache_bytes), spec)
        if is_moe:
            if tokens % min(1024, tokens * ax.batch_size()):
                gather += gathered(tokens * ax.batch_size() * cfg.d_model
                                   * act_bytes, (tuple(ax.batch),))
            else:
                reduce += n_batch * 2 * cfg.n_experts * 4
    return {"all-gather": weights + cfg.n_superblocks * gather,
            "all-reduce": 2 * cfg.n_superblocks * reduce}


# -------------------------------------------------------- mesh serving --

#: the mesh engine's ``generate`` cases (``tests/test_torch_mesh_serving.py``):
#: prompt positions, new tokens and the engine's budget (a decode buffer
#: that the free mesh axes divide, 3 pages of 8 tokens)
MESH_SERVE = {"prompt": 12, "new": 6, "max_batch": 4, "max_seq": 24,
              "page_len": 8}
#: the scheduled day's engine and traffic, ``tests/test_scheduler.py``'s:
#: (arrival, prompt_len, max_new) a request
SERVE_DAY = {"max_batch": 4, "max_seq": 32, "page_len": 8}
TRAFFIC = ((0, 12, 8), (0, 5, 6), (1, 8, 4), (2, 3, 0), (2, 9, 5),
           (3, 12, 3))
TRACE_FIELDS = ("addrs", "kinds", "instr", "mask")


def trace_arrays(tr, prefix: str = "") -> dict:
    """An ``AddressTrace``'s arrays by field (an all-active mask where it
    has none), either package's."""
    out = {f"{prefix}{f}": np.asarray(getattr(tr, f))
           for f in TRACE_FIELDS[:3]}
    out[f"{prefix}mask"] = np.ones(out[f"{prefix}addrs"].shape, bool) \
        if tr.mask is None else np.asarray(tr.mask)
    return out


def generate_record(eng) -> dict:
    """A paged ``generate``'s recorded traffic and page table: each decode
    step's trace, the whole serving trace and ``last_pages``."""
    out = trace_arrays(eng.serving_trace(), "full/")
    for k, tr in enumerate(eng._step_traces):
        out.update(trace_arrays(tr, f"step{k}/"))
    for name in ("page_table", "seq_lens", "bank_used"):
        out[f"pages/{name}"] = np.asarray(getattr(eng.last_pages, name))
    return out


def serve_day(eng, scheduler, runtime, tokens: list, ckpt: str) -> tuple:
    """The scheduled runs of ``eng`` on ``TRAFFIC`` with the prompts
    ``tokens``, in either package (``scheduler`` / ``runtime``: its
    modules): 1-page prefill chunks; the reference's chaos plan (bank 1
    offline at tick 3, rid 0's first page corrupted at tick 5, a decode
    step failing twice at tick 6); the chunked day preempted at tick 3
    (a lane mid prefill), checkpointed to ``ckpt`` and resumed.  Returns
    ({run: outputs, stats, ticks, preempted}, {run/stream field: array})."""
    R = runtime

    def requests():
        return [scheduler.Request(rid=i, arrival=a, prompt_len=p,
                                  max_new_tokens=m,
                                  tokens=np.asarray(tokens[i], np.int32))
                for i, (a, p, m) in enumerate(TRAFFIC)]

    chaos = R.FaultPlan((
        R.FaultEvent(tick=3, kind="bank_offline", bank=1),
        R.FaultEvent(tick=5, kind="page_corrupt", rid=0, page_idx=0),
        R.FaultEvent(tick=6, kind="decode_transient", failures=2)))
    preempt = R.FaultPlan((R.FaultEvent(tick=3, kind="preempt"),))
    runs = (("chunked", lambda: eng.run_scheduler(
                requests(), prefill_chunk_pages=1)),
            ("faults", lambda: eng.run_scheduler(requests(),
                                                 fault_plan=chaos)),
            ("preempted", lambda: eng.run_scheduler(
                requests(), fault_plan=preempt, checkpoint_dir=ckpt,
                prefill_chunk_pages=1)),
            ("resumed", lambda: eng.run_scheduler(
                None, fault_plan=preempt, resume_from=ckpt,
                prefill_chunk_pages=1)))
    meta, arrays = {}, {}
    for name, run in runs:
        res = run()
        meta[name] = {"outputs": {str(k): np.asarray(v).tolist()
                                  for k, v in res.outputs.items()},
                      "stats": res.stats, "ticks": res.ticks,
                      "preempted": res.preempted}
        arrays.update(trace_arrays(eng.scheduler_stream().materialize(),
                                   f"{name}/"))
    return meta, arrays


def _logged(eng, name: str, rec: list, what=None) -> None:
    """Wrap ``eng``'s method ``name`` so that each call appends
    {"bytes": its collective bytes by kind, **what(args)} to ``rec``."""
    from repro_torch.launch.hlo_analysis import CollectiveLog
    real = getattr(eng, name)

    def call(*args, **kw):
        with CollectiveLog() as log:
            out = real(*args, **kw)
        rec.append({"bytes": log.bytes(), **(what(*args) if what else {})})
        return out
    setattr(eng, name, call)


def _serve_weights(cfg, data, ax, mesh):
    """This rank's shards of the whole float32 weights under "p/"."""
    from repro_torch.launch.sharding import own_block
    from repro_torch.models import transformer as T
    from repro_torch.models.params import from_jax, spec_tree, tree_map
    specs = spec_tree(T.model_specs(cfg), ax.resolve)
    return tree_map(lambda t, s: own_block(t, s, mesh),
                    from_jax(T.model_specs(cfg), unflatten(data, "p/"),
                             "cpu"), specs)


def whole_pools(eng, batch: int) -> dict:
    """``eng.last_pools`` flattened, an SSM state gathered whole (the
    K/V pools are whole on every rank already)."""
    from repro_torch.launch.sharding import gather_shard
    from repro_torch.models import ssm as S
    place = S._state_placement(eng.cfg, eng._lanes, batch) \
        if eng.ax.mesh is not None else None
    out = {}
    for key, pair in eng.last_pools.items():
        for name, t in pair.items():
            if place is not None and name in place:
                t = gather_shard(t, place[name], eng.ax.mesh)
            out[f"pool/{key}/{name}"] = t.float().numpy()
    return out


def mesh_serving(rank, out, cases, day):
    """``ServeEngine`` with ``ax`` on a (2, 2) mesh: each ``generate`` case
    (arch, batch, kv_mode, inputs .npz: the whole weights under "p/" and
    "prompts") sampled at temperature 0.8 (seed 3), then greedy, with its
    record, last pools and collective bytes a call; then the scheduled
    day (``day``: its inputs, with "tokens/{rid}") through ``serve_day``,
    the admissions' and steps' collective bytes, the last pools."""
    from repro_torch import runtime
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.hlo_analysis import CollectiveLog
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.sharding import make_axes
    from repro_torch.serving import scheduler
    from repro_torch.serving.engine import ServeEngine
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    coords = {"data": mesh.get_local_rank("data"),
              "model": mesh.get_local_rank("model")}
    for i, (arch, batch, kv_mode, inputs) in enumerate(cases):
        cfg, rc = get_smoke_config(arch), RunConfig(**MESH_RC)
        ax = make_axes(mesh, rc)
        data = dict(np.load(inputs))
        eng = ServeEngine(cfg, rc, _serve_weights(cfg, data, ax, mesh), ax,
                          max_batch=MESH_SERVE["max_batch"],
                          max_seq=MESH_SERVE["max_seq"], kv_mode=kv_mode,
                          page_len=MESH_SERVE["page_len"], device="cpu")
        sampled = eng.generate(data["prompts"], MESH_SERVE["new"],
                               temperature=0.8, seed=3).tokens
        steps, calls = [], []
        if kv_mode == "paged":
            _logged(eng, "_paged_step", steps)
        with CollectiveLog() as log:
            tokens = eng.generate(data["prompts"], MESH_SERVE["new"]).tokens
        calls.append(log.bytes())
        rec = {"tokens": tokens, "sampled": sampled}
        if kv_mode == "paged":
            rec.update(generate_record(eng))
            rec.update(whole_pools(eng, batch))
        np.savez(os.path.join(out, f"case{i}_rank{rank}.npz"), **rec)
        with open(os.path.join(out, f"case{i}_rank{rank}.json"), "w") as f:
            json.dump({"steps": steps, "generate": calls, **coords}, f)
    cfg, rc = get_smoke_config("llama3.2-1b"), RunConfig(**MESH_RC)
    ax = make_axes(mesh, rc)
    data = dict(np.load(day))
    eng = ServeEngine(cfg, rc, _serve_weights(cfg, data, ax, mesh), ax,
                      kv_mode="paged", device="cpu", **SERVE_DAY)
    admissions, steps = [], []
    _logged(eng, "_prefill_rows", admissions,
            lambda prompt: {"plen": int(prompt.shape[0])})
    _logged(eng, "_scheduler_step", steps)
    meta, arrays = serve_day(
        eng, scheduler, runtime,
        [data[f"tokens/{r}"] for r in range(len(TRAFFIC))],
        os.path.join(out, "day_ckpt"))
    arrays.update(whole_pools(eng, SERVE_DAY["max_batch"]))
    np.savez(os.path.join(out, f"day_rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"day_rank{rank}.json"), "w") as f:
        json.dump({"runs": meta, "admissions": admissions, "steps": steps,
                   **coords}, f)


def serving_collectives(cfg, ax, what: str, batch: int, plen: int = 0,
                        nbytes: int = 4) -> dict:
    """The mesh engine's collective bytes by kind, per rank, from the
    config alone, on ``make_axes``' ``ax`` in float32.  ``what``:

    "paged step": a paged decode step, on ``ax`` with an empty batch:
    every weight gathered once and an SSM block's state over ``dinner``
    (``inference_collectives``' decode all-gather); the paged attention
    reduces nothing, and no pool byte moves.

    "admission": a paged prefill of ``batch`` rows x ``plen`` positions
    on ``ax.for_batch(batch)`` (``inference_collectives``' prefill), its
    last logits gathered over the batch axes, each K/V made whole (its
    rows and positions) and an SSM state gathered over the batch axes.

    "dense admission": the prefill and its logits as above, then each
    K/V's positions gathered (the rank's rows) to grow the cache.

    "dense step": a decode step on ``ax.for_batch(batch)``
    (``inference_collectives``' decode) and its logits gathered over the
    batch axes."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    if what == "paged step":
        lanes = dataclasses.replace(ax, batch=())
        return {"all-gather": inference_collectives(
            cfg, lanes, "decode", batch, 0, nbytes, nbytes,
            nbytes)["all-gather"]}
    axb = ax.for_batch(batch)
    rows = (axb.batch,)
    logits = _gathered(axb, batch * cfg.padded_vocab() * nbytes, rows)
    if what == "dense step":
        out = dict(inference_collectives(cfg, axb, "decode", batch, 0,
                                         nbytes, nbytes, nbytes))
        out["all-gather"] = out.get("all-gather", 0) + logits
        return out
    out = dict(inference_collectives(cfg, axb, "prefill", batch, plen,
                                     nbytes, nbytes, nbytes))
    paged = what == "admission"
    mine = batch // axb.batch_size()
    held = S._state_placement(cfg, axb, mine)
    gather = logits
    for j, (kind, _) in enumerate(cfg.block_pattern()):
        if kind == "attn":
            w = T._block_window(cfg, j)
            t = min(plen, w) if w else plen
            whole = cfg.n_superblocks * (batch if paged else mine) * t * \
                cfg.n_kv_heads * cfg.hd * nbytes
            spec = (None, axb.batch if paged else None, L.seq_axes(axb, t))
            gather += 2 * _gathered(axb, whole, spec)
        elif paged:
            for name, leaf in S.state_specs(cfg, batch).items():
                per_row = int(np.prod(leaf.shape[1:]))
                whole = cfg.n_superblocks * batch * per_row * (
                    4 if name == "h" else nbytes)
                gather += _gathered(axb, whole,
                                    (None, axb.batch) + held[name][1:])
    out["all-gather"] = out.get("all-gather", 0) + gather
    return out
