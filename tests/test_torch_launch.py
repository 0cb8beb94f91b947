"""The compile-only accounting's units held to the reference
(``tests/test_launch.py``'s counterparts): the HLO text parser, the
roofline arithmetic (``adjusted``, ``model_flops``) on the reference's
dicts and every cell, ``Roofline`` under the H100's constants, the cells,
and the described inputs (``shape_tree``, ``inputs``, ``cache_specs``)
leaf for leaf against the reference's on the (16, 16) production mesh
(an ``AbstractMesh`` for the reference, a ``StandInMesh`` for the port)
and, in one subprocess with 8 host devices, each local shape against the
reference's ``NamedSharding.shard_shape`` on a (2, 4) mesh.

Token ids are int64 in the port and int32 in the reference
(``launch/inputs.py``); every other dtype is equal."""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.launch.hlo_analysis as RH
import repro.launch.roofline as RR
from repro.configs import SHAPES as R_SHAPES
from repro.configs import all_cells as r_all_cells
from repro.configs import get_config as r_config
from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.launch.inputs import input_specs as r_input_specs
from repro.launch.sharding import Axes as RAxes
from repro.models import transformer as RT
from repro.models.params import shape_tree as r_shape_tree
from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells, get_config,
                                 get_smoke_config, shapes_for)
from repro_torch.configs.base import RunConfig
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import roofline as PR
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import StandInMesh
from repro_torch.launch.sharding import make_axes
from repro_torch.models import transformer as T
from repro_torch.models.params import ShapeStruct, shape_tree

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

HLO = """
  %ag = bf16[16,4096]{1,0} all-gather(%x), replica_groups=...
  %ar = f32[1024]{0} all-reduce(%y), to_apply=%sum
  %rs = f32[64,64]{1,0} reduce-scatter(%z)
  %a2a = (f32[8,128]{1,0}, f32[8,128]{1,0}) all-to-all(%p, %q)
  %cp = bf16[256]{0} collective-permute(%w)
  %ags = f32[32]{0} all-gather-start(%v)
  %agd = f32[32]{0} all-gather-done(%ags)
  %ars = (s32[4,2]{1,0}, pred[3]{0}) all-reduce-start(%t)
  %notacoll = f32[2,2]{1,0} add(%a, %b)
  %q8 = u4[10]{0} collective-permute-start(%u), x=c128[2]
"""


# ------------------------------------------------------------ hlo text --

@pytest.mark.parametrize("text", [
    "bf16[16,4096]", "(f32[8,128], f32[8,128])", "pred[7]", "f32[]",
    "(s32[4,2]{1,0}, pred[3]{0})", "c128[2,3]", "f8e4m3fn[9] u4[3]",
    "tuple[3] f32[2]"])
def test_shape_bytes_equal_the_reference(text):
    assert H.shape_bytes(text) == RH.shape_bytes(text)


@pytest.mark.parametrize("text", [HLO, "", HLO * 3,
                                  HLO.replace("all-reduce", "add")])
def test_collective_parse_equals_the_reference(text):
    assert H.collective_bytes(text) == RH.collective_bytes(text)
    assert H.collective_counts(text) == RH.collective_counts(text)
    assert H.DTYPE_BYTES == RH.DTYPE_BYTES
    assert H.COLLECTIVES == RH.COLLECTIVES


def test_collective_log_keeps_the_reference_conventions():
    """An all-reduce counts twice its output bytes; ``total`` sums the
    kinds, ``count`` the ops; ``counts`` is ``collective_counts``'
    shape."""
    with H.CollectiveLog() as log:
        H.record_collective("all-gather", 16 * 4096 * 2, dry=True)
        H.record_collective("all-reduce", 1024 * 4, dry=True)
        H.record_collective("all-to-all", 2 * 8 * 128 * 4, dry=False)
        H.record_collective("all-gather", 32 * 4, dry=True)
    text = "\n".join(l for l in HLO.splitlines()
                     if "reduce-scatter" not in l and "permute" not in l
                     and "all-reduce-start" not in l)
    assert log.bytes() == RH.collective_bytes(text)
    assert log.counts() == RH.collective_counts(text)
    with pytest.raises(RuntimeError, match="stand-in"):
        H.record_collective("all-gather", 8, dry=True)


# ------------------------------------------------------------ roofline --

ART = {"n_superblocks": 10,
       "full": {"flops": 100.0, "collectives": {"total": 50}},
       "block": {"flops": 7.0, "collectives": {"total": 3}}}


@pytest.mark.parametrize("art", [ART, {**ART, "block_multiplier": 40},
                                 {**ART, "block": {}},
                                 {"n_superblocks": 1, "full": {"flops": 3}}])
@pytest.mark.parametrize("key", ["flops", "collectives.total",
                                 "memory.temp_bytes"])
def test_adjusted_equals_the_reference(art, key):
    assert PR.adjusted(art, key) == RR.adjusted(art, key)


def test_model_flops_equal_the_reference_on_every_cell():
    for arch, shape in all_cells():
        assert PR.model_flops(arch, shape.name, shape.kind, shape.seq_len,
                              shape.global_batch) == RR.model_flops(
            arch, shape.name, shape.kind, shape.seq_len,
            shape.global_batch)


def test_h100_constants():
    """NVIDIA's H100 SXM data sheet: dense bf16, HBM bandwidth, NVLink
    one way, device memory."""
    assert (PR.PEAK_FLOPS, PR.HBM_BW, PR.LINK_BW, PR.HBM_BYTES) == (
        989e12, 3.35e12, 450e9, 80e9)


def test_roofline_dataclass_brackets():
    r = PR.Roofline(arch="a", shape="s", mesh="single", chips=256,
                    compute_s=1.0, memory_s=4.0, memory_lb_s=0.5,
                    collective_s=2.0, model_flops=256 * PR.PEAK_FLOPS,
                    hlo_flops_adj=1.0, useful_ratio=0.5, fits_hbm=True,
                    arg_gib=1.0, temp_gib=1.0)
    assert r.dominant == "memory" and r.dominant_opt == "collective"
    assert r.roofline_fraction == pytest.approx(0.25)
    assert r.roofline_fraction_opt == pytest.approx(0.5)
    assert r.dominant_s == 4.0 and r.dominant_opt_s == 2.0
    decode = SHAPES["decode_32k"]
    assert r.decode_latency_ms(decode) == 4000.0
    assert r.decode_tokens_per_s(decode) == decode.global_batch / 4.0
    assert r.decode_latency_ms(SHAPES["train_4k"]) is None
    hints = {PR.Roofline(**{**dataclasses.asdict(r), **terms})
             .bottleneck_hint()
             for terms in ({"compute_s": 9.0}, {"memory_s": 9.0},
                           {"collective_s": 9.0})}
    assert len(hints) == 3


def test_cell_roofline_uses_the_h100():
    art = {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "single",
           "chips": 256, "kind": "train", "n_superblocks": 16,
           "full": {"flops": 2 * PR.PEAK_FLOPS, "bytes_accessed": PR.HBM_BW,
                    "collectives": {"total": PR.LINK_BW},
                    "memory": {"argument_bytes": 40e9, "temp_bytes": 40e9,
                               "output_bytes": 0}},
           "block": {"flops": 0.0}}
    r = PR.cell_roofline(art)
    assert (r.compute_s, r.memory_s, r.collective_s) == (2.0, 1.0, 1.0)
    assert not r.fits_hbm                     # 80 GB is not below 80 GB
    art["full"]["memory"]["temp_bytes"] = 39e9
    assert PR.cell_roofline(art).fits_hbm
    assert PR.cell_roofline({**art, "error": "x"}) is None


# --------------------------------------------------------------- cells --

def test_cells_equal_the_reference():
    cells = all_cells()
    assert len(cells) == 33
    assert [(a, dataclasses.astuple(s)) for a, s in cells] == \
        [(a, dataclasses.astuple(s)) for a, s in r_all_cells()]
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in R_SHAPES.items()}
    assert ("jamba-v0.1-52b", SHAPES["long_500k"]) in cells
    assert SHAPES["long_500k"] not in shapes_for("gemma2-9b")


# ------------------------------------------------------ described inputs --

def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts, tuples and named tuples (either
    package's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    return {} if tree is None else {prefix: tree}


def _spec(sharding, ndim) -> tuple:
    """The reference's ``PartitionSpec`` as the port's per-dimension
    tuple."""
    entries = tuple(sharding.spec) + (None,) * ndim
    return tuple(tuple(e) if isinstance(e, list) else e
                 for e in entries[:ndim])


def _same(ours: dict, ref: dict, tokens=()) -> None:
    assert ours.keys() == ref.keys()
    for path, leaf in ours.items():
        want = ref[path]
        assert isinstance(leaf, ShapeStruct)
        assert leaf.shape == tuple(want.shape), path
        dtype = str(want.dtype)
        if path in tokens:
            assert dtype == "int32", path
            dtype = "int64"
        assert leaf.dtype == getattr(torch, dtype), path
        assert leaf.spec == _spec(want.sharding, len(leaf.shape)), path
        assert leaf.local_shape == tuple(
            want.sharding.shard_shape(want.shape)), path


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _axes_pair(mesh: str, rc=None):
    shape = MESHES[mesh]
    ours = make_axes(StandInMesh(shape), rc)
    ref = RAxes(mesh=AbstractMesh(tuple(shape.values()), tuple(shape)),
                batch=ours.batch, fsdp=ours.fsdp, tp=ours.tp,
                seq_parallel=ours.seq_parallel)
    return ours, ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_inputs_of_every_cell_equal_the_reference(mesh):
    """``input_specs`` of all 33 cells and each config's parameters on
    the production meshes: shape, dtype, spec and local shape."""
    ax, rax = _axes_pair(mesh)
    for arch, shape in all_cells():
        rc = RunConfig()
        got = _flat(input_specs(arch, shape, ax, rc))
        want = _flat(r_input_specs(arch, R_SHAPES[shape.name], rax, RRun()))
        _same(got, want, tokens=("/tokens", "/token"))
    for arch in ARCH_IDS:
        for dt in (torch.float32, torch.bfloat16):
            got = shape_tree(T.model_specs(get_config(arch)), dt,
                             ax.resolve, ax.mesh)
            want = r_shape_tree(RT.model_specs(r_config(arch)),
                                jnp.dtype(str(dt).split(".")[1]),
                                rax.resolve, rax.mesh)
            _same(_flat(got), _flat(want))


def test_shape_tree_off_a_mesh_allocates_nothing():
    specs = T.model_specs(get_config("qwen1.5-110b"))
    tree = shape_tree(specs)
    leaf = tree["blocks"]["b0"]["ffn"]["w1"]
    assert leaf.spec is None and leaf.local_shape == leaf.shape
    assert leaf.dtype == torch.float32
    with pytest.raises(AttributeError):
        leaf.shape = (1,)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, stacked):
    """Leaf for leaf, shape, axes and init, at the decode cells' sizes
    and small ones (windows below and above the sequence)."""
    for cfg, rcfg in ((get_config(arch), r_config(arch)),
                      (get_smoke_config(arch), r_smoke(arch))):
        for batch, seq in ((128, 32768), (1, 524288), (3, 40), (2, 8)):
            got = _flat(T.cache_specs(cfg, batch, seq, stacked))
            want = _flat(RT.cache_specs(rcfg, batch, seq, stacked))
            assert got.keys() == want.keys()
            for path, leaf in got.items():
                w = want[path]
                assert (leaf.shape, leaf.axes, leaf.init, leaf.scale) == (
                    w.shape, w.axes, w.init, w.scale), (arch, path)
        got = [_flat(b) for b in T.superblock_param_specs(cfg)]
        want = [_flat(b) for b in RT.superblock_param_specs(rcfg)]
        assert [{p: (l.shape, l.axes, l.init, l.scale)
                 for p, l in b.items()} for b in got] == \
            [{p: (l.shape, l.axes, l.init, l.scale) for p, l in b.items()}
             for b in want]


SHARD_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax
from repro.configs import SHAPES, get_smoke_config
from repro.configs.base import RunConfig
from repro.launch.inputs import input_specs
from repro.launch.mesh import compat_make_mesh
from repro.launch.sharding import make_axes
from repro.models import transformer as T
from repro.models.params import shape_tree
mesh = compat_make_mesh((2, 4), ("data", "model"))
ax = make_axes(mesh, RunConfig())
out = {}
for arch in %(archs)r:
    cfg = get_smoke_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(SHAPES[name], global_batch=8,
                                    seq_len=64)
        tree = {"params": shape_tree(T.model_specs(cfg), resolver=ax.resolve,
                                     mesh=mesh)}
        import repro.launch.inputs as I
        I.get_config = lambda a, c=cfg: c
        tree["inputs"] = input_specs(arch, shape, ax, RunConfig())
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        out[arch + "/" + name] = {
            jax.tree_util.keystr(p): list(l.sharding.shard_shape(l.shape))
            for p, l in leaves}
print("RESULT " + json.dumps(out))
"""

SMOKE_ARCHS = ("llama3.2-1b", "jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b")


def _keystr(path: str) -> str:
    """A ``_flat`` path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"['{p}']" for p in path.strip("/").split("/"))


def test_local_shapes_equal_shard_shapes_on_8_devices(monkeypatch):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c",
                          SHARD_SCRIPT % {"archs": SMOKE_ARCHS}],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines()
            if l.startswith("RESULT ")][-1]
    want = json.loads(line[len("RESULT "):])
    import repro_torch.launch.inputs as I
    ax = make_axes(StandInMesh({"data": 2, "model": 4}), RunConfig())
    for arch in SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        monkeypatch.setattr(I, "get_config", lambda a, c=cfg: c)
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = dataclasses.replace(SHAPES[name], global_batch=8,
                                        seq_len=64)
            tree = {"params": shape_tree(T.model_specs(cfg), torch.float32,
                                         ax.resolve, ax.mesh),
                    "inputs": input_specs(arch, shape, ax, RunConfig())}
            got = {_keystr(p): list(l.local_shape)
                   for p, l in _flat(tree).items()}
            assert got == want[f"{arch}/{name}"], (arch, name)
