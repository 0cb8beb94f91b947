"""Sharding resolution of the port (``repro_torch.launch.sharding``,
``models.params.Leaf.axes``, ``runtime.elastic.make_current_mesh``) held
to the reference: every leaf's logical axes, and ``Axes.resolve`` entry
for entry equal to the reference's ``PartitionSpec`` for every leaf of
``model_specs`` and ``train_state_specs`` (ZeRO-1 on and off), for every
config, on stand-in meshes of the production shapes and small ones."""
import pytest

import repro.runtime.elastic as RE
import repro_torch.runtime.elastic as PE
from repro.configs import get_config as r_config
from repro.configs.base import RunConfig as RRun
from repro.launch.mesh import MULTI_POD as R_MULTI
from repro.launch.mesh import SINGLE_POD as R_SINGLE
from repro.launch.sharding import make_axes as r_make_axes
from repro.models.transformer import model_specs as r_model_specs
from repro.train.step import train_state_specs as r_state_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, chips
from repro_torch.launch.sharding import (NO_AXES, make_axes, replicas,
                                         to_placements)
from repro_torch.models.params import Leaf, spec_tree
from repro_torch.models.transformer import model_specs
from repro_torch.train.step import train_state_specs


class FakeMesh:
    """Duck-typed mesh: shape dict + axis names (no process group)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [dict(zip(("data", "model"), SINGLE_POD)),
          dict(zip(("pod", "data", "model"), MULTI_POD)),
          {"data": 2, "model": 2}, {"data": 4, "model": 1},
          {"data": 1, "model": 4}, {"data": 8, "model": 2}]


def _leaves(tree, path=""):
    """(path, leaf) pairs of a spec tree of either package."""
    if tree is None:
        return []
    if hasattr(tree, "axes") and hasattr(tree, "shape"):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaves(tree[k],
                                                         f"{path}/{k}")]
    return [p for f in tree._fields for p in _leaves(getattr(tree, f),
                                                     f"{path}.{f}")]


def _pairs(arch, zero1):
    rc, rrc = RunConfig(zero1=zero1), RRun(zero1=zero1)
    port = _leaves(model_specs(get_config(arch))) + \
        _leaves(train_state_specs(get_config(arch), rc), "state")
    ref = _leaves(r_model_specs(r_config(arch))) + \
        _leaves(r_state_specs(r_config(arch), rrc), "state")
    assert [p for p, _ in port] == [p for p, _ in ref]
    return rc, rrc, [(p, a, b) for (p, a), (_, b) in zip(port, ref)]


def test_production_meshes_equal_the_reference():
    assert SINGLE_POD == R_SINGLE and MULTI_POD == R_MULTI
    assert chips(FakeMesh(MESHES[1])) == 512


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_axes_equal_the_reference(arch):
    for zero1 in (True, False):
        _, _, pairs = _pairs(arch, zero1)
        for path, leaf, ref in pairs:
            assert (tuple(leaf.shape), tuple(leaf.axes), leaf.init,
                    leaf.scale) == (tuple(ref.shape), tuple(ref.axes),
                                    ref.init, ref.scale), path


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("zero1", [True, False])
def test_resolve_equals_the_reference(arch, zero1):
    rc, rrc, pairs = _pairs(arch, zero1)
    for shape in MESHES:
        mesh = FakeMesh(shape)
        ax, rax = make_axes(mesh, rc), r_make_axes(mesh, rrc)
        assert (ax.batch, ax.tp, ax.fsdp) == (rax.batch, rax.tp, rax.fsdp)
        for path, leaf, ref in pairs:
            got = ax.resolve(leaf.axes, leaf.shape)
            want = tuple(rax.resolve(ref.axes, ref.shape))
            assert got == want, (shape, path, got, want)
            # every shard divides evenly and placements name each axis once
            places = to_placements(got, mesh)
            assert len(places) == len(shape)
            assert replicas(got, mesh) * _shards(got, shape) == \
                chips(mesh), (shape, path)


def _shards(spec, shape):
    n = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            n *= shape[a]
    return n


def test_spec_tree_and_no_axes():
    specs = {"w": Leaf((8, 6), ("embed", "ffn")),
             "n": {"g": Leaf((8,), ("embed",), init="ones")}}
    mesh = FakeMesh({"data": 2, "model": 3})
    assert spec_tree(specs, make_axes(mesh).resolve) == \
        {"w": ("data", "model"), "n": {"g": ("data",)}}
    assert spec_tree(specs, NO_AXES.resolve) == \
        {"w": (None, None), "n": {"g": (None,)}}
    x = object()
    assert NO_AXES.act(x) is x and make_axes(mesh).heads_act(x) is x
    with pytest.raises(ValueError):
        Leaf((8, 6), ("embed",))


@pytest.mark.parametrize("prefer_model", [0, 2, 4, 3])
def test_make_current_mesh_shape(monkeypatch, prefer_model):
    """The (data, model) shape for 1..64 ranks, against the reference's
    arithmetic over as many devices."""
    monkeypatch.setattr(RE, "compat_make_mesh", lambda shape, axes: shape)
    monkeypatch.setattr(PE, "compat_make_mesh", lambda shape, axes: shape)
    monkeypatch.setattr(PE.dist, "is_initialized", lambda: True)
    for n in range(1, 65):
        monkeypatch.setattr(RE.jax, "devices", lambda n=n: [None] * n)
        monkeypatch.setattr(PE.dist, "get_world_size", lambda n=n: n)
        want = RE.make_current_mesh(prefer_model)
        assert PE.make_current_mesh(prefer_model) == tuple(want), n
        assert PE.current_mesh_shape(n, prefer_model) == tuple(want)
