"""The port's checkpoints (``repro_torch.checkpoint``) held to the JAX
reference's (``repro.checkpoint``): the counterpart of the checkpoint
tests of ``tests/test_faults.py`` (roundtrips, the aux sidecar, the
restore refusals with the reference's words), ``keep=`` garbage
collection, the async ``Checkpointer``, and the on-disk format read both
ways: a checkpoint the port writes restores bit-equal in the reference,
and one the reference writes restores bit-equal in the port, over random
trees with bf16 leaves (a hypothesis property).  Every comparison is
exact: a checkpoint moves bytes."""
import json
import os
from collections import OrderedDict, namedtuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import load_aux as r_load_aux
from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro_torch.checkpoint import (Checkpointer, latest_step, load_aux,
                                    restore_checkpoint, save_checkpoint)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def _leaf(dtype: str, shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return torch.from_numpy(np.asarray(rng.random(shape) > 0.5))
    if dtype in ("int32", "int64"):
        info = np.iinfo(dtype)
        return torch.from_numpy(np.asarray(rng.integers(
            info.min, info.max, shape, dtype=dtype, endpoint=True)))
    x = np.asarray(rng.standard_normal(shape) * 8, np.float32)
    return torch.from_numpy(x).to(DTYPES[dtype])


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as integers (bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _same(got, want) -> None:
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        return
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype).replace(
        "torch.", "")
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_roundtrip_every_dtype_with_zero_d_leaves(tmp_path, dtype):
    state = {"w": _leaf(dtype, (3, 5), 0), "s": _leaf(dtype, (), 1),
             "nest": {"b0s10": _leaf(dtype, (2,), 2),
                      "b0s2": _leaf(dtype, (4, 1), 3)}}
    path = save_checkpoint(str(tmp_path), 7, state)
    assert path == os.path.join(str(tmp_path), "step_00000007")
    assert latest_step(str(tmp_path)) == 7
    back = restore_checkpoint(str(tmp_path), 7, state)
    _same(back, state)
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert manifest["dtypes"] == [dtype] * 4
    assert manifest["paths"] == ["['nest']['b0s10']", "['nest']['b0s2']",
                                 "['s']", "['w']"]
    assert manifest["shapes"] == [[2], [4, 1], [], [3, 5]]


def test_flattening_order_and_names_are_the_references(tmp_path):
    """Sorted keys at every level (``b0s10`` before ``b0s2``), the leaves
    named by JAX's ``keystr``: the port's manifest is the reference's."""
    keys = [f"b0s{i}" for i in range(16)]
    p_state = {"pools": {k: {"k": torch.zeros(2, 3), "v": torch.ones(2, 3)}
                         for k in keys},
               "lane_tok": torch.zeros((4, 1), dtype=torch.int32)}
    r_state = {"pools": {k: {"k": jnp.zeros((2, 3)), "v": jnp.ones((2, 3))}
                         for k in keys},
               "lane_tok": jnp.zeros((4, 1), jnp.int32)}
    save_checkpoint(str(tmp_path / "p"), 1, p_state)
    r_save(str(tmp_path / "r"), 1, r_state)
    got, want = (json.loads((tmp_path / d / "step_00000001" /
                             "manifest.json").read_text())
                 for d in ("p", "r"))
    assert got == want
    assert got["paths"][:4] == ["['lane_tok']", "['pools']['b0s0']['k']",
                                "['pools']['b0s0']['v']",
                                "['pools']['b0s1']['k']"]
    assert got["paths"].index("['pools']['b0s10']['k']") < got[
        "paths"].index("['pools']['b0s2']['k']")


def test_keep_garbage_collects_the_oldest_steps(tmp_path):
    state = {"x": torch.arange(3)}
    for step in (1, 5, 3, 9, 12):
        save_checkpoint(str(tmp_path), step, state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000009",
                                            "step_00000012"]
    save_checkpoint(str(tmp_path), 12, {"x": torch.arange(3) + 1}, keep=2)
    assert latest_step(str(tmp_path)) == 12
    _same(restore_checkpoint(str(tmp_path), 12, state),
          {"x": torch.arange(3) + 1})
    assert latest_step(str(tmp_path / "missing")) is None
    os.makedirs(tmp_path / "empty")
    assert latest_step(str(tmp_path / "empty")) is None


def test_checkpoint_aux_sidecar_roundtrip(tmp_path):
    state = {"x": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 3, state, aux={"sched": {"now": 4}})
    assert load_aux(str(tmp_path), 3) == {"sched": {"now": 4}}
    assert r_load_aux(str(tmp_path), 3) == {"sched": {"now": 4}}
    save_checkpoint(str(tmp_path), 4, state)
    assert load_aux(str(tmp_path), 4) is None


def test_restore_rejects_shape_dtype_structure_and_corruption(tmp_path):
    """The reference's four refusals, in its words."""
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": torch.zeros(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 1, state)
    with pytest.raises(ValueError, match="disagree"):
        restore_checkpoint(str(tmp_path), 1, {"w": state["w"]})
    with pytest.raises(ValueError, match="template shape"):
        restore_checkpoint(str(tmp_path), 1,
                           {"w": torch.zeros(3, 2), "b": state["b"]})
    with pytest.raises(ValueError, match="template dtype"):
        restore_checkpoint(str(tmp_path), 1,
                           {"w": state["w"], "b": torch.zeros(3)})
    _same(restore_checkpoint(str(tmp_path), 1, state), state)
    # a manifest that no longer matches the arrays
    mpath = tmp_path / "step_00000001" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["shapes"][1] = [3, 2]
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="the checkpoint is corrupt"):
        restore_checkpoint(str(tmp_path), 1, state)
    with pytest.raises(ValueError, match="the checkpoint is corrupt"):
        r_restore(str(tmp_path), 1, {"b": jnp.zeros(3, jnp.int32),
                                     "w": jnp.zeros((2, 3))})


def test_restore_places_leaves_on_the_asked_device(tmp_path):
    state = {"a": torch.ones(2, dtype=torch.bfloat16)}
    save_checkpoint(str(tmp_path), 1, state)
    back = restore_checkpoint(str(tmp_path), 1, state, device="cpu")
    assert back["a"].device.type == "cpu"
    back["a"].add_(1)                         # an ordinary, writable tensor
    assert state["a"].tolist() == [1.0, 1.0]


def test_async_checkpointer_snapshots_and_surfaces_errors(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    x = torch.arange(4, dtype=torch.float32)
    ck.save(1, {"x": x, "h": torch.ones(2, dtype=torch.bfloat16)})
    x.add_(100)                  # after the snapshot: not in the checkpoint
    ck.save(2, {"x": x, "h": torch.ones(2, dtype=torch.bfloat16)})
    ck.wait()
    like = {"x": torch.zeros(4), "h": torch.zeros(2, dtype=torch.bfloat16)}
    _same(restore_checkpoint(str(tmp_path / "ck"), 1, like),
          {"x": torch.arange(4, dtype=torch.float32),
           "h": torch.ones(2, dtype=torch.bfloat16)})
    assert restore_checkpoint(str(tmp_path / "ck"), 2,
                              like)["x"].tolist() == [100, 101, 102, 103]
    # a directory that cannot be made: the worker's error comes out of
    # the next wait(), once
    (tmp_path / "file").write_text("")
    bad = Checkpointer(str(tmp_path / "file" / "ck"))
    bad.save(1, {"x": x})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()


# -- the on-disk format, read both ways --------------------------------------

_KEYS = st.sampled_from(["k", "v", "b0s2", "b0s10", "lane_tok", "pools",
                         "a", "B", "z"])
_SHAPES = st.lists(st.integers(0, 4), min_size=0, max_size=3).map(tuple)


def _tree(leaf):
    return st.recursive(leaf, lambda kids: st.dictionaries(
        _KEYS, kids, min_size=1, max_size=3), max_leaves=6).filter(
        lambda t: isinstance(t, dict))


@st.composite
def _leaf_spec(draw, dtypes):
    return (draw(st.sampled_from(dtypes)), draw(_SHAPES),
            draw(st.integers(0, 2**31 - 1)))


def _build(spec, make):
    if isinstance(spec, dict):
        return {k: _build(v, make) for k, v in spec.items()}
    return make(*spec)


_R_DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32,
             "int32": jnp.int32, "bool": jnp.bool_}


@settings(max_examples=25, deadline=None, database=None)
@given(_tree(_leaf_spec(["bfloat16", "float32", "int32", "bool"])))
def test_port_checkpoint_restores_bit_equal_in_the_reference(tmp_path_factory,
                                                             spec):
    d = str(tmp_path_factory.mktemp("p2r"))
    state = _build(spec, _leaf)
    save_checkpoint(d, 3, state)
    like = _build(spec, lambda dt, shape, _: jnp.zeros(shape,
                                                       _R_DTYPES[dt]))
    back = r_restore(d, 3, like)
    flat_back = jax.tree_util.tree_leaves(back)
    flat_want = [leaf for _, leaf in sorted(_flat(state))]
    assert len(flat_back) == len(flat_want)
    for got, want in zip(flat_back, flat_want):
        assert str(got.dtype) == str(want.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_bits(np.asarray(got)), _bits(want))


@settings(max_examples=25, deadline=None, database=None)
@given(_tree(_leaf_spec(["bfloat16", "float32", "int32", "int64",
                         "bool"])))
def test_reference_checkpoint_restores_bit_equal_in_the_port(tmp_path_factory,
                                                             spec):
    d = str(tmp_path_factory.mktemp("r2p"))
    state = _build(spec, _leaf)

    def host(x):            # what the reference holds: numpy / ml_dtypes
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    r_save(d, 3, _build(spec, lambda *a: host(_leaf(*a))))
    like = _build(spec, lambda dt, shape, _: torch.zeros(shape,
                                                         dtype=DTYPES[dt]))
    _same(restore_checkpoint(d, 3, like), state)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in tree for p in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


# -- trees that are not dicts of arrays: lists, tuples, None, scalars --------

_Moments = namedtuple("_Moments", "mu nu")

_NON_DICT = {
    "list": (lambda f: {"a": [f(np.ones(2, np.float32)),
                              f(np.zeros(3, np.float32))]},
             ["['a'][0]", "['a'][1]"]),
    "tuple": (lambda f: {"a": (f(np.ones(2, np.float32)),
                               f(np.zeros(3, np.float32)))},
              ["['a'][0]", "['a'][1]"]),
    "none": (lambda f: {"a": f(np.ones(2, np.float32)), "b": None},
             ["['a']"]),
    "scalar": (lambda f: {"a": 3}, ["['a']"]),
    # jax walks an OrderedDict in insertion order, a namedtuple by field
    "ordered_named": (lambda f: {"s": _Moments(f(np.ones(1, np.float32)),
                                               [f(np.zeros(2, np.float32))]),
                                 "o": OrderedDict(
                                     [("z", f(np.ones(3, np.int32))),
                                      ("a", f(np.zeros(1, np.int32)))])},
                      ["['o']['z']", "['o']['a']", "['s'].mu",
                       "['s'].nu[0]"]),
    "nested": (lambda f: {"o": ({"m": [f(np.arange(4, dtype=np.int32)),
                                       None, 2.5]}, True),
                          "x": [[f(np.ones((2, 2), np.float32))]]},
               ["['o'][0]['m'][0]", "['o'][0]['m'][2]", "['o'][1]",
                "['x'][0][0]"]),
}


def _leaves_equal(got, want) -> None:
    """Two restored trees: the same containers (list, tuple, None) and
    every leaf equal in shape, dtype name and value."""
    assert type(got) is type(want) or (
        isinstance(want, (int, float, bool)) and np.ndim(got) == 0)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _leaves_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _leaves_equal(g, w)
    elif want is None:
        assert got is None
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.tolist() == w.tolist()


@pytest.mark.parametrize("case", sorted(_NON_DICT))
def test_non_dict_trees_cross_restore_both_ways(tmp_path, case):
    """A tree with lists, tuples, ``None`` and Python scalar leaves: the
    port writes the reference's leaf count, paths, shapes and dtypes, and
    each package restores the other's checkpoint (and its own) into the
    template's containers: lists as lists, tuples as tuples, ``None``
    kept."""
    build, paths = _NON_DICT[case]
    p_state, r_state = build(torch.from_numpy), build(jnp.asarray)
    save_checkpoint(str(tmp_path / "p"), 1, p_state)
    r_save(str(tmp_path / "r"), 1, r_state)
    got, want = (json.loads((tmp_path / d / "step_00000001" /
                             "manifest.json").read_text())
                 for d in ("p", "r"))
    assert got == want
    assert got["paths"] == paths
    for d in ("p", "r"):
        _leaves_equal(restore_checkpoint(str(tmp_path / d), 1, p_state),
                      p_state)
        _leaves_equal(r_restore(str(tmp_path / d), 1, r_state), r_state)


def test_python_scalar_template_restores_numpys_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"i": 3, "f": 2.5, "b": True})
    manifest = json.loads((tmp_path / "step_00000001" /
                           "manifest.json").read_text())
    assert manifest["dtypes"] == ["bool", "float64", "int64"]
    back = restore_checkpoint(str(tmp_path), 1, {"i": 0, "f": 0.0,
                                                 "b": False})
    assert back["i"].dtype == torch.int64 and int(back["i"]) == 3
    assert back["f"].dtype == torch.float64 and float(back["f"]) == 2.5
    assert back["b"].dtype == torch.bool and bool(back["b"])
    with pytest.raises(ValueError, match="template dtype"):
        restore_checkpoint(str(tmp_path), 1, {"i": 0.0, "f": 0.0,
                                              "b": False})
    with pytest.raises(ValueError, match="disagree"):
        restore_checkpoint(str(tmp_path), 1, {"i": 0, "f": None, "b": 0})


def test_async_checkpointer_keeps_lists_and_tuples(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(3)
    state = {"opt": (x, [torch.ones(2), None])}
    ck.save(1, state)
    x.add_(7)
    ck.wait()
    back = restore_checkpoint(str(tmp_path), 1, state)
    assert isinstance(back["opt"], tuple) and isinstance(back["opt"][1],
                                                         list)
    assert back["opt"][0].tolist() == [0, 1, 2] and back["opt"][1][1] is None


def _dict_only_flatten(tree, prefix=""):
    """The dict-only flattening every earlier port checkpoint was written
    with: sorted keys, ``[key!r]`` names."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _dict_only_flatten(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def test_run_scheduler_checkpoint_is_unchanged(tmp_path, monkeypatch):
    """A preempted ``run_scheduler`` day's checkpoint (``{"pools": ...,
    "lane_tok": ...}``, all tensors) flattens exactly as the dict-only
    walk did: the same names, the same leaves in the same order, so its
    manifest and arrays are byte for byte what they were; and its
    manifest is the reference's for the same arrays."""
    import repro_torch.checkpoint as PCk
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.sharding import NO_AXES
    from repro_torch.models import init_tree, model_specs
    from repro_torch.runtime import FaultEvent, FaultPlan
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Request
    saved = []
    real = PCk.save_checkpoint

    def spy(directory, step, state, *a, **kw):
        saved.append(state)
        return real(directory, step, state, *a, **kw)
    monkeypatch.setattr(PCk, "save_checkpoint", spy)
    cfg = get_smoke_config("llama3.2-1b")
    gen = torch.Generator().manual_seed(0)
    eng = ServeEngine(cfg, RunConfig(remat="none", attn_impl="dense"),
                      init_tree(model_specs(cfg), gen, device="cpu"), NO_AXES,
                      max_batch=4, max_seq=32, kv_mode="paged", page_len=8,
                      device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=a, prompt_len=p, max_new_tokens=m,
                    tokens=rng.integers(0, cfg.vocab_size, p).astype(
                        np.int32))
            for i, (a, p, m) in enumerate(((0, 12, 8), (0, 5, 6),
                                           (1, 8, 4)))]
    res = eng.run_scheduler(reqs, checkpoint_dir=str(tmp_path / "ck"),
                            fault_plan=FaultPlan((FaultEvent(
                                tick=3, kind="preempt"),)))
    assert res.preempted and len(saved) == 1
    state = saved[0]
    assert sorted(state) == ["lane_tok", "pools"]
    new, old = _flatten_with_paths(state), _dict_only_flatten(state)
    assert [p for p, _ in new] == [p for p, _ in old]
    assert all(a is b for (_, a), (_, b) in zip(new, old, strict=True))
    step = latest_step(str(tmp_path / "ck"))
    manifest = json.loads((tmp_path / "ck" / f"step_{step:08d}" /
                           "manifest.json").read_text())
    assert manifest["paths"] == [p for p, _ in old]

    def host(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    r_save(str(tmp_path / "r"), step, {
        k: ({n: {h: host(t) for h, t in v.items()} for n, v in
             state[k].items()} if k == "pools" else host(state[k]))
        for k in state})
    assert json.loads((tmp_path / "r" / f"step_{step:08d}" /
                       "manifest.json").read_text()) == manifest
