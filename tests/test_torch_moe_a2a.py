"""The port's expert-parallel all-to-all MoE (``repro_torch.models.
moe_a2a``) on 4 gloo ranks of a (2, 2) mesh, held to the reference's
``moe_gshard`` on the whole batch, as tests/test_moe_a2a.py holds the
reference's ``moe_a2a``: the E ≥ tp path and the capacity-split virtual
expert path (E < tp); with requests dropped, to the reference's
``moe_a2a`` on a (2, 2) mesh of 4 host devices.  And the port's
``moe_gshard`` / ``moe_scatter`` on the same mesh at the config's own
capacity factor, held to the reference's on the whole batch: groups cut
from the whole batch's tokens, whether a group spans data ranks or each
rank holds whole groups."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_gloo import run_ranks
from repro.configs import get_smoke_config as r_smoke
from repro.launch.sharding import NO_AXES
from repro.models import init_tree
from repro.models import moe as RM
from repro.models.moe import moe_gshard, moe_specs
from repro_torch.configs import get_smoke_config
from repro_torch.launch.sharding import Axes
from repro_torch.models.moe_a2a import a2a_applicable


SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

#: the reference's ``moe_a2a`` on a (2, 2) mesh of 4 host devices, once a
#: (experts, k, capacity factor or None) in argv[2], on argv[1]'s inputs
REF_A2A = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch.mesh import compat_make_mesh
from repro.launch.sharding import make_axes
from repro.models.moe_a2a import a2a_applicable, moe_a2a

mesh = compat_make_mesh((2, 2), ("data", "model"))
ax = make_axes(mesh, None)
for i, (experts, k, cf) in enumerate(json.loads(sys.argv[2])):
    cfg = dataclasses.replace(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                              n_experts=experts, experts_per_token=k)
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    data = np.load(os.path.join(sys.argv[1], f"inputs{i}.npz"))
    params = {n: jnp.asarray(data[n]) for n in ("router", "w1", "w2", "w3")}
    assert a2a_applicable(cfg, ax, data["x"].shape[1])
    with mesh:
        y, aux = jax.jit(lambda p, x: moe_a2a(cfg, p, x, ax))(
            params, jnp.asarray(data["x"]))
    np.savez(os.path.join(sys.argv[1], f"ref{i}.npz"), y=np.asarray(y),
             aux=np.asarray(aux))
"""

#: (experts, k, capacity factor) of the dropping a2a cases: the config's
#: own 1.25 on the E ≥ tp path; 0.5 on the virtual-expert path, where one
#: expert takes every token and 1.25 would keep them all
A2A_DROPS = [(4, 2, None), (1, 1, 0.5)]

#: (impl, group_len) of the grouped cases: a group of 16 tokens lies
#: within a data rank's 32; one of 1024 is the whole batch's 64 tokens
GROUPED = [(impl, g) for impl in ("gshard", "scatter") for g in (16, 1024)]


def _biased_x(d: int) -> np.ndarray:
    """(4, 16, d) rows sharing one offset, so the router favours some
    experts and a group at a small capacity factor drops requests."""
    rng = np.random.default_rng(1)
    return (rng.standard_normal((4, 16, d))
            + 2.0 * rng.standard_normal(d)).astype(np.float32)


def _cfg(experts: int, k: int, cf):
    rcfg = dataclasses.replace(r_smoke("phi3.5-moe-42b-a6.6b"),
                               n_experts=experts, experts_per_token=k)
    return rcfg if cf is None else dataclasses.replace(rcfg,
                                                       capacity_factor=cf)


def _inputs(path: str, rcfg) -> tuple:
    params = init_tree(moe_specs(rcfg), jax.random.PRNGKey(0))
    x = _biased_x(rcfg.d_model)
    np.savez(path, x=x, **{n: np.asarray(v) for n, v in params.items()})
    return params, x


def _assert_drops(rcfg, params, x, y, group_len: int = 1024) -> None:
    """``y`` differs from the output without drops (capacity factor 16):
    the case drops requests, so it sees which ones."""
    free = dataclasses.replace(rcfg, capacity_factor=16.0)
    y_free = np.asarray(moe_gshard(free, params, jnp.asarray(x), NO_AXES,
                                   group_len)[0])
    assert np.abs(y - y_free).max() > 1e-3 * np.abs(y_free).max()


def _assert_rows(out: str, y_ref, aux_ref) -> None:
    norm = max(float(np.abs(y_ref).max()), 1.0)
    for rank in range(4):
        got = np.load(os.path.join(out, f"rank{rank}.npz"))
        i = int(got["data"])
        err = float(np.abs(got["y"] - y_ref[2 * i:2 * i + 2]).max())
        assert err < 1e-4 * norm, (rank, err, norm)
        assert abs(float(got["aux"]) - float(aux_ref)) < 1e-4, (rank,
                                                                aux_ref)


@pytest.fixture(scope="module")
def a2a_drops(tmp_path_factory):
    """The dropping a2a cases, the reference's (a subprocess) and the
    port's (4 gloo ranks) run side by side: (cases, port's output dir)."""
    tmp = tmp_path_factory.mktemp("a2a_drops")
    cases = []
    for i, (experts, k, cf) in enumerate(A2A_DROPS):
        rcfg = _cfg(experts, k, cf)
        cases.append((rcfg,) + _inputs(str(tmp / f"inputs{i}.npz"), rcfg))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", REF_A2A, str(tmp),
                            json.dumps(A2A_DROPS)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        out = run_ranks("moe_cases", 4, tmp, timeout=180, layer="moe_a2a",
                        runs=[dict(experts=e, k=k, capacity_factor=cf,
                                   inputs=str(tmp / f"inputs{i}.npz"))
                              for i, (e, k, cf) in enumerate(A2A_DROPS)])
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-4000:]
    return cases, tmp, out


@pytest.mark.parametrize("case", range(len(A2A_DROPS)),
                         ids=[f"E{e}-k{k}" for e, k, _ in A2A_DROPS])
def test_a2a_drops_as_the_reference(a2a_drops, case):
    cases, tmp, out = a2a_drops
    rcfg, params, x = cases[case]
    ref = np.load(str(tmp / f"ref{case}.npz"))
    _assert_drops(rcfg, params, x, ref["y"])
    _assert_rows(os.path.join(out, str(case)), ref["y"], ref["aux"])


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    """The grouped cases on 4 gloo ranks: (weights, x, output dir)."""
    tmp = tmp_path_factory.mktemp("grouped")
    rcfg = r_smoke("phi3.5-moe-42b-a6.6b")
    params, x = _inputs(str(tmp / "inputs.npz"), rcfg)
    out = run_ranks("moe_cases", 4, tmp, timeout=180, layer="moe_grouped",
                    runs=[dict(impl=impl, group_len=g,
                               inputs=str(tmp / "inputs.npz"))
                          for impl, g in GROUPED])
    return rcfg, params, x, out


@pytest.mark.parametrize("case", range(len(GROUPED)),
                         ids=[f"{impl}-g{g}" for impl, g in GROUPED])
def test_grouped_moe_on_mesh_equals_the_reference(grouped, case):
    rcfg, params, x, out = grouped
    impl, group_len = GROUPED[case]
    y_ref, aux_ref = getattr(RM, f"moe_{impl}")(rcfg, params,
                                                jnp.asarray(x), NO_AXES,
                                                group_len)
    y_ref = np.asarray(y_ref)
    _assert_drops(rcfg, params, x, y_ref, group_len)
    _assert_rows(os.path.join(out, str(case)), y_ref, float(aux_ref))


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("experts,k", [(4, 2), (1, 1)])
def test_a2a_equals_gshard(tmp_path, experts, k):
    rcfg = dataclasses.replace(r_smoke("phi3.5-moe-42b-a6.6b"),
                               n_experts=experts, experts_per_token=k,
                               capacity_factor=16.0)  # no drops
    params = init_tree(moe_specs(rcfg), jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal(
        (4, 16, rcfg.d_model)).astype(np.float32)
    y_ref, aux_ref = moe_gshard(rcfg, params, jnp.asarray(x), NO_AXES)
    y_ref, aux_ref = np.asarray(y_ref), float(aux_ref)
    inputs = os.path.join(str(tmp_path), "inputs.npz")
    np.savez(inputs, x=x, **{n: np.asarray(v) for n, v in params.items()})
    out = run_ranks("moe_a2a", 4, tmp_path, experts=experts, k=k,
                    inputs=inputs)
    norm = max(float(np.abs(y_ref).max()), 1.0)
    for rank in range(4):
        got = np.load(os.path.join(out, f"rank{rank}.npz"))
        i = int(got["data"])
        err = float(np.abs(got["y"] - y_ref[2 * i:2 * i + 2]).max())
        assert err < 1e-4 * norm, (rank, err, norm)
        assert abs(float(got["aux"]) - aux_ref) < 1e-4, (rank, aux_ref)


def test_a2a_applicable_as_the_reference():
    from repro.launch.sharding import Axes as RAxes
    from repro.models.moe_a2a import a2a_applicable as r_applicable
    for shape in ({"data": 2, "model": 2}, {"data": 4, "model": 1},
                  {"data": 1, "model": 4}, {"data": 8, "model": 2},
                  {"data": 16, "model": 16}):
        for experts in (1, 2, 3, 4, 16):
            for seq in (15, 16, 64):
                cfg = dataclasses.replace(
                    get_smoke_config("phi3.5-moe-42b-a6.6b"),
                    n_experts=experts)
                rcfg = dataclasses.replace(r_smoke("phi3.5-moe-42b-a6.6b"),
                                           n_experts=experts)
                mesh = FakeMesh(shape)
                assert a2a_applicable(cfg, Axes(mesh=mesh), seq) == \
                    r_applicable(rcfg, RAxes(mesh=mesh), seq)
    assert not a2a_applicable(get_smoke_config("phi3.5-moe-42b-a6.6b"),
                              Axes(), 16)
