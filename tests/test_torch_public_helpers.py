"""The reference's public helpers in the port's mirrored modules, held to
the reference on the inputs of the reference's own uses (integers
bit-equal), and a sweep of every reference module's public names against
its port: only the Pallas kernel modules (replaced by ``csrc/*.cu``) may
be missing, and a public function or method takes the reference's
parameter names but for the port's listed idiom."""
import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.controllers as RC
import repro_torch.core.controllers as PC
from repro.core.arbiter import arbitrate_schedule as r_schedule
from repro.core.arbiter import output_mux_controls as r_mux
from repro.core.arbiter import writeback_strobe as r_strobe
from repro.kernels.banked_gather import from_banked_layout as r_from
from repro.kernels.banked_gather import to_banked_layout as r_to
from repro.kernels.banked_gather.ops import physical_rows as r_rows
from repro.models.params import is_leaf as r_is_leaf
from repro.models.params import tree_map_leaves as r_map_leaves
from repro.models.transformer import model_specs as r_model_specs
from repro_torch.configs import get_smoke_config
from repro_torch.core.arbiter import (arbitrate_schedule,
                                      output_mux_controls, writeback_strobe)
from repro_torch.kernels.banked_gather import (from_banked_layout,
                                               to_banked_layout)
from repro_torch.kernels.banked_gather.ops import physical_rows
from repro_torch.models.params import Leaf, is_leaf, tree_map_leaves
from repro_torch.models.transformer import model_specs
from repro.configs import get_smoke_config as r_smoke

SRC = Path(__file__).resolve().parents[1] / "src"

def test_writeback_strobe_as_the_reference():
    banks = [0, 1, 1, 3, 1, 4, 3, 6]
    r_out = r_mux(r_schedule(jnp.array(banks, jnp.int32), 8)[0],
                  mem_latency=3)
    out = output_mux_controls(arbitrate_schedule(
        torch.tensor(banks, dtype=torch.int32), 8)[0], mem_latency=3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out))
    strobe = writeback_strobe(out)
    assert strobe.dtype == torch.int32
    np.testing.assert_array_equal(strobe.numpy(), np.asarray(r_strobe(r_out)))
    assert int(strobe.sum()) == 8


@pytest.mark.parametrize("v,d", [(256, 512), (1024, 1024), (64, 512),
                                 (128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mapping", ["lsb", "offset", "xor"])
def test_banked_layouts_as_the_reference(v, d, dtype, mapping):
    """tests/test_kernels.py's and tests/test_banked_scatter.py's tables:
    the relayout both ways, bit for bit, and the row permutation."""
    key = jax.random.PRNGKey(v + d)
    table = jax.random.normal(key, (v, d)).astype(dtype)
    r_banked = r_to(table, 16, mapping)
    t = torch.from_numpy(np.array(table.astype(jnp.float32))).to(
        getattr(torch, dtype))
    banked = to_banked_layout(t, 16, mapping)
    np.testing.assert_array_equal(banked.float().numpy(),
                                  np.asarray(r_banked.astype(jnp.float32)))
    np.testing.assert_array_equal(from_banked_layout(banked, 16, mapping)
                                  .float().numpy(), t.float().numpy())
    np.testing.assert_array_equal(
        physical_rows(v, 16, mapping, device="cpu").numpy(),
        np.asarray(r_rows(v, 16, mapping)))


def test_instruction_cycles_as_the_reference():
    rng = np.random.default_rng(0)
    for ops in (1, 4, 64, 1024):
        cyc = rng.integers(1, 17, size=ops).astype(np.int32)
        for port, ref in ((PC.read_instruction_cycles,
                           RC.read_instruction_cycles),
                          (PC.write_instruction_cycles,
                           RC.write_instruction_cycles)):
            assert int(port(torch.from_numpy(cyc))) == int(ref(
                jnp.asarray(cyc)))
        assert int(PC.write_instruction_cycles(torch.from_numpy(cyc),
                                               blocking=False)) == \
            int(RC.write_instruction_cycles(jnp.asarray(cyc), False))
    for n_ops in (1, 7, 64):
        for ports in (1, 2, 3, 4, 16):
            for lanes in (16, 32):
                assert PC.multiport_read_cycles(n_ops, ports, lanes) == \
                    RC.multiport_read_cycles(n_ops, ports, lanes)
                assert PC.multiport_write_cycles(n_ops, ports, lanes) == \
                    RC.multiport_write_cycles(n_ops, ports, lanes)
    timing = PC.InstrTiming(issue_cycles=64, drain_cycles=40, blocking=True)
    ref = RC.InstrTiming(issue_cycles=64, drain_cycles=40, blocking=True)
    assert dataclasses.astuple(timing) == dataclasses.astuple(ref)
    assert timing.total == ref.total == 104
    for name in ("ISSUE_LATENCY", "BANK_RAM_LATENCY", "XBAR_IN_LATENCY",
                 "XBAR_OUT_LATENCY", "WRITEBACK_LATENCY",
                 "MAX_THREADS_PER_BLOCK", "READ_OVERHEAD",
                 "WRITE_OVERHEAD"):
        assert getattr(PC, name) == getattr(RC, name), name


def test_tree_map_leaves_as_the_reference():
    """``src/repro/optim/adamw.py``'s use: a zero-init copy of every leaf
    of a model's specs, axes kept."""
    specs = model_specs(get_smoke_config("jamba-v0.1-52b"))
    r_specs = r_model_specs(r_smoke("jamba-v0.1-52b"))
    got = tree_map_leaves(lambda l: Leaf(l.shape, l.axes, init="zeros"),
                          specs)
    want = r_map_leaves(lambda l: type(l)(l.shape, l.axes, init="zeros"),
                        r_specs)
    flat = jax.tree.leaves(want, is_leaf=r_is_leaf)     # sorted keys

    def ordered(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in ordered(tree[k])]
        return [tree]
    ours = ordered(got)
    assert [(l.shape, l.axes, l.init) for l in ours] == \
        [(l.shape, l.axes, l.init) for l in flat]
    assert is_leaf(ours[0]) and not is_leaf(specs) and not is_leaf(None)
    assert r_is_leaf(flat[0]) and not r_is_leaf(r_specs)


def _public_names(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names |= set(ast.literal_eval(node.value))
    # ``Array`` is the reference's jnp type alias, ``log`` a logger
    return {n for n in names if not n.startswith("_")} - {"Array", "log"}


#: parameters only the reference takes, and why the port has none
REF_ONLY = {
    "interpret": "a Pallas kernel's interpret mode: a wrapper runs its "
                 "plain version on a CPU tensor",
    "kernel_interpret": "the same, for the serving engine's kernels",
    "key": "a JAX PRNG key: the port takes a torch.Generator",
    "shardings": "a restore's JAX shardings: the port's takes `place`",
    "legacy_shard": "a GSPMD layout hint (models/moe.py)",
}
#: parameters only the port takes
PORT_ONLY = {
    "device": "the device a function makes its tensors on",
    "generator": "the torch.Generator in place of a PRNG key",
    "place": "what a leaf keeps of itself on a mesh",
    "argv": "a CLI's arguments, for calling its main in-process",
    "copy": "whether a checkpoint's writer copies the state first",
    "mesh": "the mesh an update reduces over (GSPMD infers it there)",
    "specs": "the placements of that update's leaves",
}
#: (module, function) -> (reference-only, port-only) names beyond those
PER_FUNCTION = {
    # the Pallas kernel's VMEM tile; the CUDA kernel picks its own tiling
    ("repro_torch.kernels.banked_transpose.ops", "banked_transpose"):
        ({"tile"}, set()),
    # the reference's body never reads it: the mesh's axis names decide
    ("repro_torch.launch.sharding", "make_axes"): ({"multi_pod"}, set()),
}


def _ref_params(node: ast.FunctionDef) -> set:
    a = node.args
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    names |= {x.arg for x in (a.vararg, a.kwarg) if x is not None}
    return names - {"self", "cls"}


def _port_params(obj) -> set:
    return set(inspect.signature(obj).parameters) - {"self", "cls"}


def _public_functions(path: Path):
    """(qualified name, ``FunctionDef``) of every public function and of
    every public class's public methods and ``__init__``."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith(
                "_"):
            yield node.name, node
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        sub.name == "__init__"
                        or not sub.name.startswith("_")):
                    yield f"{node.name}.{sub.name}", sub


def test_every_reference_name_has_a_port():
    """The re-anchor's sweep: every public function, class, constant and
    ``__all__`` entry of every reference module exists in its port, and
    every public function and method takes the reference's parameter
    names, but for ``REF_ONLY``, ``PORT_ONLY`` and ``PER_FUNCTION``."""
    missing_modules, missing, params = set(), {}, {}
    for path in sorted((SRC / "repro").rglob("*.py")):
        rel = path.relative_to(SRC / "repro")
        if not (SRC / "repro_torch" / rel).exists():
            missing_modules.add(rel.as_posix())
            continue
        parts = ("repro_torch",) + rel.with_suffix("").parts
        name = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        mod = importlib.import_module(name)
        gone = {n for n in _public_names(path) if not hasattr(mod, n)}
        if gone:
            missing[name] = gone
        for qual, node in _public_functions(path):
            obj = mod
            for part in qual.split("."):
                obj = getattr(obj, part, None)
            if not callable(obj):              # missing, or a property
                continue
            ref, port = _ref_params(node), _port_params(obj)
            ref_only, port_only = PER_FUNCTION.get((name, qual),
                                                   (set(), set()))
            extra = (ref - port - set(REF_ONLY) - ref_only,
                     port - ref - set(PORT_ONLY) - port_only)
            if any(extra):
                params[f"{name}.{qual}"] = extra
    pallas = {p.relative_to(SRC / "repro").as_posix()
              for p in (SRC / "repro" / "kernels").glob("*/kernel.py")}
    assert len(pallas) == 7
    assert missing_modules == pallas
    assert missing == {}
    assert params == {}
