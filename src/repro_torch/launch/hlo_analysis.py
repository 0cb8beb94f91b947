"""What the compile-only accounting counts (port of
``repro.launch.hlo_analysis``).

The reference parses the per-device HLO text of a compiled step for its
collectives; that parser is kept here as it is (``shape_bytes``,
``collective_bytes``, ``collective_counts``) for HLO text from anywhere.
The port has no compiled module to read.  It counts the step it runs, op
by op, as the step is dispatched:

* ``CollectiveLog``: while one is active, every collective of the
  sharding layer (``launch/sharding.py``: ``all_gather``, ``all_to_all``,
  ``all_reduce_sum``, ``all_reduce_``) adds its per-device output bytes
  by kind, with the reference's conventions: an all-reduce counts twice
  its output bytes (a ring all-reduce is a reduce-scatter and an
  all-gather), and ``total`` and ``count`` are present.  On a real
  process group (gloo or NCCL) each collective runs and is counted
  ("observe"); on a stand-in mesh (``launch/mesh.py``'s ``StandInMesh``,
  or any object with only ``.shape`` and ``.axis_names``) nothing is
  sent and each collective returns a tensor of the right shape and dtype
  ("dry").
* ``OpCounter``: a dispatch mode that counts every aten op: FLOPs as
  XLA's cost analysis counts them (a matmul 2·M·N·K through
  ``torch.utils.flop_counter``'s formulas, kept apart as
  ``matmul_flops``; one per output element of an op that torch tags
  pointwise or reduction, and of the softmax family and ``cumsum``,
  which it tags neither; data movement none), the bytes each op reads
  and writes (its input tensors plus its outputs; a view or alias of an
  input counts 0: the pre-fusion upper bound the reference documents),
  and the live bytes of every storage, whose peak gives the temporaries.

``analyze(fn, *args)`` runs ``fn`` under both and returns the record the
reference's ``_analyze`` makes of a compiled module.  Under
``torch._subclasses.fake_tensor.FakeTensorMode`` nothing is computed or
allocated, and a real run of the same function counts the same ops.
"""
from __future__ import annotations

import re
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[\d,]*\][^\s]*)\s+"
    r"((?:all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?)\(")


def shape_bytes(type_str: str) -> int:
    """Bytes of one HLO type string, incl. tuples '(bf16[2,4], f32[8])'."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dtype]
    return total


def _by_kind(pairs) -> dict:
    """{kind: bytes, ..., 'total': bytes, 'count': n_ops} of (kind,
    output bytes) pairs, an all-reduce counted twice."""
    out: dict = defaultdict(int)
    count = 0
    for kind, b in pairs:
        out[kind] += 2 * b if kind == "all-reduce" else b
        count += 1
    out["total"] = sum(out[k] for k in COLLECTIVES if k in out)
    out["count"] = count
    return dict(out)


def collective_bytes(hlo_text: str) -> dict:
    """Returns {op_kind: bytes, ..., 'total': bytes, 'count': n_ops}."""
    return _by_kind((m.group(2).removesuffix("-start"),
                     shape_bytes(m.group(1)))
                    for m in _OP_RE.finditer(hlo_text))


def collective_counts(hlo_text: str) -> dict:
    out: dict = defaultdict(int)
    for m in _OP_RE.finditer(hlo_text):
        out[m.group(2).removesuffix("-start")] += 1
    return dict(out)


# -- the port's own counting ------------------------------------------------

#: the logs being written; a process-wide stack, not a context variable,
#: because autograd runs a CUDA backward (and its collectives) on a thread
#: of its own
_ACTIVE: list = []


class CollectiveLog:
    """Collective bytes by kind while active (``with CollectiveLog() as
    log:``); ``bytes()`` and ``counts()`` have ``collective_bytes``'s and
    ``collective_counts``' shapes."""

    def __init__(self):
        self.ops: list[tuple[str, int]] = []

    def __enter__(self) -> "CollectiveLog":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def bytes(self) -> dict:
        return _by_kind(self.ops)

    def counts(self) -> dict:
        out: dict = defaultdict(int)
        for kind, _ in self.ops:
            out[kind] += 1
        return dict(out)


def record_collective(kind: str, nbytes: int, dry: bool) -> None:
    """Add one collective (``kind``, per-device output bytes) to every
    active log.  A dry collective (a stand-in mesh's) moves nothing, so
    one outside a log is refused."""
    if dry and not _ACTIVE:
        raise RuntimeError(f"{kind} on a stand-in mesh moves no data; run "
                           "it under a CollectiveLog (the dry run does)")
    for log in _ACTIVE:
        log.ops.append((kind, int(nbytes)))


#: arithmetic that torch tags neither pointwise nor reduction
_UNTAGGED_ARITHMETIC = {torch.ops.aten._softmax, torch.ops.aten._log_softmax,
                        torch.ops.aten._softmax_backward_data,
                        torch.ops.aten._log_softmax_backward_data,
                        torch.ops.aten.cumsum}
_ARITHMETIC_TAGS = (torch.Tag.pointwise, torch.Tag.reduction)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_tensors(values) -> list:
    """The tensors among an op's arguments or results: aten takes them
    bare or in one list."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _kind(func) -> tuple:
    """(whether ``func`` may write its inputs, what it counts as:
    "matmul", "arithmetic" or "move")."""
    packet = func._overloadpacket
    if packet in flop_registry:
        kind = "matmul"
    elif packet in _UNTAGGED_ARITHMETIC or any(
            tag in func.tags for tag in _ARITHMETIC_TAGS):
        kind = "arithmetic"
    else:
        kind = "move"
    return func._schema.is_mutable, kind


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched while active (module docstring):
    ``flops``, ``matmul_flops``, ``bytes_accessed``, ``ops``, and the
    live bytes of the storages it has seen (``track`` the arguments
    first), whose maximum is ``peak``."""

    def __init__(self):
        super().__init__()
        self.flops = self.matmul_flops = self.bytes_accessed = 0
        self.ops = self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._kinds: dict = {}

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` as live; returns the bytes
        of those not seen before."""
        added = 0
        for t in tensors:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            added += n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":        # fake tensors' device queries
            return out
        self.ops += 1
        ins = _op_tensors((*args, *kwargs.values()))
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,))
        if func not in self._kinds:
            self._kinds[func] = _kind(func)
        mutable, kind = self._kinds[func]
        if outs and not mutable:
            in_storages = {id(t.untyped_storage()) for t in ins}
            if all(id(t.untyped_storage()) in in_storages for t in outs):
                return out                  # a view or alias: nothing moves
        if kind == "matmul":
            f = int(flop_registry[func._overloadpacket](*args, **kwargs,
                                                        out_val=out))
            self.matmul_flops += f
            self.flops += f
        elif kind == "arithmetic":
            self.flops += sum(t.numel() for t in outs)
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes,
                                                                outs))
        self.track(outs)
        return out


def _storage_bytes(tensors, among=None) -> int:
    """Bytes of the distinct storages of ``tensors`` (those whose storage
    is in ``among``, a set of storage ids, when given)."""
    seen: dict = {}
    for t in tensors:
        st = t.untyped_storage()
        if among is None or id(st) in among:
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def analyze(fn, *args):
    """``fn(*args)`` under an ``OpCounter`` and a ``CollectiveLog``;
    returns (its result, the record): ``flops``, ``matmul_flops``,
    ``bytes_accessed``, ``memory`` (``argument_bytes``, ``output_bytes``,
    ``temp_bytes``: the peak of live bytes less the arguments,
    ``alias_bytes``: outputs that are arguments' storages),
    ``collectives``, ``collective_counts`` and ``ops``."""
    arg_tensors = _tensors(args)
    counter = OpCounter()
    args_bytes = counter.track(arg_tensors)
    with CollectiveLog() as log, counter:
        result = fn(*args)
    outs = _tensors(result)
    return result, {
        "flops": counter.flops,
        "matmul_flops": counter.matmul_flops,
        "bytes_accessed": counter.bytes_accessed,
        "memory": {
            "argument_bytes": args_bytes,
            "output_bytes": _storage_bytes(outs),
            "temp_bytes": max(counter.peak - args_bytes, 0),
            "alias_bytes": _storage_bytes(
                outs, {id(t.untyped_storage()) for t in arg_tensors}),
        },
        "collectives": log.bytes(),
        "collective_counts": log.counts(),
        "ops": counter.ops,
    }
