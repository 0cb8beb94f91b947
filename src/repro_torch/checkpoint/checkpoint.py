"""Crash-safe, async checkpointing of tensor trees (port of
``repro.checkpoint.checkpoint``), in the reference's on-disk format.

Layout:   <dir>/step_<N>/          (tmp dir + atomic rename = crash safe)
            manifest.json          leaf names, shapes, dtypes, step
            arrays.npz             the flattened leaves (host values)
            aux.json               optional JSON sidecar

A tree is flattened as ``jax.tree_util`` flattens a pytree, so a
checkpoint either package writes restores in the other:

  * a dict is walked in sorted key order, each child named ``[key!r]``
    (an ``OrderedDict`` in insertion order);
  * a list or a tuple is walked in order, each child named ``[i]``; a
    namedtuple's child is named ``.field``;
  * ``None`` is an empty subtree: it has no leaf and no name;
  * anything else is a leaf (a tensor, a numpy array, a Python scalar),
    its shape ``np.shape`` of it and its name the path down to it
    (``['pools']['b0s10']['k']``, ``['a'][0]``).

A restore gives back the template's containers: lists as lists, tuples as
tuples, ``None`` where the template has ``None``.  dtype names in the
manifest are numpy's (``bfloat16``, ``float32``, ``int32``, ``int64``,
``bool``, ...).  numpy
has no bfloat16: a bf16 leaf is stored as 2-byte void (the bits of its
``int16`` view), which the reference reinterprets through the manifest
dtype, and restored by viewing those bits back as ``torch.bfloat16``.

``restore_checkpoint`` places the tensors on ``device``, or on each
template leaf's device.  The async ``Checkpointer`` snapshots to the host
on the caller's thread and writes on a worker thread; ``wait()`` drains it
and raises the worker's error, if any.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

#: numpy's names for the torch dtypes a checkpoint may hold
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _keys(tree: dict) -> list:
    return list(tree) if isinstance(tree, OrderedDict) else sorted(tree)


def _children(tree):
    """(name suffix, child) pairs of a container node, in the reference's
    order; None for a leaf.  ``None`` is a node with no children."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(f"[{key!r}]", tree[key]) for key in _keys(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """(name, leaf) pairs in the reference's order, each leaf named by its
    key path (``['a']['b']``, ``['a'][0]``)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for name, child in kids
            for pair in _flatten_with_paths(child, prefix + name)]


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves taken from ``leaves`` in
    flattening order (the containers' types kept)."""
    kids = _children(like)
    if kids is None:
        return leaves.pop(0)
    values = [_unflatten(child, leaves) for _, child in kids]
    if like is None:
        return None
    if isinstance(like, dict):
        return type(like)(zip(_keys(like), values))
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def _leaf_dtype_name(leaf) -> str:
    """A template leaf's dtype name: a tensor's or an array's, a Python
    scalar's as numpy makes it (``int64``, ``float64``, ``bool``)."""
    dtype = getattr(leaf, "dtype", None)
    return _dtype_name(dtype if dtype is not None else np.asarray(leaf).dtype)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPE_NAMES:
            raise TypeError(f"no checkpoint dtype for {dtype}")
        return _DTYPE_NAMES[dtype]
    return np.dtype(dtype).name


def _host_array(leaf) -> tuple:
    """A leaf as (numpy array as stored, numpy dtype name): bf16 as the
    2-byte void view of its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2"), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def save_checkpoint(directory: str, step: int, state, keep: int = 3,
                    aux: Optional[dict] = None) -> str:
    """Synchronous save with an atomic rename; returns the final path.

    ``aux`` is an optional JSON-serializable sidecar (``aux.json`` inside
    the same atomic step directory) for state that is not an array, e.g.
    the serving scheduler's ``state_dict()`` beside its KV pools.  Read it
    back with ``load_aux``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=directory)
    try:
        leaves = _flatten_with_paths(state)
        host = [_host_array(v) for _, v in leaves]
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": arr for i, (arr, _) in enumerate(host)})
        manifest = {
            "step": int(step),
            "paths": [p for p, _ in leaves],
            "shapes": [list(arr.shape) for arr, _ in host],
            "dtypes": [name for _, name in host],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if aux is not None:
            with open(os.path.join(tmp, "aux.json"), "w") as f:
                json.dump(aux, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def load_aux(directory: str, step: int) -> Optional[dict]:
    """The ``aux`` sidecar saved with ``save_checkpoint`` (None if the
    checkpoint has none)."""
    path = os.path.join(directory, f"step_{step:08d}", "aux.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _as_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's dtype ``name``."""
    if name == "bfloat16":
        # stored as the bits: 2-byte void (either package) or int16
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    want = np.dtype(name)
    if (arr.dtype != want and arr.dtype.kind == "V"
            and arr.dtype.itemsize == want.itemsize):
        arr = arr.view(want)
    return torch.from_numpy(np.array(arr, dtype=want))


def _stored_dtype_ok(arr: np.ndarray, name: str) -> bool:
    """Whether npz's array can hold the manifest's dtype ``name``."""
    if name == "bfloat16":
        return arr.dtype.itemsize == 2 and arr.dtype.kind in "Vi"
    return True


def restore_checkpoint(directory: str, step: int, like, device=None,
                       place=None):
    """Restore into the structure of ``like`` (a tree of tensors, of
    anything with ``.shape`` and ``.dtype``, or of Python scalars).  Each
    tensor lands on ``device``, else on its template leaf's device, else
    the CPU.  ``place``, a tree of callables of ``like``'s structure,
    maps each array, read on the host, to what is kept of it (a mesh
    rank's block) before it moves, so no more than one whole leaf is
    held at a time."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    leaves_like = [leaf for _, leaf in _flatten_with_paths(like)]
    keep = [f for _, f in _flatten_with_paths(place)] if place is not None \
        else [None] * len(leaves_like)
    if len(leaves_like) != len(manifest["paths"]):
        raise ValueError(
            f"checkpoint step {step} in {directory} has "
            f"{len(manifest['paths'])} leaves but the restore template has "
            f"{len(leaves_like)}; the pytree structures disagree")
    out = []
    for i, ref in enumerate(leaves_like):
        name = manifest["paths"][i]
        arr = data[f"leaf_{i}"]
        saved_shape = tuple(manifest["shapes"][i])
        saved_dtype = manifest["dtypes"][i]
        if tuple(arr.shape) != saved_shape or not _stored_dtype_ok(
                arr, saved_dtype):
            raise ValueError(
                f"leaf {name}: arrays.npz holds shape {tuple(arr.shape)} "
                f"but the manifest recorded {saved_shape} — the checkpoint "
                f"is corrupt")
        want_shape = tuple(np.shape(ref))
        if saved_shape != want_shape:
            raise ValueError(
                f"leaf {name}: checkpoint shape {saved_shape} != template "
                f"shape {want_shape} — restoring into a different model/"
                f"config than the one checkpointed")
        want_dtype = _leaf_dtype_name(ref)
        if saved_dtype != want_dtype:
            raise ValueError(
                f"leaf {name}: checkpoint dtype {saved_dtype} != template "
                f"dtype {want_dtype} — restoring into a different model/"
                f"config than the one checkpointed")
        where = device if device is not None else getattr(ref, "device",
                                                          "cpu")
        host = _as_tensor(arr, saved_dtype)
        out.append((host if keep[i] is None else keep[i](host)).to(where))
    return _unflatten(like, out)


def _gc(directory: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for d in os.listdir(directory)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _snapshot(tree):
    """A host copy of every leaf that later writes to the source cannot
    change (containers kept)."""
    return _unflatten(tree, [
        leaf.detach().to("cpu", copy=True)
        if isinstance(leaf, torch.Tensor) else np.array(leaf)
        for _, leaf in _flatten_with_paths(tree)])


class Checkpointer:
    """Async checkpointer: snapshot on the caller's thread, serialize on a
    worker thread; at most one pending write (a save waits for the
    previous one)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, copy: bool = True) -> None:
        """Write ``state`` at ``step`` on the worker thread.  ``copy=False``
        takes a tree that is already a private host copy as it is."""
        self.wait()
        snapshot = _snapshot(state) if copy else state

        def work():
            try:
                save_checkpoint(self.directory, step, snapshot, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
