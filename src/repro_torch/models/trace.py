"""Whole-model decode traffic lowered to the Trace protocol (port of
``repro.models.trace``).

The paper's banked-vs-multi-port verdict rests on transpose/FFT
microkernels; a real inference step mixes attention gathers, RoPE index
streams, MoE dispatch, and SSM state updates.  This module lowers one
decode step, per ``repro_torch.configs.ModelConfig`` layer pattern, into
the same ``repro_torch.core.trace`` artifacts every other workload speaks,
so ``tune.search`` can answer "which of the nine paper memories serves a
whole Llama-style decode step" rather than one kernel at a time.

Three traffic kernels register here (reachable through ``kernels.get`` like
the seven kernel packages: the registry's builtin hook imports this
module):

  * ``attn_decode`` — one attention layer's decode-step traffic: Q/K/V/O
    weight-row streams, the RoPE frequency-row gather (one row per (seq,
    head) at the sequence's position), the paged-KV K/V page gathers and
    the current-page appends (the exact ``serving.kvcache`` request
    streams), and the output-row store.
  * ``moe_a2a``   — one MoE layer's all-to-all dispatch traffic: router
    weight rows, the priority-ordered expert-id store (the ``moe_dispatch``
    stream), and the send/combine slot scatter+gather derived from the
    carry-chain arbiter's grant positions.  The grant positions come from
    ``kernels.get("moe_dispatch").ref``, the registry's host oracle, as in
    the reference: pricing traffic launches no CUDA kernel.
  * ``ssm_scan``  — one SSM layer's decode-step traffic: the rolling conv
    window rows, the x/dt projection rows, the stride-``ssm_state`` state
    read-modify-write (the (B·D_inner, N) state matrix accessed one state
    column at a time: the strided pattern the bank maps exist for), and
    the output-row store.

Each kernel's ``cuda`` entry is its host ``_run`` (the reference puts the
same function in its ``pallas`` field): these kernels price memory
traffic, they compute nothing on the card.  Every kernel is built from
one list of ``StreamSpec`` request streams, from which the dense
``trace``, the O(block) ``blocks`` generator and the ``symbolic`` families
of the conflict prover (``repro_torch.analysis.symbolic``) are all
derived, so the three entry points are bit-equal by construction and
``analysis.symbolic.cross_check`` holds on data-dependent (page table,
expert routing) and closed-form (weight rows, strided state) streams
alike; ``model_step_symbolic`` is the whole decode step's families.

``model_step_trace(config, arch, ...)`` stitches the per-layer streams of a
whole decode step (attention/SSM mixer, then MoE or dense FFN, following
``config.block_pattern()``) into ONE re-iterable ``TraceStream``: pages
are allocated on ``device`` by the same ``serving.kvcache`` arbiter the
live engine uses (the traffic is arch-dependent, like
``simulate_serving_stream``), every iteration replays the routing from the
seed, and instructions bigger than ``block_ops`` stream as
``instr_carry``-marked chunks, so a 56-layer Mixtral step is constructed
AND costed in O(block) memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.kernels.registry import Kernel, register

__all__ = ["StreamSpec", "attn_decode_specs", "moe_a2a_specs",
           "ssm_scan_specs", "model_step_trace", "model_step_symbolic",
           "resolve_model_config", "MODEL_TRACE_KERNELS"]

#: the kernel names this module registers (for discovery and docs; the
#: registry keys on the registered set)
MODEL_TRACE_KERNELS = ("attn_decode", "moe_a2a", "ssm_scan")


@dataclass(frozen=True)
class StreamSpec:
    """One memory instruction of model traffic: a named row-index request
    stream (rows are the banked unit throughout the repo).  The single
    source all three kernel entry points are derived from: ``trace``
    (dense), ``blocks`` (O(block) streaming) and ``symbolic`` (prover
    families)."""
    name: str
    kind: str                        # "load" | "store" | "tw"
    idx: np.ndarray                  # flat row-index request stream
    mask: np.ndarray | None = None   # flat active-lane mask (None = all)


def _specs_trace(arch, specs: Sequence[StreamSpec], meta: dict | None = None):
    """Dense ``AddressTrace``: one instruction per spec, concatenated."""
    from repro_torch.core.trace import AddressTrace
    from repro_torch.kernels.registry import row_stream_trace
    t = AddressTrace.concat(*[row_stream_trace(s.idx, kind=s.kind,
                                               mask=s.mask) for s in specs])
    if meta:
        t.meta.update(meta)
    return t


def _specs_blocks(arch, specs: Sequence[StreamSpec],
                  block_ops: int | None = None) -> Iterator:
    """Streaming counterpart of ``_specs_trace``: each spec's instruction
    yielded as at-most-``block_ops``-op chunks (continuations
    ``instr_carry``-marked: the instruction overhead is charged once)."""
    from repro_torch.core.trace import iter_op_chunks
    for s in specs:
        yield from iter_op_chunks(s.idx, s.kind, mask=s.mask,
                                  block_ops=block_ops)


def _specs_symbolic(arch, specs: Sequence[StreamSpec],
                    meta: dict | None = None):
    """The specs as a ``SymbolicTrace``: arithmetic-progression streams
    (weight rows, strided state) prove in closed form; data-dependent ones
    (page tables, expert routing) enumerate exactly."""
    from repro_torch.analysis.symbolic import (SymbolicTrace,
                                               affine_from_indices)
    fams = tuple(affine_from_indices(s.idx, s.kind, s.name, mask=s.mask)
                 for s in specs)
    return SymbolicTrace(families=fams, meta=dict(meta or {}))


# --------------------------------------------------------------------------
# attn_decode — one attention layer's decode-step traffic
# --------------------------------------------------------------------------

def _kv_streams(page_table, positions, page_len: int) -> tuple:
    """(read ids, read mask, append ids, append mask, positions) of a
    paged-KV decode step: every sequence reads its whole page list and
    appends to the page its position falls in (-1 entries predicated
    off)."""
    from repro_torch.serving.kvcache import kv_read_stream
    pt = np.asarray(page_table, np.int64)
    pos = np.asarray(positions, np.int64).reshape(-1)
    read_ids, read_mask = kv_read_stream(pt)
    cur = pt[np.arange(pt.shape[0]), pos // page_len]
    return read_ids, read_mask, np.maximum(cur, 0), cur >= 0, pos


def attn_decode_specs(page_table, positions, d_model: int = 64,
                      n_heads: int = 4, page_len: int = 8
                      ) -> tuple[StreamSpec, ...]:
    """The request streams of one attention layer decoding one token per
    sequence.

    ``page_table`` is the paged-KV table ((B, max_pages) logical pool page
    ids, -1 unmapped) and ``positions`` the (B,) current token positions,
    the inputs ``serving.kvcache.decode_step_trace`` takes, so the K/V
    gather and append streams here are exactly the serving ones.  The
    projection streams are the unit-stride weight-row loads of
    Wq/Wk/Wv/Wo (d_model rows each), the RoPE stream gathers one
    frequency-table row per (sequence, head) at that sequence's position
    (a broadcast-heavy gather: every head of a sequence hits the same
    row), and the output is one store of B residual rows.
    """
    read_ids, read_mask, cur_ids, cur_mask, pos = _kv_streams(
        page_table, positions, page_len)
    b = pos.shape[0]
    w_rows = np.arange(d_model)
    rope = np.repeat(pos, max(n_heads, 1))
    return (
        StreamSpec("wq rows", "load", w_rows),
        StreamSpec("wk rows", "load", w_rows),
        StreamSpec("wv rows", "load", w_rows),
        StreamSpec("rope freq rows", "load", rope),
        StreamSpec("K page gather", "load", read_ids, read_mask),
        StreamSpec("V page gather", "load", read_ids, read_mask),
        StreamSpec("K page append", "store", cur_ids, cur_mask),
        StreamSpec("V page append", "store", cur_ids, cur_mask),
        StreamSpec("wo rows", "load", w_rows),
        StreamSpec("attn out rows", "store", np.arange(b)),
    )


def attn_decode_trace(arch, page_table, positions, d_model: int = 64,
                      n_heads: int = 4, page_len: int = 8, **_):
    return _specs_trace(arch, attn_decode_specs(page_table, positions,
                                                d_model, n_heads, page_len),
                        meta={"kernel": "attn_decode"})


def attn_decode_blocks(arch, page_table, positions, d_model: int = 64,
                       n_heads: int = 4, page_len: int = 8,
                       block_ops: int | None = None, **_):
    yield from _specs_blocks(arch, attn_decode_specs(page_table, positions,
                                                     d_model, n_heads,
                                                     page_len), block_ops)


def attn_decode_symbolic(arch, page_table, positions, d_model: int = 64,
                         n_heads: int = 4, page_len: int = 8, **_):
    return _specs_symbolic(arch, attn_decode_specs(page_table, positions,
                                                   d_model, n_heads,
                                                   page_len),
                           meta={"kernel": "attn_decode"})


def _attn_decode_run(arch, page_table, positions, d_model: int = 64,
                     n_heads: int = 4, page_len: int = 8, **_):
    """Host-side reference: the concrete (clamped ids, active mask) pairs
    of the paged-KV read and append, what the gather/scatter kernels
    consume.  The attention compute lives in
    ``repro_torch.models.transformer``; this kernel prices the layer's
    memory traffic."""
    read_ids, read_mask, cur_ids, cur_mask, _ = _kv_streams(
        page_table, positions, page_len)
    return {"read_ids": read_ids, "read_mask": read_mask,
            "append_ids": cur_ids, "append_mask": cur_mask}


# --------------------------------------------------------------------------
# moe_a2a — one MoE layer's all-to-all dispatch traffic
# --------------------------------------------------------------------------

def _a2a_slots(experts: np.ndarray, n_experts: int,
               capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """(flat priority-ordered expert ids) -> (send-buffer slot ids, kept
    mask) through the registered ``moe_dispatch`` kernel's ``ref`` (the
    host oracle, as the reference calls it): the carry-chain arbiter's
    exclusive-count grant order, with the capacity budget applied
    (over-budget requests drop)."""
    from repro_torch.kernels import registry as _kernels
    pos, kept = _kernels.get("moe_dispatch").ref(
        None, torch.from_numpy(experts.astype(np.int32)), n_experts,
        capacity=capacity)
    pos, kept = pos.numpy(), kept.numpy().astype(bool)
    slot = np.where(kept, experts.astype(np.int64) * capacity + pos, 0)
    return slot, kept


def moe_a2a_specs(experts, n_experts: int, capacity: int,
                  d_model: int = 0) -> tuple[StreamSpec, ...]:
    """The request streams of one MoE layer's all-to-all dispatch.

    ``experts`` is the flat priority-ordered expert-id stream (GShard
    order: all first choices before second).  Streams: the router weight
    rows (when ``d_model`` is given), the expert-id store (the
    ``moe_dispatch`` stream: experts are banks), the send-buffer slot
    scatter at ``expert·capacity + grant position`` (dropped requests
    predicated off), and the combine gather reading the same slots back.
    """
    e = np.asarray(experts, np.int64).reshape(-1)
    slot, kept = _a2a_slots(e, n_experts, capacity)
    specs = []
    if d_model:
        specs.append(StreamSpec("router rows", "load", np.arange(d_model)))
    specs += [
        StreamSpec("expert dispatch", "store", e),
        StreamSpec("a2a send slots", "store", slot, kept),
        StreamSpec("a2a combine slots", "load", slot, kept),
    ]
    return tuple(specs)


def moe_a2a_trace(arch, experts, n_experts, capacity, d_model: int = 0, **_):
    return _specs_trace(arch, moe_a2a_specs(experts, n_experts, capacity,
                                            d_model),
                        meta={"kernel": "moe_a2a"})


def moe_a2a_blocks(arch, experts, n_experts, capacity, d_model: int = 0,
                   block_ops: int | None = None, **_):
    yield from _specs_blocks(arch, moe_a2a_specs(experts, n_experts,
                                                 capacity, d_model),
                             block_ops)


def moe_a2a_symbolic(arch, experts, n_experts, capacity, d_model: int = 0,
                     **_):
    return _specs_symbolic(arch, moe_a2a_specs(experts, n_experts, capacity,
                                               d_model),
                           meta={"kernel": "moe_a2a"})


def _moe_a2a_run(arch, experts, n_experts, capacity, d_model: int = 0, **_):
    """Host-side reference: (send-buffer slot per request, kept mask) under
    the arbiter's grant order and the capacity budget."""
    e = np.asarray(experts, np.int64).reshape(-1)
    return _a2a_slots(e, n_experts, capacity)


# --------------------------------------------------------------------------
# ssm_scan — one SSM layer's decode-step state-update traffic
# --------------------------------------------------------------------------

def _state_rows(batch: int, d_inner: int, ssm_state: int) -> np.ndarray:
    return np.arange(batch * d_inner, dtype=np.int64) * ssm_state


def ssm_scan_specs(batch: int, d_inner: int, ssm_state: int,
                   ssm_conv: int = 4) -> tuple[StreamSpec, ...]:
    """The request streams of one Mamba layer's O(1) decode update.

    The state matrix is (B·D_inner, N) words stored channel-row-major, so
    the channel-parallel recurrence ``h = abar·h + bbar`` touches one word
    per channel at stride ``N = ssm_state``: the strided access pattern
    banked maps exist for (N ≥ n_banks on an LSB map is fully serialized,
    exactly like the paper's transpose column stores).  Plus the rolling
    depthwise-conv window rows, the x/dt projection weight rows, and the
    output-row store, all unit-stride.
    """
    state_rows = _state_rows(batch, d_inner, ssm_state)
    return (
        StreamSpec("conv window rows", "load",
                   np.arange(batch * max(ssm_conv - 1, 1))),
        StreamSpec("x_proj rows", "load", np.arange(d_inner)),
        StreamSpec("h state read", "load", state_rows),
        StreamSpec("h state write", "store", state_rows),
        StreamSpec("ssm out rows", "store", np.arange(batch)),
    )


def ssm_scan_trace(arch, batch, d_inner, ssm_state, ssm_conv: int = 4, **_):
    return _specs_trace(arch, ssm_scan_specs(batch, d_inner, ssm_state,
                                             ssm_conv),
                        meta={"kernel": "ssm_scan"})


def ssm_scan_blocks(arch, batch, d_inner, ssm_state, ssm_conv: int = 4,
                    block_ops: int | None = None, **_):
    yield from _specs_blocks(arch, ssm_scan_specs(batch, d_inner, ssm_state,
                                                  ssm_conv), block_ops)


def ssm_scan_symbolic(arch, batch, d_inner, ssm_state, ssm_conv: int = 4,
                      **_):
    return _specs_symbolic(arch, ssm_scan_specs(batch, d_inner, ssm_state,
                                                ssm_conv),
                           meta={"kernel": "ssm_scan"})


def _ssm_scan_run(arch, batch, d_inner, ssm_state, ssm_conv: int = 4, **_):
    """Host-side reference: the stride-N state row stream the recurrence
    touches."""
    return _state_rows(batch, d_inner, ssm_state)


# --------------------------------------------------------------------------
# registration (the registry's builtin hook imports this module)
# --------------------------------------------------------------------------

register(Kernel(
    name="attn_decode", cuda=_attn_decode_run, ref=_attn_decode_run,
    trace=attn_decode_trace, blocks=attn_decode_blocks,
    symbolic=attn_decode_symbolic,
    description="transformer decode-step attention traffic (QKV/O weight "
                "rows, RoPE gather, paged-KV page gathers + appends)",
))

register(Kernel(
    name="moe_a2a", cuda=_moe_a2a_run, ref=_moe_a2a_run,
    trace=moe_a2a_trace, blocks=moe_a2a_blocks, symbolic=moe_a2a_symbolic,
    description="MoE all-to-all dispatch traffic (expert-id store + "
                "arbiter-granted send/combine slot streams)",
))

register(Kernel(
    name="ssm_scan", cuda=_ssm_scan_run, ref=_ssm_scan_run,
    trace=ssm_scan_trace, blocks=ssm_scan_blocks, symbolic=ssm_scan_symbolic,
    description="SSM decode-step state update traffic (stride-N state "
                "read-modify-write + conv window rows)",
))


# --------------------------------------------------------------------------
# whole-model decode step
# --------------------------------------------------------------------------

def resolve_model_config(config, smoke: bool = False):
    """A ``ModelConfig``, an arch id (``"llama3.2-1b"``), or a module-style
    name (``"llama3_2_1b"``) -> the ``ModelConfig`` (its ``smoke()``
    variant when ``smoke=True``)."""
    if not isinstance(config, str):
        return config
    from repro_torch import configs as _configs
    getter = _configs.get_smoke_config if smoke else _configs.get_config
    if config in _configs._MODULES:
        return getter(config)
    for arch_id, module in _configs._MODULES.items():
        if module == config:
            return getter(arch_id)
    raise KeyError(f"unknown model config {config!r}; choose from "
                   f"{tuple(_configs._MODULES)} (or module-style names "
                   f"{tuple(_configs._MODULES.values())})")


def _route_experts(rng: np.random.Generator, batch: int, n_experts: int,
                   k: int) -> np.ndarray:
    """Synthesize one decode step's top-k routing (distinct experts per
    token) in GShard priority order: all first choices before second, the
    flat stream ``moe_a2a`` dispatches."""
    choices = np.argsort(rng.random((batch, n_experts)), axis=1)[:, :k]
    return choices.T.reshape(-1).astype(np.int64)       # (k·B,) priority


def _model_step_specs(cfg, kv_cfg, page_table, positions, batch: int,
                      seed: int):
    """Generator of the whole decode step's ``StreamSpec``s, layer by layer
    in ``cfg.block_pattern()`` order (mixer, then MoE or dense FFN).
    Deterministic per seed: every replay yields identical streams, which
    is what makes ``model_step_trace`` re-iterable."""
    from repro_torch.models.moe import capacity as moe_capacity
    rng = np.random.default_rng(seed)
    pattern = cfg.block_pattern()
    layer = 0
    for _ in range(cfg.n_superblocks):
        for kind, is_moe in pattern:
            tag = f"L{layer} "
            if kind == "attn":
                specs = attn_decode_specs(page_table, positions,
                                          cfg.d_model, cfg.n_heads,
                                          kv_cfg.page_len)
            else:
                specs = ssm_scan_specs(batch, cfg.d_inner, cfg.ssm_state,
                                       cfg.ssm_conv)
            for s in specs:
                yield StreamSpec(tag + s.name, s.kind, s.idx, s.mask)
            if is_moe:
                experts = _route_experts(rng, batch, cfg.n_experts,
                                         cfg.experts_per_token)
                cap = moe_capacity(cfg, batch)
                specs = moe_a2a_specs(experts, cfg.n_experts, cap,
                                      d_model=cfg.d_model)
            else:
                specs = (StreamSpec("ffn rows", "load", np.arange(cfg.d_ff)),
                         StreamSpec("ffn out rows", "store",
                                    np.arange(batch)))
            for s in specs:
                yield StreamSpec(tag + s.name, s.kind, s.idx, s.mask)
            layer += 1


def _decode_point(cfg, arch, batch: int, prompt_len: int, page_len: int,
                  device="cuda"):
    """Shared lowering setup: resolve (config, arch), size the page pool
    from the arch's banked layout (multi-port memories price the canonical
    16-bank LSB pool, like ``simulate_serving_stream``), allocate every
    prompt page plus the decode-step page through the serving arbiter on
    ``device``, and return (cfg, resolved arch, kv_cfg, page table,
    positions)."""
    from repro_torch.core import arch as _arch
    from repro_torch.serving.kvcache import (PagedKVConfig, allocate_pages,
                                             fill_prompt_pages, pool_pages)
    cfg = resolve_model_config(cfg)
    a = _arch.resolve(arch)
    max_seq = prompt_len + 1
    lay = a.layout
    n_banks = lay.n_banks if lay is not None else 16
    kv_cfg = PagedKVConfig(
        n_pages=pool_pages(n_banks, batch, max_seq, page_len),
        page_len=page_len, n_banks=n_banks,
        mapping=lay.mapping if lay is not None else "lsb",
        map_shift=lay.shift if lay is not None else 1,
        kv_heads=1, head_dim=1)
    state = fill_prompt_pages(kv_cfg, batch, max_seq, prompt_len, device)
    need = (state.seq_lens % page_len) == 0
    state, _ = allocate_pages(kv_cfg, state, need)
    page_table = state.page_table.cpu().numpy()
    positions = np.full(batch, prompt_len, np.int64)
    return cfg, a, kv_cfg, page_table, positions


def model_step_trace(config, arch, batch: int = 4, prompt_len: int = 32,
                     page_len: int = 8, block_ops: int | None = 4096,
                     seed: int = 0, device="cuda"):
    """One whole-model decode step as a re-iterable ``TraceStream``.

    Stitches the per-layer streams (``attn_decode`` / ``ssm_scan`` mixers
    and ``moe_a2a`` / dense-FFN feed-forwards, in ``config.block_pattern()``
    order) into one lazy ``Trace``: pages come from the serving arbiter on
    ``device`` under ``arch``'s bank map (the traffic is
    architecture-DEPENDENT, so ``bench.model_workload`` re-lowers per
    layout like ``serving_workload``), routing is seeded, and instructions
    bigger than ``block_ops`` stream as ``instr_carry``-marked chunks: a
    56-layer step is constructed and costed in O(block) memory, bit-equal
    to its dense materialization.  ``meta["n_tokens"] = batch`` (one token
    per sequence per step) feeds the ``us_per_token`` tune objective.
    """
    from repro_torch.core.trace import TraceStream
    cfg, a, kv_cfg, page_table, positions = _decode_point(
        config, arch, batch, prompt_len, page_len, device)

    def blocks():
        for spec in _model_step_specs(cfg, kv_cfg, page_table, positions,
                                      batch, seed):
            yield from _specs_blocks(a, (spec,), block_ops)

    return TraceStream(blocks, meta={
        "what": "model_step", "model": cfg.name, "arch": a.name,
        "batch": batch, "prompt_len": prompt_len, "page_len": page_len,
        "n_layers": cfg.n_layers, "n_tokens": batch, "seed": seed})


def model_step_symbolic(config, arch, batch: int = 4, prompt_len: int = 32,
                        page_len: int = 8, seed: int = 0, device="cuda"):
    """The same decode step as a ``SymbolicTrace`` for the conflict prover:
    one family per instruction, derived from the very ``StreamSpec``s the
    trace is built from (pages allocated on ``device``, as
    ``model_step_trace`` allocates them), so
    ``analysis.symbolic.cross_check`` against ``model_step_trace`` is
    bit-exact by construction."""
    cfg, a, kv_cfg, page_table, positions = _decode_point(
        config, arch, batch, prompt_len, page_len, device)
    specs = tuple(_model_step_specs(cfg, kv_cfg, page_table, positions,
                                    batch, seed))
    return _specs_symbolic(a, specs, meta={
        "what": "model_step", "model": cfg.name, "arch": a.name})
