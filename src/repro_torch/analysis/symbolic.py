"""Symbolic bank-conflict prover (port of ``repro.analysis.symbolic``) —
the second, independent timing oracle.

The cost engine *observes* conflict cycles by simulating address streams;
this module *proves* them from closed-form descriptions of the streams.
A kernel (or ISA program generator) describes its traffic as a small set of
**lane families**: every memory operation of a family requests

    addr(lane j) = const + Σ_i coeff_i·x_i                       (outer part)
                 + stride·((Σ_k mcoeff_k·y_k + moff_j) mod modulus)  (inner)
                 + off_j                                         (lane part)

with multi-indices ``x``/``y`` ranging over fixed extents (an affine base
set) and a fixed 16-entry lane-offset vector — exactly the shape of the
paper's transpose/FFT address equations (the inner ``mod`` part exists for
the FFT's twiddle index ``(q·i·step) mod n``).  The prover pushes families
through the engine's own generic bank formula (``cost_engine._spec_paths``:
``bank = (((a>>sh) ^ (a>>xsh)) + (a>>ash)) mod B``, plus
``B·((a // G) mod O)`` for two-level macro hierarchies) analytically:

  * the bank of an address depends only on ``addr mod M`` with
    ``M = B·2^(max real shift)`` (lcm'd with ``G·O`` for two-level) — each
    ``(a>>s) mod B`` term is determined by ``a mod B·2^s``, XOR/ADD both
    factor through ``mod M``, and so does the macro term through
    ``mod G·O``; non-power-of-two B and hierarchical maps prove through
    the same residue argument (see ``_bank_modulus``);
  * the base sum's residues mod M are counted by a per-term cyclic DP
    (``coeff·x mod M`` is periodic with period ``M / gcd(coeff, M)``;
    multi-index terms combine by cyclic convolution), so a million-op
    family reduces to at most M weighted *representative* operations;
  * per-representative conflicts are then evaluated exactly — max per-bank
    popcount via an independent bincount algorithm, NOT the engine's
    lane-pair equality matrix — and weighted by the residue multiplicity.

The result is a full ``TraceCost`` **and** per-family max-conflict bounds
("16B-xor transpose 64×64 loads are conflict-free", "lsb is 16-way
serialized on column stores"), both bit-exactly comparable against
``cost_many`` on the same trace: ``cross_check`` makes the two oracles
mutually validating (the ``--prove`` pass of ``python -m
repro_torch.analysis`` runs it on the Table II/III points).  The prover is
host arithmetic in numpy; ``cross_check(..., device=)`` prices the engine's
side on the card unless the caller passes ``"cpu"``, so on a card it holds
the card's engine to the host's proof.  Data-dependent streams
(gather/scatter indices, arbiter request words) fall back to
``DataFamily`` — exact enumeration of the concrete op matrix, still
through the independent bincount conflict algorithm.

Broadcast coalescing is provable because same-address lane pairs within an
op are base-independent: ``addr_j == addr_j'`` reduces to equality of the
lane parts, so one first-occurrence mask per representative suffices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Union

import numpy as np

from repro_torch.core.cost_engine import _spec_paths
from repro_torch.core.memsim import LANES, TraceCost
from repro_torch.core.trace import KIND_LOAD, KIND_STORE, KIND_TW, as_ops
from repro_torch.kernels.registry import host_array

__all__ = ["AffineFamily", "DataFamily", "SymbolicTrace", "FamilyProof",
           "ArchProof", "prove", "prove_many", "cross_check",
           "affine_from_indices"]

_KIND_CODES = {"load": KIND_LOAD, "store": KIND_STORE, "tw": KIND_TW}
_LANE_RANGE = tuple(range(LANES))


# --------------------------------------------------------------------------
# Family descriptions
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AffineFamily:
    """One closed-form run of memory operations (see module docstring).

    ``terms`` are the outer multi-index ``((coeff, extent), ...)`` — every
    combination of indices is one operation; ``offsets`` is the 16-lane
    offset vector.  The optional inner part (``modulus``/``mod_terms``/
    ``mod_offsets``/``stride``) models an index reduced mod a power of two
    *inside* the address computation (FFT twiddles).  ``n_instructions``
    instructions of the family's kind span its operations (controller
    overhead is charged per instruction); ``mask`` predicates lanes off
    uniformly across the family (None = all active)."""
    name: str
    kind: str                              # "load" | "store" | "tw"
    const: int = 0
    terms: tuple = ()                      # ((coeff, extent), ...)
    offsets: tuple = _LANE_RANGE
    n_instructions: int = 1
    mask: tuple | None = None              # 16 bools, uniform per op
    modulus: int | None = None             # power of two
    mod_terms: tuple = ()
    mod_offsets: tuple = (0,) * LANES
    stride: int = 1

    def __post_init__(self):
        if self.kind not in _KIND_CODES:
            raise ValueError(f"unknown kind {self.kind!r}")
        if len(self.offsets) != LANES or len(self.mod_offsets) != LANES:
            raise ValueError("offset vectors must have 16 lanes")
        if self.modulus is not None and self.modulus & (self.modulus - 1):
            raise ValueError(f"modulus must be a power of two, got "
                             f"{self.modulus}")

    @property
    def n_ops(self) -> int:
        n = 1
        for _, extent in self.terms:
            n *= extent
        if self.modulus is not None:
            for _, extent in self.mod_terms:
                n *= extent
        return n


@dataclass(frozen=True)
class DataFamily:
    """A data-dependent run of operations given by its concrete op matrix
    (gather/scatter index streams, arbiter request words): no closed form,
    but still proved through the independent bincount conflict algorithm —
    the cross-check against the engine stays a two-oracle comparison."""
    name: str
    kind: str
    addrs: np.ndarray                      # (n_ops, LANES) int
    mask: np.ndarray | None = None         # (n_ops, LANES) bool
    n_instructions: int = 1

    def __post_init__(self):
        object.__setattr__(self, "addrs",
                           np.asarray(self.addrs, np.int64).reshape(-1, LANES))
        if self.mask is not None:
            object.__setattr__(self, "mask",
                               np.asarray(self.mask, bool).reshape(-1, LANES))
        if self.kind not in _KIND_CODES:
            raise ValueError(f"unknown kind {self.kind!r}")

    @property
    def n_ops(self) -> int:
        return self.addrs.shape[0]


Family = Union[AffineFamily, DataFamily]


@dataclass(frozen=True)
class SymbolicTrace:
    """A whole workload's traffic as families + the compute-side metadata
    needed to assemble full ``TraceCost`` rows.  Produced by each kernel's
    ``symbolic_trace`` / the ISA generators' ``symbolic_trace``; consumed
    by ``prove``."""
    families: tuple = ()
    compute_cycles: int = 0
    op_counts: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    @property
    def n_ops(self) -> int:
        return sum(f.n_ops for f in self.families)


# --------------------------------------------------------------------------
# Residue-multiplicity DP
# --------------------------------------------------------------------------

def _residue_counts(const: int, terms, M: int) -> np.ndarray:
    """Multiplicity vector mu over Z_M of ``const + Σ coeff_i·x_i`` with
    ``0 <= x_i < extent_i``: per term, ``coeff·x mod M`` cycles with period
    ``M / gcd(coeff, M)`` (full cycles weight every cycle residue equally,
    the remainder weights a prefix); terms combine by cyclic convolution.
    Exact integer counting — a million-op family costs O(M·nnz) here."""
    mu = np.zeros(M, np.int64)
    mu[const % M] = 1
    for coeff, extent in terms:
        c = coeff % M
        term = np.zeros(M, np.int64)
        if c == 0 or extent <= 0:
            term[0] = max(extent, 0)
        else:
            period = M // math.gcd(c, M)
            q, r = divmod(extent, period)
            vals = (c * np.arange(min(period, extent), dtype=np.int64)) % M
            if q:
                term[vals] += q
            if r:
                term[vals[:r]] += 1
        # cyclic convolution, driven by the (sparse) term support
        new = np.zeros(M, np.int64)
        for v in np.nonzero(term)[0]:
            new += term[v] * np.roll(mu, v)
        mu = new
    return mu


def _bank_modulus(path) -> int:
    """The modulus M the path's bank function factors through: bank(a)
    depends only on ``a mod M``.

    Single-level: ``M = B · 2^(max real shift)`` — each ``(a>>s) mod B``
    term is determined by ``a mod B·2^s`` (write ``a = q·B·2^s + r``:
    ``(a>>s) = q·B + (r>>s)`` exactly, since ``r < B·2^s`` splits cleanly
    at bit s, and ``q·B`` vanishes mod B).  For power-of-two B this is the
    historical ``2^(log2B + top)``; 31 is the engine's no-shift sentinel —
    those terms read nothing.

    Two-level adds the macro term ``(a // G) mod O``, which factors
    through ``a mod G·O`` by the same split; the composite factors through
    ``lcm`` of the two moduli."""
    (_, nb, sh, xsh, ash, _, _, outb, outg) = (int(v) for v in path)
    top = max([s for s in (sh, xsh, ash) if s != 31], default=0)
    M = nb << top
    if outb > 1:
        M = math.lcm(M, outg * outb)
    return M


def _representatives(fam: AffineFamily, M: int) -> tuple:
    """(reps, mults): representative (N, LANES) address vectors and their
    op multiplicities — conflict-equivalent to enumerating every op."""
    outer = _residue_counts(fam.const, fam.terms, M)
    r_out = np.nonzero(outer)[0]
    off = np.asarray(fam.offsets, np.int64)
    if fam.modulus is None:
        reps = r_out[:, None] + off[None, :]
        return reps, outer[r_out]
    inner = _residue_counts(0, fam.mod_terms, fam.modulus)
    r_in = np.nonzero(inner)[0]
    moff = np.asarray(fam.mod_offsets, np.int64)
    lane = fam.stride * ((r_in[:, None] + moff[None, :]) % fam.modulus)
    reps = (r_out[:, None, None] + lane[None, :, :]
            + off[None, None, :]).reshape(-1, LANES)
    mults = (outer[r_out][:, None] * inner[r_in][None, :]).reshape(-1)
    return reps, mults


# --------------------------------------------------------------------------
# Exact per-op conflict evaluation (independent of the engine's algorithm)
# --------------------------------------------------------------------------

def _first_occurrence_np(addrs: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Numpy twin of ``repro_torch.core.conflicts.first_occurrence``: 1 for the
    first ACTIVE lane requesting each distinct address (broadcast mask)."""
    eq = addrs[:, :, None] == addrs[:, None, :]
    lower = np.tril(np.ones((LANES, LANES), bool), k=-1)
    shadowed = (eq & active[:, None, :] & lower).any(axis=-1)
    return ~shadowed & active


def _op_cycles(reps: np.ndarray, active: np.ndarray, path) -> np.ndarray:
    """(N, LANES) representative addresses -> (N,) memory cycles per op
    under one lowered path row [use_banked, n_banks, sh, xsh, ash,
    use_uniq, ports, outer_banks, outer_granule].  Banked conflicts come
    from a per-bank bincount (an algorithm independent of the engine's
    lane-pair equality matrix, so the cross-check compares two distinct
    computations).  Non-power-of-two bank counts use the ``% B`` form and
    two-level rows add the macro term — both proved through the same
    residue argument (see ``_bank_modulus``)."""
    (use_banked, nb, sh, xsh, ash, use_uniq, ports,
     outb, outg) = (int(v) for v in path)
    n = reps.shape[0]
    if not use_banked:
        return -(-active.sum(axis=-1) // ports)
    eff = active
    if use_uniq:
        eff = _first_occurrence_np(reps, active)
    M = _bank_modulus(path)
    a = reps % M                        # bank() factors through mod M
    raw = ((a >> sh) ^ (a >> xsh)) + (a >> ash)
    bank = raw & (nb - 1) if nb & (nb - 1) == 0 else raw % nb
    n_banks = nb
    if outb > 1:
        bank = bank + nb * ((a // outg) % outb)
        n_banks = nb * outb
    flat = (bank + np.arange(n, dtype=np.int64)[:, None] * n_banks)[eff]
    counts = np.bincount(flat, minlength=n * n_banks).reshape(n, n_banks)
    return counts.max(axis=1)


# --------------------------------------------------------------------------
# Proof assembly
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FamilyProof:
    """One family's proven conflict bounds under one architecture."""
    name: str
    kind: str
    n_ops: int
    n_instructions: int
    max_cycles: int          # proven per-op maximum (the conflict bound)
    min_cycles: int
    total_cycles: int        # Σ per-op cycles, no controller overhead

    @property
    def conflict_free(self) -> bool:
        """Every op of the family retires in one memory cycle."""
        return self.max_cycles <= 1

    @property
    def serialization(self) -> int:
        """Worst-case lane serialization (the paper's B-way figure)."""
        return self.max_cycles

    def __repr__(self) -> str:
        tag = "conflict-free" if self.conflict_free else (
            f"≤{self.max_cycles}-way")
        return (f"FamilyProof({self.name!r}, {self.kind}, ops={self.n_ops}, "
                f"{tag})")


@dataclass(frozen=True)
class ArchProof:
    """Everything proved about one workload under one architecture: the
    per-family bounds plus the assembled ``TraceCost`` (bit-comparable to
    ``cost_many`` on the equivalent trace)."""
    arch: str
    proofs: tuple
    cost: TraceCost

    def family(self, name: str) -> FamilyProof:
        for p in self.proofs:
            if p.name == name:
                return p
        raise KeyError(f"no family {name!r}; have "
                       f"{[p.name for p in self.proofs]}")

    def __repr__(self) -> str:
        return (f"ArchProof({self.arch!r}, families="
                f"{len(self.proofs)}, total={self.cost.total_cycles})")


def _family_proof(fam: Family, path) -> FamilyProof:
    if isinstance(fam, AffineFamily):
        M = _bank_modulus(path)
        reps, mults = _representatives(fam, M)
        if fam.mask is None:
            active = np.ones_like(reps, bool)
        else:
            active = np.broadcast_to(np.asarray(fam.mask, bool), reps.shape)
        cyc = _op_cycles(reps, active, path)
        total = int((cyc * mults).sum())
        mx, mn = (int(cyc.max()), int(cyc.min())) if cyc.size else (0, 0)
    else:
        active = (np.ones_like(fam.addrs, bool) if fam.mask is None
                  else fam.mask)
        cyc = _op_cycles(fam.addrs, active, path)
        total = int(cyc.sum())
        mx, mn = (int(cyc.max()), int(cyc.min())) if cyc.size else (0, 0)
    return FamilyProof(name=fam.name, kind=fam.kind, n_ops=fam.n_ops,
                       n_instructions=fam.n_instructions,
                       max_cycles=mx, min_cycles=mn, total_cycles=total)


def prove(arch, symbolic: SymbolicTrace) -> ArchProof:
    """Prove one workload's conflict behaviour under one architecture.

    Pushes every family through the SAME lowered parameters the batched
    engine uses (``cost_engine._spec_paths``), but evaluates them
    analytically over residue representatives.  The returned
    ``ArchProof.cost`` equals ``cost_many([arch], trace)[0]`` bit-exactly
    for the trace the families describe — ``cross_check`` asserts it.
    """
    from repro_torch.core import arch as _arch
    a = _arch.resolve(arch)
    if getattr(a.spec, "dead_banks", ()):
        # Degraded ``!d`` variants remap conflict groups through a surviving-
        # bank table AFTER the bank formula — the residue-class argument the
        # prover rests on (bank as a pure function of address bits) no longer
        # holds, so there is no symbolic story to tell.  Price degraded
        # layouts through the engine (cost_many / arch.cost) instead.
        raise NotImplementedError(
            f"prove() does not support degraded architectures ({a.name}): "
            f"the surviving-bank remap breaks the residue-class bank model; "
            f"use cost_many / arch.cost for degraded pricing")
    read, write, (r_ovh, w_ovh) = _spec_paths(a.spec)

    proofs = []
    cyc = {KIND_LOAD: 0, KIND_STORE: 0, KIND_TW: 0}
    ops = {KIND_LOAD: 0, KIND_STORE: 0, KIND_TW: 0}
    instrs = {KIND_LOAD: 0, KIND_STORE: 0, KIND_TW: 0}
    for fam in symbolic.families:
        code = _KIND_CODES[fam.kind]
        path = write if code == KIND_STORE else read
        p = _family_proof(fam, path)
        proofs.append(p)
        cyc[code] += p.total_cycles
        ops[code] += p.n_ops
        instrs[code] += p.n_instructions

    # the engine's assembly rules: per-instruction controller overhead per
    # kind (twiddle loads are reads), kinds with no ops report 0
    oc = symbolic.op_counts
    cost = TraceCost(
        load_cycles=(cyc[KIND_LOAD] + instrs[KIND_LOAD] * r_ovh
                     if ops[KIND_LOAD] else 0),
        store_cycles=(cyc[KIND_STORE] + instrs[KIND_STORE] * w_ovh
                      if ops[KIND_STORE] else 0),
        tw_load_cycles=(cyc[KIND_TW] + instrs[KIND_TW] * r_ovh
                        if ops[KIND_TW] else 0),
        compute_cycles=int(symbolic.compute_cycles),
        n_load_ops=ops[KIND_LOAD], n_store_ops=ops[KIND_STORE],
        n_tw_ops=ops[KIND_TW],
        fp_ops=int(oc.get("fp", 0)), int_ops=int(oc.get("int", 0)),
        imm_ops=int(oc.get("imm", 0)), other_ops=int(oc.get("other", 0)))
    return ArchProof(arch=a.name, proofs=tuple(proofs), cost=cost)


def prove_many(archs, symbolic: SymbolicTrace) -> list:
    """``prove`` over an architecture list (the prover's ``cost_many``)."""
    return [prove(a, symbolic) for a in archs]


def cross_check(archs, symbolic: SymbolicTrace, trace,
                block_ops: int | None = None, device="cuda") -> list:
    """The two-oracle comparison: prove ``symbolic`` (on the host) AND cost
    ``trace`` with ``cost_many`` on ``device`` under every architecture,
    asserting full bit-exact ``TraceCost`` equality (cycles per kind, op
    counts, compute buckets).  Raises ``AssertionError`` naming the first
    diverging field; returns the ``ArchProof`` list on success."""
    from repro_torch.core.cost_engine import cost_many
    proofs = prove_many(archs, symbolic)
    engine = cost_many(archs, trace, block_ops=block_ops, device=device)
    for proof, cost in zip(proofs, engine):
        if proof.cost != cost:
            diffs = [f"{f}: proved {getattr(proof.cost, f)} != engine "
                     f"{getattr(cost, f)}"
                     for f in ("load_cycles", "store_cycles",
                               "tw_load_cycles", "compute_cycles",
                               "n_load_ops", "n_store_ops", "n_tw_ops",
                               "fp_ops", "int_ops", "imm_ops", "other_ops")
                     if getattr(proof.cost, f) != getattr(cost, f)]
            raise AssertionError(
                f"prover/engine divergence under {proof.arch}: "
                + "; ".join(diffs))
    return proofs


# --------------------------------------------------------------------------
# Stream -> family helpers
# --------------------------------------------------------------------------

def affine_from_indices(idx, kind: str, name: str,
                        mask=None) -> Family:
    """A flat row-index request stream as a family: arithmetic progressions
    (constant stride, whole ops, no mask) get an exact closed-form
    ``AffineFamily``; anything data-dependent falls back to the exact
    ``DataFamily`` enumeration.  Mirrors ``registry.row_stream_trace`` —
    one stream = one instruction.  ``idx`` and ``mask`` may be arrays or
    tensors (on any device; they come to the host here)."""
    a = np.asarray(host_array(idx), np.int64).reshape(-1)
    if mask is None and a.size >= LANES and a.size % LANES == 0:
        d = np.diff(a)
        if d.size == 0 or (d == d[0]).all():
            step = int(d[0]) if d.size else 0
            return AffineFamily(
                name=name, kind=kind, const=int(a[0]),
                terms=((step * LANES, a.size // LANES),),
                offsets=tuple(step * j for j in range(LANES)))
    ops = as_ops(a)
    m = None
    if mask is not None:
        m = np.asarray(host_array(mask), bool).reshape(-1)
        pad = ops.size - m.size
        if pad:                        # ragged tail: padded lanes inactive
            m = np.concatenate([m, np.zeros(pad, bool)])
        m = m.reshape(ops.shape)
    return DataFamily(name=name, kind=kind, addrs=ops, mask=m)
