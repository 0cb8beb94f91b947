"""Architecture autotuner (port of ``repro.tune.search``).

``search`` sweeps the memory-architecture space (bank count × bank map ×
broadcast × offset-map shift, plus the multi-port family) for the cheapest
architecture on one workload, pricing its address traces streamed
block by block through ``repro_torch.core.cost_engine.cost_many`` on
``device`` (the card unless the caller passes ``device="cpu"``), the same
path as the benchmark sweep and the ISA VM, never densified.

Workloads come in three forms:

  * a ``repro_torch.bench.Workload`` (an ISA program, e.g. the paper's
    transpose/FFT builders) — priced via ``bench.run_cells``;
  * a ``repro_torch.bench.TraceWorkload`` (a per-architecture trace
    lowering, e.g. ``bench.serving_workload``'s paged-KV traffic) —
    re-lowered per lowering key and priced per group;
  * ``(kernel, args)``: any registry kernel with a ``trace`` generator plus
    its call arguments — priced over ``kernel.trace_blocks(arch, *args)``.

Strategies:

  * ``"exhaustive"`` — price every point of the space (the paper's own
    methodology: all 9 memories × every benchmark), in ONE fused
    ``cost_many`` pass per trace lowering;
  * ``"hillclimb"``  — greedy walk of the banked lattice (bank count
    doubling/halving, bank-map switch, offset shift, broadcast toggle) from
    a deterministic start, with the multi-port points always evaluated
    outright.  Each neighborhood is one engine pass.  Every evaluated point
    is returned, ranked.

Objectives: ``"time_us"`` (default; fmax-aware — the paper's Tables rank on
time, which is why 600 MHz 4R-2W can win with more cycles), ``"cycles"``,
``"area_time"`` (Fig 9 cost×performance; needs ``capacity_kb``),
``"us_per_token"`` (needs a workload whose meta carries ``n_tokens``) or
any callable ``(record, arch) -> float`` (lower is better).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.bench.runner import TraceWorkload, Workload, run_cells
from repro_torch.core import arch as _arch


@dataclass(frozen=True)
class ArchSpace:
    """The searchable architecture grid.
    ``banks``/``mappings``/``broadcast``/``map_shifts`` span the banked
    lattice; ``multiports`` are standalone points.

    ``map_shifts`` only applies to the ``offset`` map — the bank bits sit
    at ``[shift+log2B-1 : shift]`` — so other mappings contribute one point
    per (banks, mapping, broadcast) cell regardless of the shift grid.
    Shifted points are named ``{B}B-offset-s{K}`` (shift 1 keeps the
    paper's short name)."""
    banks: tuple = (4, 8, 16)
    mappings: tuple = ("lsb", "offset")
    broadcast: tuple = (False,)
    multiports: tuple = ("4R-1W", "4R-2W", "4R-1W-VB")
    map_shifts: tuple = (1,)

    @staticmethod
    def banked_name(banks: int, mapping: str, bcast: bool,
                    shift: int = 1) -> str:
        name = f"{banks}B" + ("" if mapping == "lsb" else f"-{mapping}")
        if mapping == "offset" and shift != 1:
            name += f"-s{shift}"
        return name + ("-bcast" if bcast else "")

    def _shifts(self, mapping: str) -> tuple:
        return self.map_shifts if mapping == "offset" else (1,)

    def banked_points(self) -> list:
        return [(b, m, bc, sh) for b in self.banks for m in self.mappings
                for bc in self.broadcast for sh in self._shifts(m)]

    def names(self) -> list:
        return ([self.banked_name(*p) for p in self.banked_points()]
                + list(self.multiports))

    def start_point(self) -> tuple:
        """Deterministic hillclimb start: middle of the bank grid, first
        mapping (at its first shift), no broadcast."""
        banks = sorted(self.banks)
        m = self.mappings[0]
        return (banks[len(banks) // 2], m, self.broadcast[0],
                self._shifts(m)[0])

    def neighbors(self, point: tuple) -> list:
        """Lattice moves: bank count one step up/down, any other bank map,
        offset shift one step up/down, broadcast toggled.  Deterministic
        order."""
        b, m, bc, sh = point
        banks = sorted(self.banks)
        i = banks.index(b)
        out = []
        if i + 1 < len(banks):
            out.append((banks[i + 1], m, bc, sh))
        if i > 0:
            out.append((banks[i - 1], m, bc, sh))
        out.extend((b, m2, bc, self._shifts(m2)[0])
                   for m2 in self.mappings if m2 != m)
        if m == "offset":
            shifts = sorted(self.map_shifts)
            j = shifts.index(sh)
            if j + 1 < len(shifts):
                out.append((b, m, bc, shifts[j + 1]))
            if j > 0:
                out.append((b, m, bc, shifts[j - 1]))
        out.extend((b, m, bc2, sh) for bc2 in self.broadcast if bc2 != bc)
        return out


#: the paper's own comparison surface (Tables II/III: 9 architectures)
PAPER_SPACE = ArchSpace()

#: beyond-paper grid: anti-stride maps, broadcast coalescing, wider banking,
#: shifted offset maps (the map_shift search dimension)
EXTENDED_SPACE = ArchSpace(banks=(4, 8, 16, 32),
                           mappings=("lsb", "offset", "xor", "fold"),
                           broadcast=(False, True),
                           map_shifts=(1, 2))


@dataclass(frozen=True)
class TuneResult:
    """One evaluated architecture, ranked by ``objective`` (lower =
    better)."""
    arch: str
    total_cycles: int
    time_us: float
    objective: float
    record: dict = field(default_factory=dict)

    def __repr__(self) -> str:
        return (f"TuneResult({self.arch!r}, cycles={self.total_cycles}, "
                f"time_us={self.time_us:.2f}, objective={self.objective:.4g})")


def _objective_fn(objective, capacity_kb):
    if callable(objective):
        return objective
    if objective == "time_us":
        return lambda rec, a: rec["time_us"]
    if objective == "cycles":
        return lambda rec, a: rec["total_cycles"]
    if objective == "us_per_token":
        # serving time per generated token: the record's workload meta
        # must carry ``n_tokens``
        def per_token(rec, a):
            n = rec.get("n_tokens")
            if not n:
                raise ValueError(
                    "objective='us_per_token' needs a workload whose meta "
                    "carries n_tokens (e.g. bench.scheduler_workload)")
            return rec["time_us"] / n
        return per_token
    if objective == "area_time":
        if capacity_kb is None:
            raise ValueError("objective='area_time' needs capacity_kb")
        from repro_torch.core.cost import area_time_score
        return lambda rec, a: area_time_score(a.spec, capacity_kb,
                                              rec["time_us"])
    raise ValueError(f"unknown objective {objective!r}; use 'time_us', "
                     f"'cycles', 'area_time', 'us_per_token', or a "
                     f"callable")


def _evaluator(kernel, workload, device):
    """(kernel, workload) -> batched evaluator: names -> list of tidy
    records (one fused ``cost_many`` pass per trace lowering on
    ``device``: the engine prices a whole neighborhood / space at once)."""
    if isinstance(workload, (Workload, TraceWorkload)):
        # TraceWorkloads (e.g. serving traffic) re-lower per architecture
        # (the page allocator follows the arch's bank map), grouped and
        # cached by lowering key inside run_cells, so revisits stay free
        return lambda names: run_cells(names, workload, device=device)
    if kernel is None:
        raise ValueError("pass a bench.Workload / bench.TraceWorkload, or a "
                         "kernel plus its call args as `workload`")
    if isinstance(kernel, str):
        from repro_torch.kernels import registry
        kernel = registry.get(kernel)
    args = tuple(workload) if isinstance(workload, (tuple, list)) else (
        workload,)
    # kernel traces are logical-address streams, architecture-independent
    # by design: the lazy block lowering (kernel.trace_blocks, O(block)
    # memory) is built once and priced under every point
    cached = []

    def ev_many(names) -> list:
        from repro_torch.core.cost_engine import cost_many
        arch_objs = [_arch.resolve(n) for n in names]
        if not cached:
            cached.append(kernel.trace_blocks(arch_objs[0], *args))
        costs = cost_many(arch_objs, cached[0], device=device)
        return [{"workload": kernel.name, "arch": a.name,
                 "kind": a.spec.kind, "fmax_mhz": a.fmax_mhz,
                 "total_cycles": c.total_cycles,
                 "time_us": c.time_us(a.fmax_mhz)}
                for a, c in zip(arch_objs, costs)]
    return ev_many


def search(kernel=None, workload=None, space: ArchSpace | None = None,
           strategy: str = "exhaustive", objective="time_us",
           capacity_kb: float | None = None, top_k: int | None = None,
           device="cuda") -> list:
    """Find the best memory architecture for one workload, pricing on
    ``device``.

    Returns every evaluated point as a ``TuneResult`` list ranked best-first
    (``results[0].arch`` is the winner); ``top_k`` truncates the ranking.
    """
    space = space or PAPER_SPACE
    obj = _objective_fn(objective, capacity_kb)
    ev_many = _evaluator(kernel, workload, device)

    results: dict = {}

    def visit_many(names) -> None:
        """Evaluate every not-yet-visited name in one fused engine pass
        (exhaustive = the whole space at once; hillclimb = one batch per
        neighborhood)."""
        fresh = [n for n in dict.fromkeys(names) if n not in results]
        if not fresh:
            return
        for name, rec in zip(fresh, ev_many(fresh)):
            a = _arch.resolve(name)
            results[name] = TuneResult(
                arch=name, total_cycles=int(rec["total_cycles"]),
                time_us=float(rec["time_us"]),
                objective=float(obj(rec, a)), record=rec)

    if strategy == "exhaustive":
        visit_many(space.names())
    elif strategy == "hillclimb":
        point = space.start_point()
        # the few multi-port points (always evaluated) + the start: one batch
        visit_many(list(space.multiports) + [space.banked_name(*point)])
        best = results[space.banked_name(*point)]
        while True:
            neighborhood = space.neighbors(point)
            visit_many([space.banked_name(*p) for p in neighborhood])
            moves = [(results[space.banked_name(*p)], p)
                     for p in neighborhood]
            better = [(r, p) for r, p in moves
                      if (r.objective, r.arch) < (best.objective, best.arch)]
            if not better:
                break
            best, point = min(better, key=lambda rp: (rp[0].objective,
                                                      rp[0].arch))
    else:
        raise ValueError(f"unknown strategy {strategy!r}; use 'exhaustive' "
                         f"or 'hillclimb'")

    ranked = sorted(results.values(), key=lambda r: (r.objective, r.arch))
    return ranked[:top_k] if top_k else ranked
