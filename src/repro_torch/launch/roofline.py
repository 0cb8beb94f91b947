"""Roofline analysis: three terms per (arch x shape x mesh) from the dry
run's artifacts (port of ``repro.launch.roofline``, with the H100's
constants).

  compute    = FLOPs_adj / peak_FLOPs_per_card                [s]
  memory     = bytes_adj / HBM_bw                             [s]
  collective = collective_bytes_adj / link_bw                 [s]

Every input is a per-device quantity (a rank's shards, its rows and its
collectives' output bytes), so no further division by the card count is
needed.  An artifact names its shape cell and, where the cell was cut,
its ``seq_len`` and ``global_batch``.  It keeps the reference's
two-compile form, ``adj = full + (block_multiplier - 1) x block``; the
port's dry run traces the whole step into ``full`` and leaves ``block``
empty, so ``adj`` is the whole step's count.

MODEL_FLOPS uses 6·N·D (train) / 2·N·D (prefill/decode) with N = *active*
params (MoE) and D = global tokens; the ratio MODEL_FLOPS / (FLOPs_adj x
cards) shows how much of the counted compute is useful (remat recompute,
MoE dispatch einsums, and attention, which 6·N·D excludes, all lower it).

Hardware constants: one NVIDIA H100 SXM, from NVIDIA's H100 data sheet.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from repro_torch.configs import SHAPES, get_config

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
# NVIDIA H100 SXM data sheet: NVLink, 900 GB/s both ways, one direction
LINK_BW = 450e9
# NVIDIA H100 SXM data sheet: 80 GB of device memory
HBM_BYTES = 80e9


def adjusted(artifact: dict, key_full: str, key_block: str | None = None):
    n_sb = artifact.get("block_multiplier", artifact["n_superblocks"])
    full = artifact["full"]
    block = artifact.get("block", {})

    def get(d, dotted):
        for part in dotted.split("."):
            d = d.get(part, 0.0) if isinstance(d, dict) else 0.0
        return float(d or 0.0)

    key_block = key_block or key_full
    return get(full, key_full) + (n_sb - 1) * get(block, key_block)


def model_flops(arch: str, shape_name: str, kind: str, seq_len: int,
                global_batch: int) -> float:
    cfg = get_config(arch)
    n = cfg.param_counts()["active"]
    if kind == "train":
        return 6.0 * n * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n * seq_len * global_batch
    return 2.0 * n * global_batch  # decode: one token per sequence


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float        # bytes-accessed bound (every op's operands and
                           # results, no fusion -> UPPER bound)
    memory_lb_s: float     # resident-bytes bound (args+outputs+temps touched
                           # once -> LOWER bound); the card lies between
    collective_s: float
    model_flops: float
    hlo_flops_adj: float
    useful_ratio: float
    fits_hbm: bool
    arg_gib: float
    temp_gib: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def dominant_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant_opt(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_lb_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def dominant_opt_s(self) -> float:
        return max(self.compute_s, self.memory_lb_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs time over the pessimistic bound."""
        useful = self.model_flops / self.chips / PEAK_FLOPS
        return useful / self.dominant_s if self.dominant_s else 0.0

    @property
    def roofline_fraction_opt(self) -> float:
        """Useful-FLOPs time over the fused/optimistic bound; the card's
        score brackets in [fraction, fraction_opt]."""
        useful = self.model_flops / self.chips / PEAK_FLOPS
        return useful / self.dominant_opt_s if self.dominant_opt_s else 0.0

    def decode_latency_ms(self, shape) -> float | None:
        """Decode cells are latency-bound: per-token step latency (ms) from
        the dominant bound, assuming perfect overlap of the other terms."""
        if shape.kind != "decode":
            return None
        return self.dominant_s * 1e3

    def decode_tokens_per_s(self, shape) -> float | None:
        if shape.kind != "decode":
            return None
        return shape.global_batch / self.dominant_s if self.dominant_s else 0.0

    def bottleneck_hint(self) -> str:
        if self.dominant == "collective":
            return ("shrink weight all-gathers (bigger per-device shards, "
                    "overlap with compute) or re-split TP/FSDP axes")
        if self.dominant == "memory":
            return ("cut bytes: fewer remat passes, fused CE, smaller "
                    "saved-carry stacks (microbatching)")
        return ("compute-bound — raise useful_ratio (less remat recompute, "
                "leaner MoE dispatch) to convert counted FLOPs into model "
                "FLOPs")


def cell_roofline(artifact: dict) -> Roofline | None:
    if "error" in artifact:
        return None
    shape = SHAPES[artifact["shape"]]
    seq = artifact.get("seq_len", shape.seq_len)
    batch = artifact.get("global_batch", shape.global_batch)
    flops = adjusted(artifact, "flops")
    bytes_ = adjusted(artifact, "bytes_accessed")
    coll = adjusted(artifact, "collectives.total")
    mf = model_flops(artifact["arch"], shape.name, artifact["kind"], seq,
                     batch)
    mem = artifact["full"].get("memory", {})
    arg = mem.get("argument_bytes", 0)
    out = mem.get("output_bytes", 0)
    temp = mem.get("temp_bytes", 0)
    return Roofline(
        arch=artifact["arch"], shape=shape.name, mesh=artifact["mesh"],
        chips=artifact["chips"],
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_ / HBM_BW,
        memory_lb_s=(arg + out + temp) / HBM_BW,
        collective_s=coll / LINK_BW,
        model_flops=mf,
        hlo_flops_adj=flops,
        useful_ratio=mf / max(flops * artifact["chips"], 1.0),
        fits_hbm=(arg + temp) < HBM_BYTES,
        arg_gib=arg / 2 ** 30,
        temp_gib=temp / 2 ** 30,
    )


def load_artifacts(artifact_dir: str, mesh: str = "single") -> list[dict]:
    out = []
    for f in sorted(os.listdir(artifact_dir)):
        if f.endswith(f"__{mesh}.json"):
            with open(os.path.join(artifact_dir, f)) as fh:
                out.append(json.load(fh))
    return out


def report(artifact_dir: str, mesh: str = "single") -> str:
    lines = ["| arch | shape | compute s | mem s (ub/lb) | collective s | "
             "dominant | useful | frac (pess/opt) | fits 80G | hint |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for art in load_artifacts(artifact_dir, mesh):
        r = cell_roofline(art)
        if r is None:
            lines.append(f"| {art['arch']} | {art['shape']} | ERROR "
                         f"| | | | | | | |")
            continue
        lines.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.4f} "
            f"| {r.memory_s:.3f}/{r.memory_lb_s:.3f} "
            f"| {r.collective_s:.4f} | **{r.dominant}** "
            f"| {r.useful_ratio:.2f} "
            f"| {r.roofline_fraction:.2f}/{r.roofline_fraction_opt:.2f} "
            f"| {'Y' if r.fits_hbm else 'N'} | {r.bottleneck_hint()} |")
    return "\n".join(lines)
