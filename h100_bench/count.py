"""The analytic FLOP and byte count of the served model's prefills and
decode steps, from a configuration's widths and the lanes' real contexts,
and the least time the H100 could take for each.

What is counted (bfloat16 weights and KV rows, 2 bytes an element):
  * every weight is read once a step: attention, every expert of a MoE
    layer (at 64 lanes x 2 of 16 experts an expert goes unused in a step
    with odds (14/16)^64, about 2e-4), the embedding or output head;
  * each active lane's live K/V rows up to its position are read once,
    and each new row is written once; padded pages and idle lanes are
    never counted, so the gathers' waste shows;
  * FLOPs are 2 a multiply-add: the projections, the FFN (the experts a
    token is routed to, k of them), each lane's attention over its own
    context, and the unembedding over the real vocabulary at each position
    that is sampled (every lane of a step, the last of a prompt).
Activations and norms are left out.  This module imports nothing of the
program.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12      # H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s
ELT = 2                  # bytes a bf16 element


def _sizes(cfg: dict) -> dict:
    d, h, kvh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["head_dim"] or d // h
    vp = -(-cfg["vocab_size"] // 256) * 256
    attn = d * (h + 2 * kvh) * hd + h * hd * d
    ffn1 = 3 * d * cfg["d_ff"]
    moe = cfg["family"] == "moe"
    ffn_all = (cfg["n_experts"] * ffn1 + d * cfg["n_experts"]) if moe \
        else ffn1
    ffn_tok = (cfg["experts_per_token"] * ffn1 + d * cfg["n_experts"]) \
        if moe else ffn1
    n_emb = vp * d * (1 if cfg["tie_embeddings"] else 2)
    weights = cfg["n_layers"] * (attn + ffn_all + 2 * d) + n_emb + d
    return {"d": d, "h": h, "hd": hd, "L": cfg["n_layers"],
            "V": cfg["vocab_size"], "attn": attn, "ffn_tok": ffn_tok,
            "weight_bytes": ELT * weights,
            "kv_row": 2 * kvh * hd * ELT}     # K and V of a token, a layer


def weight_bytes(cfg: dict) -> int:
    return _sizes(cfg)["weight_bytes"]


def kv_bytes_per_token(cfg: dict) -> int:
    """K and V of one token over every layer."""
    s = _sizes(cfg)
    return s["kv_row"] * s["L"]


def decode_step(cfg: dict, positions) -> tuple:
    """(FLOPs, bytes) of one decode step whose active lanes sit at
    ``positions`` (each lane's new token goes to that position and
    attends to it and every earlier one)."""
    s = _sizes(cfg)
    n = len(positions)
    ctx = sum(int(p) + 1 for p in positions)
    flops = n * s["L"] * 2 * (s["attn"] + s["ffn_tok"]) \
        + s["L"] * 4 * s["h"] * s["hd"] * ctx + n * 2 * s["d"] * s["V"]
    byts = s["weight_bytes"] + s["L"] * s["kv_row"] * (ctx - n) \
        + s["L"] * s["kv_row"] * n
    return flops, byts


def prefill(cfg: dict, length: int) -> tuple:
    """(FLOPs, bytes) of one prompt's prefill of ``length`` tokens: causal
    attention over length (length + 1) / 2 pairs, logits at the last
    position, every K/V row written."""
    s = _sizes(cfg)
    pairs = length * (length + 1) // 2
    flops = length * s["L"] * 2 * (s["attn"] + s["ffn_tok"]) \
        + s["L"] * 4 * s["h"] * s["hd"] * pairs + 2 * s["d"] * s["V"]
    byts = s["weight_bytes"] + s["L"] * s["kv_row"] * length
    return flops, byts


def least_seconds(flops: float, byts: float) -> float:
    """The least time the chip could take: whichever roof binds."""
    return max(flops / PEAK_FLOPS, byts / PEAK_BYTES)
