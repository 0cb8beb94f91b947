"""The plain reference: the dense transformer of the benchmark's
configurations in float32 plain PyTorch (TF32 off), and its control, the
same model computed in fp8.

It takes the parameter tree the benchmark made (bfloat16 leaves, the
program's key names, each block's leaves stacked over layers) and token
sequences, and returns float32 logits.  It runs layer by layer over every
sequence at once, each layer's weights upcast when it comes, so that a
model whose float32 copy would not fit the card still runs.  It imports
nothing of the program.

The equations (per layer): RMSNorm, rotary attention with grouped K/V
heads and a causal mask, a residual; RMSNorm, then the gated SiLU MLP and
a residual.  Then a final RMSNorm and the unembedding (tied to the
embedding or not) over the real vocabulary.

The control (``fp8=True``) is this reference put in the program's place
and computed in float8 e4m3, the precision below the configuration's
bfloat16: every tensor the program holds in bfloat16 is rounded to fp8
where the program rounds it (the weights, a scale per output channel;
the residual stream, the norms' outputs, every matmul's output and the
K/V rows, a scale per row), products accumulating in float32 and the
softmaxes in float32, as the program's.
"""
from __future__ import annotations

import math

import torch

F8_MAX = 448.0


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a scale per slice along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Mm:
    """Float32 arithmetic, or the control's: each stored tensor rounded to
    fp8 (``r``) and each matmul's output too."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (in, out) weight upcast, rounded per output column in fp8."""
        w = w.float()
        return _q8(w, 0) if self.fp8 else w

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """A stored activation: rounded per row (last dim) in fp8."""
        return _q8(x, -1) if self.fp8 else x

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.r(x @ w)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, hd) at positions 0..S-1; rotates the two halves."""
    s, hd = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(cfg: dict, params: dict, seqs: list, n_out: list, *,
           fp8: bool = False) -> list:
    """Logits (n_out[i], vocab) at the last ``n_out[i]`` positions of each
    int64 sequence ``seqs[i]`` (on the parameters' device)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits(cfg, params, seqs, n_out, fp8)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _logits(cfg, params, seqs, n_out, fp8):
    mm = _Mm(fp8)
    d, h, kvh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["head_dim"] or d // h
    g = h // kvh
    if cfg["family"] != "dense":
        raise ValueError(f"no reference for the {cfg['family']} family")
    eps = cfg["norm_eps"]
    lens = [len(s) for s in seqs]
    edges = [0] + list(torch.tensor(lens).cumsum(0).tolist())
    x = mm.r(params["embed"][torch.cat(seqs)].float())
    blk = params["blocks"]["b0"]
    for layer in range(cfg["n_layers"]):
        p = {name: leaf[layer] for name, leaf in blk["mixer"].items()}
        a = mm.r(rmsnorm(x, blk["ln1"][layer], eps))
        q = mm(a, mm.weight(p["wq"].reshape(d, h * hd))).reshape(-1, h, hd)
        k = mm(a, mm.weight(p["wk"].reshape(d, kvh * hd))).reshape(-1, kvh,
                                                                    hd)
        v = mm(a, mm.weight(p["wv"].reshape(d, kvh * hd))).reshape(-1, kvh,
                                                                    hd)
        o = torch.empty_like(q)
        for i in range(len(seqs)):
            s0, s1 = edges[i], edges[i + 1]
            qi = mm.r(rope(q[s0:s1], cfg["rope_theta"]))
            ki = mm.r(rope(k[s0:s1], cfg["rope_theta"]))
            vi = v[s0:s1]
            n = s1 - s0
            qi = qi.reshape(n, kvh, g, hd)
            sc = torch.einsum("skgh,tkh->kgst", qi, ki) / math.sqrt(hd)
            causal = torch.ones(n, n, dtype=torch.bool,
                                device=x.device).tril()
            sc = sc.masked_fill(~causal, float("-inf"))
            pr = torch.softmax(sc, dim=-1)
            o[s0:s1] = mm.r(torch.einsum("kgst,tkh->skgh", mm.r(pr),
                                         vi).reshape(n, h, hd))
        x = mm.r(x + mm(o.reshape(-1, h * hd),
                        mm.weight(p["wo"].reshape(h * hd, d))))
        a = mm.r(rmsnorm(x, blk["ln2"][layer], eps))
        f = blk["ffn"]
        x = mm.r(x + _mlp(mm, a, f["w1"][layer], f["w3"][layer],
                          f["w2"][layer]))
    head = params["embed"].t() if cfg["tie_embeddings"] \
        else params["lm_head"]
    rows = torch.cat([x[edges[i + 1] - n_out[i]:edges[i + 1]]
                      for i in range(len(seqs))])
    rows = mm.r(rmsnorm(rows, params["final_norm"], eps))
    out = rows @ mm.weight(head[:, :cfg["vocab_size"]])
    return list(out.split(n_out))


def _mlp(mm: _Mm, a, w1, w3, w2) -> torch.Tensor:
    u = mm.r(torch.nn.functional.silu(mm(a, mm.weight(w1)))
             * mm(a, mm.weight(w3)))
    return mm(u, mm.weight(w2))


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each served token's reference logit lies below the
    reference's best at its position (inf for an id outside the
    vocabulary)."""
    inside = (tokens >= 0) & (tokens < ref.shape[1])
    got = ref.gather(1, tokens.clamp(0, ref.shape[1] - 1)[:, None])[:, 0]
    return torch.where(inside, ref.max(1).values - got,
                       torch.full_like(got, float("inf")))
