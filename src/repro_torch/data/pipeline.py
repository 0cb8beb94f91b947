"""Deterministic, shard-aware synthetic data pipeline (port of
``repro.data.pipeline``).

Batches are a pure function of (seed, step, host_shard): stateless, so a
restarted job resumes mid-stream with no iterator checkpoint.  The token
stream is a seeded first-order Markov chain over the vocab, so small models
visibly learn (loss falls toward the chain's conditional entropy).  The
numbers are drawn with numpy from the reference's seeds in the reference's
order, so every batch is equal, token for token, to the reference's; it
becomes tensors on the ``device`` the caller names (tokens as int64, the
index dtype torch prefers).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4      # out-degree of the Markov chain (entropy knob)
    frontend_tokens: int = 0
    d_model: int = 0        # for frontend embedding stubs

    def _chain(self) -> np.ndarray:
        """(V, branching) allowed successors, seeded & static."""
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.vocab_size,
                            size=(self.vocab_size, self.branching))

    def batch_np(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Global batch for one step (host-sharded slice if n_shards > 1)
        as numpy arrays: ``tokens`` (b, seq_len) int32 and, with frontend
        tokens, ``frontend`` (b, frontend_tokens, d_model) float32."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        chain = self._chain()
        toks = np.empty((b, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=b)
        choices = rng.integers(0, self.branching, size=(b, self.seq_len))
        for t in range(1, self.seq_len):
            toks[:, t] = chain[toks[:, t - 1], choices[:, t]]
        out = {"tokens": toks}
        if self.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (b, self.frontend_tokens, self.d_model)).astype(np.float32)
        return out

    def batch(self, step: int, shard: int = 0, n_shards: int = 1,
              device="cuda") -> dict:
        """``batch_np`` as tensors on ``device``."""
        out = self.batch_np(step, shard, n_shards)
        batch = {"tokens": torch.from_numpy(out["tokens"]).to(
            device, torch.int64)}
        if "frontend" in out:
            batch["frontend"] = torch.from_numpy(out["frontend"]).to(device)
        return batch


def make_batch_iterator(ds: SyntheticLM, start_step: int = 0, shard: int = 0,
                        n_shards: int = 1, device="cuda"):
    step = start_step
    while True:
        yield step, ds.batch(step, shard, n_shards, device)
        step += 1
