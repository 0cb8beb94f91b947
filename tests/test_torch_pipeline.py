"""The port's GPipe ring (``repro_torch.train.pipeline``) on 4 gloo
ranks, one a stage, 8 microbatches: equal on every rank to the
reference's serial stack, as tests/test_pipeline.py holds the
reference's; one stage on one rank; and the bubble accounting."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_gloo import run_ranks
from repro.train.pipeline import bubble_fraction as r_bubble
from repro_torch.train.pipeline import bubble_fraction

D = 16


@pytest.mark.parametrize("n_stages", [4, 1])
def test_pipeline_matches_serial(tmp_path, n_stages):
    """4 stages on 4 ranks; one stage, where the ring is a local copy."""
    rng = np.random.default_rng(0)
    stages = [{"w": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal(D) * 0.1).astype(np.float32)}
              for _ in range(n_stages)]
    xs = rng.standard_normal((8, 3, D)).astype(np.float32)
    want = jnp.asarray(xs)
    for st in stages:
        want = jax.vmap(lambda x: jnp.tanh(x @ st["w"] + st["b"]))(want)
    inputs = os.path.join(str(tmp_path), "inputs.npz")
    np.savez(inputs, xs=xs, **{f"{k}{s}": st[k] for s, st in
                               enumerate(stages) for k in ("w", "b")})
    out = run_ranks("pipeline", n_stages, tmp_path, inputs=inputs,
                    n_stages=n_stages)
    for rank in range(n_stages):
        got = np.load(os.path.join(out, f"rank{rank}.npy"))
        err = float(np.abs(got - np.asarray(want)).max())
        assert err < 1e-5, (rank, err)


@pytest.mark.parametrize("n_micro,n_stages", [(8, 4), (1, 1), (32, 2),
                                              (3, 5)])
def test_bubble_fraction(n_micro, n_stages):
    assert bubble_fraction(n_micro, n_stages) == r_bubble(n_micro, n_stages)
    assert bubble_fraction(8, 4) == (4 - 1) / (8 + 4 - 1)
    assert bubble_fraction(32, 2) < 0.04
