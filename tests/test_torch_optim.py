"""The port's data pipeline and optimizer (``repro_torch.data``,
``repro_torch.optim``) held to the JAX reference on the same numpy inputs:
``SyntheticLM`` batches token for token, ``lr_schedule`` for the three
kinds, ``adamw_update`` over three steps (with and without clipping, with
and without int8 error feedback) at rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.data.pipeline import make_batch_iterator as r_iter
from repro.optim import adamw as RA
from repro.optim.schedule import lr_schedule as r_lr
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.models.params import Leaf
from repro_torch.optim import adamw as PA
from repro_torch.optim import lr_schedule

RTOL = 1e-6


@pytest.mark.parametrize("step,shard,n_shards", [
    (0, 0, 1), (7, 0, 1), (123, 0, 2), (123, 1, 2), (5, 3, 4), (999, 2, 4)])
def test_synthetic_batches_equal_the_reference(step, shard, n_shards):
    kw = dict(vocab_size=300, seq_len=24, global_batch=8, seed=5,
              branching=3)
    got = SyntheticLM(**kw).batch(step, shard, n_shards, device="cpu")
    want = RSyntheticLM(**kw).batch(step, shard, n_shards)
    assert got["tokens"].dtype == torch.int64
    assert got["tokens"].shape == (8 // n_shards, 24)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


def test_frontend_stub_and_iterator_equal_the_reference():
    kw = dict(vocab_size=64, seq_len=8, global_batch=4, seed=2,
              frontend_tokens=3, d_model=16)
    got = SyntheticLM(**kw).batch(4, device="cpu")
    want = RSyntheticLM(**kw).batch(4)
    np.testing.assert_array_equal(got["frontend"].numpy(),
                                  np.asarray(want["frontend"]))
    ours = make_batch_iterator(SyntheticLM(**kw), start_step=2,
                               device="cpu")
    theirs = r_iter(RSyntheticLM(**kw), start_step=2)
    for _ in range(3):
        (s1, b1), (s2, b2) = next(ours), next(theirs)
        assert s1 == s2
        np.testing.assert_array_equal(b1["tokens"].numpy(),
                                      np.asarray(b2["tokens"]))
    with pytest.raises(ValueError, match="split"):
        SyntheticLM(**kw).batch_np(0, 0, 3)


@pytest.mark.parametrize("kind", ["wsd", "cosine", "const"])
def test_lr_schedule_equals_the_reference(kind):
    steps = [0, 1, 3, 9, 10, 11, 50, 89, 90, 95, 99, 100, 140]
    for warmup in (0, 10):
        got = [float(lr_schedule(torch.tensor(s, dtype=torch.int32),
                                 base_lr=3e-3, warmup=warmup, total=100,
                                 kind=kind)) for s in steps]
        want = [float(r_lr(jnp.asarray(s, jnp.int32), base_lr=3e-3,
                           warmup=warmup, total=100, kind=kind))
                for s in steps]
        np.testing.assert_allclose(got, want, rtol=RTOL)
    # python ints too, and the reference test's plateau / floor values
    assert float(lr_schedule(50, base_lr=1.0, warmup=10, total=100)) == 1.0
    assert float(lr_schedule(100, base_lr=1.0, warmup=10, total=100)) == \
        pytest.approx(0.1)


def _tree(rng, scale):
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "b": {"x": (scale * rng.standard_normal(7)).astype(np.float32),
                  "n": np.ones(3, np.float32)}}


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.array(a)), tree)


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adamw_update_equals_the_reference(grad_clip, compression):
    """Three steps from the same params and gradients: params, m, v, the
    residuals and grad_norm at rtol 1e-6 (gradients of norm ~5, so the
    clip at 1.0 acts)."""
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    r_params = jax.tree.map(jnp.asarray, params)
    p_params = _torch(params)
    zeros = lambda t: jax.tree.map(np.zeros_like, t)  # noqa: E731
    ef = zeros(params) if compression == "int8_ef" else None
    r_opt = RA.OptState(*(jax.tree.map(jnp.asarray, t) if t is not None
                          else None for t in (zeros(params), zeros(params),
                                              ef)))
    p_opt = PA.OptState(*(_torch(t) if t is not None else None
                          for t in (zeros(params), zeros(params), ef)))
    for step in range(3):
        grads = _tree(rng, 0.8)
        lr = 1e-2 * (step + 1)
        kw = dict(lr=lr, grad_clip=grad_clip, compression=compression)
        r_params, r_opt, r_met = RA.adamw_update(
            r_params, jax.tree.map(jnp.asarray, grads), r_opt, step, **kw)
        p_params, p_opt, p_met = PA.adamw_update(
            p_params, _torch(grads), p_opt, torch.tensor(step), **kw)
        np.testing.assert_allclose(float(p_met["grad_norm"]),
                                   float(r_met["grad_norm"]), rtol=RTOL)
        pairs = [(p_params, r_params), (p_opt.m, r_opt.m),
                 (p_opt.v, r_opt.v)]
        if compression == "int8_ef":
            pairs.append((p_opt.ef, r_opt.ef))
        for got, want in pairs:
            jax.tree.map(lambda g, w: np.testing.assert_allclose(
                g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-7), got, want)
    if grad_clip:
        assert float(r_met["grad_norm"]) > grad_clip


def test_adamw_updates_in_place_and_clips():
    """The trees passed in are the trees returned (the reference donates
    them); a huge gradient moves the parameters by at most lr a step."""
    p = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
    opt = PA.OptState({k: torch.zeros_like(v) for k, v in p.items()},
                      {k: torch.zeros_like(v) for k, v in p.items()}, None)
    w = p["w"]
    huge = {k: v + 1e6 for k, v in p.items()}
    p2, opt2, met = PA.adamw_update(p, huge, opt, 0, lr=0.1, grad_clip=1.0,
                                    weight_decay=0.0)
    assert p2["w"] is w and opt2.m is opt.m
    assert float(met["grad_norm"]) > 1e5          # reported before the clip
    assert float((1 - p2["w"]).abs().max()) <= 0.1 + 1e-6


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_adamw_updates_large_leaves_in_slices_bit_for_bit(monkeypatch,
                                                          compression):
    """A leaf above ``UPDATE_SLICE`` elements is updated in slices along
    its first axis, giving the whole leaf's numbers bit for bit (a leaf
    with int8 EF stays whole: its scale is the leaf's)."""
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5, 4), "b": (7,), "s": ()}

    def run(slice_elems):
        monkeypatch.setattr(PA, "UPDATE_SLICE", slice_elems)
        p = {k: torch.tensor(rng_p[k]) for k in shapes}
        g = {k: torch.tensor(rng_g[k]) for k in shapes}
        opt = PA.OptState({k: torch.tensor(rng_m[k]) for k in shapes},
                          {k: torch.tensor(rng_v[k]) for k in shapes},
                          {k: torch.zeros(shapes[k]) for k in shapes}
                          if compression == "int8_ef" else None)
        seen = []
        piece = torch.Tensor.tensor_split
        monkeypatch.setattr(torch.Tensor, "tensor_split", lambda t, n: (
            seen.append(n), piece(t, n))[1])
        out = PA.adamw_update(p, g, opt, 3, lr=1e-2, grad_clip=1.0,
                              compression=compression)
        monkeypatch.undo()
        return out, seen

    rng_p, rng_g, rng_m = ({k: rng.standard_normal(s).astype(np.float32)
                            for k, s in shapes.items()} for _ in range(3))
    rng_v = {k: rng.uniform(0.5, 1.5, s).astype(np.float32) * 1e-4
             for k, s in shapes.items()}
    whole, seen = run(1 << 28)
    assert seen == []
    sliced, seen = run(8)
    # "w" (120 elements) in one slice per row: p, g, m and v split six ways
    assert seen == ([] if compression == "int8_ef" else [6] * 4)
    for a, b in zip(jax.tree.leaves((whole[0], whole[1].m, whole[1].v)),
                    jax.tree.leaves((sliced[0], sliced[1].m, sliced[1].v))):
        assert torch.equal(a, b)


def test_int8_ef_residual_conserves_gradient():
    g = np.array([0.001, -3.0, 2.5, 0.0], np.float32)
    e = np.array([0.01, 0.0, -0.02, 0.5], np.float32)
    got = PA._quantize_int8_ef(torch.tensor(g), torch.tensor(e))
    want = RA._quantize_int8_ef(jnp.asarray(g), jnp.asarray(e))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-7)
    np.testing.assert_allclose((got[0] + got[1]).numpy(), g + e, rtol=1e-6,
                               atol=1e-7)


def test_global_norm_and_init_specs():
    rng = np.random.default_rng(3)
    t = _tree(rng, 2.0)
    np.testing.assert_allclose(float(PA.global_norm(_torch(t))),
                               float(RA.global_norm(
                                   jax.tree.map(jnp.asarray, t))), rtol=RTOL)
    specs = {"a": Leaf((3, 2), ("embed", "ffn")),
             "b": {"c": Leaf((4,), ("embed",), init="ones")}}
    none = PA.adamw_init_specs(specs, zero1=False, compression="none")
    ef = PA.adamw_init_specs(specs, zero1=False, compression="int8_ef")
    assert none.ef is None and none._fields == ("m", "v", "ef")
    for tree in (none.m, none.v, ef.ef):
        assert tree == {"a": Leaf((3, 2), ("embed", "ffn"), init="zeros"),
                        "b": {"c": Leaf((4,), ("embed",), init="zeros")}}
