"""The analytic count against hand arithmetic for one layer."""
import pytest

from h100_bench import count

ONE = {"family": "dense", "n_layers": 1, "d_model": 8, "n_heads": 2,
       "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 100,
       "tie_embeddings": True, "n_experts": 0, "experts_per_token": 0}


def test_one_dense_layer_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8: 192; MLP 3 x 8 x 16 = 384; norms 2 x 8;
    # embedding 256 x 8 (vocab padded to 256) tied; final norm 8
    weights = 192 + 384 + 16 + 256 * 8 + 8
    assert count.weight_bytes(ONE) == 2 * weights
    kv_row = 2 * 1 * 4 * 2                 # K and V, one head of 4, bf16
    assert count.kv_bytes_per_token(ONE) == kv_row
    # two lanes at positions 3 and 5: 4 + 6 keys
    flops, byts = count.decode_step(ONE, [3, 5])
    assert flops == 2 * 2 * (192 + 384) + 4 * 2 * 4 * (4 + 6) \
        + 2 * 2 * 8 * 100
    assert byts == 2 * weights + kv_row * (3 + 5) + kv_row * 2
    # a prompt of 5: 15 causal pairs, logits at the last position
    flops, byts = count.prefill(ONE, 5)
    assert flops == 5 * 2 * (192 + 384) + 4 * 2 * 4 * 15 + 2 * 8 * 100
    assert byts == 2 * weights + kv_row * 5


def test_moe_reads_every_expert_and_computes_k():
    moe = dict(ONE, family="moe", n_experts=4, experts_per_token=2,
               tie_embeddings=False)
    weights = 192 + 4 * 384 + 8 * 4 + 16 + 2 * 256 * 8 + 8
    assert count.weight_bytes(moe) == 2 * weights
    flops, _ = count.decode_step(moe, [0])
    assert flops == 2 * (192 + 2 * 384 + 8 * 4) + 4 * 2 * 4 * 1 \
        + 2 * 8 * 100


def test_the_binding_roof():
    assert count.least_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert count.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name,params,kv", [("minicpm-2b", 2.72e9, 368640)])
def test_the_cells_sizes(name, params, kv):
    import json
    from pathlib import Path
    cfg = json.loads((Path(__file__).parent / "configs" / f"{name}.json")
                     .read_text())["model"]
    assert count.weight_bytes(cfg) / 2 == pytest.approx(params, rel=0.01)
    assert count.kv_bytes_per_token(cfg) == kv
