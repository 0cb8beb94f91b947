from repro_torch.models.params import (Leaf, count_params, from_jax,
                                       init_tree)
from repro_torch.models.transformer import decode_step, model_specs, prefill

__all__ = ["Leaf", "count_params", "from_jax", "init_tree", "decode_step",
           "model_specs", "prefill"]
