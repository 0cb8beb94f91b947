from repro_torch.models.params import (Leaf, count_params, from_jax,
                                       init_tree, spec_tree)
from repro_torch.models.trace import (model_step_symbolic, model_step_trace,
                                      resolve_model_config)
from repro_torch.models.transformer import (decode_step, forward, loss_fn,
                                            model_specs, prefill)

__all__ = ["Leaf", "count_params", "from_jax", "init_tree", "decode_step",
           "forward", "loss_fn", "model_specs", "prefill",
           "model_step_trace", "model_step_symbolic",
           "resolve_model_config", "spec_tree"]
