from repro_torch.models.params import (Leaf, ShapeStruct, count_params,
                                       from_jax, init_tree, shape_tree,
                                       spec_tree)
from repro_torch.models.trace import (model_step_symbolic, model_step_trace,
                                      resolve_model_config)
from repro_torch.models.transformer import (cache_specs, decode_step,
                                            forward, loss_fn, model_specs,
                                            prefill)

__all__ = ["Leaf", "ShapeStruct", "cache_specs", "count_params", "from_jax",
           "init_tree", "decode_step", "forward", "loss_fn", "model_specs",
           "prefill", "model_step_trace", "model_step_symbolic",
           "resolve_model_config", "shape_tree", "spec_tree"]
