"""Banked paged-KV serving on torch (port of ``repro.serving``)."""
from repro_torch.serving.engine import GenerationResult, ServeEngine
from repro_torch.serving.kvcache import (PagedKVConfig, simulate_serving_stream,
                                         simulate_serving_trace)

__all__ = ["GenerationResult", "ServeEngine", "PagedKVConfig",
           "simulate_serving_stream", "simulate_serving_trace"]
