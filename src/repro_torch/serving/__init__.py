"""Banked paged-KV serving on torch (port of ``repro.serving``).

``ServeEngine`` runs batched prefill + decode with its KV cache in banked
page pools (``kvcache``), every decode step's KV traffic through the
paired row kernels, and records each step's ``AddressTrace`` for
``cost_many``.  ``append_token`` / ``gather_kv`` on a ``PagedKVState``
are the plain-torch oracle the row kernels are held to.
``serving.scheduler`` adds the continuous-batching control plane (request
queues, a free-bitmap ``PagePool`` with a preferred-bank policy, whole
serving days lowered to the streaming ``Trace`` protocol);
``ServeEngine.run_scheduler`` drives the same schedule lane-ragged against
the model.
"""
from repro_torch.serving.engine import (GenerationResult, SchedulerRunResult,
                                        ServeEngine)
from repro_torch.serving.kvcache import (ALLOC_POLICIES, PagedKVConfig,
                                         PagedKVState, PageTableState,
                                         allocate_pages, append_token,
                                         bank_load_stats, decode_step_trace,
                                         gather_kv, gather_pages, init_pages,
                                         init_state, pool_pages,
                                         prefill_trace, preferred_banks,
                                         resolve_policy, scatter_pages,
                                         simulate_serving_stream,
                                         simulate_serving_trace)
from repro_torch.serving.scheduler import (PagePool, Request, Scheduler,
                                           scheduler_step_trace,
                                           simulate_scheduler_stream,
                                           synthesize_requests)

__all__ = [
    "ServeEngine", "GenerationResult", "SchedulerRunResult",
    "PagedKVConfig", "PagedKVState", "PageTableState",
    "pool_pages", "init_pages", "init_state", "allocate_pages",
    "append_token", "gather_kv", "bank_load_stats",
    "gather_pages", "scatter_pages",
    "decode_step_trace", "prefill_trace", "simulate_serving_trace",
    "simulate_serving_stream",
    "ALLOC_POLICIES", "preferred_banks", "resolve_policy",
    "Request", "Scheduler", "PagePool", "scheduler_step_trace",
    "simulate_scheduler_stream", "synthesize_requests",
]
