"""Serving on the PyTorch/CUDA port: the paged KV cache, the
continuous-batching scheduler and the mixed-step engine
(``flexflow_tpu/serve`` is the reference)."""

from .engine import ServeEngine, ServeSession, StepEvents
from .kv_cache import KVCacheConfig, PagedKVCache
from .scheduler import (ChunkPlan, ContinuousBatchingScheduler, Request,
                        SampleParams, StepPlan)

__all__ = ["ServeEngine", "ServeSession", "StepEvents", "KVCacheConfig",
           "PagedKVCache", "ChunkPlan", "ContinuousBatchingScheduler",
           "Request", "SampleParams", "StepPlan"]
