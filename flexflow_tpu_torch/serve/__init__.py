"""Serving on the PyTorch/CUDA port: the paged KV cache, the
continuous-batching scheduler, the mixed-step engine with LoRA adapters
and the host tier, the disaggregated prefill/decode cluster with its
socket transport, and the multi-replica router on its virtual and wall
clocks with its traffic harness (``flexflow_tpu/serve`` is the reference)."""

from .adapters import (AdapterConfig, AdapterPool, make_tenant_adapters,
                       merge_adapter_params, tenant_prefix_salt)
from .disagg import (DisaggCluster, PageShipment, engine_for,
                     normalize_on_step)
from .engine import (ServeEngine, ServeSession, StepEvents,
                     probe_serve_arch)
from .host_tier import HostPageStore
from .kv_cache import KVCacheConfig, PagedKVCache, prefix_page_keys
from .router import Autoscaler, Replica, ReplicaPool
from .scheduler import (ChunkPlan, ContinuousBatchingScheduler, Request,
                        SampleParams, StepPlan)
from .traffic import (TrafficRequest, TrafficSpec, make_traffic,
                      rescale_arrivals, tenant_prefixes)

__all__ = ["ServeEngine", "ServeSession", "StepEvents", "KVCacheConfig",
           "PagedKVCache", "prefix_page_keys", "ChunkPlan",
           "ContinuousBatchingScheduler", "Request", "SampleParams",
           "StepPlan", "AdapterConfig", "AdapterPool",
           "make_tenant_adapters", "merge_adapter_params",
           "tenant_prefix_salt", "PageShipment", "DisaggCluster",
           "engine_for", "normalize_on_step", "probe_serve_arch",
           "HostPageStore",
           "Autoscaler", "Replica", "ReplicaPool", "TrafficRequest",
           "TrafficSpec", "make_traffic", "rescale_arrivals",
           "tenant_prefixes"]
