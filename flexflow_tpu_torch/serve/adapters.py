"""Tenant identity of the prefix cache (``flexflow_tpu/serve/adapters.py``).

The port serves the base model only; the LoRA slab pool is not ported
yet. What the scheduler needs from the adapter module is the chain-key
salt, copied here so the port's prefix keys equal the JAX package's.
"""

from __future__ import annotations

import hashlib


def tenant_prefix_salt(tenant_id: int) -> bytes:
    """Seed of a tenant's prefix-cache chain (kv_cache.
    prefix_page_keys ``prev``): tenant 0 (the base model) keeps the
    empty seed — its pages stay shareable with every unarmed engine —
    while an adapted tenant's chain starts from a digest of its
    identity, so equal token content under different adapters hashes
    to DISJOINT keys (adapted K/V is a function of the adapter, and a
    cross-tenant page hit would hand one tenant another's cache)."""
    t = int(tenant_id)
    if t == 0:
        return b""
    return hashlib.sha256(b"adapter-tenant:%d" % t).digest()
