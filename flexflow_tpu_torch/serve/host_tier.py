"""Host-RAM tier below the device page pool (hierarchical prefix
cache); a copy of ``flexflow_tpu/serve/host_tier.py`` (numpy only).

`HostPageStore` holds spilled KV pages as host numpy bytes in the KV
storage dtype plus the f32 scale rows — exactly the per-page layout
`ServeEngine.export_kv` produces — keyed by the same chain-hash page
keys the HBM prefix registry uses. Instead of a refcount-0 hashed page
under pressure being discarded (its prefix recomputed from tokens),
`PagedKVCache` queues its identity here and the engine DMAs the bytes
out through the existing fixed-shape export program; a later prefix
match re-imports through the fixed-shape import scatter — zero new
compiles either way.

The store is byte-budgeted (`--host-tier-mb`) with its own LRU, and is
shared: `ReplicaPool` builds ONE store for every replica so a tenant's
preamble crosses HBM once per replica instead of once per request. The
wall-clock fabric steps replicas on worker threads, so every method
takes the store lock.

Whether a host hit is worth reloading at all is NOT decided here — the
scheduler prices DMA-vs-recompute per chunk through the machine
model's `host_transfer` (see ServeEngine._host_reload); the
store only answers "which keys do I hold".
"""

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import threading

import numpy as np


class HostPageStore:
    """Byte-budgeted host-RAM LRU of spilled KV pages, chain-key keyed.

    Each entry is the tuple of per-pool page rows export_kv yields for
    one page: `(k, v)` at the storage dtype for unquantized pools, or
    `(k, v, k_scale, v_scale)` with f32 scale rows for int8/fp8 pools
    (shapes `(num_layers, page_size, num_heads, head_dim)` for values,
    minus `head_dim` for scales). The port hands bf16 rows over as a
    uint16 view and fp8 rows as a uint8 view (numpy has neither type). The first `put` pins the geometry
    signature (shapes + dtypes); mismatching entries are rejected so a
    shared store can never hand a replica rows its import program
    cannot scatter (replicas in a pool share one model geometry).
    """

    def __init__(self, budget_mb: float = 256.0):
        if budget_mb <= 0:
            raise ValueError(f"host tier budget must be > 0 MB "
                             f"(got {budget_mb})")
        self.budget_bytes = int(budget_mb * (1 << 20))
        self._lock = threading.Lock()
        self._pages: "OrderedDict[bytes, Tuple[np.ndarray, ...]]" = \
            OrderedDict()          # key -> per-pool page rows, LRU order
        self._bytes = 0
        self._sig: Optional[Tuple] = None
        self.stats: Dict[str, int] = {
            "spills": 0,       # pages stored (puts accepted)
            "reloads": 0,      # pages handed back for HBM re-import
            "hits": 0,         # keys found by match_chain/contains
            "misses": 0,       # keys probed but absent
            "evictions": 0,    # pages dropped by the byte-budget LRU
            "rejects": 0,      # puts refused (geometry / oversized)
        }

    # ---------------- geometry ----------------------------------------
    @staticmethod
    def _signature(rows: Sequence[np.ndarray]) -> Tuple:
        return tuple((tuple(r.shape), str(r.dtype)) for r in rows)

    @staticmethod
    def _nbytes(rows: Sequence[np.ndarray]) -> int:
        return int(sum(int(r.nbytes) for r in rows))

    # ---------------- writes ------------------------------------------
    def put(self, key: bytes, rows: Sequence[np.ndarray]) -> bool:
        """Store one spilled page's rows under its chain key. Copies
        the rows (callers hand views over export buffers), refreshes
        LRU position on re-put, and evicts from the LRU end until the
        byte budget holds. Returns False when the entry is rejected
        (geometry drift, or a single page larger than the budget)."""
        rows = tuple(np.ascontiguousarray(r) for r in rows)
        sig = self._signature(rows)
        nbytes = self._nbytes(rows)
        with self._lock:
            if self._sig is None:
                self._sig = sig
            elif sig != self._sig:
                self.stats["rejects"] += 1
                return False
            if nbytes > self.budget_bytes:
                self.stats["rejects"] += 1
                return False
            old = self._pages.pop(key, None)
            if old is not None:
                self._bytes -= self._nbytes(old)
            self._pages[key] = rows
            self._bytes += nbytes
            while self._bytes > self.budget_bytes and self._pages:
                _, dropped = self._pages.popitem(last=False)
                self._bytes -= self._nbytes(dropped)
                self.stats["evictions"] += 1
            self.stats["spills"] += 1
            return True

    # ---------------- reads -------------------------------------------
    def get(self, key: bytes) -> Optional[Tuple[np.ndarray, ...]]:
        """The rows for one key (LRU-touched), or None. Counts as a
        reload — callers fetch only when actually re-importing."""
        with self._lock:
            rows = self._pages.get(key)
            if rows is None:
                self.stats["misses"] += 1
                return None
            self._pages.move_to_end(key)
            self.stats["hits"] += 1
            self.stats["reloads"] += 1
            return rows

    def contains(self, key: bytes) -> bool:
        with self._lock:
            return key in self._pages

    def match_chain(self, keys: Sequence[bytes]) -> int:
        """Longest PREFIX run of `keys` resident in the store — the
        host-tier mirror of `PagedKVCache.match_prefix` (chain hashes
        make any gap unmatchable, so only the leading run counts).
        Touches matched keys to MRU; counts one hit/miss per probe."""
        n = 0
        with self._lock:
            for key in keys:
                if key not in self._pages:
                    if n < len(keys):
                        self.stats["misses"] += 1
                    break
                self._pages.move_to_end(key)
                self.stats["hits"] += 1
                n += 1
        return n

    def probe_chain(self, keys: Sequence[bytes]) -> int:
        """Pure observation for the router's affinity probe: the
        longest resident prefix run WITHOUT LRU-touching or stat
        counting — `route()` must not perturb the store (only an
        actual admission-time match should refresh recency)."""
        n = 0
        with self._lock:
            for key in keys:
                if key not in self._pages:
                    break
                n += 1
        return n

    # ---------------- maintenance -------------------------------------
    def discard(self, keys: Sequence[bytes]) -> int:
        """Drop entries (e.g. a pool reset invalidating content).
        Returns the number removed; not counted as budget evictions."""
        removed = 0
        with self._lock:
            for key in keys:
                rows = self._pages.pop(key, None)
                if rows is not None:
                    self._bytes -= self._nbytes(rows)
                    removed += 1
        return removed

    def clear(self) -> None:
        with self._lock:
            self._pages.clear()
            self._bytes = 0

    # ---------------- introspection -----------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._pages)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def report(self) -> Dict[str, object]:
        """The host-tier block of serve stats / reports."""
        with self._lock:
            return {
                "pages": len(self._pages),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "occupancy": (self._bytes / self.budget_bytes
                              if self.budget_bytes else 0.0),
                **{k: int(v) for k, v in self.stats.items()},
            }

    def debug_state(self, max_keys: int = 32) -> Dict[str, object]:
        """Post-mortem view: occupancy plus a bounded LRU-ordered key
        sample (hex, oldest first) so a flight-recorder dump shows what
        was spilled and what the budget was about to drop."""
        with self._lock:
            keys = list(self._pages)
            return {
                "pages": len(keys),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "stats": {k: int(v) for k, v in self.stats.items()},
                "lru_keys": [k.hex()[:16] for k in keys[:max_keys]],
                "lru_truncated": max(0, len(keys) - max_keys),
            }
