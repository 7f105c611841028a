"""Multi-tenant LoRA adapter pool for the one mixed serving step; the
port's copy of ``flexflow_tpu/serve/adapters.py``.

Each tenant's fine-tune is a low-rank delta: per adapted projection W,
a pair (A, B) of rank r << min(W.shape) applied as

    y = x @ W + (x @ A) @ B * scale

Every resident tenant's (A, B) pairs live in fixed device slabs, and
each lane of the mixed step gathers ITS tenant's pair by slot index, so
a tenant-heterogeneous batch decodes in one fixed-shape step, token for
token the merged-weight server's (:func:`merge_adapter_params`).

The pool is managed like the paged KV pool (kv_cache.py): the slabs
have a fixed geometry (``adapter_rank``, padding exact: zero rows add
exactly 0.0), slot 0 is the reserved zero slab of the base model,
slots are free, cached (refcount 0, in an LRU) or mapped, a miss loads
into a free slot or evicts the least recently parked tenant, and an
adapter that cannot take a slot blocks admission (a stall the scheduler
reports). ``adapter_pool_mb`` sizes the slot count by bytes.

This module is host bookkeeping only (slot states, refcounts, the
tenant registry, pending loads, the rank-padded host weights). The
engine allocates the device slabs once; a load copies one tenant's rows
into its slot in place, outside any captured step, so a captured mixed
step reads every load (serve/engine.py ``_drain_adapter_loads``).

Tenant identity also salts the prefix-cache chain keys
(:func:`tenant_prefix_salt`): two tenants with the same prompt never
share pages, and tenant 0 keeps the unsalted chain.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

# the adapted projections, in slab order: per layer, qkv (stacked),
# the attention output, and the two FFN matmuls
ADAPTER_SLABS = ("a_qkv", "b_qkv", "a_wo", "b_wo",
                 "a_ff1", "b_ff1", "a_ff2", "b_ff2")


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


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """Geometry of the adapter slab pool. Built from FFConfig + model
    shape via :meth:`from_ff` (config.py adapter_rank /
    adapter_pool_mb) so the engine, the scheduler's admission gate,
    the memory ledger, and the placement search all size from the
    same knobs.

    ``ff_dim`` here is the ENGINE's ff width (the JAX engine's is
    padded to its tensor degree; the port serves one device).
    ``num_slots`` includes the reserved zero slot 0 (the base model),
    mirroring the KV pool's sink page 0."""

    num_layers: int
    hidden: int
    num_heads: int
    head_dim: int
    ff_dim: int
    rank: int = 8
    num_slots: int = 9  # including the reserved base slot 0
    act_itemsize: int = 4
    tensor_parallel: int = 1

    @classmethod
    def from_ff(cls, config, *, num_layers: int, hidden: int,
                num_heads: int, head_dim: int, ff_dim: int,
                act_itemsize: int = 4,
                tensor_parallel: int = 1) -> "AdapterConfig":
        rank = int(getattr(config, "adapter_rank", 0))
        pool_mb = float(getattr(config, "adapter_pool_mb", 0.0) or 0.0)
        tp = max(1, int(tensor_parallel))
        max_seqs = int(getattr(config, "serve_max_seqs", 8))
        num_slots = 1 + max_seqs
        if pool_mb > 0:
            # byte-budget sizing, the kv_pool_mb idiom: the slot count
            # follows the per-DEVICE slab bytes, so a sharded pool
            # holds more tenants at the same per-chip budget
            probe = cls(num_layers=num_layers, hidden=hidden,
                        num_heads=num_heads, head_dim=head_dim,
                        ff_dim=ff_dim, rank=rank, num_slots=2,
                        act_itemsize=act_itemsize, tensor_parallel=tp)
            num_slots = 1 + max(1, int(pool_mb * (1 << 20))
                                // probe.slot_device_bytes)
        return cls(num_layers=num_layers, hidden=hidden,
                   num_heads=num_heads, head_dim=head_dim,
                   ff_dim=ff_dim, rank=rank, num_slots=num_slots,
                   act_itemsize=act_itemsize, tensor_parallel=tp)

    # ---------------- byte accounting ----------------------------------
    @property
    def usable_slots(self) -> int:
        return self.num_slots - 1  # minus the reserved base slot

    def _params_replicated(self) -> int:
        """Per-slot elements of the slabs that stay REPLICATED under
        tensor sharding: the A factors contracted from replicated
        activations (a_qkv, a_ff1) and the B factors producing
        replicated outputs (b_wo, b_ff2)."""
        L, E, r = self.num_layers, self.hidden, self.rank
        return L * (3 * E * r + r * E + E * r + r * E)

    def _params_sharded(self) -> int:
        """Per-slot elements that shard with the program: B factors on
        the head axis (b_qkv) / padded ff axis (b_ff1), A factors
        contracting the sharded head (a_wo) / ff (a_ff2) dims."""
        L, r = self.num_layers, self.rank
        H, D, F = self.num_heads, self.head_dim, self.ff_dim
        return L * (3 * r * H * D + H * D * r + r * F + F * r)

    @property
    def slot_bytes(self) -> int:
        """Device bytes ONE slot costs unsharded: every A/B element at
        the activation itemsize plus the f32 per-slot scale."""
        return (self._params_replicated() + self._params_sharded()) \
            * self.act_itemsize + 4

    @property
    def slot_device_bytes(self) -> int:
        """Per-device bytes of one slot under the serve mesh: the
        head/ff-sharded components divide by the tensor degree, the
        rank-side components replicate."""
        t = max(1, self.tensor_parallel)
        return (self._params_replicated()
                + self._params_sharded() // t) * self.act_itemsize + 4

    @property
    def pool_bytes(self) -> int:
        return self.num_slots * self.slot_bytes

    @property
    def pool_device_bytes(self) -> int:
        return self.num_slots * self.slot_device_bytes

    def validate(self) -> None:
        if self.rank < 1:
            raise ValueError(
                f"adapter_rank must be >= 1 to arm the pool, got "
                f"{self.rank}")
        if self.num_slots < 2:
            raise ValueError(
                f"adapter pool needs >= 2 slots (slot 0 is the "
                f"reserved base-model zero slab), got {self.num_slots}"
                f" — raise --adapter-pool-mb")
        t = max(1, self.tensor_parallel)
        if self.num_heads % t != 0:
            raise ValueError(
                f"sharded adapter slabs need num_heads "
                f"({self.num_heads}) divisible by the tensor degree "
                f"({t})")
        if self.ff_dim % t != 0:
            raise ValueError(
                f"adapter slabs carry the PADDED ff width; {self.ff_dim}"
                f" is not divisible by the tensor degree ({t})")


def _weight_shapes(cfg: AdapterConfig, rank: int, ff: int
                   ) -> Dict[str, tuple]:
    """Expected host-weight shapes at a given (rank, ff width)."""
    L, E = cfg.num_layers, cfg.hidden
    H, D = cfg.num_heads, cfg.head_dim
    return {
        "a_qkv": (L, 3, E, rank), "b_qkv": (L, 3, rank, H, D),
        "a_wo": (L, H, D, rank), "b_wo": (L, rank, E),
        "a_ff1": (L, E, rank), "b_ff1": (L, rank, ff),
        "a_ff2": (L, ff, rank), "b_ff2": (L, rank, E),
    }


class AdapterPool:
    """Host-side slot allocator + tenant registry for the adapter
    slabs (module docstring). Every usable slot (1..num_slots-1) is in
    exactly one of three states:

      free    — unassigned, in ``_free`` (LIFO: warmest reuse first)
      cached  — assigned to a tenant, refcount 0, in the LRU
                (resident; a returning tenant re-attaches for free;
                evictable when a new tenant needs the slot)
      mapped  — refcount > 0 (that many ADMITTED requests of the
                tenant are running; the scheduler acquires at
                admission and releases at finish/abort/preempt)

    ``acquire`` returning a slot may enqueue a PENDING device load
    (the miss path); the session drains :meth:`take_pending` through
    the engine's in-place slot load before the next dispatch — the
    stall is planning-visible (``stats["loads"]``), never a new
    capture. The class never touches device memory."""

    def __init__(self, cfg: AdapterConfig):
        cfg.validate()
        self.cfg = cfg
        self._free: List[int] = list(range(cfg.num_slots - 1, 0, -1))
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._ref = np.zeros((cfg.num_slots,), dtype=np.int64)
        self._slot_of_tenant: Dict[int, int] = {}
        self._tenant_of_slot: Dict[int, int] = {}
        # tenant -> (rank+ff padded host weights, scale): the source
        # of truth a (re)load copies to the device slab
        self._host: Dict[int, Tuple[Dict[str, np.ndarray], float]] = {}
        # slot -> tenant awaiting a device load (dict, not list: a
        # slot evicted and reassigned before its drain must load the
        # LAST tenant only)
        self._pending: "OrderedDict[int, int]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "loads": 0,
                      "evictions": 0, "releases": 0,
                      "blocked_admissions": 0, "max_slot_refs": 0}

    # ---------------- tenant registry ----------------------------------
    def register(self, tenant_id: int, weights: Dict[str, np.ndarray],
                 *, scale: float = 1.0, ff_dim: Optional[int] = None
                 ) -> None:
        """Register a tenant's adapter weights (host copy, padded to
        the pool rank and the engine's padded ff width — zero padding
        is exact). `weights` carries the true-rank arrays at the
        MODEL's ff width (`ff_dim`, defaulting to the pool's); shapes
        are validated against :func:`_weight_shapes`. Re-registering
        a RESIDENT tenant is refused — its slab would go stale."""
        t = int(tenant_id)
        if t < 1:
            raise ValueError(
                f"tenant ids are >= 1 (0 is the base model), got {t}")
        if t in self._slot_of_tenant:
            raise ValueError(
                f"tenant {t} is resident; evict it before replacing "
                f"its adapter")
        missing = [k for k in ADAPTER_SLABS if k not in weights]
        if missing:
            raise ValueError(f"adapter weights missing {missing}")
        rank = int(weights["a_qkv"].shape[-1])
        if not 1 <= rank <= self.cfg.rank:
            raise ValueError(
                f"adapter rank {rank} exceeds the pool rank "
                f"{self.cfg.rank} (fixed slab geometry)")
        ff = int(ff_dim if ff_dim is not None else self.cfg.ff_dim)
        expect = _weight_shapes(self.cfg, rank, ff)
        padded: Dict[str, np.ndarray] = {}
        full = _weight_shapes(self.cfg, self.cfg.rank, self.cfg.ff_dim)
        for key in ADAPTER_SLABS:
            arr = np.asarray(weights[key], dtype=np.float32)
            if arr.shape != expect[key]:
                raise ValueError(
                    f"adapter {key} shape {arr.shape} != "
                    f"{expect[key]}")
            out = np.zeros(full[key], dtype=np.float32)
            out[tuple(slice(0, s) for s in arr.shape)] = arr
            padded[key] = out
        self._host[t] = (padded, float(scale))

    def registered(self) -> Tuple[int, ...]:
        return tuple(sorted(self._host))

    def host_weights(self, tenant_id: int
                     ) -> Tuple[Dict[str, np.ndarray], float]:
        """(rank/ff-padded weights, scale) of a registered tenant —
        what the engine's load program copies into the slab."""
        return self._host[int(tenant_id)]

    # ---------------- capacity / residency queries ---------------------
    @property
    def free_slots(self) -> int:
        """ACQUIRABLE slots: truly free plus cached-but-unreferenced
        (the LRU is evicted on demand by acquire)."""
        return len(self._free) + len(self._lru)

    def resident(self, tenant_id: int) -> bool:
        """Whether the tenant holds a slot (mapped or LRU-parked) —
        the router's adapter-affinity signal: routing here skips the
        load stall."""
        return int(tenant_id) == 0 \
            or int(tenant_id) in self._slot_of_tenant

    def slot_of(self, tenant_id: int) -> int:
        """The lane gather index of a tenant (0 = the base slab)."""
        t = int(tenant_id)
        return 0 if t == 0 else self._slot_of_tenant[t]

    def ref(self, slot: int) -> int:
        return int(self._ref[slot])

    # ---------------- admission lifecycle ------------------------------
    def acquire(self, tenant_id: int) -> Optional[int]:
        """Admission-side attach: bump the tenant's refcount and
        return its slot, loading into a free/evicted slot on a miss
        (the pending device load). Returns None when every usable
        slot is mapped by OTHER running tenants — the caller must
        block admission (head-of-line stall), exactly like KV page
        exhaustion. Tenant 0 is the base model: always slot 0, never
        counted."""
        t = int(tenant_id)
        if t == 0:
            return 0
        if t not in self._host:
            raise KeyError(
                f"tenant {t} has no registered adapter (register() "
                f"before submitting its requests)")
        slot = self._slot_of_tenant.get(t)
        if slot is not None:
            if self._ref[slot] == 0:
                self._lru.pop(slot, None)
            self.stats["hits"] += 1
        else:
            if self._free:
                slot = self._free.pop()
            elif self._lru:
                slot, _ = self._lru.popitem(last=False)
                self._evict_slot(slot)
                self.stats["evictions"] += 1
            else:
                self.stats["blocked_admissions"] += 1
                return None
            self._slot_of_tenant[t] = slot
            self._tenant_of_slot[slot] = t
            self._pending[slot] = t
            self.stats["misses"] += 1
            self.stats["loads"] += 1
        self._ref[slot] += 1
        self.stats["max_slot_refs"] = max(self.stats["max_slot_refs"],
                                          int(self._ref[slot]))
        return slot

    def release(self, tenant_id: int) -> None:
        """Finish/abort/preempt-side detach: the refcount drops; a
        slot reaching 0 parks in the LRU — still loaded, so the
        tenant's next request re-attaches without a load."""
        t = int(tenant_id)
        if t == 0:
            return
        slot = self._slot_of_tenant[t]
        if self._ref[slot] <= 0:
            raise RuntimeError(
                f"release of tenant {t} (slot {slot}) below zero refs")
        self._ref[slot] -= 1
        self.stats["releases"] += 1
        if self._ref[slot] == 0:
            self._lru[slot] = None  # most-recently parked

    def _evict_slot(self, slot: int) -> None:
        old = self._tenant_of_slot.pop(slot)
        del self._slot_of_tenant[old]
        self._pending.pop(slot, None)  # a never-drained load is moot

    def take_pending(self) -> List[Tuple[int, int]]:
        """Drain the pending device loads as [(slot, tenant)] — the
        session runs these through the engine's slot load BEFORE the
        next mixed dispatch (a lane must never gather a
        slab its tenant hasn't landed in)."""
        out = list(self._pending.items())
        self._pending.clear()
        return out

    # ---------------- reports ------------------------------------------
    def pool_report(self) -> Dict[str, object]:
        """The adapter-pool block of serve_report / last_stats."""
        c = self.cfg
        return {
            "rank": c.rank,
            "usable_slots": c.usable_slots,
            "resident_tenants": len(self._slot_of_tenant),
            "registered_tenants": len(self._host),
            "bytes_per_slot": c.slot_bytes,
            "pool_bytes": c.pool_bytes,
            "tensor_parallel": c.tensor_parallel,
            "bytes_per_slot_device": c.slot_device_bytes,
            "pool_device_bytes": c.pool_device_bytes,
            "occupancy": 1.0 - self.free_slots / c.usable_slots,
        }

    def debug_state(self) -> dict:
        """Bounded JSON-ready snapshot for the failure flight recorder
        (the PagedKVCache.debug_state idiom)."""
        mapped = int(np.count_nonzero(self._ref[1:]))
        return {
            "usable_slots": self.cfg.usable_slots,
            "free_slots": len(self._free),
            "parked_slots": len(self._lru),
            "mapped_slots": mapped,
            "acquirable_slots": self.free_slots,
            "rank": self.cfg.rank,
            "resident": {str(t): int(s) for t, s in
                         sorted(self._slot_of_tenant.items())},
            "pending_loads": len(self._pending),
            "max_slot_ref": int(self._ref.max()) if mapped else 0,
            "stats": dict(self.stats),
        }

    # ---------------- invariant checks (tests) -------------------------
    def check_invariants(self) -> None:
        """Property-style asserts: the free/cached/mapped states
        partition the usable slots, refcounts are consistent, the
        tenant registry is a bijection over assigned slots, pending
        loads target assigned slots, and the base slot is untouched."""
        c = self.cfg
        assert int(self._ref[0]) == 0, "base slot 0 acquired refs"
        assert 0 not in self._tenant_of_slot, "base slot 0 assigned"
        free, lru = set(self._free), set(self._lru)
        assert len(free) == len(self._free), "free list has duplicates"
        assert not (free & lru), "slot both free and cached"
        for s in range(1, c.num_slots):
            r = int(self._ref[s])
            assert r >= 0, f"slot {s} refcount {r} negative"
            states = (s in free) + (s in lru) + (r > 0)
            assert states == 1, (
                f"slot {s} in {states} states (free={s in free}, "
                f"cached={s in lru}, refs={r})")
            assert (s in self._tenant_of_slot) == (s not in free), (
                f"slot {s} assignment inconsistent with free state")
        assert len(free) + len(lru) + int(
            np.count_nonzero(self._ref[1:])) == c.usable_slots, (
            "slot leak: states do not partition the pool")
        assert len(self._slot_of_tenant) == len(self._tenant_of_slot), (
            "tenant registry is not a bijection")
        for t, s in self._slot_of_tenant.items():
            assert self._tenant_of_slot.get(s) == t, (
                f"tenant {t} <-> slot {s} maps inconsistently")
            assert t in self._host, (
                f"resident tenant {t} has no registered weights")
        for s, t in self._pending.items():
            assert self._tenant_of_slot.get(s) == t, (
                f"pending load of slot {s} targets tenant {t} but the "
                f"slot is assigned to {self._tenant_of_slot.get(s)}")


# ---------------- synthetic tenants + the merged-weight oracle ---------
def make_tenant_adapters(*, num_layers: int, hidden: int,
                         num_heads: int, head_dim: int, ff_dim: int,
                         rank: int, tenants: int, seed: int = 0,
                         scale: float = 0.5
                         ) -> Dict[int, Tuple[Dict[str, np.ndarray],
                                              float]]:
    """Seeded synthetic per-tenant adapters {tenant_id: (weights,
    scale)} for tenants 1..`tenants` at the MODEL's (unpadded) ff
    width. Both factors are nonzero (unlike the train-time B=0 init)
    so every tenant visibly steers the logits — which is what the
    parity and goodput gates need — at magnitudes (~1/sqrt(fan-in))
    that keep the adapted forward numerically tame."""
    out: Dict[int, Tuple[Dict[str, np.ndarray], float]] = {}
    L, E, H, D, F = num_layers, hidden, num_heads, head_dim, ff_dim
    shapes = {
        "a_qkv": ((L, 3, E, rank), E), "b_qkv": ((L, 3, rank, H, D), rank),
        "a_wo": ((L, H, D, rank), H * D), "b_wo": ((L, rank, E), rank),
        "a_ff1": ((L, E, rank), E), "b_ff1": ((L, rank, F), rank),
        "a_ff2": ((L, F, rank), F), "b_ff2": ((L, rank, E), rank),
    }
    for t in range(1, int(tenants) + 1):
        rng = np.random.default_rng(int(seed) * 100003 + t)
        w = {k: rng.normal(0.0, fan ** -0.5, shape).astype(np.float32)
             for k, (shape, fan) in shapes.items()}
        out[t] = (w, float(scale))
    return out


def merge_adapter_params(params, weights: Dict[str, np.ndarray],
                         scale: float):
    """The per-tenant merged-weight REFERENCE: a new ``{op: {name:
    tensor}}`` tree with every adapted projection folded, W' = W +
    scale * A @ B — what a weight-swap server would serve for this
    tenant, and the oracle the batched path must match token for token
    (greedy). The fold is the JAX package's numpy arithmetic in f32,
    cast back to each kernel's dtype; leaves may be torch tensors
    (returned as tensors on the same device) or numpy arrays. `weights`
    is the registered (true-rank or padded) dict at the kernels' ff
    width."""
    import torch

    def fold(kern, delta):
        if isinstance(kern, torch.Tensor):
            k32 = kern.detach().float().cpu().numpy()
            return torch.from_numpy(k32 + float(scale) * delta).to(
                device=kern.device, dtype=kern.dtype)
        k32 = np.asarray(kern, dtype=np.float32)
        return (k32 + float(scale) * delta).astype(np.asarray(kern).dtype)

    out = {name: dict(p) for name, p in params.items()}
    L = weights["a_qkv"].shape[0]
    for i in range(L):
        attn = dict(out[f"layer{i}_attn"])
        for j, wname in enumerate(("wq", "wk", "wv")):
            delta = np.einsum("er,rhd->ehd", weights["a_qkv"][i, j],
                              weights["b_qkv"][i, j])
            attn[wname] = fold(attn[wname], delta)
        attn["wo"] = fold(attn["wo"],
                          np.einsum("hdr,re->hde", weights["a_wo"][i],
                                    weights["b_wo"][i]))
        out[f"layer{i}_attn"] = attn
        ff1 = dict(out[f"layer{i}_ff1"])
        ff1["kernel"] = fold(ff1["kernel"],
                             weights["a_ff1"][i] @ weights["b_ff1"][i])
        out[f"layer{i}_ff1"] = ff1
        ff2 = dict(out[f"layer{i}_ff2"])
        ff2["kernel"] = fold(ff2["kernel"],
                             weights["a_ff2"][i] @ weights["b_ff2"][i])
        out[f"layer{i}_ff2"] = ff2
    return out
