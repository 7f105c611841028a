"""The page shipment of disaggregated serving
(``flexflow_tpu/serve/disagg.py``). Only the :class:`PageShipment`
dataclass is ported yet: ``ServeEngine.export_kv`` returns one and
``import_kv`` adopts one. The prefill/decode roles and their cluster
are the next slice (ROADMAP module item 4).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class PageShipment:
    """One slot's finished KV pages, host-side: the unit a prefill
    engine hands a decode engine. ``keys`` are the chain hashes (the
    transfer identity), ``k_rows``/``v_rows`` the page value rows as
    numpy ``(layers, n_pages, page_size, heads, head_dim)`` in the
    JAX package's layout, byte for byte: f32 and int8 pools at their
    own dtype, bf16 rows as a uint16 view and fp8 (e4m3fn) rows as a
    uint8 view (numpy has neither type). ``*_scale_rows`` are the f32
    ``(layers, n_pages, page_size, heads)`` scale rows of quantized
    pools (None otherwise). The geometry stamp lets ``import_kv``
    reject a pool-shape mismatch; ``stream_id``, ``tenant_id`` and
    ``trace_id`` carry the request's sampling stream, adapter tenant
    and trace context across the split."""

    keys: List[bytes]
    ntokens: int
    k_rows: np.ndarray
    v_rows: np.ndarray
    k_scale_rows: Optional[np.ndarray]
    v_scale_rows: Optional[np.ndarray]
    page_size: int
    num_layers: int
    num_heads: int
    head_dim: int
    kv_dtype: str
    stream_id: Optional[int] = None
    tenant_id: int = 0
    trace_id: Optional[int] = None

    def signature(self) -> tuple:
        return (self.page_size, self.num_layers, self.num_heads,
                self.head_dim, self.kv_dtype)

    @property
    def num_pages(self) -> int:
        return len(self.keys)

    @property
    def nbytes(self) -> int:
        """Host-link bytes this shipment moves (values + scale rows)."""
        n = int(self.k_rows.nbytes + self.v_rows.nbytes)
        if self.k_scale_rows is not None:
            n += int(self.k_scale_rows.nbytes
                     + self.v_scale_rows.nbytes)
        return n
