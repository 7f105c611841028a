"""Data loading; counterpart of ``flexflow_tpu/core/dataloader.py``.

The dataset stays in host numpy. A batch lands on the device through
:func:`host_to_device`, the one placement rule of the port's batches
(the executor's ``shard_batch`` uses it too): cast to the declared dtype
in the transfer, and otherwise the JAX package's placement with 64-bit
types off (``jnp.asarray``: float64 becomes float32, int64 int32), so a
batch is byte for byte the JAX loader's.

``DataLoaderSet`` prefetches on a worker thread. On the card the worker
gathers each batch's rows into pinned host buffers, copies them to the
device with ``non_blocking=True`` on a CUDA stream of its own (casting
there to the declared dtype) and records an event; the consumer's stream
waits on that event before the batch is used — before a captured step's
replay copies it into the graph's static input, never inside the graph
— and each device tensor is marked as used by the consumer's stream
(``record_stream``), so the caching allocator keeps its memory until
that use is done. A pinned buffer is rewritten only after the copy that
reads it has completed (its event). So the copy of batch i+1 overlaps
step i, where the synchronous path's pageable copy waits for the device
to finish the queued work first. Batch order and contents are
byte-identical to the synchronous path and to JAX's loader.

The rows of a batch are gathered by the native C++ loader
(``csrc/dataloader.cc`` through ``native.wrappers.NativePrefetchLoader``)
whenever the native library is on, as JAX's ``DataLoaderSet`` does
(``use_native=None``; ``use_native=False`` gathers in Python, and
``use_native=True`` with the library turned off raises, as a failed
build does). Its batches are views into the loader's double buffer,
valid only until its next ``next_batch``: the thread that takes a view
copies this rank's rows out of it (into the pinned slot on the card)
before it asks for the next batch, and only then queues the
host-to-device copy. The batches are the Python path's, batch for
batch.

``mesh=``: on an executing mesh each rank's loaders yield its block of
every global batch, rows ``[c*b/d, (c+1)*b/d)`` of the batch's order,
``c`` the rank's ``data`` coordinate and ``d`` the ``data`` axis size
(ranks that differ only on ``model`` get the same rows): the process-
local batches of JAX's ``place_process_local``, which the executor takes
as they are. The global order, prefetch, pinned slots and the copy
stream are unchanged; :func:`host_to_device` is the placement of the
rank's rows.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import resolve_device, torch_dtype

# JAX's canonical dtypes with 64-bit types off
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def placed_dtype(src: torch.dtype, dtype=None) -> torch.dtype:
    """The dtype a batch of ``src`` lands in: the declared ``dtype``,
    else ``src`` narrowed as JAX narrows it."""
    want = torch_dtype(dtype)
    return want if want is not None else _NARROW.get(src, src)


def host_to_device(host, device, dtype=None, mesh=None) -> torch.Tensor:
    """A host array (or a tensor) on ``device`` at
    :func:`placed_dtype`, cast in the transfer. With an executing
    ``mesh`` the host batch is this process's rows, its block of the
    global batch (JAX's ``place_process_local``: a mesh with no
    ``data`` axis to split the batch over raises)."""
    if mesh is not None:
        from ..parallel.mesh import bound_mesh
        from ..parallel.sharding import batch_sharding, place_process_local
        bm = bound_mesh(mesh)
        if bm is not None:
            host = place_process_local(
                host, batch_sharding(bm, np.ndim(host)), bm)
    t = host if isinstance(host, torch.Tensor) else torch.as_tensor(
        np.asarray(host))
    return torch.as_tensor(t, device=device,
                           dtype=placed_dtype(t.dtype, dtype))


def _rank_rows(mesh, batch_size: int):
    """(first row, rows) of this rank's block of a global batch."""
    if mesh is None:
        return 0, batch_size
    from ..parallel.mesh import bound_mesh
    bm = bound_mesh(mesh)
    if bm is None or "data" not in bm.groups:
        return 0, batch_size
    d = bm.axis_size("data")
    if batch_size % d:
        raise ValueError(f"batch size {batch_size} does not split over "
                         f"{d} data ranks")
    n = batch_size // d
    return bm.coord("data") * n, n


class SingleDataLoader:
    """One loader per (input tensor, full dataset array) pair, mirroring
    the reference's per-tensor loaders; `DataLoaderSet` batches them."""

    def __init__(self, name: str, data: np.ndarray, batch_size: int,
                 mesh=None, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, dtype=None, device="cuda"):
        self.name = name
        # this rank's rows of each batch: (offset, count)
        self._rows = _rank_rows(mesh, int(batch_size))
        self.data = np.asarray(data)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.dtype = torch_dtype(dtype)  # cast in the transfer
        self.device = resolve_device(device)
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(len(self.data))
        self._pos = 0
        if shuffle:
            self._rng.shuffle(self._order)

    @property
    def num_samples(self) -> int:
        return len(self.data)

    @property
    def num_batches(self) -> int:
        n = self.num_samples // self.batch_size
        if not self.drop_last and self.num_samples % self.batch_size:
            n += 1
        return n

    def reset(self) -> None:
        self._pos = 0
        if self.shuffle:
            self._rng.shuffle(self._order)

    def next_batch(self) -> torch.Tensor:
        """The next slice of the order, on the device."""
        if self._pos + self.batch_size > self.num_samples:
            if self.drop_last or self._pos >= self.num_samples:
                raise StopIteration
        sel = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        lo, n = self._rows
        return host_to_device(self.data[sel[lo:lo + n]], self.device,
                              self.dtype)


class _PinnedStager:
    """The worker's side of a prefetching epoch on the card: a ring of
    pinned host buffers per input and a copy stream. :meth:`stage`
    fills a free slot with a batch's rows — gathered from the dataset
    (``torch.index_select``, which runs on several cores and outside the
    GIL, where a numpy fancy index is one core) or copied from the
    native loader's views — queues the slot's non-blocking copy and,
    where the batch's dtype differs from the data's, the cast, both on
    the copy stream; it returns (device batch, event). The cast on the
    card rounds as the host's would (to nearest even)."""

    def __init__(self, loaders, device, depth: int = 2):
        self.loaders = loaders
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.src = {k: torch.from_numpy(np.ascontiguousarray(l.data))
                    for k, l in loaders.items()}
        self.slots = [dict() for _ in range(depth)]
        self.events = [None] * depth
        self.n = 0

    def stage(self, sel=None, rows=None):
        """Stage the rows ``sel`` of the dataset, or the host arrays
        ``rows`` (one per input: the native loader's views, copied into
        the slot before this returns)."""
        s = self.n % len(self.slots)
        self.n += 1
        if self.events[s] is not None:      # the copy reading it is done
            self.events[s].synchronize()
        idx = None if sel is None else torch.from_numpy(
            np.asarray(sel, dtype=np.int64))
        out = {}
        with torch.cuda.stream(self.stream):
            for k, l in self.loaders.items():
                src = self.src[k]
                n = len(sel) if sel is not None else len(rows[k])
                shape = (n,) + tuple(src.shape[1:])
                host = self.slots[s].get(k)
                if host is None or tuple(host.shape) != shape:
                    host = self.slots[s][k] = torch.empty(
                        shape, dtype=src.dtype, pin_memory=True)
                if idx is not None:
                    torch.index_select(src, 0, idx, out=host)
                else:
                    host.copy_(torch.from_numpy(rows[k]))
                dev = torch.empty(shape, dtype=src.dtype, device=self.device)
                dev.copy_(host, non_blocking=True)
                out[k] = dev.to(placed_dtype(src.dtype, l.dtype))
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[s] = ev
        return out, ev


def _own_rows(view: np.ndarray, lo: int, n: int) -> np.ndarray:
    """This rank's rows of a native batch, copied out of the loader's
    buffer, which its next ``next_batch`` overwrites."""
    return np.array(view[lo:lo + n], copy=True)


class DataLoaderSet:
    """Batches several SingleDataLoaders in lockstep (inputs + label),
    the shape FFModel.fit consumes. ``prefetch`` (the default) stages
    batches on a worker thread, two ahead of the consumer; on the card
    through pinned buffers and a copy stream of its own (module
    docstring). ``prefetch=False`` is the synchronous path. The rows
    are gathered by the native loader when ``use_native`` is not False
    and the native library is on; ``use_native=True`` raises when it is
    turned off. :meth:`close` stops the native loader's thread."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 mesh=None, shuffle: bool = True, seed: int = 0,
                 use_native: Optional[bool] = None,
                 dtypes: Optional[Dict] = None,
                 prefetch: bool = True, device="cuda"):
        n = {len(v) for v in arrays.values()}
        if len(n) != 1:
            raise ValueError("all arrays must have equal sample counts")
        # one shared shuffled order: shuffle once here, not per-loader
        self._order_rng = np.random.RandomState(seed)
        self.device = resolve_device(device)
        self.dtypes = dict(dtypes or {})
        self.loaders = {
            k: SingleDataLoader(k, v, batch_size, mesh=mesh, shuffle=False,
                                dtype=self.dtypes.get(k),
                                device=self.device)
            for k, v in arrays.items()
        }
        self.shuffle = shuffle
        self.batch_size = batch_size
        self.prefetch = bool(prefetch)
        self._native = None
        if use_native is not False:
            from .. import native
            if native.available():
                from ..native.wrappers import NativePrefetchLoader
                self._native = NativePrefetchLoader(
                    {k: np.asarray(v) for k, v in arrays.items()},
                    batch_size, drop_last=True)
            elif use_native:
                raise RuntimeError(
                    "the native loader was asked for (use_native=True) "
                    "but the native library is turned off "
                    "(FLEXFLOW_TORCH_NO_NATIVE)")

    @property
    def num_batches(self) -> int:
        return next(iter(self.loaders.values())).num_batches

    def _rows(self):
        """(first row, rows) of this rank's block of each batch."""
        return next(iter(self.loaders.values()))._rows

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(next(iter(self.loaders.values())).num_samples)
        if self.shuffle:
            self._order_rng.shuffle(order)
        return order

    def _set_order(self, order: np.ndarray) -> None:
        for l in self.loaders.values():
            l._order = order
            l._pos = 0

    def reset(self) -> None:
        self._set_order(self._epoch_order())

    # ---------------- crash-safe loader state --------------------------
    def state_dict(self) -> dict:
        """Resumable shuffle-stream state: the shared order rng, at
        EPOCH granularity (a permutation already drawn for an epoch in
        progress is not recoverable from it; save at epoch boundaries)."""
        s = self._order_rng.get_state()
        return {"rng": [s[0], np.asarray(s[1]).tolist(), int(s[2]),
                        int(s[3]), float(s[4])]}

    def load_state_dict(self, state: dict) -> None:
        # parse everything before mutating anything: a malformed state
        # leaves the loader untouched
        s = state["rng"]
        rng_state = (s[0], np.asarray(s[1], dtype=np.uint32), int(s[2]),
                     int(s[3]), float(s[4]))
        self._order_rng.set_state(rng_state)

    def save_state(self, path: str) -> None:
        """Checkpoint the loader state atomically (temp file, then
        ``os.replace``; fault site ``loader.commit``): a kill at any
        instant leaves the previous complete file or the new one."""
        from .checkpoint import atomic_write_json
        atomic_write_json(path, self.state_dict(),
                          fault_site="loader.commit")

    def load_state(self, path: str) -> bool:
        """Restore from save_state's file; False (state untouched) when
        the file is absent or unreadable."""
        try:
            with open(path) as f:
                state = json.load(f)
            self.load_state_dict(state)
        except (OSError, ValueError, KeyError, TypeError):
            return False
        return True

    def close(self) -> None:
        """Stop the native loader's thread and free its buffers (an
        epoch's own worker thread and pinned buffers end with its
        iterator). Safe to call more than once."""
        if self._native is not None:
            self._native.close()
            self._native = None

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self.iter_with_order(self._epoch_order())

    def iter_with_order(self, order: np.ndarray
                        ) -> Iterator[Dict[str, torch.Tensor]]:
        """Iterate one epoch in an EXPLICIT sample order (fit()'s own
        permutation stream)."""
        order = np.asarray(order)
        n = next(iter(self.loaders.values())).num_samples
        if len(order) != n:
            raise ValueError(f"order has {len(order)} entries for {n} "
                             f"samples")
        if self._native is not None:
            self._native.start_epoch(order)
        if self.prefetch and self.num_batches > 1:
            yield from self._iter_prefetch(order)
            return
        # iterator-local slicing: the loaders' cursors stay untouched
        for i in range(self.num_batches):
            yield {k: host_to_device(rows, self.device,
                                     self.loaders[k].dtype)
                   for k, rows in self._host_rows(order, i).items()}

    def _host_rows(self, order: np.ndarray, i: int) -> Dict[str, np.ndarray]:
        """Batch i's rows of this rank, one host array per input: the
        native loader's next batch copied out of its buffer, or a
        gather from the dataset."""
        lo, n_rows = self._rows()
        if self._native is not None:
            return {k: _own_rows(v, lo, n_rows)
                    for k, v in self._native_view(i).items()}
        bs = self.batch_size
        sel = order[i * bs:(i + 1) * bs][lo:lo + n_rows]
        return {k: l.data[sel] for k, l in self.loaders.items()}

    def _native_view(self, i: int) -> Dict[str, np.ndarray]:
        """The native loader's batch i (views into its buffer)."""
        view = self._native.next_batch()
        if view is None:
            raise RuntimeError(f"the native loader ended the epoch before "
                               f"batch {i}")
        return view

    def _iter_prefetch(self, order: np.ndarray
                       ) -> Iterator[Dict[str, torch.Tensor]]:
        """A worker thread stages batches up to two ahead; the order and
        the contents are those of the synchronous path (the worker walks
        the same slices, or takes the native loader's batches in turn),
        only the time of staging changes."""
        import queue
        import threading
        bs = self.batch_size
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        stager = (_PinnedStager(self.loaders, self.device)
                  if self.device.type == "cuda" else None)

        lo, n_rows = self._rows()

        def gather() -> None:
            try:
                for i in range(self.num_batches):
                    if stop.is_set():
                        return
                    if stager is not None and self._native is None:
                        sel = order[i * bs:(i + 1) * bs][lo:lo + n_rows]
                        q.put(stager.stage(sel))
                    elif stager is not None:
                        # the views are copied into the slot before the
                        # next next_batch can overwrite them
                        q.put(stager.stage(rows={
                            k: v[lo:lo + n_rows]
                            for k, v in self._native_view(i).items()}))
                    else:
                        q.put(({k: host_to_device(
                            rows, self.device, self.loaders[k].dtype)
                            for k, rows in self._host_rows(order, i).items()},
                            None))
                q.put(None)                          # end of epoch
            except BaseException as e:               # surface in consumer
                q.put(e)

        worker = threading.Thread(target=gather, daemon=True,
                                  name="ff-dataloader-prefetch")
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, ev = item
                if ev is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ev)
                    for t in batch.values():
                        t.record_stream(cur)
                yield batch
        finally:
            # an abandoned iterator: unblock a worker parked on the full
            # queue, then reap it
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            worker.join(timeout=5.0)


def synthetic_inputs(model, n_samples: int, seed: int = 0,
                     int_high: int = 10) -> Dict[str, np.ndarray]:
    """Synthetic input arrays (n_samples rows) matching the model's
    declared input tensors: integer tensors get uniform ints in [0,
    int_high), float tensors standard normals — in their dtype where
    numpy has it, else f32 (a bf16 input then rounds in the transfer,
    where the JAX function rounds numpy's f64 draw to bf16 directly)."""
    rng = np.random.RandomState(seed)
    x = {}
    for t in model.input_tensors:
        shape = (n_samples,) + tuple(t.shape[1:])
        if not t.dtype.is_floating_point:
            x[t.name] = rng.randint(0, int_high, shape).astype(np.int32)
        else:
            try:
                np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            except TypeError:
                np_dtype = np.float32
            x[t.name] = rng.randn(*shape).astype(np_dtype)
    return x


def synthetic_batch(model, label_classes: int = 10, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """One synthetic batch (batch-size rows) incl. integer labels."""
    bs = model.input_tensors[0].shape[0]
    batch = synthetic_inputs(model, bs, seed)
    rng = np.random.RandomState(seed + 1)
    batch["label"] = rng.randint(0, label_classes, bs).astype(np.int32)
    return batch
