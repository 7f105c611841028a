"""Cross-process PageShipment transport (``flexflow_tpu/serve/
transport.py``, whole): length-prefixed socket frames, byte for byte
the JAX package's.

The disaggregated handoff (serve/disagg.py) moves a
:class:`~flexflow_tpu_torch.serve.disagg.PageShipment` — host numpy page
rows, chain keys, stream/trace/tenant ids — from a prefill role to a
decode role. In process that is a Python reference; this module is the
wire: the shipment serializes to ONE frame, crosses a TCP socket, and
the RECEIVER applies the decode pool's admission watermark before it
imports (a shipment the pool cannot hold is skipped, acked as such, and
the decode role re-prefills).

Frame format:

    [4s magic b"FFPS"] [u8 version] [u64 body_len] [body] [u32 crc32]

where ``body`` is ``[u32 header_len][header JSON][array payload]``. The
header carries the shipment's scalar fields (chain keys hex-coded, the
geometry stamp, the ids) and each array's dtype NAME and shape; the
payload is the arrays' raw C-order bytes in header order. The names are
numpy's as the JAX package writes them — ``bfloat16`` and
``float8_e4m3fn`` included, which numpy alone cannot name: the port
holds those rows as uint16 and uint8 views of the same bits
(:class:`PageShipment`), writes the JAX name for them from the
shipment's ``kv_dtype``, and reads a JAX frame's names back into the
views, so a frame crosses between the packages in both directions
without ml_dtypes. The trailing CRC covers the body: a truncated or
corrupted frame raises :class:`ShipmentWireError`.

Every ack is a small JSON frame (``[4s b"FFPA"][u32 len][JSON]``) with
the receiver's verdict: ``accepted`` (watermark admission),
``pages_written`` (after dedupe) and the error string when decoding
failed. The sender blocks for it, which keeps each engine's imports
single-writer even when the receiver lives on another thread or
process.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import Callable, List, Optional

import numpy as np

from .disagg import PageShipment

__all__ = [
    "ShipmentWireError", "dumps_shipment", "loads_shipment",
    "ShipmentReceiver", "ShipmentSender",
]

MAGIC = b"FFPS"
ACK_MAGIC = b"FFPA"
WIRE_VERSION = 1
# magic + version + body_len
_HDR = struct.Struct(">4sBQ")
_CRC = struct.Struct(">I")
_LEN = struct.Struct(">I")

# a frame larger than this is a protocol error, not a shipment (64 GiB
# would be ~4M pages of a large pool — nothing legitimate gets there)
MAX_FRAME_BYTES = 64 << 30

_ARRAY_FIELDS = ("k_rows", "v_rows", "k_scale_rows", "v_scale_rows")


class ShipmentWireError(ValueError):
    """A frame failed to decode: truncated stream, bad magic/version,
    length out of range, CRC mismatch, or a header that does not
    describe its payload. The receiver drops the frame (and acks the
    error when the stream is still usable) — corrupt bytes never reach
    ``import_kv``."""


# numpy cannot name bf16 or fp8: the port holds those page rows as
# views of their bits, and the wire names them as the JAX package does
# (ml_dtypes' names), by the shipment's kv_dtype
_WIRE_NAME = {("bfloat16", "uint16"): "bfloat16",
              ("float8_e4m3", "uint8"): "float8_e4m3fn",
              ("float8_e4m3fn", "uint8"): "float8_e4m3fn"}
_VIEW_OF = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
            "float8_e4m3": np.uint8}


def _encode_array(a: Optional[np.ndarray], kv_dtype: str = ""):
    if a is None:
        return None, b""
    a = np.ascontiguousarray(a)
    name = _WIRE_NAME.get((kv_dtype, a.dtype.name), a.dtype.name)
    return {"dtype": name, "shape": list(a.shape)}, a.tobytes()


def _decode_array(desc, buf: bytes, offset: int):
    if desc is None:
        return None, offset
    name = str(desc["dtype"])
    try:
        dt = np.dtype(_VIEW_OF.get(name, name))
    except TypeError as e:
        raise ShipmentWireError(
            f"unknown array dtype {desc.get('dtype')!r}") from e
    shape = tuple(int(x) for x in desc["shape"])
    n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    if offset + n > len(buf):
        raise ShipmentWireError(
            f"array payload truncated: need {n} bytes at offset "
            f"{offset}, frame body has {len(buf)}")
    # .copy(): frombuffer views the frame's read-only bytes; the
    # imported pages must own writable storage of their own
    a = np.frombuffer(buf, dtype=dt, count=int(np.prod(
        shape, dtype=np.int64)), offset=offset).reshape(shape).copy()
    return a, offset + n


def dumps_shipment(ship: PageShipment) -> bytes:
    """Serialize one shipment to a self-delimiting wire frame, the JAX
    package's bytes for the same shipment (bit-exact round trip:
    ``loads_shipment(dumps_shipment(s))`` reproduces every array byte,
    chain key and id)."""
    header = {
        "keys": [k.hex() for k in ship.keys],
        "ntokens": int(ship.ntokens),
        "page_size": int(ship.page_size),
        "num_layers": int(ship.num_layers),
        "num_heads": int(ship.num_heads),
        "head_dim": int(ship.head_dim),
        "kv_dtype": str(ship.kv_dtype),
        "stream_id": ship.stream_id,
        "tenant_id": int(ship.tenant_id),
        "trace_id": ship.trace_id,
        "arrays": {},
    }
    payload_parts: List[bytes] = []
    for name in _ARRAY_FIELDS:
        desc, raw = _encode_array(getattr(ship, name),
                                  str(ship.kv_dtype))
        header["arrays"][name] = desc
        payload_parts.append(raw)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    body = _LEN.pack(len(hjson)) + hjson + b"".join(payload_parts)
    return (_HDR.pack(MAGIC, WIRE_VERSION, len(body)) + body
            + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF))


def loads_shipment(frame: bytes) -> PageShipment:
    """Decode one complete frame back into a :class:`PageShipment`.
    Raises :class:`ShipmentWireError` on ANY malformation — short
    frame, wrong magic/version, CRC mismatch, or arrays that don't fit
    the declared body."""
    if len(frame) < _HDR.size + _CRC.size:
        raise ShipmentWireError(
            f"frame too short ({len(frame)} bytes) for the "
            f"{_HDR.size + _CRC.size}-byte envelope")
    magic, version, body_len = _HDR.unpack_from(frame, 0)
    if magic != MAGIC:
        raise ShipmentWireError(f"bad magic {magic!r}")
    if version != WIRE_VERSION:
        raise ShipmentWireError(
            f"unsupported wire version {version} (speaks "
            f"{WIRE_VERSION})")
    if body_len > MAX_FRAME_BYTES:
        raise ShipmentWireError(f"frame body length {body_len} "
                                f"exceeds {MAX_FRAME_BYTES}")
    want = _HDR.size + body_len + _CRC.size
    if len(frame) != want:
        raise ShipmentWireError(
            f"frame is {len(frame)} bytes, envelope declares {want}")
    body = frame[_HDR.size:_HDR.size + body_len]
    (crc,) = _CRC.unpack_from(frame, _HDR.size + body_len)
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise ShipmentWireError("CRC mismatch: frame corrupted in "
                                "flight")
    if len(body) < _LEN.size:
        raise ShipmentWireError("body too short for header length")
    (hlen,) = _LEN.unpack_from(body, 0)
    if _LEN.size + hlen > len(body):
        raise ShipmentWireError(
            f"header length {hlen} overruns body ({len(body)} bytes)")
    try:
        header = json.loads(body[_LEN.size:_LEN.size + hlen]
                            .decode("utf-8"))
        keys = [bytes.fromhex(k) for k in header["keys"]]
        arrays_desc = header["arrays"]
    except (ValueError, KeyError, TypeError) as e:
        raise ShipmentWireError(f"undecodable header: {e}") from e
    offset = _LEN.size + hlen
    decoded = {}
    for name in _ARRAY_FIELDS:
        decoded[name], offset = _decode_array(
            arrays_desc.get(name), body, offset)
    if offset != len(body):
        raise ShipmentWireError(
            f"{len(body) - offset} trailing bytes after declared "
            f"arrays")
    if decoded["k_rows"] is None or decoded["v_rows"] is None:
        raise ShipmentWireError("shipment frame carries no page rows")
    sid = header.get("stream_id")
    tid = header.get("trace_id")
    return PageShipment(
        keys=keys, ntokens=int(header["ntokens"]),
        k_rows=decoded["k_rows"], v_rows=decoded["v_rows"],
        k_scale_rows=decoded["k_scale_rows"],
        v_scale_rows=decoded["v_scale_rows"],
        page_size=int(header["page_size"]),
        num_layers=int(header["num_layers"]),
        num_heads=int(header["num_heads"]),
        head_dim=int(header["head_dim"]),
        kv_dtype=str(header["kv_dtype"]),
        stream_id=None if sid is None else int(sid),
        tenant_id=int(header.get("tenant_id", 0)),
        trace_id=None if tid is None else int(tid))


# ---------------------------------------------------------------------------
# socket plumbing
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly `n` bytes or raise ShipmentWireError (a peer that
    closes mid-frame is a truncated frame, not a silent partial)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            raise ShipmentWireError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> bytes:
    """Read one complete shipment frame off the stream."""
    head = _recv_exact(sock, _HDR.size)
    magic, version, body_len = _HDR.unpack(head)
    if magic != MAGIC:
        raise ShipmentWireError(f"bad magic {magic!r}")
    if version != WIRE_VERSION:
        raise ShipmentWireError(f"unsupported wire version {version}")
    if body_len > MAX_FRAME_BYTES:
        raise ShipmentWireError(f"frame body length {body_len} "
                                f"exceeds {MAX_FRAME_BYTES}")
    rest = _recv_exact(sock, body_len + _CRC.size)
    return head + rest


def _send_ack(sock: socket.socket, doc: dict) -> None:
    raw = json.dumps(doc, separators=(",", ":")).encode("utf-8")
    sock.sendall(ACK_MAGIC + _LEN.pack(len(raw)) + raw)


def _recv_ack(sock: socket.socket) -> dict:
    head = _recv_exact(sock, len(ACK_MAGIC) + _LEN.size)
    if head[:len(ACK_MAGIC)] != ACK_MAGIC:
        raise ShipmentWireError(f"bad ack magic {head[:4]!r}")
    (n,) = _LEN.unpack_from(head, len(ACK_MAGIC))
    if n > 1 << 20:
        raise ShipmentWireError(f"ack length {n} out of range")
    try:
        return json.loads(_recv_exact(sock, n).decode("utf-8"))
    except ValueError as e:
        raise ShipmentWireError(f"undecodable ack: {e}") from e


class ShipmentReceiver:
    """The decode-side endpoint: a listening TCP socket + acceptor
    thread. Each received frame decodes to a PageShipment and is
    handed to ``import_fn(ship) -> dict`` — the cluster's admission
    path, which applies the watermark check and returns the ack
    payload (``{"accepted": bool, "pages_written": int, ...}``). The
    import runs ON the receiver thread while the sender blocks for the
    ack, so the decode engine keeps one writer at a time.

    ``port=0`` binds an ephemeral port; read ``.port`` after
    construction (how tests and the in-process "tcp" cluster mode
    avoid port collisions)."""

    def __init__(self, import_fn: Callable[[PageShipment], dict], *,
                 host: str = "127.0.0.1", port: int = 0,
                 backlog: int = 8):
        self._import_fn = import_fn
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((str(host), int(port)))
        self._sock.listen(int(backlog))
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self.stats = {"frames": 0, "bytes": 0, "accepted": 0,
                      "skipped": 0, "wire_errors": 0}
        self._thread = threading.Thread(
            target=self._serve, name="shipment-receiver", daemon=True)
        self._thread.start()

    # ---------------- acceptor loop ------------------------------------
    def _serve(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # closed
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="shipment-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._closed:
                try:
                    frame = _recv_frame(conn)
                except ShipmentWireError:
                    return  # stream unusable (peer gone / desynced)
                try:
                    ship = loads_shipment(frame)
                except ShipmentWireError as e:
                    self.stats["wire_errors"] += 1
                    try:
                        _send_ack(conn, {"accepted": False,
                                         "pages_written": 0,
                                         "error": str(e)})
                    except OSError:
                        return
                    continue
                self.stats["frames"] += 1
                self.stats["bytes"] += len(frame)
                try:
                    ack = dict(self._import_fn(ship))
                except Exception as e:  # import failure is an ack,
                    ack = {"accepted": False, "pages_written": 0,
                           "error": f"{type(e).__name__}: {e}"}
                ack.setdefault("accepted", False)
                ack.setdefault("pages_written", 0)
                self.stats["accepted" if ack["accepted"]
                           else "skipped"] += 1
                try:
                    _send_ack(conn, ack)
                except OSError:
                    return

    def close(self) -> None:
        self._closed = True
        try:
            # shutdown wakes the acceptor blocked in accept(); a bare
            # close leaves it blocked until the join times out
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShipmentSender:
    """The prefill-side endpoint: one TCP connection to a
    :class:`ShipmentReceiver`. ``send(ship)`` frames, ships, and
    blocks for the receiver's ack — the wire analogue of the
    in-process ``DisaggCluster._handoff`` call."""

    def __init__(self, host: str, port: int,
                 connect_timeout: float = 5.0):
        self._sock = socket.create_connection(
            (str(host), int(port)), timeout=connect_timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.stats = {"frames": 0, "bytes": 0}

    def send(self, ship: PageShipment) -> dict:
        frame = dumps_shipment(ship)
        self._sock.sendall(frame)
        self.stats["frames"] += 1
        self.stats["bytes"] += len(frame)
        return _recv_ack(self._sock)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
