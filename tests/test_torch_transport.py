"""The port's PageShipment wire (serve/transport.py) against the JAX
package's: every case of JAX's transport suite on the port's codec and
sockets, and the cross-package gates — the same shipment serializes to
the same bytes in both packages on f32, bf16, int8 and fp8 pages, and a
frame of either loads in the other bit for bit. numpy has no bf16 or
fp8: the port's shipment holds those rows as uint16 and uint8 views of
the bits, and the JAX frame names them ``bfloat16`` and
``float8_e4m3fn`` (ml_dtypes), which the port writes and reads without
importing ml_dtypes."""

import json
import threading
import zlib

import ml_dtypes
import numpy as np
import pytest

from flexflow_tpu.serve import transport as jtr
from flexflow_tpu.serve.disagg import PageShipment as JShipment

from flexflow_tpu_torch.serve import transport as ttr
from flexflow_tpu_torch.serve.disagg import PageShipment

_GEOM = dict(layers=2, pages=3, page=4, heads=2, hd=8)
# kv_dtype -> (JAX numpy dtype of the page rows, the port's view)
_ROWS = {"float32": (np.float32, np.float32),
         "int8": (np.int8, np.int8),
         "bfloat16": (ml_dtypes.bfloat16, np.uint16),
         "float8_e4m3": (ml_dtypes.float8_e4m3fn, np.uint8)}


def _pair(kv_dtype="float32", *, scales=False, seed=0, stream_id=7,
          tenant_id=2, trace_id=12345):
    """(JAX shipment, port shipment) of the same pages: the port's rows
    are the JAX rows' bits under the port's view."""
    rng = np.random.default_rng(seed)
    g = _GEOM
    shape = (g["layers"], g["pages"], g["page"], g["heads"], g["hd"])
    jdt, view = _ROWS[kv_dtype]

    def rows():
        if kv_dtype == "int8":
            return rng.integers(-128, 128, size=shape).astype(np.int8)
        return rng.standard_normal(shape).astype(jdt)

    k, v = rows(), rows()
    scale = None
    if scales:
        scale = rng.standard_normal(shape[:-1]).astype(np.float32)
    kw = dict(keys=[bytes([i] * 16) for i in range(g["pages"])],
              ntokens=g["pages"] * g["page"] - 1,
              k_scale_rows=scale,
              v_scale_rows=None if scale is None else scale * 2.0,
              page_size=g["page"], num_layers=g["layers"],
              num_heads=g["heads"], head_dim=g["hd"], kv_dtype=kv_dtype,
              stream_id=stream_id, tenant_id=tenant_id, trace_id=trace_id)
    return (JShipment(k_rows=k, v_rows=v, **kw),
            PageShipment(k_rows=k.view(view), v_rows=v.view(view), **kw))


def _ship(kv_dtype="float32", **kw):
    return _pair(kv_dtype, **kw)[1]


def _bits(a):
    return np.asarray(a).view(np.uint8)


def _assert_identical(a, b) -> None:
    assert b.keys == a.keys
    assert b.ntokens == a.ntokens
    assert b.signature() == a.signature()
    assert (b.stream_id, b.tenant_id, b.trace_id) == \
        (a.stream_id, a.tenant_id, a.trace_id)
    assert b.k_rows.shape == a.k_rows.shape
    assert b.k_rows.dtype.itemsize == a.k_rows.dtype.itemsize
    assert np.array_equal(_bits(b.k_rows), _bits(a.k_rows))
    assert np.array_equal(_bits(b.v_rows), _bits(a.v_rows))
    for name in ("k_scale_rows", "v_scale_rows"):
        sa, sb = getattr(a, name), getattr(b, name)
        assert (sa is None) == (sb is None)
        if sa is not None:
            assert sb.dtype == sa.dtype
            assert np.array_equal(_bits(sb), _bits(sa))


PAGES = [("float32", False), ("bfloat16", False), ("int8", True),
         ("float8_e4m3", True)]


# ------------------------------------------------------ cross-package
@pytest.mark.parametrize("kv_dtype,scales", PAGES)
def test_frames_identical_across_packages(kv_dtype, scales):
    """The same shipment is the same frame in both packages, and each
    package loads the other's frame bit for bit (the port into its
    views, JAX into its ml_dtypes arrays)."""
    jship, tship = _pair(kv_dtype, scales=scales)
    frame = ttr.dumps_shipment(tship)
    assert frame == jtr.dumps_shipment(jship)
    port = ttr.loads_shipment(jtr.dumps_shipment(jship))
    _assert_identical(tship, port)
    assert port.k_rows.dtype == _ROWS[kv_dtype][1]
    back = jtr.loads_shipment(frame)
    _assert_identical(jship, back)
    assert back.k_rows.dtype == np.dtype(_ROWS[kv_dtype][0])
    assert port.nbytes == back.nbytes == jship.nbytes


# --------------------------------------------------- JAX's wire cases
@pytest.mark.parametrize("kv_dtype,scales", PAGES)
def test_wire_round_trip_bit_exact(kv_dtype, scales):
    ship = _ship(kv_dtype, scales=scales)
    back = ttr.loads_shipment(ttr.dumps_shipment(ship))
    _assert_identical(ship, back)
    assert back.k_rows.dtype == ship.k_rows.dtype
    # decoded arrays own writable storage (frombuffer views don't)
    back.k_rows[0, 0, 0, 0, 0] = back.k_rows[0, 0, 0, 0, 0]


def test_wire_none_ids_and_nbytes():
    ship = _ship(stream_id=None, trace_id=None, tenant_id=0)
    back = ttr.loads_shipment(ttr.dumps_shipment(ship))
    assert back.stream_id is None and back.trace_id is None
    assert back.nbytes == ship.nbytes
    assert back.num_pages == ship.num_pages


def test_wire_rejects_malformed_frames():
    frame = bytearray(ttr.dumps_shipment(_ship("int8", scales=True)))
    for cut in (0, 3, ttr._HDR.size, ttr._HDR.size + 10, len(frame) - 1):
        with pytest.raises(ttr.ShipmentWireError):
            ttr.loads_shipment(bytes(frame[:cut]))
    bad = bytes(b"XXXX") + bytes(frame[4:])
    with pytest.raises(ttr.ShipmentWireError, match="magic"):
        ttr.loads_shipment(bad)
    bad = bytearray(frame)
    bad[4] = ttr.WIRE_VERSION + 1
    with pytest.raises(ttr.ShipmentWireError, match="version"):
        ttr.loads_shipment(bytes(bad))
    bad = bytearray(frame)
    bad[len(bad) - ttr._CRC.size - 5] ^= 0x40
    with pytest.raises(ttr.ShipmentWireError, match="CRC"):
        ttr.loads_shipment(bytes(bad))
    with pytest.raises(ttr.ShipmentWireError):
        ttr.loads_shipment(bytes(frame) + b"\x00")
    ttr.loads_shipment(bytes(frame))


def test_wire_header_must_describe_payload():
    frame = ttr.dumps_shipment(_ship())
    _magic, _ver, body_len = ttr._HDR.unpack_from(frame, 0)
    body = bytearray(frame[ttr._HDR.size:ttr._HDR.size + body_len])
    (hlen,) = ttr._LEN.unpack_from(bytes(body), 0)
    header = json.loads(bytes(body[ttr._LEN.size:ttr._LEN.size + hlen]))
    header["arrays"]["v_rows"]["shape"][1] += 7
    hjson = json.dumps(header, separators=(",", ":")).encode()
    body2 = ttr._LEN.pack(len(hjson)) + hjson \
        + bytes(body[ttr._LEN.size + hlen:])
    frame2 = (ttr._HDR.pack(ttr.MAGIC, ttr.WIRE_VERSION, len(body2))
              + body2 + ttr._CRC.pack(zlib.crc32(body2) & 0xFFFFFFFF))
    with pytest.raises(ttr.ShipmentWireError):
        ttr.loads_shipment(frame2)


# ------------------------------------------------------ socket cases
@pytest.mark.parametrize("sender", ["torch", "jax"])
def test_socket_round_trip_and_acks(sender):
    """A port receiver takes frames from a port sender and from JAX's,
    and acks each."""
    got = []

    def import_fn(ship):
        got.append(ship)
        return {"accepted": True, "pages_written": ship.num_pages}

    tx_mod = ttr if sender == "torch" else jtr
    with ttr.ShipmentReceiver(import_fn) as rx:
        with tx_mod.ShipmentSender(rx.host, rx.port) as tx:
            for seed in range(3):
                ship = _pair("int8", scales=True, seed=seed,
                             stream_id=seed)[sender == "jax"]
                ack = tx.send(ship)
                assert ack["accepted"] is True
                assert ack["pages_written"] == ship.num_pages
        assert len(got) == 3
        for seed, back in enumerate(got):
            _assert_identical(_ship("int8", scales=True, seed=seed,
                                    stream_id=seed), back)
        assert rx.stats["frames"] == 3
        assert rx.stats["accepted"] == 3
        assert rx.stats["wire_errors"] == 0


def test_socket_receiver_backpressure_and_errors():
    verdicts = iter([
        {"accepted": False, "pages_written": 0},
        RuntimeError("pool exploded"),
        {"accepted": True, "pages_written": 3},
    ])

    def import_fn(ship):
        v = next(verdicts)
        if isinstance(v, Exception):
            raise v
        return v

    with ttr.ShipmentReceiver(import_fn) as rx:
        with ttr.ShipmentSender(rx.host, rx.port) as tx:
            a1 = tx.send(_ship())
            assert a1["accepted"] is False
            a2 = tx.send(_ship())
            assert a2["accepted"] is False
            assert "pool exploded" in a2["error"]
            a3 = tx.send(_ship())
            assert a3["accepted"] is True and a3["pages_written"] == 3
        assert rx.stats["skipped"] == 2 and rx.stats["accepted"] == 1


def test_socket_concurrent_senders():
    seen = []
    lock = threading.Lock()

    def import_fn(ship):
        with lock:
            seen.append(ship.stream_id)
        return {"accepted": True, "pages_written": ship.num_pages}

    n = 4
    with ttr.ShipmentReceiver(import_fn) as rx:
        errs = []

        def one(sid):
            try:
                with ttr.ShipmentSender(rx.host, rx.port) as tx:
                    for j in range(5):
                        ack = tx.send(_ship(seed=sid * 10 + j,
                                            stream_id=sid))
                        assert ack["accepted"] is True
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=one, args=(sid,))
                   for sid in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not errs
        assert sorted(seen) == sorted(
            [sid for sid in range(n) for _ in range(5)])
        assert rx.stats["frames"] == n * 5
