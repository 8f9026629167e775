"""Minimal TensorBoard event-file writer (no tensorboard or tensorflow).

``Trainer.fit`` writes its per-epoch scalars through ``EventWriter`` into
``<run_dir>/tb/events.out.tfevents.*``, files that ``tensorboard --logdir
experiments/`` reads. The two protobufs involved (Event, Summary) are
encoded by hand, in TFRecord framing with masked crc32c; the bytes equal
the JAX package's writer's for the same steps, scalars and wall time.

Wire format per record: <len:uint64le> <masked_crc32c(len):uint32le>
<event bytes> <masked_crc32c(bytes):uint32le>. Proto fields used:
Event{1: double wall_time, 2: int64 step, 5: Summary}, Summary{1: repeated
Value}, Value{1: string tag, 2: float simple_value}.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# -- crc32c (Castagnoli), software table --------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if _c & 1 else 0)
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- tiny protobuf encoder -----------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _i64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def encode_scalar_event(step: int, scalars: Dict[str, float],
                        wall_time: Optional[float] = None) -> bytes:
    values = b"".join(
        _bytes(1, _bytes(1, tag.encode()) + _f32(2, float(v)))
        for tag, v in scalars.items())
    return (_f64(1, wall_time if wall_time is not None else time.time())
            + _i64(2, step) + _bytes(5, values))


def encode_file_version(wall_time: Optional[float] = None) -> bytes:
    return (_f64(1, wall_time if wall_time is not None else time.time())
            + _bytes(3, b"brain.Event:2"))


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Append-only TensorBoard scalar writer for one run directory."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        with open(self.path, "ab") as f:
            f.write(frame_record(encode_file_version()))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        finite = {k: float(v) for k, v in scalars.items()
                  if isinstance(v, (int, float))}
        if not finite:
            return
        with open(self.path, "ab") as f:
            f.write(frame_record(encode_scalar_event(step, finite)))


# -- reader (tests + offline inspection without tensorboard) -------------------

def read_scalars(path: str):
    """Parse an event file written by EventWriter back into
    [(step, {tag: value})] — also serves as the round-trip test oracle."""
    out = []
    with open(path, "rb") as f:
        blob = f.read()
    off = 0
    while off < len(blob):
        (ln,) = struct.unpack_from("<Q", blob, off)
        (hcrc,) = struct.unpack_from("<I", blob, off + 8)
        assert hcrc == _masked_crc(blob[off:off + 8]), "corrupt length crc"
        payload = blob[off + 12:off + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", blob, off + 12 + ln)
        assert pcrc == _masked_crc(payload), "corrupt payload crc"
        off += 16 + ln
        step, scalars = 0, {}
        i = 0
        while i < len(payload):
            key = payload[i]
            field, wire = key >> 3, key & 7
            i += 1
            if wire == 0:
                v = 0
                shift = 0
                while True:
                    b = payload[i]
                    i += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 2:
                    step = v
            elif wire == 1:
                i += 8
            elif wire == 5:
                i += 4
            elif wire == 2:
                ln2 = 0
                shift = 0
                while True:
                    b = payload[i]
                    i += 1
                    ln2 |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                sub = payload[i:i + ln2]
                i += ln2
                if field == 5:  # Summary
                    j = 0
                    while j < len(sub):
                        assert sub[j] == 0x0A  # Value, field 1, wire 2
                        j += 1
                        vl = 0
                        shift = 0
                        while True:
                            b = sub[j]
                            j += 1
                            vl |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        val = sub[j:j + vl]
                        j += vl
                        tag, sv, k = "", None, 0
                        while k < len(val):
                            fk = val[k]
                            k += 1
                            if fk == 0x0A:  # tag
                                tl = val[k]
                                k += 1
                                tag = val[k:k + tl].decode()
                                k += tl
                            elif fk == 0x15:  # simple_value, f32
                                (sv,) = struct.unpack_from("<f", val, k)
                                k += 4
                            else:
                                raise AssertionError(f"unexpected field {fk}")
                        if sv is not None:
                            scalars[tag] = sv
        if scalars:
            out.append((step, scalars))
    return out
