"""Minimal TensorBoard event-file writer — zero dependencies.

The reference logs epoch scalars + the current LR to TensorBoard event
files (training_utils.py:77-84 ``LRTensorBoard``; source/main.py:144-149
``TensorBoard(profile_batch=0)``). The TPU build keeps JSONL as the
machine-readable history and adds this writer for TB-compatible scalars
without importing TensorFlow/torch: it hand-encodes the two protobufs a
scalar event needs (Event, Summary.Value.simple_value) and the TFRecord
framing (length + masked-crc32c) that `tensorboard --logdir` reads.

Wire format notes (stable public formats):
* TFRecord frame: u64le length, u32le masked_crc32c(length bytes),
  payload, u32le masked_crc32c(payload); mask(c) = ((c>>15 | c<<17) +
  0xa282ead8) mod 2^32.
* Event proto: wall_time (field 1, double), step (field 2, varint),
  file_version (field 3, string — first record only, "brain.Event:2"),
  summary (field 5, message). Summary: repeated Value (field 1, message);
  Value: tag (field 1, string), simple_value (field 2, float).

(Copied from ``bert4clickpath_tpu/utils/tb.py``, which imports nothing
but the standard library; keep the two in step.)
"""

from __future__ import annotations

import os
import socket
import struct
import time

# -- crc32c (Castagnoli, reflected poly 0x82F63B78) -----------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf primitives ---------------------------------------------------


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


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    value_msg = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, value_msg)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class EventWriter:
    """Append-only scalar event writer; one instance per run directory."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (
            f"events.out.tfevents.{time.time():.6f}."
            f"{socket.gethostname()}{filename_suffix}"
        )
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._record(_version_event(time.time()))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_scalar_event(tag, value, step, time.time()))

    def scalars(self, record: dict, step: int) -> None:
        """Write every numeric entry of ``record`` as its own scalar tag."""
        for k, v in record.items():
            if isinstance(v, bool):
                v = float(v)
            if isinstance(v, (int, float)):
                self.scalar(k, float(v), step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()
