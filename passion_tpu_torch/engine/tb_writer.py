"""Pure-python TensorBoard event-file writer (copy of
`passion_tpu/engine/tb_writer.py`; no TF or tensorboard dependency, which
the machine with the card does not have, so `torch.utils.tensorboard` is
not used).

The reference's second observability channel is TensorBoard scalars
(reference train.py:39,184,342-354 — tags lr, epoch_*_losses, kl_m{m},
sep_m{m}, proto_m{m}, dist_m{m}, rp_m{m}). This writer emits real
`events.out.tfevents.*` files that TensorBoard loads, implementing just the
pieces the scalar channel needs:

  * TFRecord framing: <u64 length><u32 masked-crc32c(length)><payload>
    <u32 masked-crc32c(payload)>;
  * Event protobuf: wall_time (double, field 1), step (int64, field 2),
    file_version (string, field 3), summary (field 5);
  * Summary/Value protobuf: value (field 1) { tag (field 1),
    simple_value (float, field 2) }.

Hand-rolled because the environment ships neither tensorflow nor the
tensorboard wheel, and the schema needed here is tiny and frozen.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli polynomial
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding
# ---------------------------------------------------------------------------

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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def scalar_event(tag: str, value: float, step: int,
                 wall_time: float | None = None) -> bytes:
    """Serialized Event proto carrying one Summary scalar."""
    val = (_field_bytes(1, tag.encode("utf-8"))
           + _field_float(2, float(value)))
    summary = _field_bytes(1, val)
    return (_field_double(1, time.time() if wall_time is None else wall_time)
            + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def version_event(wall_time: float | None = None) -> bytes:
    return (_field_double(1, time.time() if wall_time is None else wall_time)
            + _field_bytes(3, b"brain.Event:2"))


def tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TensorBoardWriter:
    """Drop-in ScalarWriter with real TensorBoard event files.

    Mirrors `SummaryWriter(os.path.join(savepath, 'summary'))` (reference
    train.py:39): files land in `{savepath}/summary/` and carry the exact
    reference tag set when driven by `fit`.
    """

    def __init__(self, savepath: str, subdir: str = "summary"):
        logdir = os.path.join(savepath, subdir) if subdir else savepath
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname())
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._f.write(tfrecord(version_event()))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, global_step: int):
        self._f.write(tfrecord(scalar_event(tag, value, global_step)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.flush()
        self._f.close()


# ---------------------------------------------------------------------------
# reader (round-trip tests + offline inspection of our own files)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def read_scalars(path: str) -> list[tuple[int, str, float]]:
    """Parse an event file written by TensorBoardWriter (or any TB scalar
    file) into (step, tag, simple_value) rows, verifying record CRCs."""
    rows = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        (length,) = struct.unpack_from("<Q", data, i)
        (hcrc,) = struct.unpack_from("<I", data, i + 8)
        if _masked_crc(data[i:i + 8]) != hcrc:
            raise ValueError(f"length crc mismatch at byte {i}")
        payload = data[i + 12:i + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, i + 12 + length)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"payload crc mismatch at byte {i}")
        i += 16 + length
        rows.extend(_event_scalars(payload))
    return rows


def _event_scalars(ev: bytes) -> list[tuple[int, str, float]]:
    i, step, summaries = 0, 0, []
    while i < len(ev):
        key, i = _read_varint(ev, i)
        num, wt = key >> 3, key & 7
        if wt == 1:
            i += 8
        elif wt == 5:
            i += 4
        elif wt == 0:
            v, i = _read_varint(ev, i)
            if num == 2:
                step = v
        else:
            ln, i = _read_varint(ev, i)
            if num == 5:
                summaries.append(ev[i:i + ln])
            i += ln
    rows = []
    for s in summaries:
        i = 0
        while i < len(s):
            key, i = _read_varint(s, i)
            ln, i = _read_varint(s, i)
            if key >> 3 == 1:
                rows.append(_value_scalar(step, s[i:i + ln]))
            i += ln
    return [r for r in rows if r is not None]


def _value_scalar(step: int, val: bytes):
    i, tag, sv = 0, None, None
    while i < len(val):
        key, i = _read_varint(val, i)
        num, wt = key >> 3, key & 7
        if wt == 2:
            ln, i = _read_varint(val, i)
            if num == 1:
                tag = val[i:i + ln].decode("utf-8")
            i += ln
        elif wt == 5:
            if num == 2:
                (sv,) = struct.unpack_from("<f", val, i)
            i += 4
        elif wt == 1:
            i += 8
        else:
            _, i = _read_varint(val, i)
    if tag is None or sv is None:
        return None
    return (step, tag, sv)
