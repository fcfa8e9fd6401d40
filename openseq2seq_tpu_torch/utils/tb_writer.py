"""Minimal TensorBoard event-file writer, dependency-free: the scalar
writer of ``openseq2seq_tpu/utils/tb_writer.py``, copied for the port
with its ``plot_to_png`` (its reader, image, histogram and audio events
are not).

The reference logs train loss / lr / grad norms / eval metrics as TF
summaries (`open_seq2seq/models/model.py:526-532`,
`utils/hooks.py:120-190`). Without TensorFlow, this module hand-encodes the TFRecord framing (length + masked-CRC32C) and
the Event/Summary protobuf wire format for scalar summaries — enough
for TensorBoard to read loss/lr/metric curves.

Wire format (protobuf):
  Event:  1=wall_time(double) 2=step(int64) 3=file_version(bytes)
          5=summary(Summary)
  Summary: 1=repeated Value;  Value: 1=tag(string) 2=simple_value(float)
"""
from __future__ import annotations

import os
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf encoding helpers
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = b""
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out += bytes([bits | 0x80])
        else:
            return out + bytes([bits])


def _read_varint(data: bytes, i: int):
    """(value, next offset) of the base-128 varint at ``data[i]``."""
    result, shift = 0, 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_bytes(num: int, data: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(data)) + data


def _encode_event(step: Optional[int] = None,
                  scalars: Optional[Dict[str, float]] = None,
                  file_version: Optional[str] = None) -> bytes:
    body = _field_double(1, time.time())
    if step is not None:
        body += _field_varint(2, int(step))
    if file_version is not None:
        body += _field_bytes(3, file_version.encode())
    if scalars:
        values = b""
        for tag, value in scalars.items():
            v = _field_bytes(1, tag.encode()) + _field_float(2,
                                                             float(value))
            values += _field_bytes(1, v)
        body += _field_bytes(5, values)
    return body


class SummaryWriter:
    """Append-only scalar summary writer; one events file per run."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.{}.os2s".format(int(time.time()))
        self._path = os.path.join(logdir, fname)
        self._f = open(self._path, "ab")
        self._write_record(_encode_event(file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        clean = {k: float(v) for k, v in scalars.items()
                 if _is_scalar(v)}
        if clean:
            self._write_record(_encode_event(step=step, scalars=clean))

    def close(self):
        self._f.close()

    @property
    def path(self):
        return self._path


def _is_scalar(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def plot_to_png(matrix, xlabel: str = "", ylabel: str = "") -> tuple:
    """Render a 2-D array (an attention alignment) to PNG bytes with
    matplotlib (Agg backend), imported here: a box without matplotlib
    raises ImportError. Returns (png_bytes, height, width)."""
    import io as _io

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
    ax.imshow(matrix, aspect="auto", origin="lower",
              interpolation="nearest")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    buf = _io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    png = buf.getvalue()
    return png, 400, 600
