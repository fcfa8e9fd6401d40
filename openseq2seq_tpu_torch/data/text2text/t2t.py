"""TFRecord / tf.Example reading without TensorFlow (the port's copy of
``openseq2seq_tpu/data/text2text/t2t.py``, unchanged in behaviour), for the
TransformerDataLayer — reference `open_seq2seq/data/text2text/t2t.py`
consumes Tensor2Tensor-style records with int64 "inputs"/"targets").

TFRecord framing: [len u64][masked crc32c][payload][masked crc32c] —
the same framing as TensorBoard event files (see utils/tb_writer.py).
tf.Example wire format:
  Example: 1=features(Features)
  Features: 1=repeated map entry { 1=key(string) 2=value(Feature) }
  Feature: 1=bytes_list 2=float_list 3=int64_list
  Int64List: 1=repeated varint (possibly packed)
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List

from ...utils.tb_writer import _read_varint


def read_tfrecords(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)                       # length crc
            payload = f.read(length)
            f.read(4)                       # payload crc
            if len(payload) < length:
                return
            yield payload


def parse_example(data: bytes) -> Dict[str, List]:
    """Parse a tf.Example into {key: list-of-values} (int64/float/bytes)."""
    out: Dict[str, List] = {}
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        if key >> 3 == 1 and key & 7 == 2:      # features
            ln, i = _read_varint(data, i)
            _parse_features(data[i:i + ln], out)
            i += ln
        else:
            i = _skip_field(data, i, key & 7)
    return out


def _parse_features(data: bytes, out: Dict[str, List]):
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        if key >> 3 == 1 and key & 7 == 2:      # map entry
            ln, i = _read_varint(data, i)
            _parse_entry(data[i:i + ln], out)
            i += ln
        else:
            i = _skip_field(data, i, key & 7)


def _parse_entry(data: bytes, out: Dict[str, List]):
    i, name, values = 0, None, []
    while i < len(data):
        key, i = _read_varint(data, i)
        num, wt = key >> 3, key & 7
        if num == 1 and wt == 2:                # key
            ln, i = _read_varint(data, i)
            name = data[i:i + ln].decode()
            i += ln
        elif num == 2 and wt == 2:              # Feature
            ln, i = _read_varint(data, i)
            values = _parse_feature(data[i:i + ln])
            i += ln
        else:
            i = _skip_field(data, i, wt)
    if name is not None:
        out[name] = values


def _parse_feature(data: bytes) -> List:
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        num, wt = key >> 3, key & 7
        ln, i = _read_varint(data, i)
        chunk = data[i:i + ln]
        i += ln
        if num == 3:                            # Int64List
            return _parse_int64_list(chunk)
        if num == 2:                            # FloatList (packed f32)
            return list(struct.unpack("<{}f".format(len(chunk) // 4),
                                      chunk))
        if num == 1:                            # BytesList
            vals, j = [], 0
            while j < len(chunk):
                k, j = _read_varint(chunk, j)
                if k & 7 == 2:
                    bl, j = _read_varint(chunk, j)
                    vals.append(chunk[j:j + bl])
                    j += bl
            return vals
    return []


def _parse_int64_list(data: bytes) -> List[int]:
    vals: List[int] = []
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        num, wt = key >> 3, key & 7
        if num == 1 and wt == 2:                # packed
            ln, i = _read_varint(data, i)
            end = i + ln
            while i < end:
                v, i = _read_varint(data, i)
                vals.append(v)
        elif num == 1 and wt == 0:              # unpacked
            v, i = _read_varint(data, i)
            vals.append(v)
        else:
            i = _skip_field(data, i, wt)
    return vals


def _skip_field(data: bytes, i: int, wiretype: int) -> int:
    if wiretype == 0:
        _, i = _read_varint(data, i)
    elif wiretype == 1:
        i += 8
    elif wiretype == 2:
        ln, i = _read_varint(data, i)
        i += ln
    elif wiretype == 5:
        i += 4
    return i


# ---------------------------------------------------------------------------
# writer (for tests and preprocessing pipelines)
# ---------------------------------------------------------------------------
def write_tfrecords(path: str, examples):
    """examples: iterable of {key: list-of-int}. Writes int64 features."""
    from ...utils.tb_writer import _masked_crc, _varint

    def encode_example(feats: Dict[str, List[int]]) -> bytes:
        entries = b""
        for key, values in feats.items():
            packed = b"".join(_varint(int(v)) for v in values)
            int64_list = _varint(1 << 3 | 2) + _varint(len(packed)) + \
                packed
            feature = _varint(3 << 3 | 2) + _varint(len(int64_list)) + \
                int64_list
            entry = (_varint(1 << 3 | 2) + _varint(len(key)) +
                     key.encode() +
                     _varint(2 << 3 | 2) + _varint(len(feature)) +
                     feature)
            entries += _varint(1 << 3 | 2) + _varint(len(entry)) + entry
        return _varint(1 << 3 | 2) + _varint(len(entries)) + entries

    with open(path, "wb") as f:
        for feats in examples:
            payload = encode_example(feats)
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
