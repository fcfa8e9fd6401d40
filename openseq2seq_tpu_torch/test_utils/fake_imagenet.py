"""A small ImageNet-shaped set: the class-per-directory JPEG tree that
``ImagenetDataLayer`` reads (``train/<class>/*.jpg``, ``val/<class>/
*.jpg``) and TFRecord shards in the reference's layout
(``train-00000-of-00001``, ``validation-00000-of-00001``; features
``image/encoded`` (JPEG bytes) and ``image/class/label`` (1-based)) that
``ImagenetTFRecordDataLayer`` reads. Images are of several sizes and
aspect ratios, so the layers' crops and resizes all run. Needs Pillow
to encode the JPEGs.

    python -m openseq2seq_tpu_torch.test_utils.fake_imagenet <dir>
"""
from __future__ import annotations

import argparse
import io
import os
import struct
from typing import Dict, List, Sequence

import numpy as np

from ..utils.tb_writer import _masked_crc, _varint


def _jpeg(rng: np.random.RandomState, label: int) -> bytes:
    from PIL import Image
    h, w = int(rng.randint(160, 320)), int(rng.randint(160, 320))
    base = np.zeros((h, w, 3), np.float32)
    base[..., label % 3] = 180.0
    img = np.clip(base + rng.randn(h, w, 3) * 30 + 40, 0, 255)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG",
                                               quality=90)
    return buf.getvalue()


def _example(feats: Dict[str, Sequence]) -> bytes:
    """A tf.train.Example of int64 lists and byte strings."""
    entries = b""
    for key, values in feats.items():
        if isinstance(values[0], bytes):
            packed = b"".join(_varint(1 << 3 | 2) + _varint(len(v)) + v
                              for v in values)
            kind = 1                                  # BytesList
        else:
            ints = b"".join(_varint(int(v)) for v in values)
            packed = _varint(1 << 3 | 2) + _varint(len(ints)) + ints
            kind = 3                                  # Int64List
        feature = _varint(kind << 3 | 2) + _varint(len(packed)) + packed
        entry = (_varint(1 << 3 | 2) + _varint(len(key)) + key.encode() +
                 _varint(2 << 3 | 2) + _varint(len(feature)) + feature)
        entries += _varint(1 << 3 | 2) + _varint(len(entry)) + entry
    return _varint(1 << 3 | 2) + _varint(len(entries)) + entries


def write_tfrecord(path: str, examples: List[Dict[str, Sequence]]) -> None:
    with open(path, "wb") as f:
        for feats in examples:
            payload = _example(feats)
            header = struct.pack("<Q", len(payload))
            f.write(header + struct.pack("<I", _masked_crc(header)))
            f.write(payload + struct.pack("<I", _masked_crc(payload)))


def generate(out_dir: str, num_classes: int = 4, per_class: int = 3,
             seed: int = 0) -> str:
    """Write both layouts under ``out_dir``: ``per_class`` images a class
    in each split, the same images as JPEG files and as records; returns
    ``out_dir``."""
    rng = np.random.RandomState(seed)
    for split, shard in (("train", "train-00000-of-00001"),
                         ("val", "validation-00000-of-00001")):
        records = []
        for c in range(num_classes):
            cdir = os.path.join(out_dir, split, "n{:08d}".format(c))
            os.makedirs(cdir, exist_ok=True)
            for i in range(per_class):
                data = _jpeg(rng, c)
                with open(os.path.join(cdir, "{}.JPEG".format(i)),
                          "wb") as f:
                    f.write(data)
                records.append({"image/encoded": [data],
                                "image/class/label": [c + 1]})
        write_tfrecord(os.path.join(out_dir, shard), records)
    return out_dir


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir")
    parser.add_argument("--classes", type=int, default=4)
    parser.add_argument("--per-class", type=int, default=3)
    a = parser.parse_args()
    generate(a.out_dir, a.classes, a.per_class)
