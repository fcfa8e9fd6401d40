"""Image-classification data layers (the port's copy of
``openseq2seq_tpu/data/image2label/image2label.py``, unchanged in
behaviour: the same files and seed give the same batches).

  * :class:`CifarDataLayer` — the CIFAR-10/100 binary records (1 label
    byte + 3072 image bytes), pad-4 random crop and flip in training,
    per-image standardization;
  * :class:`ImagenetDataLayer` — a class-per-directory tree of JPEGs
    (``train/``, ``val/``), random-resized crop and flip in training, the
    shorter side resized to 256/224 of the crop and a centre crop
    otherwise, mean subtraction;
  * :class:`ImagenetTFRecordDataLayer` — the reference's TFRecord shards
    (``train-*``, ``validation-*``; ``image/encoded``, 1-based
    ``image/class/label``), read through ``data/text2text/t2t.py``.

Batches are (B, H, W, 3) fp32 images, (B,) int32 labels, the examples'
ids and ``batch_valid``. The JPEG layers import PIL inside the functions
that decode, so the port imports where Pillow is absent; there those two
layers raise ImportError when they first decode (the TFRecord layer, which
skips a record it cannot decode, imports it before its first record).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List

import numpy as np

from ..data_layer import DataLayer


class CifarDataLayer(DataLayer):

    _HEIGHT, _WIDTH, _DEPTH = 32, 32, 3

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "data_dir": str,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "num_parallel_calls": int,
            "image_size": int,
            "num_classes": int,
            "files_pattern": str,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("batch_size", 32)
        p.setdefault("num_classes", 10)
        if p["mode"] == "train":
            pattern = p.get("files_pattern", "data_batch_*.bin")
        else:
            pattern = p.get("files_pattern", "test_batch.bin")
        import glob
        files = sorted(glob.glob(os.path.join(p["data_dir"], pattern)))
        if not files:
            raise FileNotFoundError("No CIFAR files matching {} in {}"
                                    .format(pattern, p["data_dir"]))
        records = []
        rec_len = 1 + self._HEIGHT * self._WIDTH * self._DEPTH
        for path in files:
            raw = np.fromfile(path, np.uint8)
            records.append(raw.reshape(-1, rec_len))
        self._records = np.concatenate(records, axis=0)
        if p["mode"] != "train" and num_workers > 1:
            n = len(self._records)
            start = n // num_workers * worker_id
            end = (n if worker_id == num_workers - 1
                   else n // num_workers * (worker_id + 1))
            self._records = self._records[start:end]

    def get_size_in_samples(self) -> int:
        return len(self._records)

    def _preprocess(self, record, train: bool):
        label = int(record[0])
        img = record[1:].reshape(self._DEPTH, self._HEIGHT,
                                 self._WIDTH).transpose(1, 2, 0)
        img = img.astype(np.float32)
        if train:
            # pad 4 + random crop + random flip (standard CIFAR recipe)
            padded = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="constant")
            y = self._rng.randint(0, 9)
            x = self._rng.randint(0, 9)
            img = padded[y:y + self._HEIGHT, x:x + self._WIDTH]
            if self._rng.rand() < 0.5:
                img = img[:, ::-1]
        # per-image standardization
        img = (img - img.mean()) / max(img.std(), 1.0 / np.sqrt(img.size))
        return img, label

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B = p["batch_size"]
        order = np.arange(len(self._records))
        if p["shuffle"]:
            self._rng.shuffle(order)
        train = p["mode"] == "train"
        batch_imgs, batch_labels, batch_ids = [], [], []
        for idx in order:
            img, label = self._preprocess(self._records[idx], train)
            batch_imgs.append(img)
            batch_labels.append(label)
            batch_ids.append(idx)
            if len(batch_imgs) == B:
                yield self._collate(batch_imgs, batch_labels, batch_ids, B)
                batch_imgs, batch_labels, batch_ids = [], [], []
        if batch_imgs:
            valid = len(batch_imgs)
            while len(batch_imgs) < B:
                batch_imgs.append(batch_imgs[-1])
                batch_labels.append(batch_labels[-1])
                batch_ids.append(batch_ids[-1])
            yield self._collate(batch_imgs, batch_labels, batch_ids, valid)

    def _collate(self, imgs, labels, ids, valid):
        return {"source_tensors": [np.stack(imgs).astype(np.float32)],
                "target_tensors": [np.asarray(labels, np.int32)],
                "source_ids": np.asarray(ids, np.int32),
                "batch_valid": np.int32(valid)}


class ImagenetDataLayer(DataLayer):
    """Directory-tree ImageNet reader (JPEG decode via PIL on the
    prefetch thread)."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "data_dir": str,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "num_parallel_calls": int,
            "shuffle_buffer": int,
            "image_size": int,
            "num_classes": int,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("batch_size", 32)
        p.setdefault("image_size", 224)
        p.setdefault("num_classes", 1000)
        split = "train" if p["mode"] == "train" else "val"
        root = os.path.join(p["data_dir"], split)
        if not os.path.isdir(root):
            raise FileNotFoundError("ImageNet split dir not found: {}"
                                    .format(root))
        classes = sorted(os.listdir(root))
        self._examples: List = []
        for ci, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            if not os.path.isdir(cdir):
                continue
            for fname in sorted(os.listdir(cdir)):
                self._examples.append((os.path.join(cdir, fname), ci))
        if p["mode"] != "train" and num_workers > 1:
            n = len(self._examples)
            start = n // num_workers * worker_id
            end = (n if worker_id == num_workers - 1
                   else n // num_workers * (worker_id + 1))
            self._examples = self._examples[start:end]

    def get_size_in_samples(self) -> int:
        return len(self._examples)

    def _load(self, path, train):
        from PIL import Image
        size = self._params["image_size"]
        img = Image.open(path).convert("RGB")
        if train:
            # random resized crop (scale 0.08-1.0)
            w, h = img.size
            area = w * h
            for _ in range(10):
                target = self._rng.uniform(0.08, 1.0) * area
                ar = np.exp(self._rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(target * ar)))
                ch = int(round(np.sqrt(target / ar)))
                if cw <= w and ch <= h:
                    x = self._rng.randint(0, w - cw + 1)
                    y = self._rng.randint(0, h - ch + 1)
                    img = img.crop((x, y, x + cw, y + ch))
                    break
            img = img.resize((size, size))
            arr = np.asarray(img, np.float32)
            if self._rng.rand() < 0.5:
                arr = arr[:, ::-1]
        else:
            # resize shorter side to 256/224 ratio then center crop
            w, h = img.size
            scale = (size * 256 // 224) / min(w, h)
            img = img.resize((int(w * scale), int(h * scale)))
            w, h = img.size
            x = (w - size) // 2
            y = (h - size) // 2
            arr = np.asarray(img.crop((x, y, x + size, y + size)),
                             np.float32)
        mean = np.array([123.68, 116.78, 103.94], np.float32)
        return arr - mean

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B = p["batch_size"]
        order = np.arange(len(self._examples))
        if p["shuffle"]:
            self._rng.shuffle(order)
        train = p["mode"] == "train"
        imgs, labels, ids = [], [], []
        for idx in order:
            path, label = self._examples[idx]
            try:
                imgs.append(self._load(path, train))
            except OSError:
                continue
            labels.append(label)
            ids.append(idx)
            if len(imgs) == B:
                yield {"source_tensors": [np.stack(imgs)],
                       "target_tensors": [np.asarray(labels, np.int32)],
                       "source_ids": np.asarray(ids, np.int32),
                       "batch_valid": np.int32(B)}
                imgs, labels, ids = [], [], []
        if imgs:
            valid = len(imgs)
            while len(imgs) < B:
                imgs.append(imgs[-1])
                labels.append(labels[-1])
                ids.append(ids[-1])
            yield {"source_tensors": [np.stack(imgs)],
                   "target_tensors": [np.asarray(labels, np.int32)],
                   "source_ids": np.asarray(ids, np.int32),
                   "batch_valid": np.int32(valid)}


class ImagenetTFRecordDataLayer(DataLayer):
    """ImageNet TF-Record reader matching the reference's shard layout
    (`image2label.py:160-230`: train-xxxxx-of-01024 /
    validation-xxxxx-of-00128) — records parsed without TensorFlow via
    `data/text2text/t2t.py`, JPEGs decoded with PIL on the prefetch
    thread."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "data_dir": str,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "num_parallel_calls": int,
            "shuffle_buffer": int,
            "image_size": int,
            "num_classes": int,
            "file_pattern": str,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        import glob
        p = self._params
        p.setdefault("batch_size", 32)
        p.setdefault("image_size", 224)
        p.setdefault("num_classes", 1000)
        pattern = p.get("file_pattern",
                        "train-*" if p["mode"] == "train"
                        else "validation-*")
        files = sorted(glob.glob(os.path.join(p["data_dir"], pattern)))
        if not files:
            raise FileNotFoundError("no TFRecord shards match {} in {}"
                                    .format(pattern, p["data_dir"]))
        if p["mode"] != "train" and num_workers > 1:
            n = len(files)
            start = n // num_workers * worker_id
            end = (n if worker_id == num_workers - 1
                   else n // num_workers * (worker_id + 1))
            files = files[start:end]
        self._files = files
        self._size = None

    def get_size_in_samples(self) -> int:
        if self._size is None:
            from ..text2text.t2t import read_tfrecords
            self._size = sum(1 for f in self._files
                             for _ in read_tfrecords(f))
        return self._size

    def _decode(self, example, train):
        from io import BytesIO
        from PIL import Image
        size = self._params["image_size"]
        raw = example.get("image/encoded", [b""])[0]
        label_list = example.get("image/class/label", [0])
        label = int(label_list[0]) - 1 if label_list else 0  # 1-based
        img = Image.open(BytesIO(raw)).convert("RGB")
        if train:
            w, h = img.size
            scale = self._rng.uniform(1.0, 1.2) * size / min(w, h)
            img = img.resize((max(int(w * scale), size),
                              max(int(h * scale), size)))
            w, h = img.size
            x = self._rng.randint(0, w - size + 1)
            y = self._rng.randint(0, h - size + 1)
            arr = np.asarray(img.crop((x, y, x + size, y + size)),
                             np.float32)
            if self._rng.rand() < 0.5:
                arr = arr[:, ::-1]
        else:
            w, h = img.size
            scale = (size * 256 // 224) / min(w, h)
            img = img.resize((int(w * scale), int(h * scale)))
            w, h = img.size
            x0, y0 = (w - size) // 2, (h - size) // 2
            arr = np.asarray(img.crop((x0, y0, x0 + size, y0 + size)),
                             np.float32)
        mean = np.array([123.68, 116.78, 103.94], np.float32)
        return arr - mean, max(label, 0)

    def iterate_one_epoch(self):
        # imported here, where a missing Pillow raises, and not inside the
        # per-record decode, whose failures are skipped
        import PIL.Image  # noqa: F401
        from ..text2text.t2t import parse_example, read_tfrecords
        p = self._params
        B = p["batch_size"]
        train = p["mode"] == "train"
        files = list(self._files)
        if p["shuffle"]:
            self._rng.shuffle(files)
        imgs, labels, ids = [], [], []
        idx = 0
        for path in files:
            for record in read_tfrecords(path):
                try:
                    img, label = self._decode(parse_example(record),
                                              train)
                except Exception:
                    continue
                imgs.append(img)
                labels.append(label)
                ids.append(idx)
                idx += 1
                if len(imgs) == B:
                    yield {"source_tensors": [np.stack(imgs)],
                           "target_tensors": [np.asarray(labels,
                                                         np.int32)],
                           "source_ids": np.asarray(ids, np.int32),
                           "batch_valid": np.int32(B)}
                    imgs, labels, ids = [], [], []
        if imgs:
            valid = len(imgs)
            while len(imgs) < B:
                imgs.append(imgs[-1])
                labels.append(labels[-1])
                ids.append(ids[-1])
            yield {"source_tensors": [np.stack(imgs)],
                   "target_tensors": [np.asarray(labels, np.int32)],
                   "source_ids": np.asarray(ids, np.int32),
                   "batch_valid": np.int32(valid)}
