"""Language-model and sentiment data layers (the port's copy of
``openseq2seq_tpu/data/lm/lmdata.py``: the same files give the same
vocabulary, windows, targets, lengths and classification batches).

  * :class:`Corpus`: a WikiText-style corpus, whitespace tokens with an
    ``<eos>`` at the end of each line, the vocabulary ``<unk>``, ``<eos>``
    and then the training split's words in sorted order, cached under
    ``processed_data_folder`` as ``vocab.json`` and one ``<split>.npy`` of
    ids a split. The port's ``Corpus`` also writes ``vocab.txt``, one word
    a line in id order: the path the transfer recipes give as
    ``lm_vocab_file``, which the JAX package never writes (C25 in
    ``ROADMAP.md``);
  * :class:`WKTDataLayer`: continuous batching for LM training, the token
    stream laid out as ``batch_size`` parallel tracks, windows of ``bptt``
    tokens served with the next tokens as targets; in training
    ``rand_start`` offsets the first window by a draw from the layer's
    seeded ``numpy.random.RandomState``; ``small`` keeps 1/20th of the
    stream;
  * :class:`IMDBDataLayer` and :class:`SSTDataLayer`: padded word ids and
    sentiment labels for transfer classification, over the LM's
    vocabulary (``lm_vocab_file``).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..data_layer import DataLayer


class Corpus:
    """Tokenized corpus with train/valid/test splits and a vocab."""

    SPLITS = {"train": ("train.txt", "wiki.train.tokens"),
              "valid": ("valid.txt", "wiki.valid.tokens"),
              "test": ("test.txt", "wiki.test.tokens")}

    def __init__(self, data_root: Optional[str], processed_folder: str,
                 min_count: int = 1):
        self.processed = processed_folder
        os.makedirs(processed_folder, exist_ok=True)
        vocab_cache = os.path.join(processed_folder, "vocab.json")
        if os.path.exists(vocab_cache):
            with open(vocab_cache) as f:
                self.word2idx = json.load(f)
        else:
            if data_root is None:
                raise ValueError("data_root required to build the corpus")
            counts: Dict[str, int] = {}
            for tok in self._read_tokens(data_root, "train"):
                counts[tok] = counts.get(tok, 0) + 1
            words = ["<unk>", "<eos>"] + sorted(
                w for w, c in counts.items()
                if c >= min_count and w not in ("<unk>", "<eos>"))
            self.word2idx = {w: i for i, w in enumerate(words)}
            with open(vocab_cache, "w") as f:
                json.dump(self.word2idx, f)
        self.idx2word = {i: w for w, i in self.word2idx.items()}
        vocab_txt = os.path.join(processed_folder, "vocab.txt")
        if not os.path.exists(vocab_txt):
            with open(vocab_txt, "w", encoding="utf-8") as f:
                f.write("".join(self.idx2word[i] + "\n"
                                for i in range(len(self.idx2word))))
        self._data_root = data_root

    def _read_tokens(self, data_root: str, split: str):
        for candidate in self.SPLITS[split]:
            path = os.path.join(data_root, candidate)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        for tok in line.split():
                            yield tok
                        yield "<eos>"
                return
        raise FileNotFoundError("No {} split under {}".format(split,
                                                              data_root))

    def ids(self, split: str) -> np.ndarray:
        cache = os.path.join(self.processed, "{}.npy".format(split))
        if os.path.exists(cache):
            return np.load(cache)
        unk = self.word2idx["<unk>"]
        arr = np.asarray([self.word2idx.get(t, unk)
                          for t in self._read_tokens(self._data_root,
                                                     split)], np.int32)
        np.save(cache, arr)
        return arr

    @property
    def vocab_size(self) -> int:
        return len(self.word2idx)


class WKTDataLayer(DataLayer):

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "repeat": bool,
            "bptt": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "data_root": str,
            "rand_start": bool,
            "small": bool,
            "use_targets": bool,
            "delimiter": str,
            "map_parallel_calls": int,
            "pad_lengths_to_eight": bool,
            "pad_vocab_to_eight": bool,
            "seed_tokens": str,
            "processed_data_folder": str,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("batch_size", 32)
        processed = p.get("processed_data_folder", "wkt-processed_data")
        self.corp = Corpus(p.get("data_root"), processed)
        p["vocab_size"] = self.corp.vocab_size
        p["end_token"] = self.corp.word2idx.get("<eos>", 1)
        split = {"train": "train", "eval": "valid",
                 "infer": "test"}[p["mode"]]
        stream = self.corp.ids(split)
        if p.get("small", False):
            stream = stream[:len(stream) // 20 + 1]
        B = p["batch_size"]
        n_tracks = len(stream) // B
        self._tracks = stream[:n_tracks * B].reshape(B, n_tracks)
        self.bptt = p["bptt"]

    def get_size_in_samples(self) -> int:
        # windows per epoch x batch tracks
        return max((self._tracks.shape[1] - 1) // self.bptt, 1) * \
            self._tracks.shape[0]

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        L = self._tracks.shape[1]
        start = 0
        if p.get("rand_start", False) and p["mode"] == "train":
            start = int(self._rng.randint(0, self.bptt))
        pos = start
        while pos + 1 < L:
            t = min(self.bptt, L - 1 - pos)
            x = self._tracks[:, pos:pos + t]
            y = self._tracks[:, pos + 1:pos + t + 1]
            lengths = np.full((x.shape[0],), t, np.int32)
            yield {"source_tensors": [np.ascontiguousarray(x), lengths],
                   "target_tensors": [np.ascontiguousarray(y), lengths],
                   "source_ids": np.arange(x.shape[0], dtype=np.int32),
                   "batch_valid": np.int32(x.shape[0])}
            pos += t


class TextClassificationDataLayer(DataLayer):
    """Base for padded-sequence + label classification tasks."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "lm_vocab_file": str,
            "repeat": bool,
            "max_length": int,
            "processed_data_folder": str,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "rand_start": bool,
            "small": bool,
            "use_targets": bool,
            "delimiter": str,
            "map_parallel_calls": int,
            "pad_lengths_to_eight": bool,
            "pad_vocab_to_eight": bool,
            "data_root": str,
            "binary": bool,
            "num_classes": int,
            "get_stats": bool,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("batch_size", 16)
        # the pretrained LM's vocabulary, so that the ids are its
        # embedding's rows
        self.word2idx: Dict[str, int] = {}
        with open(p["lm_vocab_file"], encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n").split("\t")[0]
                self.word2idx[tok] = i
        self.unk = self.word2idx.get("<unk>", 0)
        p["vocab_size"] = len(self.word2idx)
        self._examples: List = []

    def _tokenize(self, text: str) -> List[int]:
        tokens = re.findall(r"[A-Za-z']+|[.,!?;]", text.lower())
        ids = [self.word2idx.get(t, self.unk) for t in tokens]
        return ids[:self._params["max_length"]]

    def get_size_in_samples(self) -> int:
        return len(self._examples)

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        B = p["batch_size"]
        order = np.arange(len(self._examples))
        if p["shuffle"]:
            self._rng.shuffle(order)
        chunk: List = []
        for idx in order:
            chunk.append((idx,) + self._examples[idx])
            if len(chunk) == B:
                yield self._collate(chunk, B)
                chunk = []
        if chunk:
            valid = len(chunk)
            chunk += [chunk[-1]] * (B - valid)
            yield self._collate(chunk, valid)

    def _collate(self, chunk, valid):
        B = len(chunk)
        T = self.pad_to_multiple(max(len(c[1]) for c in chunk), 8)
        x = np.zeros((B, T), np.int32)
        lengths = np.zeros((B,), np.int32)
        labels = np.zeros((B,), np.int32)
        ids = np.zeros((B,), np.int32)
        for i, (idx, seq, label) in enumerate(chunk):
            x[i, :len(seq)] = seq
            lengths[i] = max(len(seq), 1)
            labels[i] = label
            ids[i] = idx
        return {"source_tensors": [x, lengths],
                "target_tensors": [labels],
                "source_ids": ids,
                "batch_valid": np.int32(valid)}


class IMDBDataLayer(TextClassificationDataLayer):
    """aclImdb directory layout: {split}/{pos,neg}/*.txt."""

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        self.num_classes = 2 if p.get("binary", True) else 10
        p.setdefault("num_classes", self.num_classes)
        split = "train" if p["mode"] == "train" else "test"
        root = os.path.join(p.get("data_root", ""), split)
        for label, sub in ((1, "pos"), (0, "neg")):
            d = os.path.join(root, sub)
            if not os.path.isdir(d):
                continue
            for fname in sorted(os.listdir(d)):
                with open(os.path.join(d, fname), encoding="utf-8") as f:
                    self._examples.append((self._tokenize(f.read()), label))


class SSTDataLayer(TextClassificationDataLayer):
    """SST-2 tsv layout: {split}.tsv with 'sentence<TAB>label' rows."""

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("num_classes", 2)
        split = {"train": "train", "eval": "dev",
                 "infer": "test"}[p["mode"]]
        path = os.path.join(p.get("data_root", ""),
                            "{}.tsv".format(split))
        with open(path, encoding="utf-8") as f:
            f.readline()                    # the header
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 2:
                    continue
                self._examples.append((self._tokenize(parts[0]),
                                       int(parts[1])))
