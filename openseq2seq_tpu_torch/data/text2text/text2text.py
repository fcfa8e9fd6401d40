"""Parallel-text (NMT) data layer.

The port's copy of ``openseq2seq_tpu/data/text2text/text2text.py``, unchanged
in behaviour: the same files and seed give the same batches or ids.

Contract of the reference's ``ParallelTextDataLayer``
(`open_seq2seq/data/text2text/text2text.py:36-298`): tokenized src/tgt
files (one sentence per line, space-delimited), separate vocab files,
special tokens PAD=0 / EOS=1 / S=2 / UNK=3 (`text2text.py:14-34`),
``max_length`` filtering, source gets a trailing EOS, target gets
S ... EOS. Batches are length-bucketed and padded to multiples of 8
(``pad_lengths_to_eight``) for tensor-core-friendly shapes.
"""
from __future__ import annotations

import enum
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..data_layer import DataLayer


class SpecialTextTokens(enum.IntEnum):
    PAD_ID = 0
    EOS_ID = 1
    S_ID = 2
    UNK_ID = 3

    @staticmethod
    def to_string(s_token: int) -> str:
        return {0: "<PAD>", 1: "</S>", 2: "<S>", 3: "<UNK>"}[int(s_token)]


def load_token_vocab(path: str, special_tokens_already_in_vocab: bool = True
                     ) -> Dict[str, int]:
    """token -> id. When specials are not in the file, real tokens start
    at id 4 (after PAD/EOS/S/UNK)."""
    min_idx = 0 if special_tokens_already_in_vocab else 4
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n").split("\t")[0]
            vocab[token] = i + min_idx
    return vocab


class ParallelTextDataLayer(DataLayer):

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "source_file": str,
            "src_vocab_file": str,
            "tgt_vocab_file": str,
            "max_length": int,
            "shuffle": bool,
            "repeat": bool,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "use_targets": bool,
            "delimiter": str,
            "target_file": str,
            "map_parallel_calls": int,
            "pad_lengths_to_eight": bool,
            "pad_vocab_to_eight": bool,
            "special_tokens_already_in_vocab": bool,
            "use_start_token": bool,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        self._use_targets = p.get("use_targets", True)
        self._delimiter = p.get("delimiter", " ")
        self._use_start_token = p.get("use_start_token", True)
        self._pad8 = p.get("pad_lengths_to_eight", False)
        if self._pad8 and p["max_length"] % 8 != 0:
            raise ValueError("If padding to 8 in data layer, then "
                             "max_length should be multiple of 8")
        specials_in_vocab = p.get("special_tokens_already_in_vocab", True)
        self.src_seq2idx = load_token_vocab(p["src_vocab_file"],
                                            specials_in_vocab)
        self.tgt_seq2idx = load_token_vocab(p["tgt_vocab_file"],
                                            specials_in_vocab)
        if not specials_in_vocab:
            for tok in SpecialTextTokens:
                name = SpecialTextTokens.to_string(tok.value)
                self.src_seq2idx[name] = tok.value
                self.tgt_seq2idx[name] = tok.value
        self.src_idx2seq = {i: t for t, i in self.src_seq2idx.items()}
        self.tgt_idx2seq = {i: t for t, i in self.tgt_seq2idx.items()}
        p["src_vocab_size"] = self._maybe_pad8(len(self.src_seq2idx))
        p["tgt_vocab_size"] = self._maybe_pad8(len(self.tgt_seq2idx))
        p.setdefault("batch_size", 8)

        target_file = p.get("target_file", p["source_file"]) \
            if self._use_targets else p["source_file"]
        with open(p["source_file"], encoding="utf-8") as f:
            src_lines = [line.rstrip("\n") for line in f]
        with open(target_file, encoding="utf-8") as f:
            tgt_lines = [line.rstrip("\n") for line in f]
        if len(src_lines) != len(tgt_lines):
            raise ValueError("source and target files must have the same "
                             "number of lines")
        self._examples = self._encode_corpus(src_lines, tgt_lines)
        # deterministic contiguous split for eval/infer workers
        if p["mode"] != "train" and num_workers > 1:
            n = len(self._examples)
            start = n // num_workers * worker_id
            end = (n if worker_id == num_workers - 1
                   else n // num_workers * (worker_id + 1))
            self._examples = self._examples[start:end]

    def _maybe_pad8(self, n: int) -> int:
        if self._params.get("pad_vocab_to_eight", False):
            return (n + 7) // 8 * 8
        return n

    def _encode_corpus(self, src_lines, tgt_lines):
        p = self._params
        max_len = p["max_length"]
        unk = SpecialTextTokens.UNK_ID.value
        examples = []
        for idx, (src, tgt) in enumerate(zip(src_lines, tgt_lines)):
            src_ids = [self.src_seq2idx.get(t, unk)
                       for t in src.split(self._delimiter) if t]
            src_ids.append(SpecialTextTokens.EOS_ID.value)
            tgt_ids = [self.tgt_seq2idx.get(t, unk)
                       for t in tgt.split(self._delimiter) if t]
            if self._use_start_token:
                tgt_ids = [SpecialTextTokens.S_ID.value] + tgt_ids
            tgt_ids.append(SpecialTextTokens.EOS_ID.value)
            if p["mode"] == "train" and (len(src_ids) > max_len or
                                         len(tgt_ids) > max_len):
                continue
            src_ids = src_ids[:max_len]
            tgt_ids = tgt_ids[:max_len]
            examples.append({"idx": idx,
                             "src": np.asarray(src_ids, np.int32),
                             "tgt": np.asarray(tgt_ids, np.int32)})
        return examples

    def get_size_in_samples(self) -> int:
        return len(self._examples)

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self._params
        batch_size = p["batch_size"]
        order = np.arange(len(self._examples))
        if p["shuffle"]:
            self._rng.shuffle(order)
        else:
            # group similar lengths for less padding, stable order
            order = np.argsort([len(self._examples[i]["src"])
                                for i in order], kind="stable")
        batch: List[dict] = []
        for i in order:
            batch.append(self._examples[i])
            if len(batch) == batch_size:
                yield self._collate(batch)
                batch = []
        if batch:
            yield self._collate(batch, pad_batch_to=batch_size)

    def _collate(self, examples, pad_batch_to: Optional[int] = None):
        valid = len(examples)
        if pad_batch_to is not None:
            examples = examples + [examples[-1]] * (pad_batch_to - valid)
        B = len(examples)
        mult = 8 if self._pad8 else 1
        Ts = self.pad_to_multiple(max(len(e["src"]) for e in examples), mult)
        Tt = self.pad_to_multiple(max(len(e["tgt"]) for e in examples), mult)
        pad = SpecialTextTokens.PAD_ID.value
        x = np.full((B, Ts), pad, np.int32)
        y = np.full((B, Tt), pad, np.int32)
        x_len = np.zeros((B,), np.int32)
        y_len = np.zeros((B,), np.int32)
        ids = np.zeros((B,), np.int32)
        for i, e in enumerate(examples):
            x[i, :len(e["src"])] = e["src"]
            x_len[i] = len(e["src"])
            y[i, :len(e["tgt"])] = e["tgt"]
            y_len[i] = len(e["tgt"])
            ids[i] = e["idx"]
        batch = {"source_tensors": [x, x_len],
                 "source_ids": ids,
                 "batch_valid": np.int32(valid)}
        if self._use_targets:
            batch["target_tensors"] = [y, y_len]
        return batch

    # ------------------------------------------------------------------
    def decode_ids(self, ids, side: str = "tgt") -> str:
        """ids -> detokenized string, stopping at EOS, skipping specials."""
        idx2 = self.tgt_idx2seq if side == "tgt" else self.src_idx2seq
        tokens = []
        for i in np.asarray(ids).tolist():
            i = int(i)
            if i == SpecialTextTokens.EOS_ID.value:
                break
            if i in (SpecialTextTokens.PAD_ID.value,
                     SpecialTextTokens.S_ID.value) or i < 0:
                continue
            tokens.append(idx2.get(i, "<UNK>"))
        return self._delimiter.join(tokens)


class TransformerDataLayer(DataLayer):
    """Tensor2Tensor-style TFRecord data layer (reference
    `open_seq2seq/data/text2text/text2text.py:299-388` + `t2t.py`):
    records with int64 "inputs"/"targets" subtoken ids, batched with
    padding. TFRecords are parsed without TensorFlow (see t2t.py)."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "data_dir": str,
            "file_pattern": str,
            "src_vocab_size": int,
            "batch_size": int,
            "max_length": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "delimiter": str,
            "target_file": str,
            "pad_lengths_to_eight": bool,
            "pad_vocab_to_eight": bool,
            "batch_in_tokens": bool,
            # T2T wordpiece vocab file ('subtoken' per line): enables
            # real detokenization for samples/BLEU/infer output, id-
            # compatible with reference-preprocessed TFRecords
            # (reference models/text2text.py + tokenizer.py Subtokenizer)
            "vocab_file": str,
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        import glob as _glob
        p = self._params
        p["tgt_vocab_size"] = p["src_vocab_size"]
        self._subtokenizer = None
        if p.get("vocab_file"):
            from .wordpiece import WordpieceSubtokenizer
            self._subtokenizer = WordpieceSubtokenizer(p["vocab_file"])
        pattern = os.path.join(p["data_dir"], p["file_pattern"])
        files = sorted(_glob.glob(pattern))
        if not files:
            raise FileNotFoundError("No TFRecord files match "
                                    + pattern)
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
            from .t2t import read_tfrecords
            self._size = sum(1 for path in self._files
                             for _ in read_tfrecords(path))
        return self._size

    def decode_ids(self, ids, side: str = "tgt") -> str:
        """ids -> text. With ``vocab_file`` this is true wordpiece
        detokenization (reference Subtokenizer.decode); without it,
        space-joined raw ids (enough for matching-based metrics)."""
        out = []
        for i in np.asarray(ids).tolist():
            i = int(i)
            if i == SpecialTextTokens.EOS_ID.value:
                break
            if i == SpecialTextTokens.PAD_ID.value or i < 0:
                continue
            out.append(i)
        if self._subtokenizer is not None:
            return self._subtokenizer.decode(out)
        return " ".join(str(i) for i in out)

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        from .t2t import parse_example, read_tfrecords
        p = self._params
        B = p["batch_size"]
        files = list(self._files)
        if p["shuffle"]:
            self._rng.shuffle(files)
        buf: List[dict] = []
        idx = 0
        for path in files:
            for record in read_tfrecords(path):
                ex = parse_example(record)
                src = ex.get("inputs", [])
                tgt = ex.get("targets", [])
                if not src or not tgt:
                    continue
                if p["mode"] == "train" and (
                        len(src) > p["max_length"] or
                        len(tgt) > p["max_length"]):
                    continue
                buf.append({"idx": idx,
                            "src": np.asarray(src[:p["max_length"]],
                                              np.int32),
                            "tgt": np.asarray(tgt[:p["max_length"]],
                                              np.int32)})
                idx += 1
                if len(buf) == B:
                    yield self._collate_records(buf, B)
                    buf = []
        if buf:
            valid = len(buf)
            buf += [buf[-1]] * (B - valid)
            yield self._collate_records(buf, valid)

    def _collate_records(self, examples, valid):
        mult = 8 if self._params.get("pad_lengths_to_eight") else 1
        B = len(examples)
        Ts = self.pad_to_multiple(max(len(e["src"]) for e in examples),
                                  mult)
        Tt = self.pad_to_multiple(max(len(e["tgt"]) for e in examples),
                                  mult)
        x = np.zeros((B, Ts), np.int32)
        y = np.zeros((B, Tt), np.int32)
        x_len = np.zeros((B,), np.int32)
        y_len = np.zeros((B,), np.int32)
        ids = np.zeros((B,), np.int32)
        for i, e in enumerate(examples):
            x[i, :len(e["src"])] = e["src"]
            x_len[i] = len(e["src"])
            y[i, :len(e["tgt"])] = e["tgt"]
            y_len[i] = len(e["tgt"])
            ids[i] = e["idx"]
        return {"source_tensors": [x, x_len],
                "target_tensors": [y, y_len],
                "source_ids": ids,
                "batch_valid": np.int32(valid)}
