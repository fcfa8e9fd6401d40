"""Speech-to-text data layer (the port's copy of
``openseq2seq_tpu/data/speech2text/speech2text.py``: the same params and
seed give the same batches, feature for feature).

Host pipeline with the contract of the reference's
``Speech2TextDataLayer`` (`open_seq2seq/data/speech2text/speech2text.py:
25-485`): LibriSpeech-style CSVs (``wav_filename,wav_filesize,
transcript``), char vocab (CTC blank implied as the last class) or BPE,
duration filters, deterministic contiguous eval/infer split across
workers, infer-order restoration via source ids. Batches are numpy dicts
with the time and label dims padded to multiples of ``pad_to`` and 8; the
final partial batch is padded by repeating its last example and carries
``batch_valid`` (reference's clip_last_batch, `utils/utils.py:85-92`).

Where the JAX package's copy differs in means, not in results:

  * the CSVs are read with ``csv``, not pandas: the header names the
    columns, rows of several files are concatenated in order;
  * ``features_dtype: bfloat16`` batches hold a ``torch.bfloat16`` tensor
    of the features (rounded to nearest even from fp32, as ml_dtypes
    rounds), which ``models/model.to_device_batch`` copies to the card
    at half the fp32 bytes;
  * the featurizer pools take at most a few examples per worker ahead of
    the batch being collated, so a consumer that stops early (the
    trainer's example batch) does not featurize the rest of the epoch.

With ``featurize_on_device`` the layer ships padded raw audio, (B, N)
fp32 samples with N a multiple of ``hop * pad_to`` and the samples'
lengths, and the model's forward featurizes them
(``ops/features_device.py``); as in the JAX package it then takes only
``input_type: logfbank`` and no host augmentation. In interactive
inference (``interactive``) the layer reads no CSV and
``create_interactive_batch`` makes a batch of one from a wav path or a
(signal, sample rate) pair. ``max_batch_pad_time`` and
``sort_by_duration``, which the JAX package's layer declares and never
reads, are not in the schema, so a config that sets them is refused.
"""
from __future__ import annotations

import collections
import csv
import hashlib
import io
import itertools
import math
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from ..data_layer import DataLayer
from ...ops.features import (_spec_augment, get_speech_features,
                             get_speech_features_from_file, mel_filterbank)


def load_pre_existing_vocabulary(path: str, min_idx: int = 0,
                                 read_chars: bool = False) -> Dict[str, int]:
    """Load a token->id vocabulary from a file with one token per line
    (optionally tab-separated from a count), ids assigned by line order
    starting at ``min_idx`` (reference `utils/utils.py` equivalent)."""
    vocab: Dict[str, int] = {}
    with io.open(path, newline="", encoding="utf-8") as f:
        for idx, line in enumerate(f):
            if read_chars:
                token = line[:-1] if line.endswith("\n") else line
            else:
                token = line.strip().split("\t")[0]
            vocab[token] = idx + min_idx
    return vocab


def read_csvs(paths: List[str], columns: List[str]) -> np.ndarray:
    """The ``columns`` of the CSVs' rows, as strings, the files'
    rows concatenated in order: an object array (rows, len(columns))."""
    rows = []
    for path in paths:
        with io.open(path, newline="", encoding="utf-8") as f:
            reader = csv.DictReader(f)
            missing = set(columns) - set(reader.fieldnames or ())
            if missing:
                raise ValueError("{} has no column {}".format(
                    path, ", ".join(sorted(missing))))
            rows.extend([row[c] for c in columns] for row in reader)
    table = np.empty((len(rows), len(columns)), dtype=object)
    for i, row in enumerate(rows):
        table[i] = row
    return table


# augmentation ops applied AFTER feature extraction (SpecAugment-style
# masks, ops/features.py:_spec_augment) — these are compatible with the
# feature cache: base features are cached once, masks drawn per epoch.
# Audio-level ops (speed perturb, noise) change the features themselves
# and disable caching.
_POST_FEATURE_AUG_KEYS = frozenset(
    {"n_freq_mask", "n_time_mask", "width_freq_mask", "width_time_mask"})


def _featurize_path(p: Dict[str, Any], wav_path: str, rng):
    """Featurize one wav, with an optional npz cache (reference
    ``cache_features`` + hdf5/npy cache, `speech_utils.py:42-90`).
    Configs with audio-level augmentation skip the cache (features
    change per epoch); masks-only augmentation (the flagship Jasper /
    QuartzNet recipes) caches the base features and draws masks on
    load. Module-level so featurizer processes can run it."""
    aug = p.get("augmentation") or {}
    if p.get("cache_features", False) and \
            set(aug) <= _POST_FEATURE_AUG_KEYS:
        cache_dir = p.get("cache_format", "") or \
            os.path.join(os.path.dirname(wav_path), ".feature_cache")
        # the key covers EVERY featurization-affecting param —
        # a stale cache must never survive a config change

        def _stat(name):
            v = p.get(name)
            return (hashlib.md5(np.ascontiguousarray(v).tobytes())
                    .hexdigest() if v is not None else "none")

        key = hashlib.md5("|".join(str(x) for x in (
            wav_path, p["input_type"], p["num_audio_features"],
            p.get("window_stride", 10e-3),
            p.get("window_size", 20e-3),
            p.get("num_fft", None), p.get("window", "hanning"),
            p.get("norm_per_feature", False), p.get("gain", None),
            p.get("dither", 0.0), p.get("backend", "librosa"),
            p.get("sample_freq", 16000),
            _stat("features_mean"), _stat("features_std_dev"),
        )).encode()).hexdigest()
        cache_path = os.path.join(cache_dir, key + ".npz")

        # mask seed drawn BEFORE featurization so cache hits and misses
        # consume the per-example rng identically (featurization itself
        # draws e.g. dither noise) — epoch N's masks don't depend on
        # whether the cache was warm
        mask_seed = (int(rng.randint(2 ** 31 - 1)) if aug and
                     rng is not None else None)

        def _masked(feat):
            if not aug:
                return feat
            r = (np.random.RandomState(mask_seed) if mask_seed is not None
                 else np.random)
            return _spec_augment(feat, aug, r)

        try:
            if os.path.exists(cache_path) and \
                    not p.get("cache_regenerate", False):
                blob = np.load(cache_path)
                return _masked(blob["features"]), float(blob["duration"])
        except Exception:
            pass   # truncated/corrupt cache entry: recompute
        base_p = dict(p, augmentation=None)   # cache BASE features only
        features, duration = get_speech_features_from_file(
            wav_path, base_p, rng=rng)
        try:
            os.makedirs(cache_dir, exist_ok=True)
            # atomic write: a crash mid-save must not leave a
            # poisoned entry behind
            # NB: np.savez appends ".npz" when missing — the tmp name
            # must already end in it or os.replace finds nothing
            tmp = cache_path + ".tmp{}.npz".format(os.getpid())
            np.savez(tmp, features=features, duration=duration)
            os.replace(tmp, cache_path)
        except OSError:
            pass          # read-only dataset dir: serve uncached
        return _masked(features), duration
    return get_speech_features_from_file(wav_path, p, rng=rng)


# --- featurizer process pool ------------------------------------------------
# The numpy featurizer holds the GIL for much of its work, so a thread
# pool scales it little past one core. ``use_process_pool: True``
# featurizes in worker processes started by a forkserver, which import
# this module (numpy and scipy, no torch, nothing of CUDA) and never
# fork the parent, so a pool may start after the parent has used the
# card. Workers receive the params dict once at start; per-example RNG
# seeds keep results identical to the thread path.
_POOL_PARAMS: Dict[str, Any] = {}


def _pool_init(params):
    _POOL_PARAMS.update(params)


def _pool_featurize(task):
    wav_path, seed = task
    rng = np.random.RandomState(seed) if seed is not None else None
    try:
        return ("ok",) + _featurize_path(_POOL_PARAMS, wav_path, rng)
    except (OSError, ValueError) as e:
        # ship (type name, message) so the parent can re-raise the same
        # exception class the thread path would (OSError vs ValueError)
        return ("error", type(e).__name__, str(e))


def _ahead(submit: Callable[[Any], Any], items: Iterable, window: int,
           result: Callable[[Any], Any]) -> Iterator[Any]:
    """``result(submit(x))`` for each x of ``items``, in order, with at
    most ``window`` submitted and not yet yielded."""
    items = iter(items)
    pending = collections.deque(submit(x)
                                for x in itertools.islice(items, window))
    while pending:
        done = pending.popleft()
        for x in itertools.islice(items, 1):
            pending.append(submit(x))
        yield result(done)


class Speech2TextDataLayer(DataLayer):
    """CSV-driven ASR data layer producing (features, length, labels,
    label_length) batches."""

    @staticmethod
    def get_required_params():
        return dict(DataLayer.get_required_params(), **{
            "num_audio_features": int,
            "input_type": ["spectrogram", "mfcc", "logfbank"],
            "vocab_file": str,
            "dataset_files": list,
        })

    @staticmethod
    def get_optional_params():
        return dict(DataLayer.get_optional_params(), **{
            "backend": ["psf", "librosa"],
            "augmentation": dict,
            "pad_to": int,
            "max_duration": float,
            "min_duration": float,
            "bpe": bool,
            "autoregressive": bool,
            "syn_enable": bool,
            "syn_subdirs": list,
            "window_size": float,
            "window_stride": float,
            "dither": float,
            "norm_per_feature": bool,
            "window": ["hanning", "hamming", "none"],
            "num_fft": int,
            "precompute_mel_basis": bool,
            "sample_freq": int,
            "gain": float,
            "features_mean": np.ndarray,
            "features_std_dev": np.ndarray,
            "map_parallel_calls": int,
            "use_process_pool": bool,
            "featurize_on_device": bool,
            "features_dtype": ["float32", "bfloat16"],
        })

    def __init__(self, params, model, num_workers=1, worker_id=0):
        super().__init__(params, model, num_workers, worker_id)
        p = self._params
        p.setdefault("autoregressive", False)
        p.setdefault("bpe", False)
        self.autoregressive = p["autoregressive"]

        if p["bpe"]:
            try:
                import sentencepiece as spm  # optional dependency
            except ImportError as e:
                raise ImportError(
                    "bpe=True requires the sentencepiece package") from e
            self.sp = spm.SentencePieceProcessor()
            self.sp.Load(p["vocab_file"])
            p["tgt_vocab_size"] = len(self.sp) + 1
        else:
            self.sp = None
            p["char2idx"] = load_pre_existing_vocabulary(
                p["vocab_file"], read_chars=True)
            if not self.autoregressive:
                # +1 for the implied CTC blank (last class)
                p["tgt_vocab_size"] = len(p["char2idx"]) + 1
            else:
                n = len(p["char2idx"])
                p["tgt_vocab_size"] = n + 2
                self.start_index, self.end_index = n, n + 1
                p["char2idx"]["<S>"] = self.start_index
                p["char2idx"]["</S>"] = self.end_index
            p["idx2char"] = {i: w for w, i in p["char2idx"].items()}
        self.target_pad_value = 0

        if p.get("featurize_on_device", False):
            # raw-audio batches; host augmentation and the feature cache
            # do not apply to them
            if p["input_type"] != "logfbank":
                raise ValueError("featurize_on_device supports "
                                 "input_type='logfbank' only")
            if p.get("augmentation"):
                raise ValueError("featurize_on_device does not support "
                                 "host-side augmentation")

        if p["mode"] == "eval" and not p.get("augmentation") and \
                not p.get("dither", 0) and \
                not p.get("featurize_on_device", False):
            # in-training evaluation re-featurizes the whole eval set
            # every interval; deterministic eval features are cached by
            # default (reference grew ``cache_features`` for exactly
            # this, `speech_utils.py:42-90` — here it's on by default)
            p.setdefault("cache_features", True)

        p.setdefault("min_duration", -1.0)
        p.setdefault("max_duration", -1.0)
        p.setdefault("window_size", 20e-3)
        p.setdefault("window_stride", 10e-3)
        p.setdefault("sample_freq", 16000)
        p.setdefault("pad_to", 8)
        p.setdefault("batch_size", 1)

        mel_basis = None
        if p.get("precompute_mel_basis", False) and \
                p["input_type"] == "logfbank":
            num_fft = (p.get("num_fft", None) or
                       2 ** math.ceil(math.log2(
                           p["window_size"] * p["sample_freq"])))
            mel_basis = mel_filterbank(p["sample_freq"], num_fft,
                                       n_mels=p["num_audio_features"],
                                       fmin=0, fmax=int(p["sample_freq"] / 2))
        p["mel_basis"] = mel_basis

        aug = p.get("augmentation", {}) or {}
        if "n_freq_mask" in aug:
            if aug.get("width_freq_mask", 10) > p["num_audio_features"]:
                raise ValueError("'width_freq_mask' should be smaller than "
                                 "'num_audio_features'")

        if p.get("syn_enable", False) and not p.get("syn_subdirs"):
            raise ValueError("syn_enable=True requires a non-empty "
                             "'syn_subdirs' list of synthetic-wav "
                             "subdirectories")

        if p.get("interactive", False):
            self.all_files = []
            self._files = []
            return

        columns = ["wav_filename"] if p["mode"] == "infer" else \
            ["wav_filename", "transcript"]
        self.all_files = read_csvs(p["dataset_files"], columns)
        self._files = self._split_data(self.all_files)

    def _split_data(self, data):
        """Deterministic contiguous split across workers for eval/infer
        (training shards by striding batches instead)."""
        if self.params["mode"] != "train" and self._num_workers > 1:
            size = len(data)
            start = size // self._num_workers * self._worker_id
            end = (size if self._worker_id == self._num_workers - 1
                   else size // self._num_workers * (self._worker_id + 1))
            return data[start:end]
        return data

    def get_size_in_samples(self) -> int:
        return len(self._files)

    # ------------------------------------------------------------------
    def _resolve_wav(self, path: str, rng=None) -> str:
        """Synthetic-speech training augmentation (``syn_enable``): CSV
        wav paths are format templates (``.../{}/utt.wav``) and each
        load substitutes one randomly-chosen subdir from
        ``syn_subdirs`` — a different TTS rendition of the utterance
        per epoch (reference `speech2text.py:421-422` +
        `scripts/nsr_create_syn_train_csv.py`)."""
        if self.params.get("syn_enable", False):
            r = rng if rng is not None else self._rng
            path = path.format(
                self.params["syn_subdirs"][
                    int(r.randint(len(self.params["syn_subdirs"])))])
        return path

    def _featurize(self, wav_path: str, rng=None):
        return _featurize_path(self.params, wav_path,
                               rng if rng is not None else self._rng)

    def _load_audio(self, wav_path: str):
        """The raw-audio path of ``featurize_on_device``: the float
        signal (N,) of a wav and its duration in seconds."""
        from scipy.io import wavfile
        sample_freq, signal = wavfile.read(wav_path)
        want = self.params.get("sample_freq", sample_freq)
        if sample_freq != want:
            raise ValueError(
                "The sampling frequency set in params {} does not match "
                "the frequency {} read from file {}".format(
                    want, sample_freq, wav_path))
        if signal.ndim > 1:
            signal = signal.mean(axis=1)
        signal = np.asarray(signal, np.float32)
        return signal, len(signal) / float(sample_freq)

    def _encode_transcript(self, text: str) -> np.ndarray:
        if self.sp is not None:
            ids = self.sp.EncodeAsIds(text)
        else:
            c2i = self.params["char2idx"]
            ids = [c2i[c] for c in text if c in c2i]
        if self.autoregressive:
            ids = [self.start_index] + ids + [self.end_index]
        return np.asarray(ids, dtype=np.int32)

    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        p = self.params
        batch_size = p["batch_size"]
        order = np.arange(len(self._files))
        if p["shuffle"]:
            self._rng.shuffle(order)

        workers = max(int(p.get("map_parallel_calls", 4)), 1)
        # a few examples a worker ahead of the batch being collated
        window = 4 * workers
        randomized = (bool(p.get("augmentation")) or p.get("dither", 0) > 0
                      or p.get("syn_enable", False))
        on_device = p.get("featurize_on_device", False)
        self._epoch_counter += 1

        # augmentation draws come from a per-example RNG seeded by
        # (seed, epoch, index) — thread/process-safe AND
        # order-deterministic, unlike a shared RNG (which would force a
        # single-threaded pipeline on the flagship augmented recipes —
        # the exact configs that need host throughput most)
        def handle(result_iter):
            examples: List[Dict[str, Any]] = []
            for result in result_iter:
                if result[0] == "error":
                    if p["mode"] == "train":
                        continue
                    raise result[2]
                _, global_idx, features, duration, row = result
                if p["mode"] == "train":
                    if 0 < p["max_duration"] < duration:
                        continue
                    if duration < p["min_duration"]:
                        continue
                ex = {"x": features, "idx": int(global_idx)}
                if p["mode"] != "infer":
                    ex["y"] = self._encode_transcript(str(row[1]))
                examples.append(ex)
                if len(examples) == batch_size:
                    yield self._collate(examples)
                    examples = []
            if examples:
                yield self._collate(examples, pad_batch_to=batch_size)

        if p.get("use_process_pool", False) and not on_device:
            yield from handle(self._process_results(order, randomized,
                                                    workers, window))
            return

        from concurrent.futures import ThreadPoolExecutor

        def load(global_idx):
            row = self._files[global_idx]
            rng = self.example_rng(global_idx) if randomized else None
            # fresh RNG for the subdir draw: featurization must see an
            # unconsumed stream so thread- and process-pool paths stay
            # bit-identical (the pool resolves in the parent, then the
            # worker re-creates its rng from the bare seed)
            wav = self._resolve_wav(
                row[0], self.example_rng(global_idx) if randomized
                else None)
            try:
                if on_device:
                    features, duration = self._load_audio(wav)
                else:
                    features, duration = self._featurize(wav, rng=rng)
            except (OSError, ValueError) as e:
                return ("error", global_idx, e)
            return ("ok", global_idx, features, duration, row)

        pool = ThreadPoolExecutor(max_workers=workers)
        try:
            yield from handle(_ahead(lambda i: pool.submit(load, i), order,
                                     window, lambda f: f.result()))
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _process_results(self, order, randomized, workers, window):
        """The featurized examples of ``order`` from a pool of worker
        processes, in order, as the thread path's ``load`` returns
        them."""
        import multiprocessing as mp
        import pickle
        p = self.params
        safe = {}
        for k, v in p.items():
            try:
                pickle.dumps(v)
                safe[k] = v
            except Exception:
                pass   # featurization never needs these
        # forkserver, not fork: this process is multi-threaded (the
        # prefetch thread, torch's) and fork()ing such a process can
        # deadlock on locks held by other threads, or break a CUDA
        # context. Workers get params explicitly via initargs.
        try:
            ctx = mp.get_context("forkserver")
        except ValueError:
            ctx = mp.get_context("spawn")

        def task(i):
            return (self._resolve_wav(
                        self._files[i][0],
                        self.example_rng(i) if randomized else None),
                    self.example_seed(i) if randomized else None)

        with ctx.Pool(workers, initializer=_pool_init,
                      initargs=(safe,)) as pool:
            for gi, res in zip(order, _ahead(
                    lambda i: pool.apply_async(_pool_featurize, (task(i),)),
                    order, window, lambda r: r.get())):
                if res[0] == "error":
                    exc_cls = {"OSError": OSError,
                               "ValueError": ValueError}.get(res[1],
                                                             ValueError)
                    yield ("error", gi, exc_cls(res[2]))
                else:
                    yield ("ok", gi, res[1], res[2], self._files[gi])

    def _collate(self, examples: List[Dict[str, Any]],
                 pad_batch_to: Optional[int] = None) -> Dict[str, Any]:
        p = self.params
        valid = len(examples)
        if pad_batch_to is not None:
            examples = examples + [examples[-1]] * (pad_batch_to - valid)
        pad_to = max(p["pad_to"], 1)
        B = len(examples)
        ids = np.zeros((B,), dtype=np.int32)
        x_len = np.zeros((B,), dtype=np.int32)
        if examples[0]["x"].ndim == 1:
            # raw audio (featurize_on_device): the sample axis padded to a
            # multiple of hop * pad_to, so the frame count on the device
            # is a multiple of pad_to
            hop = int(p.get("window_stride", 10e-3) *
                      p.get("sample_freq", 16000))
            T = self.pad_to_multiple(
                max(e["x"].shape[0] for e in examples), hop * pad_to)
            x = np.zeros((B, T), dtype=np.float32)
        else:
            T = self.pad_to_multiple(
                max(e["x"].shape[0] for e in examples), pad_to)
            x = np.zeros((B, T, examples[0]["x"].shape[1]),
                         dtype=np.float32)
        for i, e in enumerate(examples):
            t = e["x"].shape[0]
            x[i, :t] = e["x"]
            x_len[i] = t
            ids[i] = e["idx"]
        if p.get("features_dtype", "float32") == "bfloat16" and x.ndim == 3:
            # half the bytes of the copy to the card; the encoder casts
            # its input to the compute dtype anyway. Imported here: the
            # featurizer processes import this module and need no torch
            import torch
            x = torch.from_numpy(x).to(torch.bfloat16)
        batch = {
            "source_tensors": [x, x_len],
            "source_ids": ids,
            "batch_valid": np.int32(valid),
        }
        if "y" in examples[0]:
            L = self.pad_to_multiple(
                max(max(len(e["y"]) for e in examples), 1), 8)
            y = np.full((B, L), self.target_pad_value, dtype=np.int32)
            y_len = np.zeros((B,), dtype=np.int32)
            for i, e in enumerate(examples):
                y[i, :len(e["y"])] = e["y"]
                y_len[i] = len(e["y"])
            batch["target_tensors"] = [y, y_len]
        return batch

    def create_interactive_batch(self, model_in):
        """A batch of one from a wav path or a raw (signal, sample rate)
        pair (the streaming ASR contract, reference
        `speech2text.py:326-380`): its features, or with
        ``featurize_on_device`` its padded samples."""
        pad_to = max(self.params["pad_to"], 1)
        if self.params.get("featurize_on_device", False):
            if isinstance(model_in, str):
                signal, _ = self._load_audio(model_in)
            else:
                signal = np.asarray(model_in[0], np.float32)
            hop = int(self.params.get("window_stride", 10e-3) *
                      self.params.get("sample_freq", 16000))
            n = self.pad_to_multiple(len(signal), hop * pad_to)
            x = np.zeros((1, n), dtype=np.float32)
            x[0, :len(signal)] = signal
            length = len(signal)
        else:
            if isinstance(model_in, str):
                features, _ = self._featurize(model_in)
            else:
                signal, sample_freq = model_in
                params = dict(self.params, sample_freq=sample_freq)
                features, _ = get_speech_features(
                    np.asarray(signal), sample_freq, params, rng=self._rng)
            T = self.pad_to_multiple(features.shape[0], pad_to)
            x = np.zeros((1, T, features.shape[1]), dtype=np.float32)
            x[0, :features.shape[0]] = features
            length = features.shape[0]
        return {
            "source_tensors": [x, np.asarray([length], np.int32)],
            "source_ids": np.zeros((1,), np.int32),
            "batch_valid": np.int32(1),
        }

    def decode_ids(self, ids) -> str:
        """Map decoded id sequence (possibly -1-padded) back to text."""
        ids = [int(i) for i in np.asarray(ids).tolist() if int(i) >= 0]
        if self.sp is not None:
            return self.sp.DecodeIds(ids)
        idx2char = self.params["idx2char"]
        return "".join(idx2char.get(i, "") for i in ids)
