"""DataLayer base class, the host input pipeline contract (the port's
copy of ``openseq2seq_tpu/data/data_layer.py``, unchanged in behaviour).

A data layer is an iterator factory of numpy batch dicts with static
shapes, ``{"source_tensors": [x, x_length], "target_tensors": [y,
y_length]}`` (targets absent in infer mode), validated against the same
schema as the reference's (`open_seq2seq/data/data_layer.py:16-158`). A
background thread prefetches batches ahead of the device step.
"""
from __future__ import annotations

import abc
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..utils.params import check_params


class DataLayer(abc.ABC):
    """Abstract class from which all data layers must inherit."""

    @staticmethod
    def get_required_params():
        return {
            "mode": ["train", "eval", "infer"],
        }

    @staticmethod
    def get_optional_params():
        return {
            "batch_size": int,
            "shuffle": bool,
            "repeat": bool,
            "dtype": None,
            "interactive": bool,
            "cache_features": bool,
            "cache_format": str,
            "cache_regenerate": bool,
            "shuffle_buffer_size": int,
            "prefetch_buffer_size": int,
        }

    def __init__(self, params: Dict[str, Any], model,
                 num_workers: int = 1, worker_id: int = 0):
        check_params(params, self.get_required_params(),
                     self.get_optional_params())
        self._params = dict(params)
        self._model = model
        self._num_workers = num_workers
        self._worker_id = worker_id
        if "shuffle" not in params:
            self._params["shuffle"] = (params["mode"] == "train")
        if self._params["mode"] != "train" and self._params["shuffle"]:
            raise ValueError("Shuffle should not be performed in "
                             "{} mode".format(self._params["mode"]))
        self._rng = np.random.RandomState()
        self._base_seed = 0
        self._epoch_counter = 0

    @property
    def params(self) -> Dict[str, Any]:
        return self._params

    def seed(self, seed: int) -> None:
        """Seed this layer's augmentation/shuffle RNG (per-worker offsets
        are applied by the Model, reference `models/model.py:308-313`)."""
        self._rng = np.random.RandomState(seed)
        self._base_seed = int(seed)

    def example_seed(self, example_idx: int) -> int:
        """Deterministic per-example augmentation seed from
        (layer seed, epoch, example index)."""
        return (self._base_seed * 1000003 +
                self._epoch_counter * 8191 +
                int(example_idx)) % (2 ** 31 - 1)

    def example_rng(self, example_idx: int) -> np.random.RandomState:
        """A thread-safe per-example RNG for augmentation — deterministic
        regardless of how many featurizer threads/processes run or in
        which order they finish."""
        return np.random.RandomState(self.example_seed(example_idx))

    @abc.abstractmethod
    def get_size_in_samples(self) -> int:
        """Number of examples this worker's shard will iterate over."""

    @abc.abstractmethod
    def iterate_one_epoch(self) -> Iterator[Dict[str, Any]]:
        """Yield batch dicts for exactly one epoch (eval/infer order must
        be deterministic; the last batch may be partially padded — include
        a 'batch_valid' int so eval can clip it, mirroring the reference's
        clip_last_batch `utils/utils.py:85-92`)."""

    # ------------------------------------------------------------------
    # iteration drivers
    # ------------------------------------------------------------------
    def iterate_forever(self) -> Iterator[Dict[str, Any]]:
        while True:
            got_any = False
            for batch in self.iterate_one_epoch():
                got_any = True
                yield batch
            if not got_any:
                raise ValueError("Data layer produced an empty epoch")

    def prefetch(self, iterator: Iterator, buffer_size: Optional[int] = None
                 ) -> Iterator[Dict[str, Any]]:
        """Run ``iterator`` in a daemon thread with a bounded queue so
        featurization overlaps device compute."""
        buffer_size = buffer_size or self._params.get("prefetch_buffer_size", 4)
        q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def _put(item) -> bool:
            # timed puts so an abandoned generator (train loop stopped
            # at last_step, consumer .close()d) releases this thread
            # instead of leaking it blocked on a full queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterator:
                    if not _put(item):
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=worker, daemon=True,
                             name="data_layer_prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            with q.mutex:
                q.queue.clear()

    # ------------------------------------------------------------------
    # interactive-infer contract (streaming apps feed one example at a
    # time; reference `data/data_layer.py` create_interactive_placeholders
    # / create_feed_dict)
    # ------------------------------------------------------------------
    def create_interactive_batch(self, model_in):
        raise NotImplementedError(
            "{} does not support interactive inference".format(type(self).__name__))

    @staticmethod
    def pad_to_multiple(length: int, multiple: int) -> int:
        if multiple <= 1:
            return length
        return ((length + multiple - 1) // multiple) * multiple
