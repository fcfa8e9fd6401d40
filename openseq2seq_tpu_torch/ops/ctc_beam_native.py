"""ctypes binding to the repository's native CTC beam decoder
(``native/ctc_decoder/libos2s_ctc.so``; port of
``openseq2seq_tpu/ops/ctc_beam_native.py``, the same code but for
:func:`build`). The library, which the JAX package binds too, is built
with the directory's ``Makefile`` only when it is absent, into a file of
the building process's own that then replaces it in one rename.

The API mirrors ``ops/ctc_beam.py``'s Python implementation; the tests
hold the two to identical transcripts.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "ctc_decoder")
_SO_PATH = os.path.join(_NATIVE_DIR, "libos2s_ctc.so")

_lib = None


def build(force: bool = False) -> bool:
    """Compile the shared library where it is absent (or with ``force``).
    The Makefile writes a file of this process's own, which then replaces
    the library in one rename, so that a process loading the library
    never reads one half written by another's build. It compiles with
    the system's ``g++``, the Makefile's default, whatever ``CXX`` the
    environment names: the library runs against the ``libstdc++`` that
    the loader finds, and one built by another GCC installation, which a
    ``CXX`` can name, crashed in the scorer's ARPA load."""
    if os.path.exists(_SO_PATH) and not force:
        return True
    tmp = "libos2s_ctc.so.{}.tmp".format(os.getpid())
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "CXX=g++",
                        "TARGET=" + tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(os.path.join(_NATIVE_DIR, tmp), _SO_PATH)
        return True
    except (subprocess.CalledProcessError, OSError):
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH) and not build():
        return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.os2s_scorer_create.restype = ctypes.c_void_p
    lib.os2s_scorer_create.argtypes = [ctypes.c_double, ctypes.c_double,
                                       ctypes.c_char_p, ctypes.c_int]
    lib.os2s_scorer_destroy.argtypes = [ctypes.c_void_p]
    lib.os2s_scorer_set_dict.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.os2s_lm_binarize.restype = ctypes.c_int
    lib.os2s_lm_binarize.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.os2s_lm_logcond.restype = ctypes.c_double
    lib.os2s_lm_logcond.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p]
    lib.os2s_decode_nbest.restype = ctypes.c_int
    lib.os2s_decode_nbest.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    lib.os2s_decode.restype = ctypes.c_int
    lib.os2s_decode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    lib.os2s_decode_batch.restype = ctypes.c_int
    lib.os2s_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double)]
    lib.os2s_stream_create.restype = ctypes.c_void_p
    lib.os2s_stream_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.os2s_stream_destroy.argtypes = [ctypes.c_void_p]
    lib.os2s_stream_reset.argtypes = [ctypes.c_void_p]
    lib.os2s_stream_decode.restype = ctypes.c_int
    lib.os2s_stream_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeScorer:
    def __init__(self, alpha: float, beta: float, arpa_path: str,
                 build_trie: bool = True, dict_constrained: bool = False):
        """``arpa_path`` may be a text ARPA, the mmap binary format
        produced by :func:`binarize`, or a KenLM PROBING ``.binary``
        (all auto-detected from the file magic — reference
        `decoders/scorer.cpp:19-40` loads KenLM binaries the same way).
        ``dict_constrained`` enables the hard lexicon constraint
        (reference FSTMATCH, `decoders/scorer.h:77-89`)."""
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder library not available")
        self._lib = lib
        self._ptr = lib.os2s_scorer_create(alpha, beta,
                                           arpa_path.encode(),
                                           1 if build_trie else 0)
        if not self._ptr:
            raise ValueError("failed to load ARPA LM: " + arpa_path)
        if dict_constrained:
            lib.os2s_scorer_set_dict(self._ptr, 1)

    def log_cond(self, context: Sequence[str], word: str) -> float:
        """Raw log10 P(word | context) from the loaded n-gram model.

        Verification probe: LM-format parity tests assert a KenLM
        ``.binary`` scores identically to its ARPA source through this."""
        return self._lib.os2s_lm_logcond(
            self._ptr, " ".join(context).encode(), word.encode())

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.os2s_scorer_destroy(self._ptr)
            self._ptr = None


def binarize(arpa_path: str, out_path: str) -> None:
    """Convert a text ARPA LM into the mmap-able binary format (the
    KenLM-binary analogue, reference `generate_trie.cpp` /
    `scorer.cpp:60-62` LoadVirtual). Loading the result is near-instant
    (tables stay inside the mapping, binary-searched in place)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder library not available")
    rc = lib.os2s_lm_binarize(arpa_path.encode(), out_path.encode())
    if rc != 0:
        raise ValueError(
            "binarize failed (rc={}): {}".format(rc, arpa_path))


def _alphabet_bytes(alphabet: Sequence[str]) -> bytes:
    s = "".join(alphabet)
    if len(s) != len(alphabet):
        raise ValueError("native decoder supports single-byte alphabets")
    return s.encode("latin-1")


def decode(probs: np.ndarray, alphabet: Sequence[str],
           beam_size: int = 100, cutoff_prob: float = 1.0,
           cutoff_top_n: int = 40, blank_id: int = -1,
           scorer: Optional[NativeScorer] = None):
    lib = _load()
    probs = np.ascontiguousarray(probs, np.float32)
    T, V = probs.shape
    out = ctypes.create_string_buffer(T + 1)
    score = ctypes.c_double()
    times = (ctypes.c_int * T)()
    n = lib.os2s_decode(
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
        _alphabet_bytes(alphabet), beam_size, cutoff_prob, cutoff_top_n,
        blank_id, scorer._ptr if scorer else None, out, T + 1,
        ctypes.byref(score), times, T)
    text = out.value.decode("latin-1")
    return [(score.value, text, [times[i] for i in range(n)])]


def decode_nbest(probs: np.ndarray, alphabet: Sequence[str],
                 nbest: int, beam_size: int = 100,
                 cutoff_prob: float = 1.0, cutoff_top_n: int = 40,
                 blank_id: int = -1,
                 scorer: Optional[NativeScorer] = None):
    """Top-``nbest`` hypotheses for one utterance: [(score, text), ...]
    best-first (feeds the neural rescorer, `apps/lm_rescorer.py`)."""
    lib = _load()
    probs = np.ascontiguousarray(probs, np.float32)
    T, V = probs.shape
    stride = T + 1
    outs = ctypes.create_string_buffer(nbest * stride)
    scores = (ctypes.c_double * nbest)()
    n = lib.os2s_decode_nbest(
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
        _alphabet_bytes(alphabet), beam_size, cutoff_prob, cutoff_top_n,
        blank_id, scorer._ptr if scorer else None, nbest, outs, stride,
        scores)
    results = []
    for i in range(max(n, 0)):
        raw = outs.raw[i * stride:(i + 1) * stride]
        results.append((scores[i], raw.split(b"\0", 1)[0]
                        .decode("latin-1")))
    return results


def decode_batch(probs_list, seq_lens, alphabet, beam_size=100,
                 cutoff_prob=1.0, cutoff_top_n=40, blank_id=-1,
                 scorer: Optional[NativeScorer] = None,
                 num_threads: Optional[int] = None):
    lib = _load()
    B = len(probs_list)
    Tmax = max(int(np.shape(p)[0]) for p in probs_list)
    V = int(np.shape(probs_list[0])[1])
    grid = np.zeros((B, Tmax, V), np.float32)
    for i, p in enumerate(probs_list):
        grid[i, :np.shape(p)[0]] = p
    lens = np.ascontiguousarray(seq_lens, np.int32)
    stride = Tmax + 1
    outs = ctypes.create_string_buffer(B * stride)
    scores = (ctypes.c_double * B)()
    if num_threads is None:
        num_threads = min(B, os.cpu_count() or 1)
    lib.os2s_decode_batch(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), B, Tmax, V,
        _alphabet_bytes(alphabet), beam_size, cutoff_prob, cutoff_top_n,
        blank_id, scorer._ptr if scorer else None, num_threads, outs,
        stride, scores)
    results = []
    for i in range(B):
        raw = outs.raw[i * stride:(i + 1) * stride]
        text = raw.split(b"\0", 1)[0].decode("latin-1")
        results.append([(scores[i], text)])
    return results


class NativeStreamingDecoder:
    """Streaming decoder holding its beam state in C++ (O(chunk) per
    call — unlike the Python fallback, which re-decodes the history)."""

    def __init__(self, alphabet: Sequence[str], beam_size: int = 100,
                 cutoff_prob: float = 1.0, cutoff_top_n: int = 40,
                 blank_id: int = -1,
                 scorer: Optional[NativeScorer] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder library not available")
        self._lib = lib
        self._scorer = scorer  # keep alive
        self._alpha_bytes = _alphabet_bytes(alphabet)
        self._ptr = lib.os2s_stream_create(
            self._alpha_bytes, beam_size, cutoff_prob, cutoff_top_n,
            blank_id, scorer._ptr if scorer else None)
        self._total_frames = 0

    def reset(self):
        self._lib.os2s_stream_reset(self._ptr)
        self._total_frames = 0

    def decode(self, probs_chunk: np.ndarray) -> str:
        probs = np.ascontiguousarray(probs_chunk, np.float32)
        T, V = probs.shape
        self._total_frames += T
        cap = self._total_frames + 1
        out = ctypes.create_string_buffer(cap)
        times = (ctypes.c_int * self._total_frames)()
        n = self._lib.os2s_stream_decode(
            self._ptr, probs.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), T, V, out, cap, times,
            self._total_frames)
        self._last = (out.value.decode("latin-1"),
                      [times[i] for i in range(max(n, 0))])
        return self._last[0]

    def get_word_timestamps(self):
        from .ctc_beam import group_word_timestamps
        text, times = getattr(self, "_last", ("", []))
        return group_word_timestamps(text, times)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.os2s_stream_destroy(self._ptr)
            self._ptr = None
