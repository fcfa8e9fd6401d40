"""Serving export (port of ``openseq2seq_tpu/serving/export.py``, the
counterpart of the reference's TF-TRT path,
``open_seq2seq/models/model.py:559-696``).

The JAX package serializes its jitted eval step, weights baked in, to
StableHLO with ``jax.export``. Here :func:`export_inference_fn` traces the
model's forward with ``torch.export`` (non-strict, static shapes, as the
JAX artifact's), its parameters and buffers held by the program, and
writes it with ``torch.export.save``; :func:`load_exported` reads it back
with ``torch.export.load`` into a callable of the batch alone. Loading
needs no model code: only this package, which registers the custom op
through which the program launches the flash attention kernel
(``ops/flash_attention.flash_attn_fwd``, B7's forward, built from
``csrc/`` at its first launch).

The exported function takes the batch as the data layers give it, less
what is no array: its arrays (``source_tensors``, ``target_tensors``,
``source_ids``) as tensors on the program's device, its scalars
(``batch_valid``) dropped (:func:`serving_batch`).
"""
from __future__ import annotations

import contextlib
import io
import json
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops import flash_attention  # noqa: F401  (registers the custom op)

# the artifact's own record: the device its tensors live on and the
# ``train`` flag it was traced with
META_FILE = "openseq2seq_serving.json"


def serving_batch(batch: Any, device) -> Any:
    """The batch as an exported program takes it: arrays of rank 1 and up
    as tensors on ``device`` (dicts and lists recursed), everything else
    (a scalar such as ``batch_valid``) left out of dicts."""
    if isinstance(batch, dict):
        out = {}
        for k, v in batch.items():
            v = serving_batch(v, device)
            if v is not None:
                out[k] = v
        return out
    if isinstance(batch, (list, tuple)):
        return [serving_batch(v, device) for v in batch]
    if isinstance(batch, np.ndarray) and batch.ndim > 0:
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor) and batch.ndim > 0:
        return batch.to(device)
    return None


class ServeProgram(torch.nn.Module):
    """``module(batch, train=train)``: the forward that an artifact holds,
    with no dropout generator (a training-mode forward with a dropout rate
    above 0 raises)."""

    def __init__(self, module: torch.nn.Module, train: bool):
        super().__init__()
        self.module = module
        self.train_flag = bool(train)

    def forward(self, batch: Dict[str, Any]):
        return self.module(batch, train=self.train_flag, generator=None)


@contextlib.contextmanager
def _no_stack_traces():
    """Trace without recording each node's Python stack, which took about
    two fifths of the trace of the unrolled on-device beam (about 200
    nodes a frame) on a CPU host; the program is the same."""
    config = torch.fx.config
    if not hasattr(config, "do_not_emit_stack_traces"):
        yield
        return
    saved = config.do_not_emit_stack_traces
    config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        config.do_not_emit_stack_traces = saved


def export_program(program: torch.nn.Module, example_batch, device,
                   meta: Dict[str, Any], path: Optional[str]) -> bytes:
    """Trace ``program(serving_batch(example_batch))`` without autograd
    and serialize it with ``meta``; returns the bytes (also written to
    ``path`` if given)."""
    args = (serving_batch(example_batch, device),)
    with torch.no_grad(), _no_stack_traces():
        exported = torch.export.export(program, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf,
                      extra_files={META_FILE: json.dumps(meta)})
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_inference_fn(model, state, example_batch: Dict[str, Any],
                        path: Optional[str] = None,
                        train: bool = False) -> bytes:
    """Serialize ``state.module``'s forward with its weights held by the
    program. Returns the serialized bytes (and writes them to ``path`` if
    given). The exported function takes only the batch.

    ``train`` is passed to the forward. It departs from the JAX function,
    which always traces ``train=False``: a ``Text2Text`` forward with
    ``train=False`` appends the beam decode, whose host reads no tracer
    takes (``ops/beam_search.refuse_trace`` raises ValueError), so the
    scoring artifact traces the teacher-forced logits with ``train=True``
    and every dropout rate 0, as ``scripts/bench_serving.py`` scores."""
    program = ServeProgram(state.module, train)
    meta = {"device": str(model.device), "train": bool(train)}
    return export_program(program, example_batch, model.device, meta, path)


def load_exported(blob_or_path) -> Callable:
    """Load a serialized artifact (bytes or a path) into a
    ``callable(batch)``, which runs without autograd on the device the
    program was exported on; the loaded ``torch.fx.GraphModule`` is its
    ``program``."""
    src = io.BytesIO(blob_or_path) if isinstance(
        blob_or_path, (bytes, bytearray)) else blob_or_path
    extra = {META_FILE: ""}
    program = torch.export.load(src, extra_files=extra).module()
    device = torch.device(json.loads(extra[META_FILE])["device"])

    def serve(batch):
        with torch.no_grad():
            return program(serving_batch(batch, device))
    serve.program = program
    return serve
