"""Evaluate and infer loops (port of the eval and infer part of
``openseq2seq_tpu/training/trainer.py``).

One process, one device. Batches come from the data layer's host
prefetch thread; each is copied to the model's device inside
``eval_step``, and the step's outputs come back to the host as numpy for
the task hooks. Training lands in a later PR.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from openseq2seq_tpu.utils.logging import deco_print

from .checkpoint import CheckpointManager


def restore_state(model, checkpoint: Optional[str] = None):
    """Seeded initial state, restored from ``checkpoint`` if given."""
    if model.params.get("load_model"):
        raise NotImplementedError("load_model (partial restore) lands "
                                  "with training")
    dl = model.get_data_layer()
    example_batch = next(iter(dl.iterate_one_epoch()))
    state = model.init_state(example_batch)
    if checkpoint:
        state = CheckpointManager.restore(checkpoint, state)
    return state


def to_host(tree: Any) -> Any:
    """Tensors -> numpy (floats as fp32), through dicts and lists."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.is_floating_point():
            t = t.float()
        return t.cpu().numpy()
    return tree


def _run_epoch(model, state, hook):
    dl = model.get_data_layer()
    return [hook(batch, to_host(model.eval_step(state, batch)))
            for batch in dl.prefetch(dl.iterate_one_epoch())]


def evaluate_with_state(model, state, training_step=None) -> Dict[str, Any]:
    """One full eval epoch with an existing state."""
    results = _run_epoch(model, state, model.evaluate)
    return model.finalize_evaluation(results, training_step=training_step)


def evaluate(model, checkpoint: Optional[str]) -> Dict[str, Any]:
    state = restore_state(model, checkpoint)
    metrics = evaluate_with_state(model, state)
    deco_print("Evaluation results: {}".format(
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in metrics.items()}))
    return metrics


def infer(model, checkpoint: Optional[str], output_file: str):
    state = restore_state(model, checkpoint)
    results = _run_epoch(model, state, model.infer)
    model.finalize_inference(results, output_file)
    return results
