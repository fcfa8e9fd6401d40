"""Train, evaluate and infer loops (port of
``openseq2seq_tpu/training/trainer.py``).

One process, one device. Batches come from the data layer's host
prefetch thread and are copied to the model's device inside the step.
Training seeds one ``torch.Generator`` on the device from
``(random_seed, step)`` before each step (``parts/dropout.step_seed``,
the counterpart of ``jax.random.fold_in(base_rng, step)``), so a run
resumed from a checkpoint draws the masks an uninterrupted run would.
The step's metrics stay on the device and are fetched only every
``print_loss_steps`` (and ``save_summaries_steps``), so the host runs
ahead of the card between prints. Print, sample, summary, eval, save and
bench steps follow the JAX package's loop (``trainer.py:96-267``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.config import _latest_checkpoint
from ..utils.logging import deco_print

from ..parts.dropout import step_seed
from .checkpoint import CheckpointManager


def restore_state(model, checkpoint: Optional[str] = None):
    """Seeded initial state, restored from ``checkpoint`` if given, else
    partially from the config's ``load_model`` if set."""
    dl = model.get_data_layer()
    try:
        example_batch = next(iter(dl.iterate_one_epoch()))
    except StopIteration:
        # an interactive data layer reads no dataset: the widths come
        # from a batch of one second of silence
        sr = dl.params.get("sample_freq", 16000)
        example_batch = dl.create_interactive_batch(
            (np.zeros(sr, np.float32), sr))
    state = model.init_state(example_batch)
    if checkpoint:
        state = CheckpointManager.restore(checkpoint, state)
    elif model.params.get("load_model"):
        base = model.params["load_model"]
        CheckpointManager.restore_params_partial(
            _latest_checkpoint(base) or base, state.module)
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(train_model, eval_model=None, checkpoint: Optional[str] = None
          ) -> Dict[str, Any]:
    """The training loop; returns the final state, the step reached, the
    last fetched metrics and, past ``bench_start``, objects per second."""
    params = train_model.params
    if params.get("summaries"):
        raise NotImplementedError("histogram and norm summaries are not "
                                  "ported; scalar ones are")
    logdir = params.get("logdir", "")
    save_steps = params.get("save_checkpoint_steps")
    ckpt_mgr = CheckpointManager(logdir, params.get("num_checkpoints", 5)) \
        if logdir and save_steps is not None else None
    summary_steps = params.get("save_summaries_steps")
    writer = None
    if logdir and summary_steps:
        from ..utils.tb_writer import SummaryWriter
        writer = SummaryWriter(logdir)

    state = restore_state(train_model, checkpoint)
    device = train_model.device
    generator = torch.Generator(device=device)
    seed = params.get("random_seed", 0)
    dl = train_model.get_data_layer()
    batches = dl.prefetch(dl.iterate_forever())

    last_step = train_model.last_step
    print_loss_steps = params.get("print_loss_steps")
    print_samples_steps = params.get("print_samples_steps")
    eval_steps = params.get("eval_steps")
    bench_start = params.get("bench_start", 10)

    step = state.step
    deco_print("Starting training from step {}".format(step))
    bench_objects, bench_t0 = 0, None
    fetched = None
    try:
        while step < last_step:
            batch = next(batches)
            num_objects = train_model.get_num_objects_per_step(batch)
            generator.manual_seed(step_seed(seed, step))
            state, metrics = train_model.train_step(state, batch, generator)
            step = state.step
            if bench_t0 is not None:
                bench_objects += num_objects

            if print_loss_steps and step % print_loss_steps == 0:
                fetched = to_host(metrics)
                train_model.maybe_print_logs(fetched, step)
            if print_samples_steps and step % print_samples_steps == 0:
                train_model.print_samples(
                    batch, to_host(train_model.eval_step(state, batch)),
                    step)
            if writer and step % summary_steps == 0:
                writer.add_scalars(step, {
                    "train/" + k: v for k, v in to_host(metrics).items()})
            if step == bench_start:
                _sync(device)
                bench_t0 = time.time()
                bench_objects = 0
            # the last step's checkpoint is the final save below, after
            # the bench window
            if save_steps and ckpt_mgr and step % save_steps == 0 and \
                    step < last_step:
                ckpt_mgr.save(state, step)
            if eval_steps and eval_model is not None and \
                    step % eval_steps == 0:
                eval_metrics = evaluate_with_state(eval_model, state,
                                                   training_step=step)
                if writer:
                    writer.add_scalars(step, {
                        "eval/" + k.replace(" ", "_"): v
                        for k, v in eval_metrics.items()})
                if ckpt_mgr and "eval_loss" in eval_metrics:
                    ckpt_mgr.save_best(state, step, eval_metrics["eval_loss"])
    finally:
        batches.close()
        if writer:
            writer.close()
    _sync(device)
    result: Dict[str, Any] = {"state": state, "steps": step}
    if bench_t0 is not None and step > bench_start:
        wall = time.time() - bench_t0
        result["objects_per_sec"] = bench_objects / wall
        deco_print("Avg objects per second: {:.3f}".format(
            result["objects_per_sec"]))
        deco_print("Avg time per step: {:.3f}s".format(
            wall / (step - bench_start)))
    if ckpt_mgr:
        ckpt_mgr.save(state, step)
    deco_print("Finished training at step {}".format(step))
    if fetched is not None:
        result["last_metrics"] = fetched
    return result


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
