"""Checkpoints in torch format (port of
``openseq2seq_tpu/training/checkpoint.py``).

Layout: ``<logdir>/checkpoints/<step>/model.pt``, a ``torch.save`` of
``{"step", "module", "optimizer", "loss_scale"}``: the forward pass's
``state_dict`` (parameters and batch-norm statistics), the optimizer
state and the loss-scale state (None where the run has none). The
step-numbered directory is what
``utils/config.py:check_logdir`` looks for. Periodic saves
keep the newest ``num_checkpoints``; ``save_best`` keeps one checkpoint
of the lowest eval loss under ``<logdir>/best_models/<step>/`` with the
loss in ``best_models/best_loss.txt``, kept across restarts. A
checkpoint written from an eval state (``{"step", "module"}``) restores
for eval and infer.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from ..utils.logging import deco_print

from ..models.model import TrainState

FILE_NAME = "model.pt"


def _load(path: str, device) -> dict:
    return torch.load(os.path.join(path, FILE_NAME), map_location=device,
                      weights_only=True)


class CheckpointManager:

    def __init__(self, logdir: str, num_checkpoints: int = 5):
        self.logdir = logdir
        self.num_checkpoints = num_checkpoints
        self.ckpt_dir = os.path.join(logdir, "checkpoints")
        self.best_dir = os.path.join(logdir, "best_models")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._best_loss = self._read_best_loss()

    def _best_loss_path(self) -> str:
        return os.path.join(self.best_dir, "best_loss.txt")

    def _read_best_loss(self) -> float:
        """Best eval loss of an earlier run of this logdir; honoured only
        when a best checkpoint exists beside it."""
        try:
            if not any(n.isdigit() for n in os.listdir(self.best_dir)):
                return float("inf")
            with open(self._best_loss_path()) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return float("inf")

    @staticmethod
    def _write(state: TrainState, step: int, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, FILE_NAME + ".tmp")
        torch.save({"step": int(step),
                    "module": state.module.state_dict(),
                    "optimizer": state.opt_state,
                    "loss_scale": state.loss_scale}, tmp)
        os.replace(tmp, os.path.join(path, FILE_NAME))
        return path

    def save(self, state: TrainState, step: int) -> str:
        path = self._write(state, step, os.path.join(self.ckpt_dir,
                                                     str(step)))
        self._gc()
        return path

    def save_best(self, state: TrainState, step: int,
                  eval_loss: float) -> Optional[str]:
        if eval_loss >= self._best_loss:
            return None
        self._best_loss = eval_loss
        os.makedirs(self.best_dir, exist_ok=True)
        for name in os.listdir(self.best_dir):     # keep a single best
            full = os.path.join(self.best_dir, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
        path = self._write(state, step, os.path.join(self.best_dir,
                                                     str(step)))
        with open(self._best_loss_path(), "w") as f:
            f.write(repr(float(eval_loss)))
        deco_print("Saving new best checkpoint (eval loss {:.4f})".format(
            eval_loss), offset=4)
        return path

    def _gc(self):
        steps = sorted(int(n) for n in os.listdir(self.ckpt_dir)
                       if n.isdigit())
        for old in steps[:-self.num_checkpoints]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)),
                          ignore_errors=True)

    @staticmethod
    def restore(path: str, state: TrainState) -> TrainState:
        """Load the checkpoint in directory ``path`` into ``state`` (on
        whatever device its module lives). A training state needs the
        optimizer state in the checkpoint; ``load_model`` starts training
        from the weights alone."""
        device = next(state.module.parameters()).device
        saved = _load(path, device)
        state.module.load_state_dict(saved["module"])
        opt_state, loss_scale = state.opt_state, state.loss_scale
        if opt_state is not None:
            if saved.get("optimizer") is None:
                raise ValueError(
                    "checkpoint {} holds no optimizer state to continue "
                    "training from; load_model starts from its weights"
                    .format(path))
            opt_state = saved["optimizer"]
        if loss_scale is not None and saved.get("loss_scale") is not None:
            loss_scale = saved["loss_scale"]
        return TrainState(step=saved["step"], module=state.module,
                          opt_state=opt_state, loss_scale=loss_scale)

    @staticmethod
    def restore_params_partial(path: str, module: torch.nn.Module) -> None:
        """Transfer-learning restore into ``module``: copy the parameters
        whose name and shape match the checkpoint's (its batch-norm
        statistics and the rest keep their init values), as the JAX
        package's ``restore_params_partial`` does."""
        device = next(module.parameters()).device
        src = _load(path, device)["module"]
        copied, skipped = 0, 0
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name in src and src[name].shape == p.shape:
                    p.copy_(src[name])
                    copied += 1
                else:
                    skipped += 1
        deco_print("Partial restore: {} tensors copied, {} kept from "
                   "init".format(copied, skipped), offset=4)
