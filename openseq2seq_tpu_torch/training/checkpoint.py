"""Checkpoints in torch format (port of
``openseq2seq_tpu/training/checkpoint.py``).

Layout: ``<logdir>/checkpoints/<step>/model.pt``, a ``torch.save`` of
``{"step", "module"}`` where ``module`` is the forward pass's
``state_dict`` (parameters and batch-norm statistics). The step-numbered
directory is what ``openseq2seq_tpu.utils.config.check_logdir`` looks
for. Periodic saves keep the newest ``num_checkpoints``. Best-model
checkpoints and partial restore come with training.
"""
from __future__ import annotations

import os
import shutil

import torch

from ..models.model import TrainState

FILE_NAME = "model.pt"


class CheckpointManager:

    def __init__(self, logdir: str, num_checkpoints: int = 5):
        self.logdir = logdir
        self.num_checkpoints = num_checkpoints
        self.ckpt_dir = os.path.join(logdir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def save(self, state: TrainState, step: int) -> str:
        path = os.path.join(self.ckpt_dir, str(step))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, FILE_NAME + ".tmp")
        torch.save({"step": int(step),
                    "module": state.module.state_dict()}, tmp)
        os.replace(tmp, os.path.join(path, FILE_NAME))
        self._gc()
        return path

    def _gc(self):
        steps = sorted(int(n) for n in os.listdir(self.ckpt_dir)
                       if n.isdigit())
        for old in steps[:-self.num_checkpoints]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)),
                          ignore_errors=True)

    @staticmethod
    def restore(path: str, state: TrainState) -> TrainState:
        """Load the checkpoint in directory ``path`` into ``state``'s
        module (on whatever device it lives)."""
        device = next(state.module.parameters()).device
        saved = torch.load(os.path.join(path, FILE_NAME),
                           map_location=device, weights_only=True)
        state.module.load_state_dict(saved["module"])
        return TrainState(step=saved["step"], module=state.module)
