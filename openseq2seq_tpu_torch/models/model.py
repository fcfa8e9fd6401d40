"""Model abstract class (port of the eval and infer part of
``openseq2seq_tpu/models/model.py``).

Same schema'd config (the JAX package's keys that eval, infer or the
coming training read, plus four TPU knobs accepted as no-ops; a key
that would have no effect here is refused), the same data-layer
construction, and the same
task hooks (``evaluate`` / ``finalize_evaluation`` / ``infer`` /
``finalize_inference``). The state is a :class:`TrainState` holding the
step and the ``nn.Module`` of the whole forward pass, whose parameters
and buffers (the flax ``params`` and ``batch_stats``) live on the
model's ``device``. Parameters are drawn from a ``torch.Generator``
seeded with ``random_seed``.

Training lands in a later PR: :meth:`Model.train_step` raises.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from openseq2seq_tpu.utils.params import check_params

from ..optimizers.mixed_precision import get_mp_policy


@dataclasses.dataclass
class TrainState:
    step: int
    module: torch.nn.Module


class Model(abc.ABC):

    @staticmethod
    def get_required_params():
        return {
            "batch_size_per_gpu": int,
            "data_layer": None,
        }

    @staticmethod
    def get_optional_params():
        return {
            # read by eval and infer
            "logdir": str,
            "eval_batch_size_per_gpu": int,
            "random_seed": int,
            "data_layer_params": dict,
            "dtype": None,                # 'float32' | 'mixed' | 'bfloat16'
            "initializer": None,
            "initializer_params": dict,
            "restore_best_checkpoint": bool,
            "num_epochs": int,
            "max_steps": int,
            # read by training, which lands in a later PR
            "save_summaries_steps": None,
            "print_loss_steps": None,
            "print_samples_steps": None,
            "print_bench_info_steps": None,
            "save_checkpoint_steps": None,
            "num_checkpoints": int,
            "eval_steps": int,
            "finetune": bool,
            "load_model": str,
            "bench_start": int,
            "optimizer": None,
            "optimizer_params": dict,
            "freeze_variables_regex": None,
            "regularizer": None,
            "regularizer_params": dict,
            "lr_policy": None,
            "lr_policy_params": dict,
            "max_grad_norm": float,
            "larc_params": dict,
            "loss_scaling": None,
            "loss_scaling_params": dict,
            "summaries": list,
            "iter_size": int,
            # TPU knobs of the JAX package, no-ops here: RNG
            # implementation and mask width of dropout, activation
            # rematerialization
            "prng_impl": str,
            "dropout_bits": [8, 32],
            "remat": [False, True, "blocks"],
            "dropout_remat": bool,
            # mesh layout, filled in by utils.config.get_base_config; one
            # device here
            "num_model_partitions": int,
            "num_data_partitions": int,
        }

    def __init__(self, params: Dict[str, Any], mode: str = "train",
                 device="cpu", num_workers: int = 1, worker_id: int = 0):
        check_params(params, self.get_required_params(),
                     self.get_optional_params())
        self._params = dict(params)
        if mode not in ("train", "eval", "infer", "interactive_infer"):
            raise ValueError("Unknown mode: {}".format(mode))
        if "max_steps" in params and "num_epochs" in params:
            raise ValueError("You can't provide both max_steps and num_epochs")
        self._mode = mode
        self._interactive = (mode == "interactive_infer")
        self._device = torch.device(device)
        self._dtype_policy = get_mp_policy(self._params.get("dtype"))

        base_seed = self._params.get("random_seed", 0)
        # the data seed is offset per worker; parameter init stays on the
        # base seed so every worker builds the same weights
        self._seed = base_seed + worker_id
        self._init_seed = base_seed

        dl_params = dict(self._params.get("data_layer_params", {}))
        per_device = self._params["batch_size_per_gpu"]
        if mode == "eval" and "eval_batch_size_per_gpu" in self._params:
            per_device = self._params["eval_batch_size_per_gpu"]
        dl_params["batch_size"] = per_device
        dl_params.pop("dtype", None)  # host pipeline is dtype-agnostic
        dl_params["mode"] = "infer" if self._interactive else mode
        dl_params["interactive"] = self._interactive
        if dl_params["mode"] != "train" and dl_params.get("shuffle"):
            dl_params["shuffle"] = False
        self._data_layer = self._params["data_layer"](
            dl_params, model=self, num_workers=num_workers,
            worker_id=worker_id)
        self._data_layer.seed(self._seed)

    @property
    def params(self):
        return self._params

    @property
    def mode(self):
        return self._mode

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def mp_policy(self):
        return self._dtype_policy

    def get_data_layer(self):
        return self._data_layer

    @property
    def has_loss(self) -> bool:
        return True

    @abc.abstractmethod
    def build_module(self, example_batch: Dict[str, Any],
                     generator: torch.Generator) -> torch.nn.Module:
        """The module of the whole forward pass,
        ``module(batch, train) -> output dict``, with weights drawn from
        ``generator``; ``example_batch`` gives the input widths."""

    @abc.abstractmethod
    def compute_loss(self, outputs: Dict[str, Any], batch: Dict[str, Any]):
        """fp32 scalar task loss given forward outputs and the batch."""

    def init_state(self, example_batch: Dict[str, Any]) -> TrainState:
        """Seeded initial weights, built on the host and moved to the
        model's device in the policy's parameter dtype."""
        generator = torch.Generator().manual_seed(self._init_seed)
        module = self.build_module(example_batch, generator)
        module = module.to(self._device)
        for p in module.parameters():
            p.data = p.data.to(self._dtype_policy.param_dtype)
        return TrainState(step=0, module=module.eval())

    def train_step(self, state: TrainState, batch: Dict[str, Any]):
        raise NotImplementedError("training lands in a later PR")

    def eval_step(self, state: TrainState, batch: Dict[str, Any]
                  ) -> Dict[str, Any]:
        """Forward pass without dropout or batch-norm updates; returns
        the outputs, plus the loss when the batch has targets and the
        model has a loss (an infer-mode model has none)."""
        with torch.no_grad():
            device_batch = to_device_batch(batch, self._device)
            outputs = state.module(device_batch, train=False)
            result = {"outputs": outputs}
            if "target_tensors" in batch and self.has_loss:
                result["loss"] = self.compute_loss(outputs, device_batch)
        return result

    # task hooks, overridden by task models
    def evaluate(self, input_values, output_values):
        """Accumulate per-batch eval results (host side, numpy)."""
        return []

    def finalize_evaluation(self, results_per_batch, training_step=None
                            ) -> Dict[str, Any]:
        return {}

    def infer(self, input_values, output_values):
        return []

    def finalize_inference(self, results_per_batch, output_file: str) -> None:
        raise NotImplementedError


def to_device_batch(batch: Any, device: torch.device) -> Any:
    """numpy batch -> tensors on ``device`` (lists and dicts recursed;
    scalars kept)."""
    if isinstance(batch, dict):
        return {k: to_device_batch(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [to_device_batch(v, device) for v in batch]
    if isinstance(batch, np.ndarray) and batch.ndim > 0:
        return torch.from_numpy(batch).to(device)
    return batch
