"""Model abstract class (port of ``openseq2seq_tpu/models/model.py``).

Same schema'd config (the JAX package's keys that the port reads, plus
three TPU knobs accepted as no-ops; a key that would have no effect here
is refused; ``fused_rnn`` takes effect in the models with recurrent
layers and has none in the others), the same data-layer construction,
step accounting (``max_steps``/``num_epochs``, ``steps_in_epoch``,
``last_step``) and lr
schedule defaulting, and the same task hooks (``evaluate`` /
``finalize_evaluation`` / ``infer`` / ``finalize_inference`` /
``maybe_print_logs`` / ``print_samples``). The state is a
:class:`TrainState`: the step, the ``nn.Module`` of the whole forward
pass, whose parameters and buffers (the flax ``params`` and
``batch_stats``) live on the model's ``device``, and in training the
optimizer state and the loss scale. Parameters are drawn from a
``torch.Generator`` seeded with ``random_seed``.

:meth:`Model.train_step` is ``models/model.py:503-581``: the loss (task
loss plus regularizer), its gradients, loss scaling with the update's
gradients zeroed on overflow under the fp16 policies, the optimizer
chain of ``optimizers/optimizers.py``, ``freeze_variables_regex``, and
the metrics ``loss``, ``learning_rate``, ``global_grad_norm`` (and
``loss_scale``, ``skipped_update`` when scaling). It updates the module's
parameters and batch-norm statistics in place, and never syncs the host:
the metrics stay tensors until the trainer fetches them.
"""
from __future__ import annotations

import abc
import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import deco_print
from ..utils.params import check_params

from ..convert import _norm_modules, flax_path, layer_norm_modules
from ..optimizers import (AutomaticLossScaler, build_optimizer, check_grads,
                          get_lr_schedule_from_config, get_mp_policy)
from ..optimizers.transform import global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    module: torch.nn.Module
    opt_state: Any = None          # training only
    loss_scale: Any = None         # automatic loss scaling only


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
            # dropout mask width: 32 exact Bernoulli, 8 keep probability
            # quantized to 1/256 (parts/dropout.py)
            "dropout_bits": [8, 32],
            # the transformer FFN's relu dropout (and PreNormResidual's
            # dropout + residual add) on kernel B2 (ops/fused_dropout.py)
            "fused_residual_dropout": bool,
            # the recurrences of the GRU and LSTM layers on kernels B4 and
            # B3 (ops/gru_scan.py, ops/lstm_scan.py) where their shape is
            # supported; read by the encoders that build such layers
            "fused_rnn": bool,
            # the pretrained LM's vocabulary, as the transfer recipes name
            # it beside their data layer's own ``lm_vocab_file``
            # (``data/lm``), which reads it
            "lm_vocab_file": str,
            # accepted and ignored, as in the JAX package (one process a
            # card here)
            "use_horovod": bool,
            # TPU knobs of the JAX package, no-ops here: RNG
            # implementation of dropout, activation rematerialization
            "prng_impl": str,
            "remat": [False, True, "blocks"],
            "dropout_remat": bool,
            # mesh layout, filled in by utils.config.get_base_config; one
            # device here
            "num_model_partitions": int,
            "num_data_partitions": int,
        }

    def __init__(self, params: Dict[str, Any], mode: str = "train",
                 device="cuda", num_workers: int = 1, worker_id: int = 0):
        check_params(params, self.get_required_params(),
                     self.get_optional_params())
        self._params = dict(params)
        if mode not in ("train", "eval", "infer", "interactive_infer"):
            raise ValueError("Unknown mode: {}".format(mode))
        if "max_steps" in params and "num_epochs" in params:
            raise ValueError("You can't provide both max_steps and num_epochs")
        if mode == "train" and ("max_steps" not in params and
                                "num_epochs" not in params):
            raise ValueError("For training mode either max_steps or "
                             "num_epochs has to be provided")
        self._mode = mode
        self._interactive = (mode == "interactive_infer")
        self._device = torch.device(device)
        if self._device.type == "cuda":
            # cuDNN times its conv algorithms on the first step of each
            # shape and keeps the fastest, as XLA autotunes its convs;
            # its heuristic choice ran Jasper's conv backward several
            # times slower
            torch.backends.cudnn.benchmark = True
        defaults = {"print_samples_steps": None, "print_loss_steps": 10,
                    "save_checkpoint_steps": None,
                    "save_summaries_steps": None,
                    "print_bench_info_steps": None}
        for k, v in defaults.items():
            self._params.setdefault(k, v)
        s = self._params["print_samples_steps"]
        n = self._params["print_loss_steps"]
        if s and n and s % n != 0:
            raise ValueError("print_samples_steps has to be a multiple of "
                             "print_loss_steps")
        self._dtype_policy = get_mp_policy(self._params.get("dtype"))
        self._params.setdefault("iter_size", 1)

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

        self._steps_in_epoch = None
        self._last_step = self._params.get("max_steps", None)
        if mode == "train":
            size = self._data_layer.get_size_in_samples()
            if size > 0:
                # micro-batch steps: with iter_size > 1 the optimizer
                # advances every iter_size-th one
                self._steps_in_epoch = max(size // per_device, 1)
            if "num_epochs" in self._params:
                if self._steps_in_epoch is None:
                    raise ValueError("num_epochs requires a sized data layer")
                self._last_step = (self._params["num_epochs"] *
                                   self._steps_in_epoch)

        self._loss_scaler: Optional[AutomaticLossScaler] = None
        self._static_loss_scale = 1.0
        if self._dtype_policy.use_loss_scaling:
            ls = self._params.get("loss_scaling", "Backoff")
            if isinstance(ls, (int, float)):
                self._static_loss_scale = float(ls)
            else:
                self._loss_scaler = AutomaticLossScaler(
                    algorithm=ls,
                    params=self._params.get("loss_scaling_params"))
        self._tx = None
        self._lr_schedule = None
        self._named = (None, [])

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

    @property
    def steps_in_epoch(self):
        return self._steps_in_epoch

    @property
    def last_step(self):
        return self._last_step

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

    def _resolved_lr_policy_params(self) -> Dict[str, Any]:
        """lr_policy_params with the reference's defaulting: a policy
        that takes ``decay_steps`` decays over the whole run when the
        config does not pin it (minus warmup and ``begin_decay_at``), and
        epoch-bounded policies get ``steps_per_epoch`` from the data
        layer."""
        lr_params = dict(self._params.get("lr_policy_params") or {})
        lr_policy = self._params.get("lr_policy")
        if lr_policy is None:
            return lr_params
        from inspect import signature

        from ..optimizers.lr_policies import LR_POLICY_REGISTRY
        fn = LR_POLICY_REGISTRY.get(lr_policy) \
            if isinstance(lr_policy, str) else lr_policy
        if fn is None:
            return lr_params
        fp = signature(fn).parameters
        if ("decay_steps" in fp and "decay_steps" not in lr_params
                and self._last_step):
            lr_params["decay_steps"] = self._last_step
            if "begin_decay_at" in fp:
                if "warmup_steps" in fp:
                    lr_params["begin_decay_at"] = max(
                        lr_params.get("begin_decay_at", 0),
                        lr_params.get("warmup_steps", 0))
                lr_params["decay_steps"] -= lr_params.get(
                    "begin_decay_at", 0)
        if ("steps_per_epoch" in fp
                and "steps_per_epoch" not in lr_params
                and "num_epochs" in self._params
                and self._steps_in_epoch):
            lr_params["steps_per_epoch"] = self._steps_in_epoch
        return lr_params

    def optimizer(self):
        """The update transform of the config (``optimizers.py``)."""
        if self._tx is None:
            self._tx = build_optimizer(
                optimizer=self._params.get("optimizer", "Adam"),
                optimizer_params=self._params.get("optimizer_params", {}),
                lr_policy=self._params.get("lr_policy"),
                lr_policy_params=self._resolved_lr_policy_params(),
                max_grad_norm=self._params.get("max_grad_norm"),
                larc_params=self._params.get("larc_params"),
                iter_size=self._params.get("iter_size", 1),
            )
        return self._tx

    def learning_rate(self, step: int) -> float:
        """The lr the optimizer applies at micro-batch step ``step``."""
        if self._lr_schedule is None:
            self._lr_schedule = get_lr_schedule_from_config(
                dict(self._params,
                     lr_policy_params=self._resolved_lr_policy_params()))
        iter_size = int(self._params.get("iter_size", 1))
        return float(self._lr_schedule(step // iter_size))

    def regularization_loss(self, module: torch.nn.Module):
        """L1/L2 penalty over the kernels (conv and dense weights),
        fp32, as ``models/model.py:402-427``."""
        reg = self._params.get("regularizer")
        scale = float(self._params.get("regularizer_params", {})
                      .get("scale", 0.0))
        if reg is None or scale == 0.0:
            return 0.0
        total = 0.0
        for path, p in self._named_params(module):
            if path[-1] not in ("kernel", "embedding"):
                continue
            v32 = p.float()
            if reg in ("l2", "L2"):
                total = total + 0.5 * torch.sum(torch.square(v32))
            elif reg in ("l1", "L1"):
                total = total + torch.sum(torch.abs(v32))
            elif callable(reg):
                total = total + reg(v32)
            else:
                raise ValueError("Unknown regularizer {}".format(reg))
        return scale * total

    def init_state(self, example_batch: Dict[str, Any]) -> TrainState:
        """Seeded initial weights, built on the host and moved to the
        model's device in the policy's parameter dtype; in training also
        the optimizer state and the loss scale."""
        generator = torch.Generator().manual_seed(self._init_seed)
        module = self.build_module(example_batch, generator)
        module = module.to(self._device)
        for p in module.parameters():
            p.data = p.data.to(self._dtype_policy.param_dtype)
        state = TrainState(step=0, module=module.eval())
        if self._mode == "train":
            state.opt_state = self.optimizer().init(
                list(module.parameters()))
            if self._loss_scaler is not None:
                state.loss_scale = self._loss_scaler.init(self._device)
        return state

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        """One optimizer step on a host batch; ``generator`` (on the
        model's device) draws the step's dropout masks. Updates the
        module in place and returns the new state and the step's
        metrics, as tensors."""
        module = state.module
        named = self._named_params(module)
        params = [p for _, p in named]
        device_batch = to_device_batch(batch, self._device)
        module.zero_grad(set_to_none=True)
        outputs = module(device_batch, train=True, generator=generator)
        loss = self.compute_loss(outputs, device_batch).float()
        loss = loss + self.regularization_loss(module)
        use_scaling = self._dtype_policy.use_loss_scaling
        scale = None
        if use_scaling:
            scale = (state.loss_scale["scale"] if self._loss_scaler
                     is not None else self._static_loss_scale)
            (loss * scale).backward()
        else:
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        module.zero_grad(set_to_none=True)

        metrics: Dict[str, Any] = {"loss": loss.detach()}
        new_loss_scale = state.loss_scale
        with torch.no_grad():
            if use_scaling:
                grads = torch._foreach_div([g.float() for g in grads],
                                           scale)
                has_nan, amax = check_grads(grads)
                overflow = has_nan | ~torch.isfinite(amax)
                if self._loss_scaler is not None:
                    new_loss_scale = self._loss_scaler.update(
                        state.loss_scale, has_nan, amax)
                    metrics["loss_scale"] = new_loss_scale["scale"]
                # skip the update on overflow (mp_wrapper.py:114-120)
                grads = [torch.where(overflow, 0.0, g) for g in grads]
                metrics["skipped_update"] = overflow.int()
            updates, opt_state = self.optimizer().update(
                grads, state.opt_state, params)
            freeze = self._frozen(named)
            if freeze:
                updates = [torch.zeros_like(u) if f else u
                           for u, f in zip(updates, freeze)]
            if all(p.dtype == torch.float32 for p in params):
                torch._foreach_add_(params, updates)
            else:
                for p, u in zip(params, updates):
                    p.copy_(p.float() + u)
            metrics["learning_rate"] = self.learning_rate(state.step)
            metrics["global_grad_norm"] = global_norm(grads)
        return TrainState(step=state.step + 1, module=module,
                          opt_state=opt_state,
                          loss_scale=new_loss_scale), metrics

    def _named_params(self, module: torch.nn.Module):
        """``_named_params(module)``, kept for the module it was made
        for."""
        if self._named[0] is not module:
            self._named = (module, _named_params(module))
        return self._named[1]

    def _frozen(self, named) -> List[bool]:
        """Per parameter: its flax path matches
        ``freeze_variables_regex`` (empty list when unset)."""
        regex = self._params.get("freeze_variables_regex")
        if not regex:
            return []
        pattern = re.compile(regex)
        return [bool(pattern.search("/".join(path))) for path, _ in named]

    def eval_step(self, state: TrainState, batch: Dict[str, Any]
                  ) -> Dict[str, Any]:
        """Forward pass without dropout or batch-norm updates; returns
        the outputs, plus the loss when the batch has targets and the
        model has a loss (an infer-mode model has none)."""
        with torch.no_grad():
            device_batch = to_device_batch(batch, self._device)
            outputs = state.module(device_batch, train=False,
                                   generator=self.eval_generator())
            result = {"outputs": outputs}
            if "target_tensors" in batch and self.has_loss:
                result["loss"] = self.compute_loss(outputs, device_batch)
        return result

    def eval_generator(self) -> Optional[torch.Generator]:
        """The generator of what a forward pass draws outside training
        (none here: task models whose modules draw, such as the Tacotron
        prenet's dropout, override it)."""
        return None

    # task hooks, overridden by task models
    def maybe_print_logs(self, metrics: Dict[str, Any], step: int) -> None:
        deco_print("Global step {}: loss = {:.4f}, lr = {:.2e}".format(
            step, float(metrics["loss"]), float(metrics["learning_rate"])),
            offset=4)

    def print_samples(self, input_values, output_values, step: int) -> None:
        """Print a sample prediction from the current train batch every
        ``print_samples_steps``. Task models override."""

    def get_num_objects_per_step(self, batch: Dict[str, Any]) -> int:
        """Objects (frames, tokens, images) in a host batch, for the
        objects/s of ``bench_start``."""
        return int(batch["source_tensors"][0].shape[0])

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


def _named_params(module: torch.nn.Module
                  ) -> List[Tuple[Tuple[str, ...], torch.nn.Parameter]]:
    """The module's parameters in their fixed order, each with its flax
    path (``enc/net/conv1_1/kernel``)."""
    norms = _norm_modules([n for n, _ in module.named_buffers()])
    layer_norms = layer_norm_modules(module)
    return [(flax_path(n, norms, layer_norms), p)
            for n, p in module.named_parameters()]


def to_device_batch(batch: Any, device: torch.device) -> Any:
    """numpy batch -> tensors on ``device`` (lists and dicts recursed;
    scalars kept; a host tensor, such as the bf16 features of the speech
    data layer, moved as it is; a tensor already on a device, such as a
    streaming decoder's carry, moved there if it is elsewhere). To a CUDA
    device the copy from the host goes through pinned memory and does not
    wait for the device."""
    if isinstance(batch, dict):
        return {k: to_device_batch(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [to_device_batch(v, device) for v in batch]
    if isinstance(batch, np.ndarray) and batch.ndim > 0:
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor) and batch.ndim > 0:
        if torch.device(device).type == "cuda" and batch.device.type == "cpu":
            return batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)
    return batch
