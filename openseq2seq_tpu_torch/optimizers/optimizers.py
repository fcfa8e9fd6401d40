"""Optimizer construction from config (port of
``openseq2seq_tpu/optimizers/optimizers.py``).

:func:`build_optimizer` returns one :class:`~.transform.Transform` in the
JAX package's order (``optimizers.py:132-147``): global-norm clipping,
then LARC, then the optimizer's update scaled by ``-lr(step)``;
``iter_size > 1`` wraps it in :func:`~.transform.multi_steps` (optax's
``MultiSteps``). The registry holds the same 7 names with optax's
formulas and the JAX package's defaults.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from . import transform as tx
from .larc import larc as larc_transform
from .lr_policies import make_lr_schedule
from .novograd import scale_by_novograd


def _sgd(p, lr):
    return tx.scale_by_learning_rate(lr)


def _momentum(p, lr):
    return tx.chain(tx.trace(p.get("momentum", 0.9),
                             p.get("use_nesterov", False)),
                    tx.scale_by_learning_rate(lr))


def _adam(p, lr):
    return tx.chain(tx.scale_by_adam(p.get("beta1", 0.9),
                                     p.get("beta2", 0.999),
                                     p.get("epsilon", 1e-8),
                                     p.get("moments_dtype")),
                    tx.scale_by_learning_rate(lr))


def _adamw(p, lr):
    return tx.chain(tx.scale_by_adam(p.get("beta1", 0.9),
                                     p.get("beta2", 0.999),
                                     p.get("epsilon", 1e-8),
                                     p.get("moments_dtype")),
                    tx.add_decayed_weights(p.get("weight_decay", 0.0)),
                    tx.scale_by_learning_rate(lr))


def _adagrad(p, lr):
    return tx.chain(tx.scale_by_rss(p.get("initial_accumulator_value", 0.1)),
                    tx.scale_by_learning_rate(lr))


def _rmsprop(p, lr):
    # optax.rmsprop with momentum=0.0 still chains a (no-op) trace
    return tx.chain(tx.scale_by_rms(p.get("decay", 0.9),
                                    p.get("epsilon", 1e-10)),
                    tx.scale_by_learning_rate(lr),
                    tx.trace(p.get("momentum", 0.0)))


def _novograd(p, lr):
    return tx.chain(
        scale_by_novograd(beta1=p.get("beta1", 0.95),
                          beta2=p.get("beta2", 0.98),
                          epsilon=p.get("epsilon", 1e-8),
                          weight_decay=p.get("weight_decay", 0.0),
                          grad_averaging=p.get("grad_averaging", False),
                          moments_dtype=p.get("moments_dtype")),
        tx.scale_by_learning_rate(lr),
    )


OPTIMIZER_REGISTRY: Dict[str, Callable] = {
    "SGD": _sgd,
    "Momentum": _momentum,
    "Adam": _adam,
    "AdamW": _adamw,
    "Adagrad": _adagrad,
    "RMSProp": _rmsprop,
    "NovoGrad": _novograd,
}


def _schedule(optimizer_params: Dict[str, Any], lr_policy,
              lr_policy_params: Optional[Dict[str, Any]]) -> Callable:
    if lr_policy is None:
        base_lr = optimizer_params.get("learning_rate", None)
        if base_lr is None:
            raise ValueError("Either lr_policy or optimizer_params"
                             "['learning_rate'] must be given")
        return lambda step: base_lr
    lrp = dict(lr_policy_params or {})
    if "learning_rate" not in lrp and "learning_rate" in optimizer_params:
        lrp["learning_rate"] = optimizer_params["learning_rate"]
    return make_lr_schedule(lr_policy, lrp)


def build_optimizer(optimizer: Any,
                    optimizer_params: Optional[Dict[str, Any]] = None,
                    lr_policy: Any = None,
                    lr_policy_params: Optional[Dict[str, Any]] = None,
                    max_grad_norm: Optional[float] = None,
                    larc_params: Optional[Dict[str, Any]] = None,
                    iter_size: int = 1) -> tx.Transform:
    """The whole update of a model config.

    Args:
      optimizer: registry name, or a callable
        ``(optimizer_params, lr_schedule) -> Transform``.
      optimizer_params: the optimizer's hyperparameters.
      lr_policy: schedule callable or registry name; defaults to the fixed
        ``optimizer_params["learning_rate"]``.
      max_grad_norm: clip gradients by global norm if set.
      larc_params: LARC config (``larc_eta`` required).
      iter_size: gradient-accumulation factor (>= 1).
    """
    optimizer_params = dict(optimizer_params or {})
    lr_schedule = _schedule(optimizer_params, lr_policy, lr_policy_params)
    optimizer_params.pop("learning_rate", None)

    if isinstance(optimizer, str):
        if optimizer not in OPTIMIZER_REGISTRY:
            raise ValueError("Unknown optimizer '{}'. Available: {}".format(
                optimizer, sorted(OPTIMIZER_REGISTRY)))
        factory = OPTIMIZER_REGISTRY[optimizer]
    elif callable(optimizer):
        factory = optimizer
    else:
        raise ValueError("optimizer must be a registry name or callable")

    chain = []
    if max_grad_norm is not None and max_grad_norm > 0:
        chain.append(tx.clip_by_global_norm(max_grad_norm))
    if larc_params is not None:
        chain.append(larc_transform(
            larc_eta=float(larc_params["larc_eta"]),
            larc_mode=larc_params.get("larc_mode", "clip"),
            min_update=larc_params.get("min_update", 1e-7),
            epsilon=larc_params.get("epsilon", 1e-7),
            learning_rate=lr_schedule))
    chain.append(factory(optimizer_params, lr_schedule))
    out = tx.chain(*chain)
    if iter_size and iter_size > 1:
        out = tx.multi_steps(out, int(iter_size))
    return out


def get_lr_schedule_from_config(config: Dict[str, Any]) -> Callable:
    """The LR schedule a config describes (for logging)."""
    lrp = dict(config.get("lr_policy_params") or {})
    opt_params = config.get("optimizer_params") or {}
    if "learning_rate" not in lrp and "learning_rate" in opt_params:
        lrp["learning_rate"] = opt_params["learning_rate"]
    lr_policy = config.get("lr_policy")
    if lr_policy is None:
        base = lrp.get("learning_rate", 0.0)
        return lambda step: base
    return make_lr_schedule(lr_policy, lrp)
