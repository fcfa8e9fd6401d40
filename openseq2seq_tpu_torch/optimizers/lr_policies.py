"""Learning-rate policies (port of
``openseq2seq_tpu/optimizers/lr_policies.py``).

Each policy is a plain function of the integer ``global_step`` returning
a Python float: the step is a host counter in the port, so the schedule
costs no device work and no sync. Same names, arguments and defaults as
the JAX package's registry (``lr_policies.py:114-123``); the JAX
versions compute in float32, these in float64 (they agree to float32
rounding).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence


def fixed_lr(global_step, learning_rate: float):
    del global_step
    return float(learning_rate)


def piecewise_constant(global_step, learning_rate: float,
                       boundaries: Sequence[int],
                       decay_rates: Sequence[float],
                       steps_per_epoch: Optional[int] = None):
    """LR is ``learning_rate * decay_rates[i]`` after ``boundaries[i]``.
    Boundaries are epochs when ``steps_per_epoch`` is given, else steps."""
    if steps_per_epoch is not None:
        boundaries = [b * steps_per_epoch for b in boundaries]
    lr = float(learning_rate)
    for boundary, rate in zip(boundaries, decay_rates):
        if global_step >= boundary:
            lr = learning_rate * rate
    return lr


def _warmup(lr, global_step, warmup_steps: int):
    if warmup_steps and warmup_steps > 0 and global_step < warmup_steps:
        return lr * global_step / warmup_steps
    return lr


def exp_decay(global_step, learning_rate: float, decay_steps: int,
              decay_rate: float, use_staircase_decay: bool,
              begin_decay_at: int = 0, min_lr: float = 0.0):
    t = max(global_step - begin_decay_at, 0.0) / decay_steps
    if use_staircase_decay:
        t = math.floor(t)
    lr = learning_rate if global_step < begin_decay_at else \
        learning_rate * decay_rate ** t
    return max(min_lr, lr)


def poly_decay(global_step, learning_rate: float, decay_steps: int,
               power: float = 1.0, begin_decay_at: int = 0,
               min_lr: float = 0.0, warmup_steps: int = 0):
    base = _warmup(float(learning_rate), global_step, warmup_steps)
    if global_step < begin_decay_at:
        return base
    frac = min(max(global_step - begin_decay_at, 0.0) / decay_steps, 1.0)
    return (base - min_lr) * (1.0 - frac) ** power + min_lr


def cosine_decay(global_step, learning_rate: float, decay_steps: int,
                 power: float = 1.0, begin_decay_at: int = 0,
                 min_lr: float = 0.0, warmup_steps: int = 0):
    del power  # accepted for config parity; unused (as in the reference)
    base = _warmup(float(learning_rate), global_step, warmup_steps)
    if global_step < begin_decay_at:
        return base
    frac = min(max(global_step - begin_decay_at, 0.0) / decay_steps, 1.0)
    # tf.train.cosine_decay semantics: alpha (= min_lr) is a fraction floor
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return base * ((1.0 - min_lr) * cosine + min_lr)


def transformer_policy(global_step, learning_rate: float, d_model: int,
                       warmup_steps: int, max_lr: Optional[float] = None,
                       coefficient: float = 1.0):
    """Noam decay with an optional hat (max_lr)."""
    step = global_step + 1.0
    decay = coefficient * d_model ** -0.5 * min(step * warmup_steps ** -1.5,
                                               step ** -0.5)
    lr = decay * learning_rate
    if max_lr is not None:
        lr = min(max_lr, lr)
    return lr


def inv_poly_decay(global_step, learning_rate: float, decay_steps: int,
                   min_lr: float, power: float = 1.0,
                   begin_decay_at: int = 0, warmup_steps: int = 0):
    """lr = lr0 / (1 + scale*t)^power with scale chosen so lr(decay_steps)
    == min_lr."""
    del begin_decay_at, warmup_steps  # the reference ignores them too
    if power <= 0.0:
        raise ValueError("Inv poly decay requires power > 0.")
    min_lr = min(max(min_lr, 1e-8), learning_rate)
    scale = (math.pow(learning_rate / min_lr, 1.0 / power) - 1.0) / decay_steps
    return learning_rate / (1.0 + scale * global_step) ** power


LR_POLICY_REGISTRY: Dict[str, Callable] = {
    "fixed_lr": fixed_lr,
    "fixed": fixed_lr,   # alias used by the lm/transfer recipes
    "piecewise_constant": piecewise_constant,
    "exp_decay": exp_decay,
    "poly_decay": poly_decay,
    "cosine_decay": cosine_decay,
    "transformer_policy": transformer_policy,
    "inv_poly_decay": inv_poly_decay,
}


def make_lr_schedule(lr_policy, lr_policy_params: Optional[Dict[str, Any]]
                     = None) -> Callable[[int], float]:
    """A config's ``lr_policy`` (callable or registry name) and
    ``lr_policy_params`` as a schedule ``step -> lr``."""
    if isinstance(lr_policy, str):
        if lr_policy not in LR_POLICY_REGISTRY:
            raise ValueError("Unknown lr_policy '{}'. Available: {}".format(
                lr_policy, sorted(LR_POLICY_REGISTRY)))
        lr_policy = LR_POLICY_REGISTRY[lr_policy]
    params = dict(lr_policy_params or {})

    def schedule(step):
        return lr_policy(step, **params)

    return schedule
