"""Gradient transforms over a list of tensors, optax's model in PyTorch.

A :class:`Transform` is a pair of plain functions: ``init(params) ->
state`` and ``update(updates, state, params) -> (updates, state)``, where
``params`` and ``updates`` are lists of tensors in one fixed order (the
module's ``parameters()``). The state is a tree of dicts and lists of
tensors and host ints, so ``torch.save`` writes it and no update syncs
the host. Each transform here follows the optax one of the same name
(optax 0.2): its formula, its defaults and its state fields. Inputs are
not modified in place; the math is fp32.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tensors = List[torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]


def f32(tensors: Tensors) -> Tensors:
    return [t.float() for t in tensors]


def per_tensor(values: torch.Tensor) -> Tensors:
    """A (n,) tensor as n 0-d tensors, one factor per tensor of a list
    (``torch._foreach_mul`` broadcasts each)."""
    return list(values.unbind())


def as_dtype(dtype) -> Optional[torch.dtype]:
    """A dtype given by name (``"bfloat16"``) or as a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it (for
    decay 0.999 that is 1.3e-5 off the exact value)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        f32(tensors))))


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state

    return Transform(init, update)


def _stateless(fn) -> Transform:
    return Transform(lambda params: None,
                     lambda updates, state, params: (fn(updates, params),
                                                     None))


def clip_by_global_norm(max_norm: float) -> Transform:
    """``t`` if the global norm is under ``max_norm``, else
    ``t / norm * max_norm``."""
    def fn(updates, params):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        one = torch.ones_like(g_norm)
        out = torch._foreach_div(updates, torch.where(trigger, one, g_norm))
        torch._foreach_mul_(out, torch.where(trigger, one,
                                             one * max_norm))
        return out
    return _stateless(fn)


def scale_by_schedule(step_size_fn: Callable[[int], float]) -> Transform:
    def update(updates, state, params):
        step_size = step_size_fn(state["count"])
        return (torch._foreach_mul(updates, step_size),
                {"count": state["count"] + 1})
    return Transform(lambda params: {"count": 0}, update)


def scale_by_learning_rate(learning_rate: Callable[[int], float]
                           ) -> Transform:
    return scale_by_schedule(lambda count: -1.0 * learning_rate(count))


def add_decayed_weights(weight_decay: float) -> Transform:
    return _stateless(lambda updates, params: torch._foreach_add(
        updates, f32(params), alpha=weight_decay))


def trace(decay: float, nesterov: bool = False) -> Transform:
    """``trace = g + decay * trace``; the update is the trace, or
    ``g + decay * trace`` again under Nesterov."""
    def update(updates, state, params):
        new_trace = torch._foreach_add(
            updates, torch._foreach_mul(state["trace"], decay))
        out = torch._foreach_add(updates, torch._foreach_mul(
            new_trace, decay)) if nesterov else new_trace
        return out, {"trace": new_trace}
    return Transform(lambda params: {"trace": [torch.zeros_like(
        p, dtype=torch.float32) for p in params]}, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  mu_dtype=None) -> Transform:
    mu_dtype = as_dtype(mu_dtype)

    def init(params):
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=mu_dtype or torch.float32)
                       for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params]}

    def update(updates, state, params):
        g = f32(updates)
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1),
                                torch._foreach_mul(f32(state["mu"]), b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
            torch._foreach_mul(state["nu"], b2))
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, bias_correction(b2, count))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
        out = torch._foreach_div(mu_hat, denom)
        return out, {"count": count,
                     "mu": [m.to(old.dtype) for m, old in
                            zip(mu, state["mu"])], "nu": nu}

    return Transform(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> Transform:
    def update(updates, state, params):
        g = f32(updates)
        sos = torch._foreach_add(torch._foreach_mul(g, g),
                                 state["sum_of_squares"])
        out = [torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * u
               for s, u in zip(sos, g)]
        return out, {"sum_of_squares": sos}
    return Transform(lambda params: {"sum_of_squares": [torch.full_like(
        p, initial_accumulator_value, dtype=torch.float32)
        for p in params]}, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8) -> Transform:
    def update(updates, state, params):
        g = f32(updates)
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - decay),
            torch._foreach_mul(state["nu"], decay))
        out = torch._foreach_mul(torch._foreach_rsqrt(
            torch._foreach_add(nu, eps)), g)
        return out, {"nu": nu}
    return Transform(lambda params: {"nu": [torch.zeros_like(
        p, dtype=torch.float32) for p in params]}, update)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """``optax.MultiSteps``: average the gradients of ``every_k``
    micro-steps and run ``inner`` on the mean every ``every_k``-th step;
    the other steps return zero updates, and ``inner`` (its schedule
    included) advances only on real updates."""
    def init(params):
        return {"mini_step": 0, "gradient_step": 0,
                "inner_opt_state": inner.init(params),
                "acc_grads": [torch.zeros_like(p, dtype=torch.float32)
                              for p in params]}

    def update(updates, state, params):
        n = state["mini_step"]
        acc = state["acc_grads"]
        # Welford running mean, as optax
        acc = torch._foreach_add(acc, torch._foreach_div(
            torch._foreach_sub(f32(updates), acc), n + 1))
        if n < every_k - 1:
            return ([torch.zeros_like(a) for a in acc],
                    dict(state, mini_step=n + 1, acc_grads=acc))
        out, inner_state = inner.update(acc, state["inner_opt_state"], params)
        return out, {"mini_step": 0,
                     "gradient_step": state["gradient_step"] + 1,
                     "inner_opt_state": inner_state,
                     "acc_grads": [torch.zeros_like(a) for a in acc]}

    return Transform(init, update)
