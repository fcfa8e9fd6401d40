"""Automatic loss scaling for fp16 training (port of
``openseq2seq_tpu/optimizers/loss_scaler.py``).

The reference's two algorithms:

  * Backoff: divide the scale by ``step_factor`` on overflow; multiply it
    every ``step_window`` clean steps (counted since the last overflow).
  * LogMax: model log2(amax) with fast and slow EMAs; pick the scale that
    puts the (mu + k * sigma) quantile at 2^16.

The state is a dict of 0-d tensors on the model's device and ``update``
is a pure function of it, so the train step never syncs the host for it.
The train step zeroes the gradients on overflow before the optimizer
runs, as the JAX package does (``models/model.py:522-535``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

LossScaleState = Dict[str, torch.Tensor]


def check_grads(grads) -> Tuple[torch.Tensor, torch.Tensor]:
    """(has a non-finite value, max |g|) over a list of gradients."""
    amax = torch.stack(torch._foreach_norm([g.float() for g in grads],
                                           float("inf"))).max()
    return ~torch.isfinite(amax), amax


class AutomaticLossScaler:
    """Config-compatible factory: ``AutomaticLossScaler("Backoff", params)``."""

    SUPPORTED_ALGOS = ("backoff", "logmax")

    def __init__(self, algorithm: str = "Backoff",
                 params: Optional[dict] = None):
        algorithm = algorithm.lower().strip()
        if algorithm not in self.SUPPORTED_ALGOS:
            raise ValueError("Unknown scaling algorithm: {}".format(algorithm))
        self.algorithm = algorithm
        params = dict(params or {})
        self.scale_min = float(params.pop("scale_min", 1.0))
        self.scale_max = float(params.pop("scale_max", 2.0 ** 14))
        if algorithm == "backoff":
            self.step_factor = float(params.pop("step_factor", 2.0))
            self.step_window = int(params.pop("step_window", 2000))
        else:
            self.log_max = float(params.pop("log_max", 16.0))
            self.beta1 = float(params.pop("beta1", 0.99))
            self.beta2 = float(params.pop("beta2", 0.999))
            self.overflow_std_dev = float(params.pop("overflow_std_dev",
                                                     3.09))
        if params:
            raise ValueError("Unknown loss scaler params: {}".format(
                sorted(params)))

    def init(self, device="cpu") -> LossScaleState:
        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        def i(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        return {"scale": f(self.scale_max if self.algorithm == "backoff"
                           else 1.0),
                "iteration": i(0), "last_overflow_iteration": i(-1),
                "x_hat": f(0.0), "slow_x_hat": f(0.0), "xsquared_hat": f(0.0),
                "b1_correction": f(1.0), "b2_correction": f(1.0)}

    def update(self, state: LossScaleState, has_nan: torch.Tensor,
               amax: torch.Tensor) -> LossScaleState:
        overflow = has_nan | ~torch.isfinite(amax)
        if self.algorithm == "backoff":
            return self._backoff_update(state, overflow)
        return self._logmax_update(state, overflow, amax)

    def _backoff_update(self, state, overflow):
        scale = state["scale"]
        down = torch.clamp(scale / self.step_factor, self.scale_min,
                           self.scale_max)
        since = state["iteration"] - state["last_overflow_iteration"]
        grow = torch.remainder(since, self.step_window) == 0
        up = torch.where(grow, torch.clamp(scale * self.step_factor,
                                           self.scale_min, self.scale_max),
                         scale)
        return dict(state, scale=torch.where(overflow, down, up),
                    iteration=state["iteration"] + 1,
                    last_overflow_iteration=torch.where(
                        overflow, state["iteration"],
                        state["last_overflow_iteration"]))

    def _logmax_update(self, state, overflow, amax):
        x = torch.where(overflow, torch.full_like(amax, 2.0 ** self.log_max),
                        torch.log2(torch.clamp(amax.float(), min=1e-30)))
        x_hat = self.beta1 * state["x_hat"] + (1 - self.beta1) * x
        b1c = state["b1_correction"] * self.beta1
        mu = x_hat / (1 - b1c)
        slow_x_hat = self.beta2 * state["slow_x_hat"] + (1 - self.beta2) * x
        xsq_hat = self.beta2 * state["xsquared_hat"] + \
            (1 - self.beta2) * x * x
        b2c = state["b2_correction"] * self.beta2
        e_xsq = xsq_hat / (1 - b2c)
        slow_mu = slow_x_hat / (1 - b2c)
        sigma = torch.sqrt(torch.clamp(e_xsq - slow_mu * slow_mu, min=0.0))
        log_cutoff = sigma * self.overflow_std_dev + mu
        proposed = torch.exp2(16.0 - log_cutoff)
        return dict(state,
                    scale=torch.clamp(proposed, self.scale_min,
                                      self.scale_max),
                    iteration=state["iteration"] + 1, x_hat=x_hat,
                    slow_x_hat=slow_x_hat, xsquared_hat=xsq_hat,
                    b1_correction=b1c, b2_correction=b2c)
