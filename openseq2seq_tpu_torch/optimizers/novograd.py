"""NovoGrad as a functional transform over a list of tensors (port of
``openseq2seq_tpu/optimizers/novograd.py``).

Layer-wise second-moment normalized momentum with decoupled weight decay
and optional gradient averaging; each parameter tensor is one layer:

    v_t   = beta2 * v_{t-1} + (1 - beta2) * ||g_t||^2     (per tensor)
    v_0   = ||g_0||^2                                      (first update)
    ghat  = g_t / sqrt(v_t + eps) + wd * w_{t-1}
    ghat *= (1 - beta1)          if grad_averaging
    m_t   = beta1 * m_{t-1} + ghat

The transform outputs ``m_t``, to be scaled by ``-lr`` downstream.
Weight decay applies to every parameter, batch-norm scales and biases
included (the JAX package has no mask either). The math is fp32; with
``moments_dtype`` the stored moment is rounded to it, the returned one
is not.
"""
from __future__ import annotations

import torch

from .transform import Transform, as_dtype, f32, per_tensor


def scale_by_novograd(beta1: float = 0.95, beta2: float = 0.98,
                      epsilon: float = 1e-8, weight_decay: float = 0.0,
                      grad_averaging: bool = False,
                      moments_dtype=None) -> Transform:
    moments_dtype = as_dtype(moments_dtype)

    def init(params):
        dev = params[0].device if params else None
        return {"count": 0,
                "moments": [torch.zeros_like(p, dtype=moments_dtype or
                                             p.dtype) for p in params],
                "grads_ema": torch.zeros(len(params), dtype=torch.float32,
                                         device=dev)}

    def update(updates, state, params):
        g = f32(updates)
        g2 = torch.stack(torch._foreach_norm(g)).square()
        ema = g2 if state["count"] == 0 else \
            state["grads_ema"] * beta2 + g2 * (1.0 - beta2)
        ghat = torch._foreach_mul(g, per_tensor(torch.rsqrt(ema + epsilon)))
        if weight_decay > 0.0:
            torch._foreach_add_(ghat, f32(params), alpha=weight_decay)
        if grad_averaging:
            torch._foreach_mul_(ghat, 1.0 - beta1)
        moments = torch._foreach_add(
            torch._foreach_mul(f32(state["moments"]), beta1), ghat)
        stored = [m.to(old.dtype) for m, old in
                  zip(moments, state["moments"])]
        return moments, {"count": state["count"] + 1, "moments": stored,
                         "grads_ema": ema}

    return Transform(init, update)
