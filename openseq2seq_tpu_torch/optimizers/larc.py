"""LARC (layer-wise adaptive rate clipping or scaling) as a functional
transform over a list of tensors (port of
``openseq2seq_tpu/optimizers/larc.py``):

  clip mode:  g *= min(max(eta * ||w|| / (lr * (||g|| + eps)), min_update), 1)
  scale mode: g *= max(eta * ||w|| / (||g|| + eps), min_update)

per parameter tensor, before the optimizer's own update. Clip mode reads
the learning rate at LARC's own update count.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from .transform import Transform, f32, per_tensor


def larc(larc_eta: float, larc_mode: str = "clip", min_update: float = 1e-7,
         epsilon: float = 1e-7,
         learning_rate: Union[float, Callable, None] = None) -> Transform:
    if larc_mode not in ("clip", "scale"):
        raise ValueError("larc_mode has to be 'clip' or 'scale'")
    if larc_mode == "clip" and learning_rate is None:
        raise ValueError("LARC clip mode requires the learning rate/schedule")

    def init(params):
        del params
        return {"count": 0}

    def update(updates, state, params):
        g = f32(updates)
        w_norm = torch.stack(torch._foreach_norm(f32(params)))
        g_norm = torch.stack(torch._foreach_norm(g))
        if larc_mode == "clip":
            lr = learning_rate(state["count"]) if callable(learning_rate) \
                else learning_rate
            factor = torch.clamp(larc_eta * w_norm / (lr * (g_norm + epsilon)),
                                 min=min_update).clamp(max=1.0)
        else:
            factor = torch.clamp(larc_eta * w_norm / (g_norm + epsilon),
                                 min=min_update)
        scaled = torch._foreach_mul(g, per_tensor(factor))
        return ([s.to(u.dtype) for s, u in zip(scaled, updates)],
                {"count": state["count"] + 1})

    return Transform(init, update)
