"""Named weight initializers driven by an explicit ``torch.Generator``
(port of ``openseq2seq_tpu/parts/initializers.py``).

Each initializer fills a weight in place from the generator it is given.
Fans follow the JAX package's variance scaling: for a conv weight
(out, in, k) fan_in = in * k and fan_out = out * k; for a dense weight
(out, in) fan_in = in and fan_out = out. The ``*_normal`` variants are
JAX's: a normal truncated at two standard deviations and rescaled so that
the variance is the target one (``torch.nn.init.xavier_normal_`` is an
untruncated normal, and is not used). ``None`` keeps the layer default
of flax's Conv and Dense, ``lecun_normal``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978

Initializer = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def _fans(weight: torch.Tensor):
    receptive = weight[0, 0].numel() if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def variance_scaling(scale: float, mode: str, distribution: str
                     ) -> Initializer:
    def init(weight: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        fan_in, fan_out = _fans(weight)
        fan = {"fan_in": fan_in, "fan_out": fan_out,
               "fan_avg": (fan_in + fan_out) / 2}[mode]
        var = scale / max(fan, 1)
        with torch.no_grad():
            if distribution == "truncated_normal":
                std = math.sqrt(var) / _TRUNC_STD
                return torch.nn.init.trunc_normal_(
                    weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            limit = math.sqrt(3 * var)
            return weight.uniform_(-limit, limit, generator=gen)
    return init


_NAMED: Dict[str, Initializer] = {
    "xavier_normal": variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "xavier_uniform": variance_scaling(1.0, "fan_avg", "uniform"),
    "lecun_normal": variance_scaling(1.0, "fan_in", "truncated_normal"),
}


def resolve_initializer(init: Any,
                        init_params: Optional[Dict[str, Any]] = None
                        ) -> Initializer:
    """Map a config ``initializer`` to a function ``(weight, generator)``.

    Accepts None (the layer default, ``lecun_normal``), a name from the
    table (``glorot_*`` is an alias of ``xavier_*``; bare ``"xavier"``
    and ``"glorot"`` honour the TF-style ``{"uniform": bool}`` param,
    normal by default), or such a function itself. The JAX package's
    other names (``he_*``, ``lecun_uniform``, ``orthogonal``, ...) are
    not ported yet and raise."""
    init_params = dict(init_params or {})
    if init is None:
        return _NAMED["lecun_normal"]
    if callable(init):
        return init
    if not isinstance(init, str):
        raise ValueError("initializer must be None, a name, or a callable; "
                         "got {!r}".format(init))
    name = init.lower().replace("glorot", "xavier")
    if name == "xavier":
        name += "_uniform" if init_params.pop("uniform", False) else "_normal"
    if name not in _NAMED:
        raise ValueError("Unknown initializer '{}' (known: {})".format(
            init, ", ".join(sorted(_NAMED))))
    if init_params:
        raise ValueError("initializer '{}' takes no params, got {}".format(
            init, sorted(init_params)))
    return _NAMED[name]
