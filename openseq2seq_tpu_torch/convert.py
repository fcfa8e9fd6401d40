"""Weights of the JAX package -> the port's ``state_dict``.

Takes the flax variables as nested dicts of numpy arrays, ``{"params":
..., "batch_stats": ...}``, of any module whose torch twin keeps the
flax names (the whole forward pass, or a part such as the TDNN encoder),
and returns the ``state_dict`` for ``load_state_dict(strict=True)``:

  * conv kernel (k, in, out)   -> weight (out, in, k)
  * dense kernel (in, out)     -> weight (out, in)
  * bias                       -> bias (flax convs carry one by default)
  * batch norm scale / bias    -> weight / bias
  * batch_stats mean / var     -> running_mean / running_var, plus a zero
                                  ``num_batches_tracked``

The flax ``_Norm`` wrapper's inner ``BatchNorm_0`` folds into the torch
norm module, so ``enc/net/norm1_1/BatchNorm_0/scale`` becomes
``enc.net.norm1_1.weight``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_BN_INNER = "BatchNorm_0"


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module_key(path: Tuple[str, ...]) -> str:
    return ".".join(p for p in path if p != _BN_INNER)


def state_dict_from_flax(variables: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables.get("params", {})):
        value = np.asarray(value, dtype=np.float32)
        module, leaf = _module_key(path[:-1]), path[-1]
        if leaf == "kernel" and value.ndim == 3:
            name, value = "weight", value.transpose(2, 1, 0)
        elif leaf == "kernel" and value.ndim == 2:
            name, value = "weight", value.T
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError("no torch name for flax param {}".format(
                "/".join(path)))
        out[module + "." + name] = torch.from_numpy(
            np.ascontiguousarray(value))
    for path, value in _flatten(variables.get("batch_stats", {})):
        module, leaf = _module_key(path[:-1]), path[-1]
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise ValueError("no torch name for flax batch stat {}".format(
                "/".join(path)))
        out[module + "." + name] = torch.from_numpy(
            np.array(value, dtype=np.float32))
        out[module + ".num_batches_tracked"] = torch.tensor(0)
    return out
