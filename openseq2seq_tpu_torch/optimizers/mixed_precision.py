"""Mixed-precision policy table (port of
``openseq2seq_tpu/optimizers/mixed_precision.py``).

Parameters live in ``param_dtype``; modules cast them and their inputs
to ``compute_dtype`` at use; logits and losses are ``output_dtype``
(always fp32). The config key ``dtype`` keeps the JAX package's values:

  * ``"float32"``  — fp32 everywhere;
  * ``"mixed"``    — fp32 params, bf16 compute;
  * ``"float16"`` / ``"mixed_fp16"`` — fp32 params, fp16 compute, with
    automatic loss scaling in training (``loss_scaler.py``): the
    reference's own GPU recipe;
  * ``"bfloat16"`` — bf16 params and compute.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MixedPrecisionPolicy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype
    use_loss_scaling: bool = False


_POLICIES = {
    "float32": MixedPrecisionPolicy(torch.float32, torch.float32,
                                    torch.float32),
    "mixed": MixedPrecisionPolicy(torch.float32, torch.bfloat16,
                                  torch.float32),
    "bfloat16": MixedPrecisionPolicy(torch.bfloat16, torch.bfloat16,
                                     torch.float32),
    "float16": MixedPrecisionPolicy(torch.float32, torch.float16,
                                    torch.float32, True),
    "mixed_fp16": MixedPrecisionPolicy(torch.float32, torch.float16,
                                       torch.float32, True),
}


def get_mp_policy(dtype: Optional[str]) -> MixedPrecisionPolicy:
    """Resolve a config ``dtype`` value: a policy name, or None for
    fp32."""
    if dtype is None:
        return _POLICIES["float32"]
    if dtype not in _POLICIES:
        raise ValueError("Unknown dtype policy '{}'. Available: {}".format(
            dtype, sorted(_POLICIES)))
    return _POLICIES[dtype]
