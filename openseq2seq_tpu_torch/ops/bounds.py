"""What the element-by-element bounds of the bf16 kernels share
(``ops/scan_bounds.py`` for the scans, ``ops/conformer_conv.py`` for the
conv module): the rounding units, the error of a sigmoid, whether a
value's bf16 rounding may go the other way, the reading of a check and
the planted fault every check must refuse.

A bound is ``(want, bound)`` in fp64, the output's shape: an element whose
bound is 0 must match exactly, one whose bound is inf is not held.
"""
from __future__ import annotations

import torch

BF16_ULP = 2.0 ** -7          # a bf16 ulp, at most, relative to the value
F32_U = 2.0 ** -24            # fp32's unit roundoff
# the fp32 error of elementwise math, relative to the magnitude of the
# expression (the same expression on absolute values, each difference a
# sum): 32 roundings, transcendentals at 2 ulps each
CELL = 32 * F32_U


def sigmoid(x, err):
    """sigmoid(x) of an x within err, and the result's error: err times
    the slope (plus the slope's change over err) and the fp32 math."""
    y = torch.sigmoid(x)
    return y, (y * (1 - y) + 0.1 * err) * err + CELL * y


def roundings(v, err, dtype=torch.bfloat16):
    """(lo, hi): the least and greatest roundings to ``dtype`` of the
    values within err of v (fp64), in fp64."""
    m = err + 2.0 ** -22 * v.abs()   # and the conversions' own rounding
    return (v - m).to(dtype).double(), (v + m).to(dtype).double()


def flips(v, err):
    """The gap between the bf16 roundings of any two values within err of
    v (fp64): 0 where they all round alike."""
    lo, hi = roundings(v, err)
    return hi - lo


def reading(got, want, bound) -> float:
    """The largest |got - want| / bound; an error where the bound is 0
    reads inf, none where it is inf."""
    err = (got.double() - want.double()).abs()
    return float(torch.where(err > 0, err / bound, 0.0).max())


def readings(outputs: dict, bounds: dict) -> dict:
    """``{name: reading}`` of each output held by ``bounds``."""
    return {k: reading(outputs[k], *bounds[k]) for k in bounds}


def zero_but_row_1(x):
    """``x`` with every batch row but row 1 zeroed: a fault a bound must
    refuse."""
    bad = x.clone()
    bad[:1] = 0
    bad[2:] = 0
    return bad
