"""The port's optimizers, learning-rate policies and loss scalers against
the JAX package's.

* ``build_optimizer``: every registry optimizer, and the chain with
  global-norm clipping, with LARC in clip and in scale mode and with
  ``iter_size=2``, against the optax chain of
  ``openseq2seq_tpu/optimizers/optimizers.py:build_optimizer`` over 5
  steps of the same seeded gradients on the same parameters (conv and
  dense kernels, a bias, a batch-norm scale), under ``poly_decay``: the
  update of each step and the parameters after it. fp32; rtol 1e-5 and
  atol 1e-7 (NovoGrad's bf16-stored moments: the same rounding on both
  sides, rtol 1e-5 as well).
* all 8 lr policies on a grid of steps: rtol 1e-6 (the JAX package
  computes in fp32, the port in fp64), and atol the smallest normal
  fp32 value (XLA on the CPU flushes fp32 subnormals to zero, such as
  the staircase decay's 0.1 * 0.5**142 at step 1000).
* the Backoff and LogMax scalers on a scripted sequence of clean steps
  and overflows: every field of the state exactly, except LogMax's
  scale, rtol 1e-6: ``jnp.exp2`` on the CPU is a few ulp off (it gives
  16383.984 for 2**13.999998, where torch and the exact value give
  16383.979), and nothing in the state reads the scale back.
* NovoGrad's state carried from optax into the port
  (``convert.optimizer_state_from_optax``) continues to the same update.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openseq2seq_tpu.optimizers import lr_policies as jax_lr
from openseq2seq_tpu.optimizers.loss_scaler import \
    AutomaticLossScaler as JaxLossScaler
from openseq2seq_tpu.optimizers.optimizers import \
    build_optimizer as jax_build_optimizer
from openseq2seq_tpu_torch.convert import optimizer_state_from_optax
from openseq2seq_tpu_torch.optimizers import lr_policies
from openseq2seq_tpu_torch.optimizers.loss_scaler import AutomaticLossScaler
from openseq2seq_tpu_torch.optimizers.optimizers import (OPTIMIZER_REGISTRY,
                                                        build_optimizer)
from test_torch_text_data import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-7
STEPS = 5
# flax layout of each leaf; the update rules are per tensor and
# elementwise, so the torch layout does not change them
SHAPES = {"conv/kernel": (5, 6, 8), "conv/bias": (8,),
          "norm/scale": (8,), "dense/kernel": (8, 3)}
NAMES = sorted(SHAPES)
LR = {"lr_policy": "poly_decay",
      "lr_policy_params": {"learning_rate": 0.05, "decay_steps": 4,
                           "power": 2.0, "min_lr": 1e-3}}

CASES = {
    "SGD": dict(optimizer="SGD"),
    "Momentum": dict(optimizer="Momentum",
                     optimizer_params={"momentum": 0.8,
                                       "use_nesterov": True}),
    "Adam": dict(optimizer="Adam", optimizer_params={"beta2": 0.99}),
    "AdamW": dict(optimizer="AdamW",
                  optimizer_params={"weight_decay": 0.01}),
    "Adagrad": dict(optimizer="Adagrad"),
    "RMSProp": dict(optimizer="RMSProp",
                    optimizer_params={"momentum": 0.5}),
    "NovoGrad": dict(optimizer="NovoGrad",
                     optimizer_params={"weight_decay": 0.001,
                                       "grad_averaging": True}),
    "NovoGrad_bf16_moments": dict(
        optimizer="NovoGrad",
        optimizer_params={"weight_decay": 0.001,
                          "moments_dtype": "bfloat16"}),
    "clip": dict(optimizer="Adam", max_grad_norm=0.5),
    "larc_clip": dict(optimizer="NovoGrad",
                      optimizer_params={"weight_decay": 0.001},
                      larc_params={"larc_eta": 0.001}),
    "larc_scale": dict(optimizer="Momentum",
                       larc_params={"larc_eta": 0.01,
                                    "larc_mode": "scale"}),
    "iter_size_2": dict(optimizer="NovoGrad", larc_params={"larc_eta": 0.001},
                        iter_size=2),
}


def _params_and_grads(seed=0):
    rng = np.random.RandomState(seed)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (0.1 * rng.randn(*s)).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _port(tree):
    return [torch.from_numpy(np.array(tree[n])) for n in NAMES]


def test_registry_is_covered():
    assert set(OPTIMIZER_REGISTRY) <= {c["optimizer"] for c in CASES.values()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    kwargs = dict(CASES[case], **LR)
    params, grads = _params_and_grads()
    jtx = jax_build_optimizer(**kwargs)
    tx = build_optimizer(**kwargs)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = jtx.init(jparams)
    tparams = _port(params)
    state = tx.init(tparams)
    for i, g in enumerate(grads):
        jupd, jstate = jtx.update({n: jnp.asarray(v) for n, v in g.items()},
                                  jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        upd, state = tx.update(_port(g), state, tparams)
        tparams = [p + u for p, u in zip(tparams, upd)]
        for n, u, p in zip(NAMES, upd, tparams):
            where = "{} step {} {}".format(case, i, n)
            np.testing.assert_allclose(u.numpy(), np.asarray(jupd[n]),
                                       rtol=RTOL, atol=ATOL, err_msg=where)
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[n]),
                                       rtol=RTOL, atol=ATOL, err_msg=where)


def test_novograd_state_carries_over_from_optax():
    """Two optax steps, the state converted, the third step in the port."""
    kwargs = dict(CASES["larc_clip"], **LR)
    params, grads = _params_and_grads(1)
    jtx = jax_build_optimizer(**kwargs)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = jtx.init(jparams)
    for g in grads[:2]:
        jupd, jstate = jtx.update({n: jnp.asarray(v) for n, v in g.items()},
                                  jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
    # the port's names of the flax leaves: conv.bias, conv.weight, ...
    names = [n.replace("/", ".").replace("kernel", "weight")
             .replace("scale", "weight") for n in NAMES]
    tx = build_optimizer(**kwargs)
    port_state = optimizer_state_from_optax(_nest_state(jstate), names)
    tparams = [torch.from_numpy(_torch_layout(n, np.asarray(jparams[n])))
               for n in NAMES]
    g = grads[2]
    upd, _ = tx.update([torch.from_numpy(_torch_layout(n, g[n]))
                        for n in NAMES], port_state, tparams)
    jupd, _ = jtx.update({n: jnp.asarray(v) for n, v in g.items()}, jstate,
                         jparams)
    for n, u in zip(NAMES, upd):
        np.testing.assert_allclose(u.numpy(),
                                   _torch_layout(n, np.asarray(jupd[n])),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def _torch_layout(name, value):
    value = np.asarray(value)
    if value.ndim == 3:
        return np.ascontiguousarray(value.transpose(2, 1, 0))
    if value.ndim == 2:
        return np.ascontiguousarray(value.T)
    return value


def _nest_state(state):
    """An optax state whose per-parameter fields are flat ``module/leaf``
    dicts, with each such field as the nested flax tree the converter
    reads."""
    if isinstance(state, dict):
        out = {}
        for n, v in state.items():
            module, leaf = n.split("/")
            out.setdefault(module, {})[leaf] = v
        return out
    if hasattr(state, "_fields"):
        return type(state)(*[_nest_state(getattr(state, f))
                             for f in state._fields])
    if isinstance(state, (tuple, list)):
        return type(state)(_nest_state(s) for s in state)
    return state


POLICIES = {
    "fixed_lr": {"learning_rate": 0.1},
    "fixed": {"learning_rate": 0.1},
    "piecewise_constant": {"learning_rate": 0.1, "boundaries": [3, 40],
                           "decay_rates": [0.5, 0.1]},
    "piecewise_constant_epochs": {"learning_rate": 0.1, "boundaries": [2, 7],
                                  "decay_rates": [0.5, 0.1],
                                  "steps_per_epoch": 6},
    "exp_decay": {"learning_rate": 0.1, "decay_steps": 7, "decay_rate": 0.5,
                  "use_staircase_decay": False, "begin_decay_at": 3,
                  "min_lr": 0.004},
    "exp_decay_staircase": {"learning_rate": 0.1, "decay_steps": 7,
                            "decay_rate": 0.5, "use_staircase_decay": True},
    "poly_decay": {"learning_rate": 0.02, "decay_steps": 90, "power": 2.0,
                   "begin_decay_at": 10, "min_lr": 1e-5, "warmup_steps": 5},
    "cosine_decay": {"learning_rate": 0.02, "decay_steps": 90,
                     "begin_decay_at": 10, "min_lr": 0.1,
                     "warmup_steps": 8},
    "transformer_policy": {"learning_rate": 2.0, "d_model": 512,
                           "warmup_steps": 40, "max_lr": 1e-3},
    "inv_poly_decay": {"learning_rate": 0.1, "decay_steps": 100,
                       "min_lr": 1e-4, "power": 1.5},
}
GRID = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 14, 20, 39, 40, 41, 50, 99,
        100, 101, 150, 1000]


def test_every_policy_is_covered():
    assert {k.split("_epochs")[0].split("_staircase")[0] for k in POLICIES} \
        == set(lr_policies.LR_POLICY_REGISTRY)


@pytest.mark.parametrize("case", sorted(POLICIES))
def test_lr_policy_matches_jax(case):
    name = case.replace("_epochs", "").replace("_staircase", "")
    port = lr_policies.make_lr_schedule(name, POLICIES[case])
    want = jax_lr.make_lr_schedule(name, POLICIES[case])
    got = [port(s) for s in GRID]
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(
        got, [float(want(jnp.int32(s))) for s in GRID], rtol=1e-6,
        atol=np.finfo(np.float32).tiny, err_msg=case)


# (has_nan, amax) per step: clean steps, an inf, a NaN, more clean steps
SCRIPT = [(False, 4.0), (False, 0.5), (False, np.inf), (False, 8.0),
          (True, 1.0), (False, 0.25), (False, 2.0), (False, 2.0),
          (False, 2.0 ** -10), (False, 64.0), (False, np.inf), (False, 1.0)]


@pytest.mark.parametrize("algorithm,params", [
    ("Backoff", {"step_window": 3, "scale_max": 2.0 ** 10}),
    ("Backoff", {}),
    ("LogMax", {}),
    ("LogMax", {"beta1": 0.9, "beta2": 0.95, "scale_min": 0.5}),
])
def test_loss_scaler_matches_jax(algorithm, params):
    jscaler = JaxLossScaler(algorithm, params)
    scaler = AutomaticLossScaler(algorithm, params)
    jstate = jscaler.init()
    state = scaler.init()
    update = jscaler.update
    for i, (has_nan, amax) in enumerate(SCRIPT):
        jstate = update(jstate, jnp.bool_(has_nan), jnp.float32(amax))
        state = scaler.update(state, torch.tensor(has_nan),
                              torch.tensor(amax, dtype=torch.float32))
        for field in jstate._fields:
            got, want = state[field].numpy(), np.asarray(getattr(jstate,
                                                                 field))
            assert got.dtype == want.dtype, (i, field, got, want)
            if algorithm == "LogMax" and field == "scale":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                assert got == want, (i, field, got, want)
