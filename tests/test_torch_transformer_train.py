"""The port's transformer training slice against the JAX package's on the
CPU: the FFN, both attentions, the encoder, the teacher-forced decoder,
``PreNormResidual`` and the smoothed loss in training with dropout rates
0 (outputs and every gradient against ``jax.grad``); the fused relu
dropout's route (kernel B2's plain version); the tiny ``Text2Text``
``train_step`` against the JAX package's for 3 steps under NovoGrad and
under Adam with the transformer schedule; and ``run.main --device=cpu``
on the tiny training config in train, resumed train, eval and
train_eval.

Weights come from the JAX module's ``init`` (biases and layer-norm
scales randomized) through ``convert.py``; inputs from numpy with a seed.
Tolerance, fp32: outputs and gradients rtol 1e-5 and atol 1e-6, the
atol taken of the tensor's largest magnitude where that exceeds 1 (the
cotangents have scale 0.1); the train step's loss rtol 1e-5, the
parameters after 3 steps rtol 1e-4 and atol 1e-6. The key projections'
biases are frozen in the train steps: softmax ignores a constant per row,
so their gradient is exactly zero and in fp32 rounding noise, which
NovoGrad's and Adam's normalization would scale to a full-size update
(test_torch_jasper_train.py freezes its conv biases before a batch norm
for the same reason). With
``use_flash_attention`` both sides take their plain attention on the CPU;
the "flash route" cases send the port through the flash op's autograd
Function (its plain forward and backward) instead."""
import copy
import os
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from openseq2seq_tpu.data.synthetic import SyntheticTextDataLayer as JaxText
from openseq2seq_tpu.decoders import TransformerDecoder as JaxDecoder
from openseq2seq_tpu.encoders import TransformerEncoder as JaxEncoder
from openseq2seq_tpu.losses import \
    PaddedCrossEntropyLossWithSmoothing as JaxLoss
from openseq2seq_tpu.models import Text2Text as JaxText2Text
from openseq2seq_tpu.parts.transformer import attention as jax_attention
from openseq2seq_tpu.parts.transformer import common as jax_common
from openseq2seq_tpu.parts.transformer import ffn as jax_ffn
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.decoders import TransformerDecoder
from openseq2seq_tpu_torch.encoders import TransformerEncoder
from openseq2seq_tpu_torch.losses import PaddedCrossEntropyLossWithSmoothing
from openseq2seq_tpu_torch.ops import flash_attention as fa
from openseq2seq_tpu_torch.ops import fused_dropout as fd
from openseq2seq_tpu_torch.parts.transformer import attention, common, ffn
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CONFIG = os.path.join(REPO, "example_configs_torch", "text2text",
                            "transformer_tiny_train_synthetic.py")
D, HEADS, FILTER, V = 128, 2, 256, 61
NO_DROPOUT = dict(attention_dropout=0.0, relu_dropout=0.0,
                  layer_postprocess_dropout=0.0)


def _gen():
    return torch.Generator().manual_seed(0)


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _ids(B, T, lengths, seed=0):
    ids = np.random.RandomState(seed).randint(3, V, (B, T)).astype(np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids


def _init(module, seed, *args, **kwargs):
    variables = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    return randomize(jax.device_get(dict(variables)), seed)


def _load(module, variables):
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module


def _close(got, want, name=""):
    """rtol 1e-5 and atol 1e-6 of the tensor's largest magnitude where
    that exceeds 1 (logits reach ~5 and the embedding's gradient, scaled by
    sqrt(d) and summed over tokens, ~10: their fp32 sums differ at that
    scale's rounding)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-5,
        atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=name)


def _assert_grads(port, jax_param_grads):
    """Every parameter's gradient against ``jax.grad``'s, by name."""
    want = state_dict_from_flax({"params": jax.device_get(jax_param_grads)})
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        _close(g, want[name].numpy(), name)


def _flash_route(monkeypatch):
    """Take the flash path on the CPU (``_flash_ok`` without its device
    test): the flash op's autograd Function with its plain versions."""
    monkeypatch.setattr(attention, "_flash_ok", lambda q, k: (
        q.shape[-1] in fa.HEAD_DIMS and min(q.shape[1], k.shape[1]) > 1))


# -- parts ------------------------------------------------------------------

def test_ffn_train_output_and_grads_match_jax():
    jmod = jax_ffn.FeedForwardNetwork(hidden_size=D, filter_size=FILTER,
                                      relu_dropout=0.0)
    x, cot = _x(2, 6, D), _x(2, 6, D, seed=1, scale=0.1)
    variables = _init(jmod, 2, jnp.asarray(x))

    def f(params, x):
        out = jmod.apply({"params": params}, x, train=True)
        return jnp.sum(out * cot), out
    (_, want), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    port = _load(ffn.FeedForwardNetwork(D, FILTER, torch.float32, _gen()),
                 variables)
    tx = torch.from_numpy(x).requires_grad_()
    out = port(tx, train=True)
    out.backward(torch.from_numpy(cot))
    _close(out.detach().numpy(), np.asarray(want))
    _close(tx.grad.numpy(), np.asarray(gx))
    _assert_grads(port, gp)


@pytest.mark.parametrize("kind", ["padding", "causal", "cross"])
def test_attention_train_output_and_grads_match_jax(kind):
    T, S = 9, 11
    x, mem = _x(3, T, D, seed=3), _x(3, S, D, seed=4)
    cot = _x(3, T, D, seed=5, scale=0.1)
    if kind == "cross":
        jmod = jax_attention.CrossAttention(hidden_size=D, num_heads=HEADS,
                                            attention_dropout=0.0)
        bias = np.asarray(jax_common.get_padding_bias(jnp.asarray(
            _ids(3, S, [11, 6, 2]))))
        port = attention.CrossAttention(D, HEADS, torch.float32, _gen())
        variables = _init(jmod, 3, jnp.asarray(x), memory=jnp.asarray(mem),
                          bias=jnp.asarray(bias))

        def apply(params, x, mem):
            return jmod.apply({"params": params}, x, memory=mem,
                              bias=jnp.asarray(bias), train=True)
    else:
        causal = kind == "causal"
        jmod = jax_attention.SelfAttention(hidden_size=D, num_heads=HEADS,
                                           attention_dropout=0.0,
                                           causal=causal)
        bias = (jax_common.get_decoder_self_attention_bias(T) if causal else
                np.asarray(jax_common.get_padding_bias(jnp.asarray(
                    _ids(3, T, [9, 5, 2])))))
        port = attention.SelfAttention(D, HEADS, torch.float32, _gen(),
                                       causal=causal)
        variables = _init(jmod, 3, jnp.asarray(x), bias=jnp.asarray(bias))

        def apply(params, x, mem):
            return jmod.apply({"params": params}, x, bias=jnp.asarray(bias),
                              train=True)[0]

    def f(params, x, mem):
        out = apply(params, x, mem)
        return jnp.sum(out * cot), out
    (_, want), (gp, gx, gm) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            variables["params"], jnp.asarray(x), jnp.asarray(mem))
    _load(port, variables)
    tx, tm = (torch.from_numpy(a).requires_grad_() for a in (x, mem))
    if kind == "cross":
        out = port(tx, tm, torch.tensor(bias), train=True)
    else:
        out = port(tx, torch.tensor(bias), train=True)
    out.backward(torch.from_numpy(cot))
    _close(out.detach().numpy(), np.asarray(want))
    _close(tx.grad.numpy(), np.asarray(gx))
    if kind == "cross":
        _close(tm.grad.numpy(), np.asarray(gm))
    _assert_grads(port, gp)


ENC = {"encoder_layers": 2, "hidden_size": D, "num_heads": HEADS,
       "filter_size": FILTER, "src_vocab_size": V, "remove_padding": True,
       "pad_embeddings_2_eight": True, "use_flash_attention": True,
       **NO_DROPOUT}
DEC = {"EOS_ID": 1, "GO_SYMBOL": 2, "num_hidden_layers": 2,
       "hidden_size": D, "num_heads": HEADS, "filter_size": FILTER,
       "batch_size": 3, "tgt_vocab_size": V, "beam_size": 2, "alpha": 0.6,
       "extra_decode_length": 2, "use_flash_attention": True, **NO_DROPOUT}


@pytest.mark.parametrize("flash_route", [False, True])
def test_encoder_train_output_and_grads_match_jax(flash_route, monkeypatch):
    lengths = np.array([11, 7, 2], np.int32)
    ids = _ids(3, 11, lengths, seed=7)
    cot = _x(3, 11, D, seed=8, scale=0.1)
    jbatch = {"source_tensors": [jnp.asarray(ids), jnp.asarray(lengths)]}
    jmod = JaxEncoder(ENC, None, mode="train").make_module()
    variables = _init(jmod, 7, jbatch, train=True)

    def f(params):
        out = jmod.apply({"params": params}, jbatch, train=True)["outputs"]
        return jnp.sum(out * cot), out
    (_, want), gp = jax.value_and_grad(f, has_aux=True)(variables["params"])
    port = _load(TransformerEncoder(ENC, None).make_module(0, _gen()),
                 variables)
    if flash_route:
        _flash_route(monkeypatch)
    launches = fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES
    out = port({"source_tensors": [torch.from_numpy(ids),
                                   torch.from_numpy(lengths)]}, True)
    out["outputs"].backward(torch.from_numpy(cot))
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == launches
    _close(out["outputs"].detach().numpy(), np.asarray(want))
    _assert_grads(port, gp)


@pytest.mark.parametrize("flash_route", [False, True])
def test_decoder_teacher_forced_train_grads_match_jax(flash_route,
                                                      monkeypatch):
    """The teacher-forced pass alone (no beam decode in training), with
    the gradients of the decoder's parameters and of the encoder memory
    and the shared table it reads."""
    S, T = 10, 8
    src = _ids(3, S, [10, 6, 1], seed=9)
    tgt = _ids(3, T, [8, 5, 3], seed=10)
    mem = _x(3, S, D, seed=11)
    table = _x(64, D, seed=12, scale=D ** -0.5)
    cot = _x(3, T - 1, V, seed=13, scale=0.1)
    bias = np.asarray(jax_common.get_padding_bias(jnp.asarray(src)))

    def jax_input(mem, table):
        return {"encoder_output": {"outputs": mem, "embedding_table": table,
                                   "attention_bias": jnp.asarray(bias),
                                   "src_length": jnp.asarray([10, 6, 1])},
                "target_tensors": [jnp.asarray(tgt), jnp.asarray([8, 5, 3])]}
    jmod = JaxDecoder(DEC, None, mode="train").make_module()
    variables = _init(jmod, 9, jax_input(jnp.asarray(mem), jnp.asarray(table)),
                      train=True)

    def f(params, mem, table):
        out = jmod.apply({"params": params}, jax_input(mem, table),
                         train=True)
        assert "outputs" not in out
        return jnp.sum(out["logits"] * cot), out["logits"]
    (_, want), (gp, gm, gt) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            variables["params"], jnp.asarray(mem), jnp.asarray(table))
    port = _load(TransformerDecoder(DEC, None).make_module(0, _gen()),
                 variables)
    if flash_route:
        _flash_route(monkeypatch)
    tm, tt = (torch.from_numpy(a).requires_grad_() for a in (mem, table))
    out = port({"encoder_output": {"outputs": tm, "embedding_table": tt,
                                   "attention_bias": torch.tensor(bias),
                                   "src_length": torch.tensor([10, 6, 1])},
                "target_tensors": [torch.from_numpy(tgt),
                                   torch.tensor([8, 5, 3])]}, True)
    assert set(out) == {"logits", "targets", "src_length"}
    out["logits"].backward(torch.from_numpy(cot))
    _close(out["logits"].detach().numpy(), np.asarray(want))
    _close(tm.grad.numpy(), np.asarray(gm))
    _close(tt.grad.numpy(), np.asarray(gt))
    _assert_grads(port, gp)


def test_loss_gradient_matches_jax():
    """``PaddedCrossEntropyLossWithSmoothing`` is differentiable as
    written; its gradient in the logits is the JAX package's."""
    logits = _x(3, 7, V, seed=14, scale=2.0)
    labels = _ids(3, 7, [7, 4, 1], seed=15)
    params = {"label_smoothing": 0.1}

    def jloss(lg):
        return JaxLoss(params, None).compute_loss({
            "decoder_output": {"logits": lg},
            "target_tensors": [jnp.asarray(labels), None]})
    want, grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = PaddedCrossEntropyLossWithSmoothing(params, None).compute_loss({
        "decoder_output": {"logits": tl},
        "target_tensors": [torch.from_numpy(labels), None]})
    got.backward()
    _close(got.item(), float(want))
    _close(tl.grad.numpy(), np.asarray(grad))
    assert np.all(tl.grad.numpy()[1, 4:] == 0)     # pad positions


def test_prenorm_residual_matches_jax_and_fuses():
    """``PreNormResidual`` around an FFN: at rate 0 its output and input
    gradient are the JAX package's; with ``fused_dropout`` in training
    its output is ``fused_dropout_add_plain(x, layer(norm(x)))`` with the
    seed the step's generator gives."""
    x, cot = _x(2, 5, D, seed=16), _x(2, 5, D, seed=17, scale=0.1)
    jmod = jax_common.PreNormResidual(
        layer=jax_ffn.FeedForwardNetwork(hidden_size=D, filter_size=FILTER,
                                         relu_dropout=0.0),
        dropout_rate=0.0)
    variables = _init(jmod, 16, jnp.asarray(x), train=False)

    def f(x):
        out = jmod.apply(variables, x, train=True)
        return jnp.sum(out * cot), out
    (_, want), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    port = _load(common.PreNormResidual(
        ffn.FeedForwardNetwork(D, FILTER, torch.float32, _gen()), D, 0.0),
        variables)
    tx = torch.from_numpy(x).requires_grad_()
    out = port(tx, train=True)
    out.backward(torch.from_numpy(cot))
    _close(out.detach().numpy(), np.asarray(want))
    _close(tx.grad.numpy(), np.asarray(gx))

    port.dropout_rate, port.fused_dropout = 0.3, True
    with torch.no_grad():
        got = port(tx, train=True, generator=torch.Generator().manual_seed(4))
        seed = fd.draw_seed(torch.Generator().manual_seed(4), "cpu")
        y = port.layer(port.pre_norm(tx))
        torch.testing.assert_close(got, fd.fused_dropout_add_plain(
            tx, y, 0.3, seed), rtol=0, atol=0)
        assert bool(torch.any(got == tx)) and not torch.equal(got, tx + y)


def test_ffn_fused_relu_dropout_route():
    """With ``fused_residual_dropout`` and a filter width that is a
    multiple of 128 the FFN runs B2's plain version on relu(filter(x)) with
    the site's seed, and its input gradient is the mask applied to the
    cotangent through the same layers; otherwise ``relu_dropout``."""
    port = ffn.FeedForwardNetwork(D, FILTER, torch.float32, _gen(),
                                  relu_dropout=0.3, fused_dropout=True)
    x = torch.from_numpy(_x(2, 6, D, seed=18)).requires_grad_()
    cot = torch.from_numpy(_x(2, 6, D, seed=19))
    before = fd.LAUNCHES
    out = port(x, train=True, generator=torch.Generator().manual_seed(21))
    out.backward(cot)
    assert fd.LAUNCHES == before
    seed = fd.draw_seed(torch.Generator().manual_seed(21), "cpu")
    ref_x = x.detach().clone().requires_grad_()
    h = torch.relu(port.filter(ref_x))
    want = port.output(fd.fused_dropout_plain(h, 0.3, seed))
    want.backward(cot)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, ref_x.grad, rtol=0, atol=0)
    keep = fd.mask_bits_plain(12, FILTER, seed, "cpu") < fd.thr_q(0.3)[0]
    dropped = fd.fused_dropout_plain(h.detach(), 0.3, seed).reshape(12, -1)
    assert torch.equal(dropped != 0, keep & (h.detach().reshape(12, -1) > 0))

    narrow = ffn.FeedForwardNetwork(D, 192, torch.float32, _gen(),
                                    relu_dropout=0.3, fused_dropout=True)
    calls = []
    plain_fd = fd.fused_dropout
    fd.fused_dropout = lambda *a: calls.append(1) or plain_fd(*a)
    try:
        narrow(x, train=True, generator=torch.Generator().manual_seed(21))
        port(x, train=True, generator=torch.Generator().manual_seed(21))
    finally:
        fd.fused_dropout = plain_fd
    assert calls == [1]


# -- Text2Text train_step --------------------------------------------------

def _tiny(optimizer):
    cfg = runpy.run_path(TRAIN_CONFIG)
    params = copy.deepcopy(cfg["base_params"])
    for side in ("encoder_params", "decoder_params"):
        params[side].update(NO_DROPOUT)
    params["freeze_variables_regex"] = r"/(k|qkv)/bias$"
    if optimizer == "Adam":
        params["optimizer"] = "Adam"
        # the transformer recipe's betas; epsilon 1e-3, not its 1e-9:
        # Adam's per-entry normalization turns the fp32 rounding dg of a
        # gradient entry near epsilon into an update error of about
        # lr * dg / (4 epsilon), which at 1e-3 stays under 1e-7
        params["optimizer_params"] = {"beta1": 0.9, "beta2": 0.997,
                                      "epsilon": 1e-3}
    return cfg, params


@pytest.fixture(scope="module")
def jax_runs():
    """Per optimizer: the randomized initial variables, the batch, and
    the JAX package's losses and parameters after 3 steps."""
    out = {}
    for optimizer in ("NovoGrad", "Adam"):
        _, params = _tiny(optimizer)
        jparams = dict(params, encoder=JaxEncoder, decoder=JaxDecoder,
                       loss=JaxLoss, data_layer=JaxText)
        jparams.pop("logdir")
        jmodel = JaxText2Text(params=jparams, mode="train")
        batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
        jstate = jmodel.init_state(batch)
        variables = randomize(jax.device_get({"params": jstate.params}), 22)
        jstate = jstate.replace(
            params=variables["params"],
            opt_state=jmodel.optimizer().init(variables["params"]))
        step = jax.jit(jmodel.train_step)
        losses = []
        for i in range(3):
            jstate, metrics = step(jstate, batch, jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
        out[optimizer] = (variables, batch, losses,
                          jax.device_get(jstate.params))
    return out


@pytest.mark.parametrize("optimizer,flash_route", [
    ("NovoGrad", False), ("NovoGrad", True), ("Adam", False)])
def test_tiny_train_steps_match_jax(jax_runs, optimizer, flash_route,
                                    monkeypatch):
    variables, batch, jlosses, jparams = jax_runs[optimizer]
    cfg, params = _tiny(optimizer)
    model = cfg["base_model"](params, mode="train", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax(variables), strict=True)
    if flash_route:
        _flash_route(monkeypatch)
    losses = []
    for _ in range(3):
        state, metrics = model.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0] and state.step == 3
    want = state_dict_from_flax({"params": jparams})
    for name, p in state.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# -- run.main on the tiny training config --------------------------------

def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([-+0-9.einaf]+)", text)]


def test_run_main_tiny_train_resume_eval_and_train_eval(tmp_path, capsys):
    logdir = str(tmp_path / "logs")
    args = ["--config_file=" + TRAIN_CONFIG, "--logdir=" + logdir,
            "--device=cpu"]
    result = run.main(args + ["--mode=train"])
    out = capsys.readouterr().out
    losses = _losses(out)
    assert result["steps"] == 10 and len(losses) == 10, out
    assert all(np.isfinite(losses)) and \
        np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert "Sample prediction:" in out
    assert sorted(os.listdir(os.path.join(logdir, "checkpoints")),
                  key=int) == ["5", "10"]

    result = run.main(args + ["--mode=train", "--continue_learning",
                              "--max_steps=12"])
    out = capsys.readouterr().out
    assert "Starting training from step 10" in out and result["steps"] == 12
    assert len(_losses(out)) == 2

    metrics = run.main(args + ["--mode=eval"])
    assert np.isfinite(metrics["eval_loss"]) and metrics["Eval BLEU"] >= 0
    capsys.readouterr()

    other = str(tmp_path / "train_eval")
    run.main(["--config_file=" + TRAIN_CONFIG, "--logdir=" + other,
              "--device=cpu", "--mode=train_eval"])
    out = capsys.readouterr().out
    assert len(re.findall(r"Validation BLEU: [0-9.]+", out)) == 2
    assert "best_loss.txt" in os.listdir(os.path.join(other, "best_models"))
