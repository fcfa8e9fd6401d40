"""The port's serving package (``openseq2seq_tpu_torch/serving``) against
the JAX package's (``tests/test_serving_export.py``'s four cases), on the
same toy speech data, ``toy_nmt`` and converted weights, on the CPU:

  * the export and reload round trip of the w2l toy's eval forward: the
    artifact's logits within rtol 1e-5, atol 1e-5 of the JAX forward's
    (the JAX test's bar), its greedy ids equal, and bit for bit the port's
    eager forward;
  * int8 weights: the report's keys and errors, the int8 tensors and
    scales equal to the JAX package's, the dequantized parameters equal
    bit for bit to the converted ``dequantize_params(quantize_params_int8(
    flax_params))``, the JAX test's bars on the logits (max |d| < 0.15,
    argmax agreement > 0.98), the int8 artifact smaller than the fp one and
    within 1e-4 of the dequantized forward, the activation ranges of every
    conv, norm and dense layer within 1e-5 relative of the JAX package's;
  * int8 activations on ``toy_nmt``: the calibrated layer sets equal under
    ``jax_key_map``, the ranges within 1e-6 relative, the live int8 logits
    on the same ranges within 1e-4 x std of JAX's int8 interceptor applied
    op by op (the
    function ``int8_apply_fn`` jits: compiled, XLA rounds one of the toy's
    quantized inputs otherwise, and its logits move by 0.0196, 0.021 std,
    in one of the 32 sentences; the port is held within 0.35 std of those)
    and within the JAX test's bars (max |d| < 0.35 std, argmax agreement >
    0.97) of the fp logits;
    each int8 layer bit for bit its float64 plain version, and a planted
    fault (x_scale doubled, the bias dropped) refused; the int8-activation
    artifact of the teacher-forced scoring forward (every dropout rate 0,
    ``train=True``) within 1e-5 of the live int8 path on the dequantized
    weights and within the JAX test's bars of fp;
  * the on-device beam of width 4 in an artifact: ids and lengths equal
    to the JAX forward's, beam scores within 1e-5 (the JAX test's bars), on
    the toy batch cut to its first 16 frames (the unrolled beam's trace
    takes about half a second a frame here; the JAX test's 96 frames would
    take a minute);

and ``torch.library.opcheck`` on the flash attention custom op, the tiny
serving twin's scoring artifact (its 6 flash attention nodes run the
op's CPU implementation) loaded in a fresh interpreter that imports only
``openseq2seq_tpu_torch.serving`` and matching the JAX forward within
rtol 1e-5, atol 1e-5, the ValueError for a beam-decoding Text2Text export
and for the Conformer-Transducer's greedy decode (each raised where the
decode reads the host), and the full-width serving config's parameter
count, the JAX model's."""
import copy
import os
import subprocess
import sys
import tempfile
import types

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data.synthetic import SyntheticTextDataLayer as JaxText
from openseq2seq_tpu.decoders import TransformerDecoder as JaxDecoder
from openseq2seq_tpu.encoders import TransformerEncoder as JaxEncoder
from openseq2seq_tpu.losses import \
    PaddedCrossEntropyLossWithSmoothing as JaxLoss
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.models import Text2Text as JaxText2Text
from openseq2seq_tpu.serving import int8_exec as jax_int8_exec
from openseq2seq_tpu.serving import quantize as jax_quantize
from openseq2seq_tpu.test_utils import toy_nmt as jax_toy_nmt
from openseq2seq_tpu.test_utils.test_speech_configs import \
    w2l_test_config as jax_w2l_config
from openseq2seq_tpu_torch import serving
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           layer_norm_modules,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.models import Speech2Text, Text2Text
from openseq2seq_tpu_torch.ops import flash_attention as fa
from openseq2seq_tpu_torch.parts.transformer import attention
from openseq2seq_tpu_torch.serving import int8_exec
from openseq2seq_tpu_torch.serving.export import serving_batch
from openseq2seq_tpu_torch.test_utils import toy_nmt
from openseq2seq_tpu_torch.test_utils.test_speech_configs import \
    w2l_test_config
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "text2text")
TINY = os.path.join(CONFIGS, "transformer_base_serving_tiny_synthetic.py")
FULL = os.path.join(CONFIGS, "transformer_base_serving_synthetic.py")
TRANSFORMER_BASE_PARAMS = 60917760
BEAM_FRAMES = 16
RNG = jax.random.PRNGKey(0)


def _jax_apply(jmodel, jstate, batch, train=False, params=None):
    return jmodel.module().apply(
        {"params": jstate.params if params is None else params,
         **jstate.model_state}, batch, train=train, rngs={"dropout": RNG})


def _jax_state(module, seed):
    """The JAX state (``params``, ``model_state``) of the port's
    ``module`` with its biases and norms randomized, loaded back into
    ``module``: the JAX models take the port's weights and need no init of
    their own."""
    variables = randomize(flax_from_state_dict(
        module.state_dict(), layer_norm_modules(module)), seed)
    variables = {k: v for k, v in variables.items() if v}
    module.load_state_dict(state_dict_from_flax(variables))
    return types.SimpleNamespace(
        params=variables["params"],
        model_state={k: v for k, v in variables.items() if k != "params"})


def _speech_pair(toy, seed, beam=0):
    """(JAX model, its state, port model, its state, the JAX batch) of the
    w2l toy in eval mode on the same randomized weights."""
    jp, _ = jax_w2l_config(toy["csv"], toy["vocab"], num_epochs=1)
    port, _ = w2l_test_config(toy["csv"], toy["vocab"], num_epochs=1)
    if beam:
        for p in (jp, port):
            p["decoder_params"] = dict(p["decoder_params"],
                                       on_device_beam_width=beam)
    jmodel = JaxSpeech2Text(params=jp, mode="eval")
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    batch = jax.tree_util.tree_map(np.asarray, batch)
    model = Speech2Text(params=port, mode="eval", device="cpu")
    state = model.init_state(batch)
    return jmodel, _jax_state(state.module, seed), model, state, batch


def _logits(out):
    return np.asarray(out["decoder_output"]["logits"], np.float32)


@pytest.fixture(scope="module")
def speech(toy_speech_data, jax_globals_module):  # noqa: F811
    return _speech_pair(toy_speech_data, seed=3)


def test_export_reload_roundtrip(speech, tmp_path):
    jmodel, jstate, model, state, batch = speech
    path = str(tmp_path / "model.pt2")
    blob = serving.export_inference_fn(model, state, batch, path=path)
    assert len(blob) > 1000
    out = serving.load_exported(path)(batch)
    direct = _jax_apply(jmodel, jstate, batch)
    np.testing.assert_allclose(_logits(out), _logits(direct), rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(out["decoder_output"]["outputs"],
                         direct["decoder_output"]["outputs"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.no_grad():
        eager = state.module(serving_batch(batch, "cpu"), train=False)
    assert torch.equal(out["decoder_output"]["logits"],
                       eager["decoder_output"]["logits"])


def test_int8_weight_quantization(speech, tmp_path):
    """As the JAX test: the blob shrinks, the logits stay close, and the
    quantization and its report are the JAX package's."""
    jmodel, jstate, model, state, batch = speech
    jq, jreport = jax_quantize.quantize_params_int8(jstate.params,
                                                    min_size=64)
    qparams, report = serving.quantize_params_int8(state.module,
                                                   min_size=64)
    assert report and set(report) == set(jreport)
    assert all(report[k] == jreport[k] < 0.05 for k in report)
    for k in report:
        node, jnode = qparams, jq
        for p in k.split("/"):
            node, jnode = node[p], jnode[p]
        np.testing.assert_array_equal(node["int8"], np.asarray(jnode["int8"]))
        np.testing.assert_array_equal(node["scale"],
                                      np.asarray(jnode["scale"]))
    deq = serving.dequantize_params(qparams)
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(
        np.asarray, jax_quantize.dequantize_params(jq))})
    got = state_dict_from_flax({"params": deq})
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k

    deq_module = copy.deepcopy(state.module)
    deq_module.load_state_dict(got, strict=False)
    with torch.no_grad():
        l_fp = _logits(state.module(serving_batch(batch, "cpu"),
                                    train=False))
        l_q = _logits(deq_module(serving_batch(batch, "cpu"), train=False))
    np.testing.assert_allclose(l_q, _logits(_jax_apply(
        jmodel, jstate, batch,
        params=jax_quantize.dequantize_params(jq))), rtol=1e-5, atol=1e-5)
    assert np.max(np.abs(l_fp - l_q)) < 0.15
    assert np.mean(l_fp.argmax(-1) == l_q.argmax(-1)) > 0.98

    blob_fp = serving.export_inference_fn(model, state, batch)
    path = str(tmp_path / "model_int8.pt2")
    blob_q, report2 = serving.export_inference_fn_int8(
        model, state, batch, min_size=64, path=path)
    assert report2 == report
    assert len(blob_q) < len(blob_fp)
    l_served = _logits(serving.load_exported_int8(path)(batch))
    np.testing.assert_allclose(l_served, l_q, rtol=1e-4, atol=1e-4)

    ranges = serving.calibrate_activations(model, state, [batch])
    jranges = jax_quantize.calibrate_activations(jmodel, jstate, [batch])
    assert ranges and all(v >= 0 for v in ranges.values())
    pairs = [(name, "/".join(name.split(".")) + "/__call__/0")
             for name in ranges]
    pairs = [(n, k) for n, k in pairs if k in jranges]
    # five convs, their norms, the residual's conv and norm, the decoder's
    # dense layer
    assert len(pairs) >= 13, pairs
    for name, key in pairs:
        np.testing.assert_allclose(ranges[name], jranges[key], rtol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def nmt(jax_globals_module):  # noqa: F811
    """(JAX model, state, port model, state, batch) of ``toy_nmt`` in train
    mode (the JAX test's logits-only model) on the same randomized
    weights."""
    data = jax_toy_nmt.generate(tempfile.mkdtemp())
    jmodel = JaxText2Text(params=jax_toy_nmt.transformer_toy_config(
        data, num_epochs=1), mode="train")
    batch = next(iter(jmodel.get_data_layer().iterate_one_epoch()))
    batch = jax.tree_util.tree_map(np.asarray, batch)
    # the JAX init's weights, as the JAX test takes them. The live int8
    # logits are held within 1e-4 std of JAX's, which one quantized input
    # on a rounding edge breaks (the two frameworks' fp32 results differ
    # in their last bits): on the port's init, randomized at seed 5, three
    # of the 32 sentences cross one, 0.03 std
    jstate = jmodel.init_state(batch)
    params = randomize({"params": jstate.params}, 5)["params"]
    jstate = jstate.replace(params=params)
    model = Text2Text(params=toy_nmt.transformer_toy_config(
        data, num_epochs=1), mode="train", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state_dict_from_flax({"params": params}))
    return jmodel, jstate, model, state, batch, data


def test_int8_activation_execution(nmt):
    jmodel, jstate, model, state, batch, _ = nmt
    jranges = jax_int8_exec.calibrate_dense_inputs(jmodel, jstate, [batch])
    ranges = serving.calibrate_dense_inputs(model, state, [batch])
    names = int8_exec.jax_key_map(state.module)
    assert ranges and {names[k] for k in jranges} == set(ranges)
    assert len(ranges) == 24          # 2 x 4 encoder, 2 x 8 decoder layers
    for k, v in jranges.items():
        np.testing.assert_allclose(ranges[names[k]], v, rtol=1e-6,
                                   err_msg=k)

    with nn.intercept_methods(jax_int8_exec.make_int8_interceptor(jranges)):
        want = _logits(_jax_apply(jmodel, jstate, batch))
    jitted = _logits(jax_int8_exec.int8_apply_fn(jmodel, jstate,
                                                  jranges)(batch))
    # on the JAX package's ranges: the port's own sit within 1e-6 of them,
    # which moves a quantized input that sits on a rounding edge
    got = _logits(serving.int8_apply_fn(model, state, {
        names[k]: v for k, v in jranges.items()})(batch))
    fp = _logits(model.eval_step(state, batch)["outputs"])
    scale = np.std(fp)
    assert np.max(np.abs(got - want)) < 1e-4 * scale
    assert np.max(np.abs(got - jitted)) < 0.35 * scale
    assert not np.allclose(fp, got, atol=1e-6)
    assert np.max(np.abs(got - fp)) < 0.35 * scale
    assert np.mean(np.argmax(got, -1) == np.argmax(fp, -1)) > 0.97


def _layer_input(state, name, batch):
    """The input of the layer ``name`` in a forward over ``batch``."""
    seen = []
    layer = dict(state.module.named_modules())[name]
    handle = layer.register_forward_pre_hook(
        lambda _, args: seen.append(args[0]))
    with torch.no_grad():
        state.module(serving_batch(batch, "cpu"), train=False)
    handle.remove()
    return layer, seen[0]


@pytest.mark.parametrize("name", ["enc.self_attns_0.qkv",
                                  "dec.ffns_1.output"])
def test_int8_layer_exact_and_planted_faults(nmt, name):
    """Given the same quantized input, an int8 layer is its float64 plain
    version bit for bit and the JAX package's ``_int8_dense`` within fp32
    rounding; x_scale doubled or the bias dropped is refused."""
    jmodel, jstate, model, state, batch, _ = nmt
    layer, x = _layer_input(state, name, batch)
    absmax = float(x.abs().max()) * 0.9      # some inputs clip
    no_bias = types.SimpleNamespace(weight=layer.weight, bias=None)
    with torch.no_grad():
        got = int8_exec.int8_dense(layer, x, absmax)
        plain = int8_exec.int8_dense_plain(layer, x, absmax)
        faults = (int8_exec.int8_dense(layer, x, 2 * absmax),
                  int8_exec.int8_dense(no_bias, x, absmax))
    assert torch.equal(got, plain)
    node = jstate.params
    for p in name.split("."):
        node = node[p]

    class _Module:   # what ``_int8_dense`` reads of a flax module
        variables = {"params": node}
        use_bias = True
    want = np.asarray(jax_int8_exec._int8_dense(_Module, x.numpy(), absmax))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    for fault in faults:
        assert not torch.equal(fault, got)
        assert float((fault - got).abs().max()) > 1e-3


def test_int8_activation_artifact(nmt, tmp_path):
    """The teacher-forced scoring forward (every dropout rate 0,
    ``train=True``) exported with int8 activations: the artifact also
    quantizes the embedding (weight-only), so it matches the live int8
    path on the dequantized weights, and stays within the JAX test's bars
    of fp; the artifact holds one ``_int_mm`` node a calibrated layer and
    the live path runs one int8 product each."""
    _, _, _, state0, batch, data = nmt
    params = toy_nmt.transformer_toy_config(data, num_epochs=1)
    for side in ("encoder_params", "decoder_params"):
        for key in ("attention_dropout", "relu_dropout",
                    "layer_postprocess_dropout"):
            params[side][key] = 0.0
    model = Text2Text(params=params, mode="train", device="cpu")
    state = model.init_state(batch)
    state.module.load_state_dict(state0.module.state_dict())
    ranges = serving.calibrate_dense_inputs(model, state, [batch],
                                            train=True)
    path = str(tmp_path / "model_int8act.pt2")
    blob, report = serving.export_inference_fn_int8(
        model, state, batch, path=path, min_size=64, act_ranges=ranges,
        train=True)
    assert "enc/embedding/embedding" in report
    served = serving.load_exported_int8(path)
    got = _logits(served(batch))
    int_mm = [n for m in served.program.modules()
              if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
              if n.target is torch.ops.aten._int_mm.default]
    assert len(int_mm) == len(ranges) == 24

    qparams, _ = serving.quantize_params_int8(state.module, min_size=64)
    deq = copy.deepcopy(state)
    deq.module.load_state_dict(state_dict_from_flax(
        {"params": serving.dequantize_params(qparams)}), strict=False)
    calls = int8_exec.CALLS
    live = _logits(serving.int8_apply_fn(model, deq, ranges,
                                         train=True)(batch))
    assert int8_exec.CALLS - calls == 24
    np.testing.assert_allclose(got, live, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        fp = _logits(state.module(serving_batch(batch, "cpu"), train=True))
    scale = np.std(fp)
    assert np.max(np.abs(got - fp)) < 0.35 * scale
    assert np.mean(np.argmax(got, -1) == np.argmax(fp, -1)) > 0.97


def test_export_with_on_device_beam(toy_speech_data, tmp_path,
                                    jax_globals):  # noqa: F811
    """The artifact holds the whole decode: the on-device prefix beam,
    unrolled over the frames, reproduces the JAX forward's ids, lengths
    and scores with no model code."""
    jmodel, jstate, model, state, batch = _speech_pair(toy_speech_data,
                                                       seed=4, beam=4)
    x, lengths = batch["source_tensors"]
    batch = dict(batch, source_tensors=[
        x[:, :BEAM_FRAMES], np.minimum(lengths, BEAM_FRAMES)])
    path = str(tmp_path / "beam.pt2")
    serving.export_inference_fn(model, state, batch, path=path)
    out = serving.load_exported(path)(batch)["decoder_output"]
    direct = _jax_apply(jmodel, jstate, batch)["decoder_output"]
    for got, want in zip(out["outputs"][:2], direct["outputs"][:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(out["beam_scores"].numpy(),
                               np.asarray(direct["beam_scores"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,masked,causal", [
    (torch.float32, True, False), (torch.bfloat16, False, True)])
def test_flash_op_opcheck(dtype, masked, causal):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, T, 2, 64).astype(
        np.float32)).to(dtype) for T in (5, 7, 7))
    valid = torch.from_numpy(np.arange(7)[None] < np.array([[7], [3]])) \
        if masked else None
    result = torch.library.opcheck(fa.flash_attn_fwd,
                                   (q, k, v, valid, causal, 0.125))
    assert set(result.values()) == {"SUCCESS"}, result
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(q, k, v, valid, causal),
                           fa.flash_attention_plain(q, k, v, valid, causal))


def _tiny_serving(monkeypatch):
    """The tiny serving twin's port model and state, with the flash path
    allowed on the CPU, where the op runs its plain version."""
    import runpy
    cfg = runpy.run_path(TINY)
    monkeypatch.setattr(attention, "_flash_ok", lambda q, k: (
        q.shape[-1] in fa.HEAD_DIMS and min(q.shape[1], k.shape[1]) > 1))
    model = cfg["base_model"](copy.deepcopy(cfg["base_params"]),
                              mode="eval", device="cpu")
    return cfg, model


LOAD_ONLY_SERVING = """
import sys
import numpy as np
from openseq2seq_tpu_torch import serving
z = np.load(sys.argv[2])
batch = {"source_tensors": [z["s0"], z["s1"]],
         "target_tensors": [z["t0"], z["t1"]], "source_ids": z["ids"]}
out = serving.load_exported(sys.argv[1])(batch)
np.save(sys.argv[3], out["decoder_output"]["logits"].numpy())
print(sorted(m for m in sys.modules if m.startswith(
    ("openseq2seq_tpu_torch.models", "openseq2seq_tpu_torch.encoders",
     "openseq2seq_tpu_torch.decoders"))))
"""


def test_artifact_loads_with_serving_alone(monkeypatch, tmp_path,
                                           jax_globals):  # noqa: F811
    cfg, model = _tiny_serving(monkeypatch)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    jparams = copy.deepcopy(cfg["base_params"])
    jparams.update(encoder=JaxEncoder, decoder=JaxDecoder, loss=JaxLoss,
                   data_layer=JaxText)
    jmodel = JaxText2Text(params=jparams, mode="eval")
    state = model.init_state(batch)
    jstate = _jax_state(state.module, 6)

    path = str(tmp_path / "score.pt2")
    serving.export_inference_fn(model, state, batch, path=path, train=True)
    program = torch.export.load(path)
    ops = [n for n in program.graph.nodes
           if n.target is torch.ops.openseq2seq_tpu_torch.flash_attn_fwd
           .default]
    assert len(ops) == 6          # 2 encoder, 2 causal, 2 cross
    np.savez(tmp_path / "batch.npz", s0=batch["source_tensors"][0],
             s1=batch["source_tensors"][1], t0=batch["target_tensors"][0],
             t1=batch["target_tensors"][1], ids=batch["source_ids"])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_ONLY_SERVING, path,
         str(tmp_path / "batch.npz"), str(tmp_path / "logits.npy")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    got = np.load(tmp_path / "logits.npy")
    with torch.no_grad():
        eager = _logits(state.module(serving_batch(batch, "cpu"),
                                     train=True))
    np.testing.assert_array_equal(got, eager)
    want = _logits(_jax_apply(jmodel, jstate, batch, train=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_beam_decoding_text2text_export_refused(monkeypatch):
    _, model = _tiny_serving(monkeypatch)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    for export in (serving.export_inference_fn,
                   serving.export_inference_fn_int8):
        with pytest.raises(ValueError, match="beam decode"):
            export(model, state, batch)


def test_host_reading_decode_export_refused():
    """A decode that reads the host refuses the tracer where it reads:
    the Conformer-Transducer's greedy decode (``int(t_hi.max())``). The
    trace leaves no fake tensor behind: an eager forward afterwards, at
    the same shapes, gives real tensors (``flash_relpos.angles`` caches
    its tables outside a tracer only)."""
    import runpy
    cfg = runpy.run_path(os.path.join(
        REPO, "example_configs_torch", "speech2text",
        "conformer_transducer_tiny_synthetic.py"))
    model = cfg["base_model"](copy.deepcopy(cfg["base_params"]), mode="eval",
                              device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    with pytest.raises(ValueError, match="transducer's greedy decode"):
        serving.export_inference_fn(model, state, batch)
    with torch.no_grad():
        out = state.module(serving_batch(batch, "cpu"), train=False)
    logits = out["decoder_output"]["outputs"][0]
    assert type(logits) is torch.Tensor
    assert type(out["encoder_output"]["outputs"]) is torch.Tensor


def test_serving_config_parameter_count(jax_globals):  # noqa: F811
    """transformer_base_serving_synthetic.py holds the JAX model's
    parameters (the port's module built on the CPU, the JAX one's shapes
    from ``jax.eval_shape``)."""
    import runpy
    cfg = runpy.run_path(FULL)
    model = cfg["base_model"](copy.deepcopy(cfg["base_params"]), mode="eval",
                              device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    module = model.build_module(batch, torch.Generator().manual_seed(0))
    got = sum(p.numel() for p in module.parameters())
    jparams = copy.deepcopy(cfg["base_params"])
    jparams.update(encoder=JaxEncoder, decoder=JaxDecoder, loss=JaxLoss,
                   data_layer=JaxText)
    jmodel = JaxText2Text(params=jparams, mode="eval")
    shapes = jax.eval_shape(lambda: jmodel.init_state(batch))
    want = sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(shapes.params))
    assert got == want == TRANSFORMER_BASE_PARAMS
    layers = int8_exec.int8_layers(module)
    assert len(layers) == 72
