"""The port's transformer NMT slice against the JAX package's on the CPU:
the parts (``common``, the FFN, both attentions, one cached decode step
against the full-sequence result), the encoder, ``beam_search`` on toy
step functions, and the tiny ``Text2Text`` config in eval and infer
through ``run.main --device=cpu`` (teacher-forced decoder logits, loss,
decoded ids, BLEU and the infer file).

Weights come from the JAX module's ``init`` (biases and layer-norm
scales randomized) through ``convert.py``; inputs from numpy with a
seed. Tolerance: fp32, rtol 1e-5 and atol 1e-5 on activations, logits
and loss; decoded ids, lengths, BLEU and the infer lines exact; beam
scores rtol 1e-6. On the JAX side infer runs without ``target_tensors``,
as ``scripts/bench_nmt_decode.py`` does (ROADMAP C9)."""
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from openseq2seq_tpu.data.synthetic import SyntheticTextDataLayer as JaxText
from openseq2seq_tpu.decoders import TransformerDecoder as JaxDecoder
from openseq2seq_tpu.encoders import TransformerEncoder as JaxEncoder
from openseq2seq_tpu.losses import \
    PaddedCrossEntropyLossWithSmoothing as JaxLoss
from openseq2seq_tpu.models import Text2Text as JaxText2Text
from openseq2seq_tpu.ops import beam_search as jax_bs
from openseq2seq_tpu.parts.transformer import attention as jax_attention
from openseq2seq_tpu.parts.transformer import common as jax_common
from openseq2seq_tpu.parts.transformer import ffn as jax_ffn
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.encoders import TransformerEncoder
from openseq2seq_tpu_torch.ops import beam_search
from openseq2seq_tpu_torch.ops import flash_attention as fa
from openseq2seq_tpu_torch.parts.transformer import attention, common, ffn
from openseq2seq_tpu_torch.training import CheckpointManager, trainer
from openseq2seq_tpu_torch.training.trainer import to_host
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "example_configs_torch", "text2text",
                      "transformer_tiny_synthetic.py")
TRAIN_CONFIG = os.path.join(REPO, "example_configs_torch", "text2text",
                            "transformer_tiny_train_synthetic.py")
D, HEADS, FILTER = 128, 2, 256
TOL = dict(rtol=1e-5, atol=1e-5)


def _gen():
    return torch.Generator().manual_seed(0)


def _init(module, seed, *args, **kwargs):
    """Randomized flax variables of ``module`` as numpy."""
    variables = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    return randomize(jax.device_get(dict(variables)), seed)


def _load(module, variables):
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module.eval()


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids(B, T, V, lengths, seed=0):
    ids = np.random.RandomState(seed).randint(3, V, (B, T)).astype(np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids


# -- common ---------------------------------------------------------------

def test_position_encoding_and_biases():
    np.testing.assert_array_equal(common.get_position_encoding(17, D),
                                  jax_common.get_position_encoding(17, D))
    ids = _ids(3, 9, 20, [9, 4, 1])
    np.testing.assert_array_equal(
        common.get_padding_bias(torch.from_numpy(ids)).numpy(),
        np.asarray(jax_common.get_padding_bias(jnp.asarray(ids))))
    np.testing.assert_array_equal(
        common.get_decoder_self_attention_bias(7).numpy(),
        jax_common.get_decoder_self_attention_bias(7))


def test_shared_embedding_and_projection():
    jmod = jax_common.SharedEmbedding(vocab_size=61, hidden_size=D,
                                      pad_vocab_to_eight=True)
    ids = _ids(2, 7, 61, [7, 3])
    variables = _init(jmod, 0, jnp.asarray(ids))
    table = variables["params"]["embedding"]
    assert table.shape == (64, D)
    port = _load(nn.ModuleDict({"emb": common.SharedEmbedding(
        61, D, True, torch.float32, _gen())}),
        {"params": {"emb": variables["params"]}})
    got = port["emb"](torch.from_numpy(ids))
    want = jmod.apply(variables, jnp.asarray(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert np.all(got.detach().numpy()[1, 3:] == 0)          # pad rows zero
    x = _x(2, 5, D)
    np.testing.assert_allclose(
        common.project_logits(torch.tensor(table), torch.from_numpy(x),
                              61).numpy(),
        np.asarray(jax_common.project_logits(jnp.asarray(table),
                                             jnp.asarray(x), 61)), **TOL)


def test_transformer_norm_layer_norm():
    jmod = jax_common.make_norm(None, jnp.float32)
    x = 3.0 * _x(2, 5, D) + 1.0
    variables = _init(jmod, 1, jnp.asarray(x))
    port = _load(nn.ModuleDict({"norm": common.TransformerNorm(D)}),
                 {"params": {"norm": variables["params"]}})
    np.testing.assert_allclose(
        port["norm"](torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)
    with pytest.raises(NotImplementedError, match="batch_norm"):
        common.TransformerNorm(D, {"type": "batch_norm"})


def test_feed_forward_network():
    jmod = jax_ffn.FeedForwardNetwork(hidden_size=D, filter_size=FILTER,
                                      relu_dropout=0.0)
    x = _x(2, 6, D)
    variables = _init(jmod, 2, jnp.asarray(x))
    port = _load(ffn.FeedForwardNetwork(D, FILTER, torch.float32, _gen()),
                 variables)
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)


# -- attention ------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_self_attention_full_sequence(causal):
    T = 9
    jmod = jax_attention.SelfAttention(hidden_size=D, num_heads=HEADS,
                                       attention_dropout=0.0, causal=causal)
    x = _x(3, T, D, seed=3)
    bias = (jax_common.get_decoder_self_attention_bias(T) if causal else
            np.asarray(jax_common.get_padding_bias(
                jnp.asarray(_ids(3, T, 20, [9, 5, 2])))))
    variables = _init(jmod, 3, jnp.asarray(x), bias=jnp.asarray(bias))
    port = _load(attention.SelfAttention(D, HEADS, torch.float32, _gen(),
                                         causal=causal), variables)
    got = port(torch.from_numpy(x), torch.tensor(bias))
    want, _ = jmod.apply(variables, jnp.asarray(x), bias=jnp.asarray(bias))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_self_attention_cached_decode_steps():
    """Each decode step, on a time-first cache, equals the full causal
    pass at its position (the JAX package's decode masks the rest of its
    cache with -1e7)."""
    T, N = 8, 3
    jmod = jax_attention.SelfAttention(hidden_size=D, num_heads=HEADS,
                                       attention_dropout=0.0, causal=True)
    x = _x(N, T, D, seed=4)
    bias = jax_common.get_decoder_self_attention_bias(T)
    variables = _init(jmod, 4, jnp.asarray(x), bias=jnp.asarray(bias))
    port = _load(attention.SelfAttention(D, HEADS, torch.float32, _gen(),
                                         causal=True), variables)
    want, _ = jmod.apply(variables, jnp.asarray(x), bias=jnp.asarray(bias))
    k_cache, v_cache = torch.zeros((2, T + 2, N, HEADS, D // HEADS))
    for pos in range(T):
        with torch.no_grad():
            got = port.decode_step(torch.from_numpy(x[:, pos:pos + 1]),
                                   k_cache, v_cache, pos)
        np.testing.assert_allclose(got.numpy()[:, 0],
                                   np.asarray(want)[:, pos], **TOL)
    # the JAX package's own cached step at the last position
    jcache = {"k": jnp.asarray(k_cache[:T].transpose(0, 1).numpy()),
              "v": jnp.asarray(v_cache[:T].transpose(0, 1).numpy())}
    row = jnp.where(jnp.arange(T) > T - 1, -1e7, 0.0)[None, None, None]
    jstep, _ = jmod.apply(variables, jnp.asarray(x[:, T - 1:]), bias=row,
                          cache=jcache, decode_pos=T - 1)
    np.testing.assert_allclose(np.asarray(jstep)[:, 0],
                               np.asarray(want)[:, T - 1], **TOL)


def test_cross_attention_full_and_precomputed():
    S, T = 10, 6
    jmod = jax_attention.CrossAttention(hidden_size=D, num_heads=HEADS,
                                        attention_dropout=0.0)
    x, mem = _x(3, T, D, seed=5), _x(3, S, D, seed=6)
    bias = np.asarray(jax_common.get_padding_bias(
        jnp.asarray(_ids(3, S, 20, [10, 6, 1]))))
    variables = _init(jmod, 5, jnp.asarray(x), memory=jnp.asarray(mem),
                      bias=jnp.asarray(bias))
    port = _load(attention.CrossAttention(D, HEADS, torch.float32, _gen()),
                 variables)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x),
                                 memory=jnp.asarray(mem),
                                 bias=jnp.asarray(bias)))
    got = port(torch.from_numpy(x), torch.from_numpy(mem),
               torch.tensor(bias))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    kv = port.precompute_kv(torch.from_numpy(mem))
    step = port(torch.from_numpy(x[:, 2:3]), bias=torch.tensor(bias),
                kv_cache=kv)
    np.testing.assert_allclose(step.detach().numpy()[:, 0], want[:, 2],
                               **TOL)


# -- encoder --------------------------------------------------------------

ENC = {"encoder_layers": 2, "hidden_size": D, "num_heads": HEADS,
       "attention_dropout": 0.0, "filter_size": FILTER,
       "src_vocab_size": 61, "relu_dropout": 0.0,
       "layer_postprocess_dropout": 0.0, "remove_padding": True,
       "pad_embeddings_2_eight": True}


@pytest.mark.parametrize("flash_route", [False, True])
def test_encoder(flash_route, monkeypatch):
    """The encoder; with ``flash_route`` the flash path is taken on the
    CPU (``_flash_ok`` without its device test), which runs the kernel's
    plain version once per layer and launches nothing."""
    ids = _ids(3, 11, 61, [11, 7, 2], seed=7)
    batch = {"source_tensors": [ids, np.array([11, 7, 2], np.int32)]}
    params = dict(ENC, use_flash_attention=True)
    jmod = JaxEncoder(params, None, mode="eval").make_module()
    variables = _init(jmod, 7, {"source_tensors": [jnp.asarray(a) for a in
                                                   batch["source_tensors"]]},
                      train=False)
    want = jmod.apply(variables, {"source_tensors": [
        jnp.asarray(a) for a in batch["source_tensors"]]}, train=False)
    port = _load(TransformerEncoder(params, None, mode="eval").make_module(
        0, _gen()), {"params": variables["params"]})
    calls = []
    if flash_route:
        monkeypatch.setattr(attention, "_flash_ok", lambda q, k: (
            q.shape[-1] in fa.HEAD_DIMS and min(q.shape[1], k.shape[1]) > 1))
        plain = attention.flash_attention
        monkeypatch.setattr(attention, "flash_attention",
                            lambda *a: calls.append(1) or plain(*a))
    launches = fa.LAUNCHES
    with torch.no_grad():
        got = port({"source_tensors": [torch.from_numpy(a) for a in
                                       batch["source_tensors"]]}, False)
    assert len(calls) == (2 if flash_route else 0)
    assert fa.LAUNCHES == launches
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]), **TOL)
    np.testing.assert_array_equal(got["attention_bias"].numpy(),
                                  np.asarray(want["attention_bias"]))


@pytest.mark.parametrize("key", ["sequence_parallel", "moe_num_experts",
                                 "num_pipeline_stages"])
def test_encoder_refuses_unported_options(key):
    with pytest.raises(ValueError, match=key):
        TransformerEncoder(dict(ENC, **{key: 2 if "num" in key or "moe" in
                                        key else True}), None)


# -- beam search ----------------------------------------------------------

B, K, V = 3, 4, 23


def _tables(T, eos, seed=0):
    """Step logits per position: EOS (id 1) never wins, except at
    positions [first, last) of ``eos`` = (first, last, logit)."""
    rng = np.random.RandomState(seed)
    table = (2.0 * rng.randn(T, V)).astype(np.float32)
    table[:, 1] = -30.0
    if eos is not None:
        first, last, logit = eos
        table[first:last, 1] = logit
    w = rng.randn(V).astype(np.float32)
    return table, w


def _jax_beams(T, table, w, segments=None):
    """JAX beam search over a toy step: logits depend on the position and
    on the sum of the beam's history, which the cache carries (so beam
    reorders matter)."""
    def fn(ids, pos, cache):
        hist = jax.lax.dynamic_update_slice(
            cache["hist"], ids.astype(jnp.float32), (0, pos))
        h = jnp.sum(hist, axis=1)
        logits = jnp.asarray(table)[pos][None] + \
            0.01 * h[:, None] * jnp.asarray(w)[None]
        return logits, {"hist": hist}
    bounds = (jax_bs.geometric_segment_bounds(T, segments)
              if segments else None)
    ids, scores = jax_bs.beam_search(
        fn, {"hist": jnp.zeros((B, T), jnp.float32)}, batch_size=B,
        beam_size=K, vocab_size=V, max_decode_length=T, eos_id=1,
        alpha=0.6, bos_id=2, segment_bounds=bounds)
    return np.asarray(ids), np.asarray(scores)


def _port_beams(T, table, w):
    hist = [torch.zeros((B * K, T))]
    steps = []

    def fn(ids, pos):
        steps.append(pos)
        hist[0][:, pos] = ids[:, 0].float()
        h = hist[0].sum(1)
        return torch.from_numpy(table)[pos][None] + \
            0.01 * h[:, None] * torch.from_numpy(w)[None]

    def reorder(parents, pos):
        hist[0] = hist[0][parents]

    ids, scores = beam_search.beam_search(
        fn, reorder, batch_size=B, beam_size=K, vocab_size=V,
        max_decode_length=T, eos_id=1, alpha=0.6, bos_id=2)
    return ids.numpy(), scores.numpy(), steps


@pytest.mark.parametrize("case,eos,segments", [
    ("no EOS", None, None),
    ("EOS ends the loop", (3, 9, 6.0), None),
    ("some beams finish", (4, 5, 3.0), None),
    ("no EOS, segmented", None, 3),
    ("EOS, segmented", (2, 9, 6.0), 3),
    ("some finish, segmented", (5, 6, 1.0), 3)])
def test_beam_search_matches_jax(case, eos, segments):
    """All K beams (the finished set's NEG_INF slots included) and the
    scores; with ``segments`` the JAX side runs its segmented decode."""
    T = 9
    table, w = _tables(T, eos, seed=26)
    want_ids, want_scores = _jax_beams(T, table, w, segments)
    got_ids, got_scores, steps = _port_beams(T, table, w)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-6)
    finished = want_scores > beam_search.NEG_INF
    if "ends" in case or case == "EOS, segmented":
        assert len(steps) < T and finished.all()
    else:
        assert len(steps) == T
    if "some" in case:
        # rows with finished beams keep NEG_INF in their empty slots
        assert np.any(want_ids[:, :, 1:] == 1) and not finished.all() and \
            finished.any()
    np.testing.assert_array_equal(
        beam_search.sequence_lengths_from_ids(
            torch.from_numpy(got_ids[:, 0, 1:]), 1).numpy(),
        np.asarray(jax_bs.sequence_lengths_from_ids(
            jnp.asarray(want_ids[:, 0, 1:]), 1)))


def test_top_k_takes_the_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e7, -1e7, 3.0]])
    values, idx = beam_search._top_k(x, 5)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))


# -- Text2Text through run.main -------------------------------------------

def _jax_params(base):
    # the JAX package builds its optimizer state even for eval
    p = dict(base, encoder=JaxEncoder, decoder=JaxDecoder, loss=JaxLoss,
             data_layer=JaxText, optimizer="Adam",
             optimizer_params={"learning_rate": 1e-3})
    p.pop("logdir")
    return p


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny config's JAX model and outputs in eval and infer, and a
    port logdir holding the same (randomized) weights."""
    cfg = runpy.run_path(CONFIG)
    jparams = _jax_params(cfg["base_params"])
    jmodel = JaxText2Text(params=jparams, mode="eval")
    batches = list(jmodel.get_data_layer().iterate_one_epoch())
    jstate = jmodel.init_state(batches[0])
    variables = randomize(jax.device_get({"params": jstate.params}), 8)
    jstate = jstate.replace(params=variables["params"])
    step = jax.jit(jmodel.eval_step)
    jeval = [jax.device_get(step(jstate, b)) for b in batches]
    metrics = jmodel.finalize_evaluation(
        [jmodel.evaluate(b, o) for b, o in zip(batches, jeval)])
    imodel = JaxText2Text(params=jparams, mode="infer")
    ibatches = [{k: v for k, v in b.items() if k != "target_tensors"}
                for b in imodel.get_data_layer().iterate_one_epoch()]
    istep = jax.jit(imodel.eval_step)
    jinfer = [imodel.infer(b, jax.device_get(istep(jstate, b)))
              for b in ibatches]
    logdir = str(tmp_path_factory.mktemp("tiny") / "logs")
    out = os.path.join(os.path.dirname(logdir), "jax_infer.txt")
    imodel.finalize_inference(jinfer, out)
    with open(out) as f:
        jax_lines = f.read().splitlines()

    model = cfg["base_model"](dict(cfg["base_params"], logdir=logdir),
                              mode="eval", device="cpu")
    state = trainer.restore_state(model)
    state.module.load_state_dict(state_dict_from_flax(variables),
                                 strict=True)
    CheckpointManager(logdir).save(state, 0)
    return dict(cfg=cfg, batches=batches, jeval=jeval, metrics=metrics,
                jax_lines=jax_lines, logdir=logdir, model=model,
                state=state)


def test_tiny_eval_step_matches_jax(tiny):
    """Teacher-forced decoder logits, loss, and the beam decode of the
    same eval step."""
    for batch, want in zip(tiny["batches"], tiny["jeval"]):
        got = to_host(tiny["model"].eval_step(tiny["state"], batch))
        dec, jdec = (o["outputs"]["decoder_output"] for o in (got, want))
        assert dec["logits"].shape == (3, 11, 61)
        np.testing.assert_allclose(dec["logits"], np.asarray(jdec["logits"]),
                                   **TOL)
        np.testing.assert_allclose(got["loss"], np.asarray(want["loss"]),
                                   **TOL)
        np.testing.assert_array_equal(dec["beams"], np.asarray(jdec["beams"]))
        for a, b in zip(dec["outputs"], jdec["outputs"]):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_allclose(dec["scores"], np.asarray(jdec["scores"]),
                                   rtol=1e-5)
        assert 0 < len(set(dec["outputs"][1].tolist()))


def test_tiny_run_main_eval_and_infer_match_jax(tiny, tmp_path):
    args = ["--config_file=" + CONFIG, "--logdir=" + tiny["logdir"],
            "--device=cpu"]
    metrics = run.main(args + ["--mode=eval"])
    assert metrics["Eval BLEU"] == pytest.approx(tiny["metrics"]["Eval BLEU"],
                                                 rel=0, abs=0)
    np.testing.assert_allclose(metrics["eval_loss"],
                               tiny["metrics"]["eval_loss"], **TOL)
    out = str(tmp_path / "infer.txt")
    run.main(args + ["--mode=infer", "--infer_output_file=" + out])
    with open(out) as f:
        lines = f.read().splitlines()
    assert len(lines) == 6 and lines == tiny["jax_lines"]


def test_tiny_flash_route_counts(tiny, monkeypatch):
    """With the flash path taken on the CPU, eval calls the flash op 3
    times per layer pair (encoder self, decoder causal self and cross)
    and the beam decode none: 6 here, 18 at transformer-big's 6 + 6
    layers; infer calls it for the encoder only."""
    monkeypatch.setattr(attention, "_flash_ok", lambda q, k: (
        q.shape[-1] in fa.HEAD_DIMS and min(q.shape[1], k.shape[1]) > 1))
    calls = []
    plain = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a: calls.append(1) or plain(*a))
    batch, want = tiny["batches"][0], tiny["jeval"][0]
    got = to_host(tiny["model"].eval_step(tiny["state"], batch))
    assert len(calls) == 6
    np.testing.assert_allclose(
        got["outputs"]["decoder_output"]["logits"],
        np.asarray(want["outputs"]["decoder_output"]["logits"]), **TOL)
    np.testing.assert_array_equal(
        got["outputs"]["decoder_output"]["beams"],
        np.asarray(want["outputs"]["decoder_output"]["beams"]))
    infer = tiny["cfg"]["base_model"](tiny["cfg"]["base_params"],
                                      mode="infer", device="cpu")
    istate = trainer.restore_state(infer)
    istate.module.load_state_dict(tiny["state"].module.state_dict())
    calls.clear()
    out = to_host(infer.eval_step(istate, batch))
    assert len(calls) == 2 and "logits" not in out["outputs"][
        "decoder_output"]
    np.testing.assert_array_equal(
        out["outputs"]["decoder_output"]["beams"],
        np.asarray(want["outputs"]["decoder_output"]["beams"]))


def test_text2text_refuses_training():
    """Training is ported (tests/test_torch_transformer_train.py); what it
    refuses is a step with dropout on and no generator to draw it."""
    cfg = runpy.run_path(TRAIN_CONFIG)
    model = cfg["base_model"](cfg["base_params"], mode="train", device="cpu")
    state = trainer.restore_state(model)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    with pytest.raises(ValueError, match="torch.Generator"):
        model.train_step(state, batch)


def test_dense_keeps_its_cast_until_the_weights_change():
    """Under "mixed" a Dense casts its fp32 parameters to bf16 once per
    change of the parameters when no gradient is taken, and at every call
    under autograd."""
    dense = common.Dense(8, 4, torch.bfloat16, _gen())
    x = torch.from_numpy(_x(3, 8))
    with torch.no_grad():
        first = dense._params()
        assert dense._params()[0] is first[0]
        torch.testing.assert_close(dense(x), torch.nn.functional.linear(
            x.bfloat16(), dense.weight.bfloat16(), dense.bias.bfloat16()))
        dense.weight.add_(1.0)
        assert dense._params()[0] is not first[0]
        torch.testing.assert_close(dense._params()[0],
                                   dense.weight.bfloat16())
    assert dense._params()[0] is not dense._params()[0]
    assert common.Dense(8, 4, torch.float32, _gen())._params()[0].dtype == \
        torch.float32
