"""The port's text data layers, tokenizers and corpus generators against
the JAX package's, and the transformer NMT from text files:

  * every batch of ``ParallelTextDataLayer`` equal to the JAX layer's for
    the same files and seed: shuffle on (two epochs) and off (eval's stable
    sort by source length, the last batch padded by repeating its last
    example, with ``batch_valid``), with and without padding to eight,
    with ``use_targets`` False, the specials added to the vocabulary, and
    over two workers;
  * every batch of ``TransformerDataLayer`` (t2t records) equal, shuffled
    and over two workers, and its wordpiece detokenization;
  * ``Subtokenizer`` and ``WordpieceSubtokenizer``: the trained
    vocabularies, ids and decodes equal;
  * ``toy_nmt`` and ``fake_wmt`` files byte-identical;
  * ``CrossEntropyWithSmoothing`` against the JAX loss (fp32, rtol 1e-5);
  * ``run.main`` in train, eval and infer on the tiny transformer config
    ``example_configs_torch/text2text/transformer_tiny_wmt.py``;
  * (slow) the transformer reversal toy to a validation BLEU above 80."""
import filecmp
import os
import re
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.data import text2text as jax_t2t
from openseq2seq_tpu.data.text2text import tokenizer as jax_tokenizer
from openseq2seq_tpu.data.text2text import wordpiece as jax_wordpiece
from openseq2seq_tpu.losses import \
    CrossEntropyWithSmoothing as JaxCrossEntropy
from openseq2seq_tpu.test_utils import fake_wmt as jax_fake_wmt
from openseq2seq_tpu.test_utils import toy_nmt as jax_toy_nmt
from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.data import text2text
from openseq2seq_tpu_torch.data.text2text import tokenizer, wordpiece
from openseq2seq_tpu_torch.losses import CrossEntropyWithSmoothing
from openseq2seq_tpu_torch.ops import flash_attention
from openseq2seq_tpu_torch.test_utils import fake_wmt, toy_nmt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "text2text")
TINY = os.path.join(CONFIGS, "transformer_tiny_wmt.py")
TOY = os.path.join(CONFIGS, "nmt_reversal_toy.py")
TRAIN_EN = "train.clean.en.shuffled.BPE_common.32K.tok"
TRAIN_DE = "train.clean.de.shuffled.BPE_common.32K.tok"


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(port's fake WMT dir, JAX package's, port's toy dir, JAX's), the
    fake WMT corpus with its t2t records (120 pairs, 64 word types)."""
    root = tmp_path_factory.mktemp("text")
    kw = dict(n_train=120, n_dev=20, n_test=20, n_types=64, seed=3)
    dirs = (fake_wmt.generate(str(root / "wmt"), **kw),
            jax_fake_wmt.generate(str(root / "jax_wmt"), **kw),
            toy_nmt.generate(str(root / "toy"), num_train=40,
                             num_eval=9)["dir"],
            jax_toy_nmt.generate(str(root / "jax_toy"), num_train=40,
                                 num_eval=9)["dir"])
    return dirs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: these small models run thousands of tiny ops,
    which slowed 50x to 200x when the suite's workers, each on every
    core, contended for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def tiny_corpus_dir(tmp_path_factory):
    """The tiny config's corpus in a directory of this module's own."""
    old = os.environ.get("OS2S_FAKE_WMT_TINY_DIR")
    os.environ["OS2S_FAKE_WMT_TINY_DIR"] = str(
        tmp_path_factory.mktemp("tiny_wmt"))
    yield
    if old is None:
        del os.environ["OS2S_FAKE_WMT_TINY_DIR"]
    else:
        os.environ["OS2S_FAKE_WMT_TINY_DIR"] = old


def test_generators_write_identical_files(corpora):
    wmt, jax_wmt, toy, jax_toy = corpora
    for mine, theirs in ((wmt, jax_wmt), (toy, jax_toy),
                         (os.path.join(wmt, "t2t"),
                          os.path.join(jax_wmt, "t2t"))):
        names = sorted(n for n in os.listdir(theirs)
                       if os.path.isfile(os.path.join(theirs, n)))
        assert sorted(n for n in os.listdir(mine)
                      if os.path.isfile(os.path.join(mine, n))) == names
        _, mismatch, errors = filecmp.cmpfiles(mine, theirs, names,
                                               shallow=False)
        assert not mismatch and not errors, (mismatch, errors)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if isinstance(value, list):
                for a, b in zip(g[key], value):
                    np.testing.assert_array_equal(a, b)
                    assert a.dtype == b.dtype
            else:
                np.testing.assert_array_equal(g[key], value)


def _parallel(d, mode, **extra):
    return dict({"mode": mode, "batch_size": 16, "max_length": 16,
                 "source_file": os.path.join(d, TRAIN_EN),
                 "target_file": os.path.join(d, TRAIN_DE),
                 "src_vocab_file": os.path.join(d, "m_common.vocab"),
                 "tgt_vocab_file": os.path.join(d, "m_common.vocab"),
                 "shuffle": mode == "train", "repeat": False}, **extra)


@pytest.mark.parametrize("mode,extra,workers", [
    ("train", {}, 1),
    ("train", {"pad_lengths_to_eight": True, "pad_vocab_to_eight": True}, 1),
    ("train", {"shuffle": False}, 1),
    ("eval", {"pad_lengths_to_eight": True}, 1),
    ("eval", {}, 2),
    ("infer", {"use_targets": False}, 1),
    ("toy", {}, 1),
], ids=["train", "pad8", "unshuffled", "eval_pad8", "eval_workers",
        "infer", "toy_specials"])
def test_parallel_text_batches_match_jax(corpora, mode, extra, workers):
    wmt, _, toy, _ = corpora
    if mode == "toy":
        params = _parallel(toy, "train", **extra)
        params.update(source_file=os.path.join(toy, "train.src"),
                      target_file=os.path.join(toy, "train.tgt"),
                      src_vocab_file=os.path.join(toy, "vocab.txt"),
                      tgt_vocab_file=os.path.join(toy, "vocab.txt"),
                      special_tokens_already_in_vocab=False, batch_size=6)
    else:
        params = _parallel(wmt, mode, **extra)
    for worker in range(workers):
        layers = [cls(dict(params), None, num_workers=workers,
                       worker_id=worker)
                  for cls in (text2text.ParallelTextDataLayer,
                              jax_t2t.ParallelTextDataLayer)]
        for layer in layers:
            layer.seed(5 + worker)
        got, want = layers[0], layers[1]
        assert got.params["src_vocab_size"] == want.params["src_vocab_size"]
        assert got.get_size_in_samples() == want.get_size_in_samples()
        for _ in range(2):
            g = list(got.iterate_one_epoch())
            _assert_batches_equal(g, list(want.iterate_one_epoch()))
        assert [got.decode_ids(b["source_tensors"][0][0], side="src")
                for b in g] == [want.decode_ids(b["source_tensors"][0][0],
                                                side="src") for b in g]
        if mode == "eval":
            assert int(g[-1]["batch_valid"]) == \
                got.get_size_in_samples() - 16 * (len(g) - 1)


@pytest.mark.parametrize("mode,workers", [("train", 1), ("eval", 2)])
def test_transformer_data_layer_matches_jax(corpora, mode, workers):
    wmt = corpora[0]
    t2t = os.path.join(wmt, "t2t")
    params = {"mode": mode, "data_dir": t2t, "batch_size": 16,
              "file_pattern": "train-*.tfrecord" if mode == "train"
              else "*.tfrecord", "src_vocab_size": 4096, "max_length": 24,
              "pad_lengths_to_eight": True,
              "vocab_file": os.path.join(t2t, "vocab.ende.sub")}
    for worker in range(workers):
        layers = [cls(dict(params), None, num_workers=workers,
                       worker_id=worker)
                  for cls in (text2text.TransformerDataLayer,
                              jax_t2t.TransformerDataLayer)]
        for layer in layers:
            layer.seed(7)
        got = list(layers[0].iterate_one_epoch())
        _assert_batches_equal(got, list(layers[1].iterate_one_epoch()))
        assert layers[0].get_size_in_samples() == \
            layers[1].get_size_in_samples()
        rows = got[0]["target_tensors"][0]
        assert [layers[0].decode_ids(r) for r in rows] == \
            [layers[1].decode_ids(r) for r in rows]


def test_subtokenizers_match_jax(corpora, tmp_path):
    wmt = corpora[0]
    files = [os.path.join(wmt, TRAIN_EN), os.path.join(wmt, TRAIN_DE)]
    with open(files[1]) as f:
        lines = [line.strip() for line in f][:20]
    bpe = tokenizer.Subtokenizer.init_from_files(files, 300)
    jbpe = jax_tokenizer.Subtokenizer.init_from_files(files, 300)
    assert bpe.vocab == jbpe.vocab and bpe.merges == jbpe.merges
    ids = [bpe.encode(x, add_eos=True) for x in lines]
    assert ids == [jbpe.encode(x, add_eos=True) for x in lines]
    assert [bpe.decode(i) for i in ids] == [jbpe.decode(i) for i in ids]
    bpe.save_vocab(str(tmp_path / "bpe.vocab"))
    assert tokenizer.Subtokenizer.from_vocab_file(
        str(tmp_path / "bpe.vocab")).vocab == bpe.vocab

    wp = wordpiece.WordpieceSubtokenizer.init_from_files(
        str(tmp_path / "wp.sub"), files, target_vocab_size=500,
        threshold=100)
    jwp = jax_wordpiece.WordpieceSubtokenizer.init_from_files(
        str(tmp_path / "jax_wp.sub"), files, target_vocab_size=500,
        threshold=100)
    assert filecmp.cmp(str(tmp_path / "wp.sub"), str(tmp_path / "jax_wp.sub"),
                       shallow=False)
    ids = [wp.encode(x, add_eos=True) for x in lines + ["a_b\\c é!"]]
    assert ids == [jwp.encode(x, add_eos=True)
                   for x in lines + ["a_b\\c é!"]]
    assert [wp.decode(i) for i in ids] == [jwp.decode(i) for i in ids]
    assert wp.decode(ids[0][:-1]) == lines[0]


@pytest.mark.parametrize("offset,average", [(True, True), (False, False)])
def test_cross_entropy_with_smoothing_matches_jax(offset, average):
    rng = np.random.RandomState(0)
    B, T, V = 3, 6, 11
    logits = rng.randn(B, T, V).astype(np.float32) * 3
    labels = rng.randint(0, V, (B, T)).astype(np.int32)
    lengths = np.array([6, 3, 1], np.int32)
    params = {"tgt_vocab_size": V, "batch_size": B, "label_smoothing": 0.1,
              "offset_target_by_one": offset,
              "average_across_timestep": average}
    want = JaxCrossEntropy(dict(params), None).compute_loss({
        "decoder_output": {"logits": jnp.asarray(logits)},
        "target_tensors": [jnp.asarray(labels), jnp.asarray(lengths)]})
    got = CrossEntropyWithSmoothing(dict(params), None).compute_loss({
        "decoder_output": {"logits": torch.from_numpy(logits)},
        "target_tensors": [torch.from_numpy(labels),
                           torch.from_numpy(lengths)]})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _losses(text):
    return [float(x) for x in re.findall(r"loss = ([0-9.]+)", text)]


def test_run_main_transformer_from_text(tmp_path, capsys):
    """The tiny transformer from text: 8 steps (losses finite, falling,
    checkpoints at 4 and 8, "Validation BLEU" at both), eval from the
    checkpoint, infer one line a source sentence; on the CPU no kernel
    launches."""
    logdir = str(tmp_path / "logs")
    argv = ["--config_file=" + TINY, "--device=cpu", "--logdir=" + logdir]
    launches = (flash_attention.LAUNCHES, flash_attention.BWD_DQ_LAUNCHES)
    result = run.main(argv + ["--mode=train_eval", "--max_steps=8",
                              "--save_checkpoint_steps=4",
                              "--eval_steps=4"])
    assert result["steps"] == 8
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    assert out.count("Validation BLEU") == 2
    metrics = run.main(argv + ["--mode=eval"])
    assert np.isfinite(metrics["eval_loss"]) and "Eval BLEU" in metrics
    infer_file = str(tmp_path / "infer.txt")
    run.main(argv + ["--mode=infer", "--infer_output_file=" + infer_file])
    data = runpy.run_path(TINY)["infer_params"]["data_layer_params"]
    with open(data["source_file"]) as f:
        n = len(f.read().splitlines())
    with open(infer_file) as f:
        assert len(f.read().splitlines()) == n == 16
    assert (flash_attention.LAUNCHES, flash_attention.BWD_DQ_LAUNCHES) == \
        launches


@pytest.mark.slow
def test_transformer_reversal_toy_reaches_bleu(tmp_path, monkeypatch,
                                               capsys):
    """``nmt_reversal_toy.py`` through ``run.main --mode=train_eval`` to
    its end: the last "Validation BLEU" above 80 (the JAX package's bar,
    ``tests/test_text2text_e2e.py``); then eval and infer from its
    checkpoint."""
    monkeypatch.setenv("OS2S_TOY_NMT_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("OS2S_TOY_NMT_LOGDIR", str(tmp_path / "logs"))
    argv = ["--config_file=" + TOY, "--device=cpu"]
    run.main(argv + ["--mode=train_eval"])
    bleu = [float(x) for x in re.findall(r"Validation BLEU: ([0-9.]+)",
                                         capsys.readouterr().out)]
    assert bleu and bleu[-1] > 80.0, bleu
    assert run.main(argv + ["--mode=eval"])["Eval BLEU"] > 80.0
    out = str(tmp_path / "infer.txt")
    run.main(argv + ["--mode=infer", "--infer_output_file=" + out])
    with open(out) as f:
        assert len(f.read().splitlines()) == 32
