"""The port's LM data layers against the JAX package's on the same files:
``Corpus`` (vocabulary, ids, caches) and ``WKTDataLayer`` (windows,
targets shifted by one, lengths, ``small``, ``rand_start`` from the
layer's seed) on a corpus of ``test_utils/fake_wikitext.py``; the three
classification layers (``IMDBDataLayer``, ``SSTDataLayer`` and their base,
``TextClassificationDataLayer``, through both) on its review tree and tsv
files; the generator's vocabulary size; and C25: the JAX ``Corpus``
writes no ``vocab.txt``, the path the transfer recipes give as
``lm_vocab_file``, and the port's does, one word a line in id order.
Everything here is exact."""
import os
import runpy

import numpy as np
import pytest

from openseq2seq_tpu.data.lm import Corpus as JaxCorpus
from openseq2seq_tpu.data.lm import IMDBDataLayer as JaxIMDB
from openseq2seq_tpu.data.lm import SSTDataLayer as JaxSST
from openseq2seq_tpu.data.lm import WKTDataLayer as JaxWKT
from openseq2seq_tpu_torch.data.lm import (Corpus, IMDBDataLayer,
                                           SSTDataLayer,
                                           TextClassificationDataLayer,
                                           WKTDataLayer)
from openseq2seq_tpu_torch.test_utils import fake_wikitext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TYPES = 300


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fake_wikitext"))
    return fake_wikitext.generate(root, seed=3, n_types=N_TYPES,
                                  n_train_tokens=6000, n_eval_tokens=900,
                                  n_reviews=6, n_sentences=11)


def test_generator_vocabulary(corpus, tmp_path):
    """Every type and <unk> in the train split: V = types + 2; the default
    size gives WikiText-103's 267,735 types with <unk>, plus <eos>."""
    corp = Corpus(corpus["wikitext"], str(tmp_path / "p"))
    assert corp.vocab_size == N_TYPES + 2
    assert list(corp.word2idx)[:2] == ["<unk>", "<eos>"]
    assert len(set(fake_wikitext.word_types(
        fake_wikitext.WKT103_TYPES))) + 2 == 267736
    again = fake_wikitext.generate(str(tmp_path / "again"), seed=3,
                                   n_types=N_TYPES, n_train_tokens=6000,
                                   n_eval_tokens=900, n_reviews=6,
                                   n_sentences=11)
    for split in ("train", "valid"):
        name = "wiki.{}.tokens".format(split)
        with open(os.path.join(corpus["wikitext"], name)) as a, \
                open(os.path.join(again["wikitext"], name)) as b:
            assert a.read() == b.read()


def test_corpus_matches_jax(corpus, tmp_path):
    corp = Corpus(corpus["wikitext"], str(tmp_path / "port"))
    jcorp = JaxCorpus(corpus["wikitext"], str(tmp_path / "jax"))
    assert corp.word2idx == jcorp.word2idx
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(corp.ids(split), jcorp.ids(split))
    # from the caches alone
    cached = Corpus(None, str(tmp_path / "port"))
    assert cached.word2idx == corp.word2idx
    np.testing.assert_array_equal(cached.ids("valid"), corp.ids("valid"))


def _wkt_params(corpus, folder, mode, **kw):
    return dict({"data_root": corpus["wikitext"],
                 "processed_data_folder": folder, "repeat": True,
                 "bptt": 12, "batch_size": 7, "mode": mode}, **kw)


@pytest.mark.parametrize("mode,kw", [
    ("train", {}), ("train", {"rand_start": True}), ("eval", {}),
    ("infer", {}), ("train", {"small": True})])
def test_wkt_layer_matches_jax(corpus, tmp_path, mode, kw):
    folder = str(tmp_path / "p")
    dl = WKTDataLayer(_wkt_params(corpus, folder, mode, **kw), None)
    jdl = JaxWKT(_wkt_params(corpus, folder, mode, **kw), None)
    assert dl.params["vocab_size"] == jdl.params["vocab_size"] == \
        N_TYPES + 2
    assert dl.params["end_token"] == jdl.params["end_token"] == 1
    assert dl.get_size_in_samples() == jdl.get_size_in_samples()
    for epoch in range(2):
        dl.seed(11 + epoch)
        jdl.seed(11 + epoch)
        got = list(dl.iterate_one_epoch())
        want = list(jdl.iterate_one_epoch())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for key in ("source_tensors", "target_tensors"):
                for a, b in zip(g[key], w[key]):
                    np.testing.assert_array_equal(a, b)
            x, y = g["source_tensors"][0], g["target_tensors"][0]
            np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
            assert int(g["batch_valid"]) == 7
    if kw.get("rand_start"):
        starts = set()
        for seed in range(20):
            dl.seed(seed)
            starts.add(int(next(iter(dl.iterate_one_epoch()))
                           ["source_tensors"][0][0, 0]))
        assert len(starts) > 1


def _cls_params(corpus, tmp_path, mode, vocab, **kw):
    return dict({"lm_vocab_file": vocab, "repeat": True, "max_length": 48,
                 "processed_data_folder": str(tmp_path / "cls"),
                 "batch_size": 4, "mode": mode}, **kw)


@pytest.mark.parametrize("layer", ["imdb", "sst"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_classification_layers_match_jax(corpus, tmp_path, layer, mode):
    vocab = os.path.join(Corpus(corpus["wikitext"],
                                str(tmp_path / "p")).processed, "vocab.txt")
    cls, jcls, root = ((IMDBDataLayer, JaxIMDB, corpus["imdb"])
                       if layer == "imdb" else
                       (SSTDataLayer, JaxSST, corpus["sst"]))
    params = _cls_params(corpus, tmp_path, mode, vocab, data_root=root)
    dl, jdl = cls(dict(params), None), jcls(dict(params), None)
    assert isinstance(dl, TextClassificationDataLayer)
    assert dl.params["num_classes"] == jdl.params["num_classes"] == 2
    assert dl.params["vocab_size"] == N_TYPES + 2
    assert dl.get_size_in_samples() == jdl.get_size_in_samples() == (
        12 if layer == "imdb" else 11)
    dl.seed(5)
    jdl.seed(5)
    got, want = list(dl.iterate_one_epoch()), list(jdl.iterate_one_epoch())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("source_tensors", "target_tensors"):
            for a, b in zip(g[key], w[key]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g["source_ids"], w["source_ids"])
        assert int(g["batch_valid"]) == int(w["batch_valid"])
        x, lengths = g["source_tensors"]
        assert x.shape[1] % 8 == 0 and lengths.max() <= 48
    # the reviews' words are the LM's: no <unk> in them
    assert all((b["source_tensors"][0] != 0).sum() ==
               b["source_tensors"][1].sum() for b in got
               if int(b["batch_valid"]) == 4)


def test_c25_transfer_vocabulary(corpus, tmp_path):
    """The JAX transfer recipes read ``<processed>/vocab.txt`` as the LM's
    vocabulary, which the JAX ``Corpus`` never writes; the port's writes
    it, so that a classifier's ids are the LM's embedding rows."""
    recipe = open(os.path.join(REPO, "example_configs", "transfer",
                               "imdb_wkt103.py")).read()
    assert '"processed", "vocab.txt"' in recipe
    JaxCorpus(corpus["wikitext"], str(tmp_path / "jax"))
    assert not os.path.exists(tmp_path / "jax" / "vocab.txt")
    corp = Corpus(corpus["wikitext"], str(tmp_path / "port"))
    vocab = tmp_path / "port" / "vocab.txt"
    words = vocab.read_text(encoding="utf-8").splitlines()
    assert [corp.word2idx[w] for w in words] == list(range(len(words)))
    dl = SSTDataLayer(_cls_params(corpus, tmp_path, "eval", str(vocab),
                                  data_root=corpus["sst"]), None)
    assert dl.word2idx == corp.word2idx


def test_transfer_recipes_point_at_the_corpus_vocabulary(corpus,
                                                         monkeypatch):
    monkeypatch.setenv("WIKITEXT103_DIR", corpus["wikitext"])
    monkeypatch.setenv("IMDB_DIR", corpus["imdb"])
    for name in ("imdb_wkt103.py", "imdb_wkt2.py", "imdb_from_scratch.py",
                 "sst_wkt2.py", "sst_wkt2_small.py"):
        c = runpy.run_path(os.path.join(REPO, "example_configs_torch",
                                        "transfer", name))
        p = c["base_params"]
        assert p["lm_vocab_file"] == \
            p["data_layer_params"]["lm_vocab_file"]
        assert p["lm_vocab_file"].endswith(os.path.join("processed",
                                                        "vocab.txt"))
