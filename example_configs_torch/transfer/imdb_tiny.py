"""Tiny IMDB sentiment classifier for the PyTorch port on the CPU: the
transfer recipes' model cut to a 16-wide embedding and one 32-unit LSTM
layer, the last h and c through a ReLU layer of 16 and the fp32
classifier, 8 reviews a batch of at most 64 words, fp32, Adam 1e-3, 10
steps. The data is a small corpus of ``test_utils/fake_wikitext.py``
(400 word types, 32 reviews a class and split), written on first use
under ``os2s_tiny_transfer`` in the temporary directory (or
``OS2S_TINY_TRANSFER_DIR``) with the LM vocabulary its ``Corpus`` builds
(``wikitext-103/processed/vocab.txt``). Set ``load_model`` to the logdir
of an LM of the same widths on that vocabulary to start from it.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --logdir=/tmp/imdb_tiny \\
      --config_file=example_configs_torch/transfer/imdb_tiny.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.lm import Corpus, IMDBDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import LSTMLM
from openseq2seq_tpu_torch.test_utils import fake_wikitext

_ROOT = os.environ.get("OS2S_TINY_TRANSFER_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_tiny_transfer"))
_WKT = os.path.join(_ROOT, "wikitext-103")
_VOCAB = os.path.join(_WKT, "processed", "vocab.txt")
if not os.path.exists(_VOCAB):
    fake_wikitext.generate(_ROOT, seed=0, n_types=400, n_train_tokens=5000,
                           n_eval_tokens=1000, n_reviews=32, n_sentences=32)
    Corpus(_WKT, os.path.dirname(_VOCAB))

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "max_steps": 10,
    "logdir": "imdb_tiny_logs",
    "lm_vocab_file": _VOCAB,
    "batch_size_per_gpu": 8,
    "print_loss_steps": 5,
    "eval_steps": 10,
    "save_checkpoint_steps": 10,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "regularizer": "l2",
    "regularizer_params": {"scale": 2e-4},
    "dtype": "float32",
    "encoder": LMEncoder,
    "encoder_params": {
        "emb_size": 16,
        "encoder_layers": 1,
        "encoder_use_skip_connections": False,
        "core_cell": None,
        "core_cell_params": {"num_units": 32},
        "use_cudnn_rnn": False,
        "cudnn_rnn_type": None,
        "weight_tied": True,
        "fc_use_bias": True,
        "use_cell_state": True,
        "fc_dim": 16,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": IMDBDataLayer,
    "data_layer_params": {
        "data_root": os.path.join(_ROOT, "aclImdb"),
        "lm_vocab_file": _VOCAB,
        "processed_data_folder": os.path.join(_ROOT, "processed_imdb"),
        "binary": True,
        "max_length": 64,
        "repeat": True,
        "num_classes": 2,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
