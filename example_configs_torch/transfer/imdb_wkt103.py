"""IMDB sentiment transfer from the WikiText-103 LM, for the PyTorch port:
the twin of ``example_configs/transfer/imdb_wkt103.py``, key for key. The
LM encoder of ``lm/lstm_wkt103.py`` (a 320-wide embedding, three
1024-unit LSTM layers) is restored by name and shape from ``load_model``
(``WKT103_LM_LOGDIR``; the LM's softmax is left out, the classifier is
drawn from the seed); the last valid h with the last layer's c goes
through the fp32 binary classifier. fp32, 16 reviews a batch of at most
256 words from ``IMDB_DIR`` (aclImdb's ``{train,test}/{pos,neg}``), ids
from the LM's vocabulary ``WKT103_VOCAB``, by default
``$WIKITEXT103_DIR/processed/vocab.txt``: the port's ``Corpus`` writes
that file, the JAX package's does not (C25). Without ``fused_rnn`` the
layers run the scan, as the JAX recipe's do.

Run (``test_utils/fake_wikitext.py`` writes an aclImdb-shaped tree):
  IMDB_DIR=<dir> WIKITEXT103_DIR=<dir> WKT103_LM_LOGDIR=<lm logdir> \
      python -m openseq2seq_tpu_torch.run --mode=train_eval \
      --config_file=example_configs_torch/transfer/imdb_wkt103.py
"""
import os

from openseq2seq_tpu_torch.data.lm import IMDBDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import LSTMLM

_DATA = os.environ.get("IMDB_DIR", "/data/aclImdb")
_LM_DIR = os.environ.get("WKT103_LM_LOGDIR", "lm_wkt103_log")
_LM_VOCAB = os.environ.get(
    "WKT103_VOCAB", os.path.join(os.environ.get("WIKITEXT103_DIR",
                                                "/data/wikitext-103"),
                                 "processed", "vocab.txt"))

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "num_epochs": 25,
    "logdir": os.environ.get("OS2S_LOGDIR", "imdb_wkt103_log"),
    "load_model": _LM_DIR,
    "restore_best_checkpoint": True,
    "lm_vocab_file": _LM_VOCAB,
    "batch_size_per_gpu": 16,
    "print_loss_steps": 10,
    "save_summaries_steps": 10,
    "eval_steps": 20,
    "save_checkpoint_steps": 10,

    "optimizer": "Adam",
    "optimizer_params": {},
    "lr_policy": "fixed",
    "lr_policy_params": {"learning_rate": 1e-5},
    "regularizer": "l2",
    "regularizer_params": {"scale": 2e-4},
    "dtype": "float32",

    # must match the WKT-103 LM recipe (lm/lstm_wkt103.py) for
    # load_model name+shape partial restore to pick everything up
    "encoder": LMEncoder,
    "encoder_params": {
        "emb_size": 320,
        "encoder_layers": 3,
        "encoder_use_skip_connections": False,
        "core_cell": None,
        "core_cell_params": {"num_units": 1024},
        "use_cudnn_rnn": False,
        "cudnn_rnn_type": None,
        "weight_tied": True,
        "fc_use_bias": True,
        "use_cell_state": True,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": IMDBDataLayer,
    "data_layer_params": {
        "data_root": _DATA,
        "lm_vocab_file": _LM_VOCAB,
        "processed_data_folder": os.path.join(_DATA, "processed_wkt103"),
        "binary": True,
        "max_length": 256,
        "repeat": True,
        "num_classes": 2,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
