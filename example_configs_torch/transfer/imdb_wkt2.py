"""IMDB sentiment transfer from the WikiText-2 LM, for the PyTorch port:
the twin of ``example_configs/transfer/imdb_wkt2.py``, key for key: the
LM encoder restored by name and shape from ``load_model``
(``WKT2_LM_LOGDIR``), the binary classifier drawn from the seed, the LM's
vocabulary ``WKT2_VOCAB`` (by default ``$WIKITEXT2_DIR/processed/
vocab.txt``, written by the port's ``Corpus``: C25), reviews from
``IMDB_DIR``.
"""
import os

from openseq2seq_tpu_torch.data.lm import IMDBDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import LSTMLM

_DATA = os.environ.get("IMDB_DIR", "/data/aclImdb")
_LM_DIR = os.environ.get("WKT2_LM_LOGDIR", "lm_wkt2_log")
_LM_VOCAB = os.environ.get(
    "WKT2_VOCAB", os.path.join(os.environ.get("WIKITEXT2_DIR",
                                              "/data/wikitext-2"),
                               "processed", "vocab.txt"))

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "num_epochs": 25,
    "logdir": os.environ.get("OS2S_LOGDIR", "imdb_wkt2_log"),
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

    "encoder": LMEncoder,
    "encoder_params": {
        "emb_size": 256,
        "encoder_layers": 3,
        "encoder_use_skip_connections": False,
        "core_cell": None,
        "core_cell_params": {"num_units": 896},
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
        "processed_data_folder": os.path.join(_DATA, "processed"),
        "binary": True,
        "max_length": 256,
        "repeat": True,
        "num_classes": 2,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
