"""IMDB sentiment trained from scratch, for the PyTorch port: the twin of
``example_configs/transfer/imdb_from_scratch.py``, key for key, the
no-transfer baseline of ``imdb_wkt2.py`` (the same vocabulary, no
``load_model``).
"""
import os

from openseq2seq_tpu_torch.data.lm import IMDBDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import LSTMLM

_DATA = os.environ.get("IMDB_DIR", "/data/aclImdb")
_LM_VOCAB = os.environ.get(
    "WKT2_VOCAB", os.path.join(os.environ.get("WIKITEXT2_DIR",
                                              "/data/wikitext-2"),
                               "processed", "vocab.txt"))

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "num_epochs": 100,
    "logdir": os.environ.get("OS2S_LOGDIR", "imdb_scratch_log"),
    "lm_vocab_file": _LM_VOCAB,
    "batch_size_per_gpu": 16,
    "print_loss_steps": 10,
    "save_summaries_steps": 10,
    "eval_steps": 20,
    "save_checkpoint_steps": 10,

    "optimizer": "Adam",
    "optimizer_params": {},
    "lr_policy": "fixed",
    "lr_policy_params": {"learning_rate": 1e-4},
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
