"""LSTM language model on WikiText-2, for the PyTorch port: the twin of
``example_configs/lm/lstm_wkt2.py``, key for key, reading
``WIKITEXT2_DIR``: two 650-unit LSTM layers with the softmax tied to the
650-wide embedding, "mixed". ``fused_rnn`` is set as there, but H 650 is
not a width the scan kernels take (H a multiple of 128), so the layers
run the scan, as the JAX package's do at that width.

Run:
  WIKITEXT2_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train_eval --config_file=example_configs_torch/lm/lstm_wkt2.py
"""
import os

from openseq2seq_tpu_torch.data.lm import WKTDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import LSTMLM

_DATA = os.environ.get("WIKITEXT2_DIR", "/data/wikitext-2")

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "fused_rnn": True,
    "num_epochs": 100,
    "logdir": os.environ.get("OS2S_LOGDIR", "lm_wkt2_log"),
    "batch_size_per_gpu": 32,
    "print_loss_steps": 50,
    "save_summaries_steps": 100,
    "eval_steps": 1000,
    "save_checkpoint_steps": 2000,
    "num_checkpoints": 3,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "lr_policy": "exp_decay",
    "lr_policy_params": {"decay_steps": 10000, "decay_rate": 0.9,
                         "use_staircase_decay": True,
                         "begin_decay_at": 20000, "min_lr": 1e-5},
    "max_grad_norm": 0.25,
    "dtype": "mixed",

    "encoder": LMEncoder,
    "encoder_params": {
        "emb_size": 650,
        "encoder_layers": 2,
        "encoder_use_skip_connections": False,
        "core_cell": None,
        "core_cell_params": {"num_units": 650},
        "use_cudnn_rnn": True,
        "cudnn_rnn_type": "cudnn_lstm",
        "weight_tied": True,
        "encoder_emb_keep_prob": 0.9,
        "encoder_dp_input_keep_prob": 0.7,
        "encoder_dp_output_keep_prob": 0.7,
        "encoder_last_output_keep_prob": 0.6,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": BasicSequenceLoss,
    "loss_params": {},
    "data_layer": WKTDataLayer,
    "data_layer_params": {
        "data_root": _DATA,
        "processed_data_folder": os.path.join(_DATA, "processed"),
        "repeat": True,
        "bptt": 96,
        "rand_start": True,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
