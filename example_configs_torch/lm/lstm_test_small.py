"""Small LM test recipe for the PyTorch port: the twin of
``example_configs/lm/lstm_test_small.py``, key for key, on whatever text
is in ``WKT_SMALL_DIR`` (train/valid/test.txt), 1/20th of it (``small``):
fp32, a 64-wide embedding, two 128-unit LSTM layers on the scan (no
``fused_rnn``).

Run:
  WKT_SMALL_DIR=<dir> python -m openseq2seq_tpu_torch.run --device=cpu \\
      --mode=train_eval --config_file=example_configs_torch/lm/lstm_test_small.py
"""
import os

from openseq2seq_tpu_torch.data.lm import WKTDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import LSTMLM

_DATA = os.environ.get("WKT_SMALL_DIR", "/data/wikitext-2")

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "num_epochs": 2,
    "logdir": os.environ.get("OS2S_LOGDIR", "lm_small_log"),
    "batch_size_per_gpu": 16,
    "print_loss_steps": 10,
    "save_summaries_steps": 50,
    "eval_steps": 200,
    "save_checkpoint_steps": 200,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 4e-3},
    "lr_policy": "fixed",
    "lr_policy_params": {"learning_rate": 4e-3},
    "max_grad_norm": 0.25,
    "dtype": "float32",

    "encoder": LMEncoder,
    "encoder_params": {
        "emb_size": 64,
        "encoder_layers": 2,
        "encoder_use_skip_connections": False,
        "core_cell": None,
        "core_cell_params": {"num_units": 128},
        "use_cudnn_rnn": False,
        "cudnn_rnn_type": None,
        "weight_tied": False,
        "encoder_emb_keep_prob": 0.9,
        "encoder_dp_output_keep_prob": 0.85,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": BasicSequenceLoss,
    "loss_params": {},
    "data_layer": WKTDataLayer,
    "data_layer_params": {
        "data_root": _DATA,
        "processed_data_folder": os.path.join(_DATA, "processed-small"),
        "repeat": True,
        "bptt": 12,
        "small": True,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
