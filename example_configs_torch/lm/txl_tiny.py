"""Tiny Transformer-XL language model for the PyTorch port on the CPU:
``txl_wkt103.py`` cut to 2 layers of width 32 (4 heads, d_inner 64),
fp32, dropout 0.1, 8 tracks of 16 tokens of the cycle corpus
(``lstm_toy.py``'s, written on first use under ``OS2S_TOY_LM_DIR`` or
``os2s_toy_lm`` in the temporary directory), Adam 5e-3, 20 steps.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --logdir=/tmp/txl_tiny --config_file=example_configs_torch/lm/txl_tiny.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.lm import WKTDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import TransformerXLEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import LSTMLM
from openseq2seq_tpu_torch.test_utils import fake_wikitext

_DATA = os.environ.get("OS2S_TOY_LM_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_toy_lm"))
if not os.path.exists(os.path.join(_DATA, "test.txt")):
    fake_wikitext.cycle(_DATA)

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "max_steps": 20,
    "logdir": "txl_tiny_logs",
    "batch_size_per_gpu": 8,
    "print_loss_steps": 5,
    "eval_steps": 10,
    "save_checkpoint_steps": 10,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 5e-3},
    "max_grad_norm": 0.25,
    "dtype": "float32",
    "encoder": TransformerXLEncoder,
    "encoder_params": {
        "num_layers": 2,
        "hidden_size": 32,
        "num_heads": 4,
        "filter_size": 64,
        "dropout": 0.1,
        "attention_dropout": 0.0,
        "mem_len": 0,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": BasicSequenceLoss,
    "loss_params": {"average_across_timestep": True, "do_mask": False},
    "data_layer": WKTDataLayer,
    "data_layer_params": {
        "data_root": _DATA,
        "processed_data_folder": os.path.join(_DATA, "processed"),
        "bptt": 16,
        "repeat": True,
    },
}
eval_params = {"data_layer_params": {"repeat": False}}
