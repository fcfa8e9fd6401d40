"""Toy LSTM language model on the cycle corpus of ``tests/test_lm.py``
(eight words repeated, 120 training lines), for the PyTorch port: the
JAX test's model (a 16-wide embedding, one 32-unit LSTM layer, Adam 5e-3,
8 tracks of 16 tokens, 30 epochs), fp32. Its "Validation perplexity"
falls below 2.0, the JAX test's bar (the LM family's toy run).

Writes the corpus on first use under ``os2s_toy_lm`` in the temporary
directory (or ``OS2S_TOY_LM_DIR``) and logs under ``OS2S_TOY_LOGDIR``.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --config_file=example_configs_torch/lm/lstm_toy.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.lm import WKTDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
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
    "num_epochs": 30,
    "logdir": os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_toy_lm_logs")),
    "batch_size_per_gpu": 8,
    "print_loss_steps": 40,
    "eval_steps": 120,
    "save_checkpoint_steps": 120,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 5e-3},
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
        "weight_tied": False,
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
        "bptt": 16,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
