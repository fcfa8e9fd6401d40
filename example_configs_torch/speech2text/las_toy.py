"""The LAS toy for the PyTorch port: ``tests/test_las_jca.py``'s
``_las_config`` (the LAS listener with one pyramid step, a two-head
location-sensitive speller with positional tables, the sequence loss)
at 150 epochs of the 10 toy utterances, built on the port's
``test_utils/test_speech_configs.w2l_test_config``. The JAX test's bar:
the last training loss below 0.5.

Generates the toy dataset on first use under ``os2s_toy_speech`` in the
temporary directory (or ``OS2S_TOY_DATA_DIR``); logs under
``OS2S_TOY_LOGDIR``.

  python -m openseq2seq_tpu_torch.run --mode=train --device=cpu \\
      --config_file=example_configs_torch/speech2text/las_toy.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.decoders import ListenAttendSpellDecoder
from openseq2seq_tpu_torch.encoders import ListenAttendSpellEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.test_utils import toy_speech
from openseq2seq_tpu_torch.test_utils.test_speech_configs import \
    w2l_test_config

_DATA_DIR = os.environ.get("OS2S_TOY_DATA_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_toy_speech"))
if not os.path.exists(os.path.join(_DATA_DIR, "toy_data.csv")):
    toy_speech.generate(_DATA_DIR)

base_model = Speech2Text
base_params, _ = w2l_test_config(
    os.path.join(_DATA_DIR, "toy_data.csv"),
    os.path.join(_DATA_DIR, "vocab.txt"),
    logdir=os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_las_toy_logs")),
    num_epochs=150)
base_params["data_layer_params"]["autoregressive"] = True
base_params["encoder"] = ListenAttendSpellEncoder
base_params["encoder_params"] = {
    "convnet_layers": [
        {"type": "conv1d", "repeat": 1, "kernel_size": [7],
         "stride": [2], "num_channels": 48, "padding": "SAME"},
    ],
    "recurrent_layers": [
        {"type": "lstm", "num_units": 48, "pool": 2},
    ],
    "activation_fn": "relu",
    "dropout_keep_prob": 1.0,
}
base_params["decoder"] = ListenAttendSpellDecoder
base_params["decoder_params"] = {
    "GO_SYMBOL": 9,
    "END_SYMBOL": 10,
    "tgt_emb_size": 48,
    "attention_params": {
        "attention_dim": 48,
        "attention_type": "chorowski",
        "use_coverage": False,
        "num_heads": 2,
        "plot_attention": True,
    },
    "rnn_type": "lstm",
    "hidden_dim": 48,
    "num_layers": 1,
    "pos_embedding": True,
    "dropout_keep_prob": 1.0,
    "beam_width": 2,
}
base_params["loss"] = BasicSequenceLoss
base_params["loss_params"] = {}
base_params["optimizer_params"] = {"learning_rate": 1e-3}

eval_params = {"data_layer_params": {"shuffle": False}}
infer_params = {"data_layer_params": {"shuffle": False}}
