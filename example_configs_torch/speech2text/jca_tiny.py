"""A tiny joint CTC-attention model for CPU runs of the PyTorch port:
``tests/test_las_jca.py``'s ``_las_jca_config`` (the LAS listener with a
conv of 32 channels and two LSTM layers of 32, a CTC head and a one-head
speller with coverage, lambda 0.5) on the 10 toy utterances, 8 epochs
with checkpoints and an eval every 4 steps; its CTC half takes the CTC
kernels' plain versions on the CPU and kernels B1a and B1b on the card.

  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --config_file=example_configs_torch/speech2text/jca_tiny.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.decoders import (FullyConnectedCTCDecoder,
                                            JointCTCAttentionDecoder,
                                            ListenAttendSpellDecoder)
from openseq2seq_tpu_torch.encoders import ListenAttendSpellEncoder
from openseq2seq_tpu_torch.losses import MultiTaskCTCEntropyLoss
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
        tempfile.gettempdir(), "os2s_torch_jca_tiny_logs")),
    num_epochs=8)
base_params.update(eval_steps=4, save_checkpoint_steps=4,
                   print_loss_steps=1)
base_params["data_layer_params"]["autoregressive"] = True
base_params["encoder"] = ListenAttendSpellEncoder
base_params["encoder_params"] = {
    "convnet_layers": [
        {"type": "conv1d", "repeat": 1, "kernel_size": [7],
         "stride": [2], "num_channels": 32, "padding": "SAME"},
    ],
    "recurrent_layers": [
        {"type": "lstm", "num_units": 32, "pool": 2},
        {"type": "lstm", "num_units": 32},
    ],
    "activation_fn": "relu",
    "dropout_keep_prob": 1.0,
}
base_params["decoder"] = JointCTCAttentionDecoder
base_params["decoder_params"] = {
    "ctc_decoder": FullyConnectedCTCDecoder,
    "attn_decoder": ListenAttendSpellDecoder,
    "ctc_decoder_params": {"use_language_model": False},
    "attn_decoder_params": {
        "tgt_emb_size": 32,
        "attention_params": {
            "attention_dim": 32,
            "attention_type": "chorowski",
            "use_coverage": True,
            "num_heads": 1,
            "plot_attention": False,
        },
        "rnn_type": "lstm",
        "hidden_dim": 32,
        "num_layers": 1,
        "dropout_keep_prob": 0.9,
    },
    "beam_search_params": {"beam_width": 2},
    "language_model_params": {},
    "GO_SYMBOL": 9,
    "END_SYMBOL": 10,
}
base_params["loss"] = MultiTaskCTCEntropyLoss
base_params["loss_params"] = {
    "ctc_loss_params": {},
    "seq_loss_params": {},
    "lambda_value": 0.5,
}

eval_params = {"data_layer_params": {"shuffle": False}}
infer_params = {"data_layer_params": {"shuffle": False}}
