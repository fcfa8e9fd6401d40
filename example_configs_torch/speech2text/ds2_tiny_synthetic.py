# DeepSpeech2 cut to two small convs and two bidirectional 128-unit GRU
# layers, fp32, on small synthetic batches (8 x 40 frames x 32 features,
# 6-label transcripts): the port's DS2 eval and infer on the CPU in
# seconds, never timed, e.g.
#
#   python -m openseq2seq_tpu_torch.run --mode=eval --device=cpu \
#       --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/ds2_tiny_synthetic.py
#
# from a checkpoint in <dir>. B = 8 and H = 128 are the smallest sizes the
# fused recurrence takes, so `fused_rnn` runs the GRU kernel's plain
# version here (and the kernel on the card); the tests swap in
# `rnn_type: cudnn_lstm` for the LSTM twin.
import torch

from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import DeepSpeech2Encoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "logdir": "ds2_tiny_synthetic_logs",
    "batch_size_per_gpu": 8,
    "dtype": "float32",
    "fused_rnn": True,
    "encoder": DeepSpeech2Encoder,
    "encoder_params": {
        "conv_layers": [
            {"kernel_size": [11, 41], "stride": [2, 2],
             "num_channels": 8, "padding": "SAME"},
            {"kernel_size": [11, 21], "stride": [1, 2],
             "num_channels": 8, "padding": "SAME"},
        ],
        "num_rnn_layers": 2,
        "rnn_cell_dim": 128,
        "use_cudnn_rnn": True,
        "rnn_type": "cudnn_gru",
        "rnn_unidirectional": False,
        "row_conv": False,
        "n_hidden": 128,
        "dropout_keep_prob": 0.5,
        "activation_fn": torch.relu,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"use_language_model": False},
    "loss": CTCLoss,
    "loss_params": {"use_pallas": True},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {
        "num_audio_features": 32,
        "tgt_vocab_size": 29,
        "time_steps": 40,
        "label_length": 6,
        "num_batches": 2,
    },
}
