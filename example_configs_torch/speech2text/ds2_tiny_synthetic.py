# DeepSpeech2 cut to two small convs and two bidirectional 128-unit GRU
# layers, fp32, on small synthetic batches (8 x 40 frames x 32 features,
# 6-label transcripts): the port's DS2 training, eval and infer on the CPU
# in seconds, never timed, e.g.
#
#   python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
#       --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/ds2_tiny_synthetic.py
#
# B = 8 and H = 128 are the smallest sizes the fused recurrence takes, so
# `fused_rnn` runs the GRU kernels' plain versions here, forward and
# backward (and the kernels on the card); the tests swap in `rnn_type:
# cudnn_lstm` for the LSTM twin. Adam 1e-3 with dropout keep 0.5; the
# synthetic layer repeats one batch, so the loss falls within the 20
# steps.
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
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    # in base_params, not train_params, so that --max_steps can override
    # them
    "max_steps": 20,
    "print_loss_steps": 5,
    "save_checkpoint_steps": 10,
    "eval_steps": 10,
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
