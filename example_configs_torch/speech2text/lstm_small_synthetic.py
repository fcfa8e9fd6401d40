# The repository's conv + bidirectional-LSTM CTC recipe
# (example_configs/speech2text/lstm_small_1gpu.py) at full width on
# synthetic speech, for the PyTorch port's training, eval and infer:
#
#   python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/lstm_small_synthetic.py
#
# and --mode=eval / --mode=infer from the checkpoint it writes. One SAME
# 11x41 stride-2x2 conv with 32 channels, four bidirectional 512-unit LSTM
# layers, a 512-unit fully-connected layer, relu; bf16 compute from fp32
# params ("mixed"). Unlike the recipe, this config sets `fused_rnn: True`
# and `loss_params: {"use_pallas": True}`: they pick the kernels (each LSTM
# recurrence, T' = 500, on csrc/lstm_scan_fwd.cu, 8 launches per batch, and
# in training its backward on csrc/lstm_scan_bwd.cu, 8 more; the CTC loss on
# csrc/ctc_alpha_fwd.cu and csrc/ctc_beta_bwd.cu) and leave the math as it
# is; the fused and the scan paths differ only in where bf16 rounds.
# Training is the recipe's: Momentum 0.001 with LARC (eta 0.001) and
# poly_decay, dropout keep 0.8 with 8-bit masks, for 20 steps with a
# checkpoint at the end. Data: 4 synthetic batches of 32 x 1000 frames x
# 64 features with 160-label transcripts over 29 symbols.
import torch

from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import DeepSpeech2Encoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "fused_rnn": True,
    "logdir": "lstm_small_synthetic_logs",
    "batch_size_per_gpu": 32,
    "optimizer": "Momentum",
    "optimizer_params": {"learning_rate": 0.001, "momentum": 0.9},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"power": 2.0, "decay_steps": 100000},
    "larc_params": {"larc_eta": 0.001},
    "dtype": "mixed",
    "encoder": DeepSpeech2Encoder,
    "encoder_params": {
        "conv_layers": [
            {"kernel_size": [11, 41], "stride": [2, 2],
             "num_channels": 32, "padding": "SAME"},
        ],
        "num_rnn_layers": 4,
        "rnn_cell_dim": 512,
        "use_cudnn_rnn": True,
        "rnn_type": "cudnn_lstm",
        "rnn_unidirectional": False,
        "row_conv": False,
        "n_hidden": 512,
        "dropout_keep_prob": 0.8,
        "activation_fn": torch.relu,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"use_language_model": False},
    "loss": CTCLoss,
    "loss_params": {"use_pallas": True},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {
        "num_audio_features": 64,
        "tgt_vocab_size": 29,
        "time_steps": 1000,
        "label_length": 160,
        "num_batches": 4,
    },
}

train_params = {
    "max_steps": 20,
    "print_loss_steps": 1,
    "save_checkpoint_steps": 20,
}
