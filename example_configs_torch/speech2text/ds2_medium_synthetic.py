# DeepSpeech2-medium at full published width on synthetic speech, for the
# PyTorch port's training, eval and infer:
#
#   python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/ds2_medium_synthetic.py
#
# and --mode=eval / --mode=infer from the checkpoint it writes. The model is
# the repository's DS2 bench (scripts/bench_ds2.py, after the recipe
# example_configs/speech2text/ds2_medium_4gpus.py): three SAME 2-D convs
# (11x41 stride 2x2 with 32 channels, 11x21 stride 1x2 with 64, 11x21
# stride 1x2 with 96), three bidirectional 1024-unit cuDNN-variant GRU
# layers, a 1024-unit fully-connected layer, relu; bf16 compute from fp32
# params ("mixed"). With `fused_rnn` each GRU recurrence (T' = 500 after
# the time stride) runs on the hand-written kernel csrc/gru_scan_fwd.cu, 6
# launches per batch, and in training its backward on csrc/gru_scan_bwd.cu,
# 6 more; the CTC loss on csrc/ctc_alpha_fwd.cu (and csrc/ctc_beta_bwd.cu
# in training). Training is the bench's step: Adam 1e-4, max_grad_norm 5,
# dropout keep 0.5 with 8-bit masks, for 20 steps with a checkpoint at the
# end. Data: 4 synthetic batches of 32 x 1000 frames x 160 features with
# 160-label transcripts over 29 symbols.
import torch

from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import DeepSpeech2Encoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "logdir": "ds2_medium_synthetic_logs",
    "batch_size_per_gpu": 32,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-4},
    "max_grad_norm": 5.0,
    "dtype": "mixed",
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "fused_rnn": True,
    "encoder": DeepSpeech2Encoder,
    "encoder_params": {
        "conv_layers": [
            {"kernel_size": [11, 41], "stride": [2, 2],
             "num_channels": 32, "padding": "SAME"},
            {"kernel_size": [11, 21], "stride": [1, 2],
             "num_channels": 64, "padding": "SAME"},
            {"kernel_size": [11, 21], "stride": [1, 2],
             "num_channels": 96, "padding": "SAME"},
        ],
        "num_rnn_layers": 3,
        "rnn_cell_dim": 1024,
        "use_cudnn_rnn": True,
        "rnn_type": "cudnn_gru",
        "rnn_unidirectional": False,
        "row_conv": False,
        "n_hidden": 1024,
        "dropout_keep_prob": 0.5,
        "activation_fn": torch.relu,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"use_language_model": False},
    "loss": CTCLoss,
    "loss_params": {"use_pallas": True},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {
        "num_audio_features": 160,
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
