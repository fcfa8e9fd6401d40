"""A tiny Tacotron-2 on synthetic batches, the CPU twin of
``tacotron2_synthetic.py`` for tests and quick runs: batches of 4 texts
of 12 characters x 16 frames of 8 mel bins, a 16-wide embedding and conv,
a bidirectional LSTM of 64 (fp32: under ``fused_rnn`` the width the scan
kernels' plain versions take on the CPU), one 32-unit decoder layer with
16-wide location-sensitive attention, a 16-unit prenet and a two-conv
postnet; fp32, Adam 1e-3, 10 steps.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --logdir=<dir> \\
      --config_file=example_configs_torch/text2speech/tacotron_tiny_synthetic.py
"""
from openseq2seq_tpu_torch.data import SyntheticTTSDataLayer
from openseq2seq_tpu_torch.decoders import Tacotron2Decoder
from openseq2seq_tpu_torch.encoders import Tacotron2Encoder
from openseq2seq_tpu_torch.losses import Text2SpeechLoss
from openseq2seq_tpu_torch.models import Text2SpeechTacotron

base_model = Text2SpeechTacotron
base_params = {
    "random_seed": 0,
    "logdir": "tacotron_tiny_synthetic_logs",
    "max_steps": 10,
    "batch_size_per_gpu": 4,
    "print_loss_steps": 1,
    "eval_steps": 5,
    "save_checkpoint_steps": 5,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "dtype": "float32",
    "max_grad_norm": 1.0,
    "fused_rnn": True,
    "encoder": Tacotron2Encoder,
    "encoder_params": {
        "cnn_dropout_prob": 0.5,
        "rnn_dropout_prob": 0.1,
        "src_emb_size": 16,
        "conv_layers": [
            {"kernel_size": [5], "stride": [1], "num_channels": 16,
             "padding": "SAME"},
        ],
        "activation_fn": "relu",
        "num_rnn_layers": 1,
        "rnn_cell_dim": 64,
        "use_cudnn_rnn": True,
        "rnn_type": "lstm",
        "rnn_unidirectional": False,
        "zoneout_prob": 0.1,
    },
    "decoder": Tacotron2Decoder,
    "decoder_params": {
        "attention_layer_size": 16,
        "attention_type": "location",
        "decoder_cell_units": 32,
        "decoder_cell_type": "lstm",
        "decoder_layers": 1,
        "enable_prenet": True,
        "prenet_layers": 1,
        "prenet_units": 16,
        "enable_postnet": True,
        "postnet_conv_layers": [
            {"kernel_size": [5], "stride": [1], "num_channels": 16,
             "padding": "SAME"},
            {"kernel_size": [5], "stride": [1], "num_channels": -1,
             "padding": "SAME"},
        ],
        "zoneout_prob": 0.1,
        "mask_decoder_sequence": True,
        "infer_max_steps": 12,
    },
    "loss": Text2SpeechLoss,
    "loss_params": {"use_mask": True},
    "data_layer": SyntheticTTSDataLayer,
    "data_layer_params": {
        "src_vocab_size": 10,
        "num_audio_features": 8,
        "text_length": 12,
        "spec_length": 16,
        "num_batches": 2,
    },
}
