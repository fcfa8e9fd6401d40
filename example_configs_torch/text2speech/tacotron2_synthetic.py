"""Tacotron-2 at the flagship recipe's width on synthetic LJSpeech-shaped
batches, for the PyTorch port: every key of the JAX package's
``scripts/bench_tacotron.py`` model (``example_configs/text2speech/
tacotron_LJ.py``'s widths: batch 48, "mixed", Adam 1e-3 with
``exp_decay``, ``max_grad_norm`` 1; embedding 512, three k=5 convs of 512
with batch norm, a 256-unit bidirectional LSTM; a 2 x 1024 zoneout LSTM
decoder with 128-wide location-sensitive attention, a 2 x 256 prenet and a
5-layer 512-channel postnet; 80 mel bins) on ``SyntheticTTSDataLayer``
batches of 96 characters x 512 frames, plus ``fused_rnn`` (a JAX model
key): the encoder's LSTM in both directions on kernel B3.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \\
      --config_file=example_configs_torch/text2speech/tacotron2_synthetic.py
"""
from openseq2seq_tpu_torch.data import SyntheticTTSDataLayer
from openseq2seq_tpu_torch.decoders import Tacotron2Decoder
from openseq2seq_tpu_torch.encoders import Tacotron2Encoder
from openseq2seq_tpu_torch.losses import Text2SpeechLoss
from openseq2seq_tpu_torch.models import Text2Speech

base_model = Text2Speech
base_params = {
    "random_seed": 0,
    "logdir": "tacotron2_synthetic_logs",
    "batch_size_per_gpu": 48,
    "print_loss_steps": None,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "lr_policy": "exp_decay",
    "lr_policy_params": {
        "decay_steps": 20000, "decay_rate": 0.1,
        "use_staircase_decay": False, "begin_decay_at": 45000,
        "min_lr": 1e-5,
    },
    "dtype": "mixed",
    "max_grad_norm": 1.0,
    "fused_rnn": True,
    "encoder": Tacotron2Encoder,
    "encoder_params": {
        "cnn_dropout_prob": 0.5,
        "rnn_dropout_prob": 0.1,
        "src_emb_size": 512,
        "conv_layers": [
            {"kernel_size": [5], "stride": [1],
             "num_channels": 512, "padding": "SAME"},
            {"kernel_size": [5], "stride": [1],
             "num_channels": 512, "padding": "SAME"},
            {"kernel_size": [5], "stride": [1],
             "num_channels": 512, "padding": "SAME"},
        ],
        "activation_fn": "relu",
        "num_rnn_layers": 1,
        "rnn_cell_dim": 256,
        "use_cudnn_rnn": True,
        "rnn_type": "lstm",
        "rnn_unidirectional": False,
        "zoneout_prob": 0.1,
    },
    "decoder": Tacotron2Decoder,
    "decoder_params": {
        "attention_layer_size": 128,
        "attention_type": "location",
        "decoder_cell_units": 1024,
        "decoder_cell_type": "lstm",
        "decoder_layers": 2,
        "enable_prenet": True,
        "prenet_layers": 2,
        "prenet_units": 256,
        "enable_postnet": True,
        "zoneout_prob": 0.1,
        "dropout_prob": 0.1,
        "mask_decoder_sequence": True,
        "infer_max_steps": 1000,
        "outputs_per_step": 1,
    },
    "loss": Text2SpeechLoss,
    "loss_params": {"use_mask": True},
    "data_layer": SyntheticTTSDataLayer,
    "data_layer_params": {
        "src_vocab_size": 64,
        "num_audio_features": 80,
        "text_length": 96,
        "spec_length": 512,
        "num_batches": 4,
    },
}
train_params = {"max_steps": 10}
eval_params = {"data_layer_params": {"num_batches": 2}}
infer_params = {"data_layer_params": {"num_batches": 1}}
