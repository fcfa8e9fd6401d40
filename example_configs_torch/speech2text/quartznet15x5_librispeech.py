"""QuartzNet-15x5 on LibriSpeech (arXiv:1910.10261), Jasper's
depthwise-separable successor, for the PyTorch port: the twin of
``example_configs/speech2text/quartznet15x5_LibriSpeech.py``, key for key
(reference recipe: NovoGrad beta2 0.5, weight decay 1e-3, cosine decay
after a 1,000-step warmup, 400 epochs, batch 32, bf16 "mixed",
SpecAugment-style masks, the CTC loss on kernels B1a/B1b), at full width,
read from wav files by the port's ``Speech2TextDataLayer``:

  LIBRISPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train \\
      --config_file=example_configs_torch/speech2text/quartznet15x5_librispeech.py

One key of the JAX recipe is left out: ``summaries`` (histograms and
norms), which the port's trainer does not write yet and refuses.
``LIBRISPEECH_DIR`` holds the LibriSpeech CSVs and ``vocab.txt``;
``openseq2seq_tpu_torch/test_utils/fake_librispeech.py`` writes a corpus
of that layout.
"""
import os

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text

_DATA = os.environ.get("LIBRISPEECH_DIR", "/data/librispeech")

# (kernel, channels) per 5-repeat separable block, QuartzNet-15x5 table
_BLOCKS = ([(33, 256)] * 3 + [(39, 256)] * 3 + [(51, 512)] * 3 +
           [(63, 512)] * 3 + [(75, 512)] * 3)


def _sep(k, ch, repeat=5, stride=1, dilation=1, residual=True):
    return {
        "type": "sep_conv1d", "repeat": repeat,
        "kernel_size": [k], "stride": [stride],
        "num_channels": ch, "padding": "SAME",
        "dilation": [dilation],
        **({"residual": True, "residual_dense": False} if residual else {}),
    }


convnet_layers = (
    [_sep(33, 256, repeat=1, stride=2, residual=False)] +
    [_sep(k, ch) for k, ch in _BLOCKS] +
    [_sep(87, 512, repeat=1, dilation=2)] +
    [{"type": "conv1d", "repeat": 1, "kernel_size": [1], "stride": [1],
      "num_channels": 1024, "padding": "SAME", "dilation": [1]}]
)

base_model = Speech2Text
base_params = {
    "random_seed": 0,
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "num_epochs": 400,
    "batch_size_per_gpu": 32,
    "save_summaries_steps": 100,
    "print_loss_steps": 10,
    "print_samples_steps": 2200,
    "eval_steps": 2200,
    "save_checkpoint_steps": 1100,
    "num_checkpoints": 2,
    "logdir": os.environ.get("OS2S_LOGDIR", "quartznet_log_folder"),

    "optimizer": "NovoGrad",
    "optimizer_params": {
        "beta1": 0.95, "beta2": 0.5, "epsilon": 1e-8,
        "weight_decay": 0.001, "grad_averaging": False,
    },
    "lr_policy": "cosine_decay",
    "lr_policy_params": {
        "learning_rate": 0.01, "min_lr": 0.0, "warmup_steps": 1000,
        "decay_steps": 400 * 2200,
    },
    "dtype": "mixed",

    "encoder": TDNNEncoder,
    "encoder_params": {
        "convnet_layers": convnet_layers,
        "dropout_keep_prob": 1.0,
        "initializer": "xavier",
        "normalization": "batch_norm",
        "activation_fn": "relu",
        "data_format": "channels_last",
        "use_conv_mask": True,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"initializer": "xavier",
                       "use_language_model": False,
                       "infer_logits_to_pickle": False},
    "loss": CTCLoss,
    "loss_params": {"use_pallas": True},

    "data_layer": Speech2TextDataLayer,
    "data_layer_params": {
        "num_audio_features": 64,
        "input_type": "logfbank",
        "vocab_file": os.path.join(_DATA, "vocab.txt"),
        "dataset_files": [
            os.path.join(_DATA, "librivox-train-clean-100.csv"),
            os.path.join(_DATA, "librivox-train-clean-360.csv"),
            os.path.join(_DATA, "librivox-train-other-500.csv"),
        ],
        "norm_per_feature": True,
        "window": "hanning",
        "precompute_mel_basis": True,
        "sample_freq": 16000,
        "pad_to": 16,
        "dither": 1e-5,
        "max_duration": 16.7,
        "backend": "librosa",
        "augmentation": {"n_freq_mask": 2, "n_time_mask": 2,
                         "width_freq_mask": 6, "width_time_mask": 6},
    },
}

train_params = {"data_layer_params": {"shuffle": True}}
eval_params = {
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "librivox-dev-clean.csv")],
        "shuffle": False,
    },
}
infer_params = {
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "librivox-test-clean.csv")],
        "shuffle": False,
    },
}
