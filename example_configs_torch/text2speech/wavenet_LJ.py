"""WaveNet on LJSpeech, for the PyTorch port: the twin of
``example_configs/text2speech/wavenet_LJ.py``, key for key (4 blocks x 10
gated layers of 64 filters, k 3, dilations 1 to 512; 256 mu-law channels;
chunks of 16,384 samples at 22,050 Hz conditioned on 80 mel bins; batches
of 2; "mixed"; Adam 1e-3 with ``exp_decay``). It reads the corpus from
``LJSPEECH_DIR`` (``metadata.csv``, ``vocab_tts.txt`` and ``wavs/``),
which is not in the repository;
``openseq2seq_tpu_torch/test_utils/fake_ljspeech.py`` writes a tree of
that layout.

Run:
  LJSPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run --mode=train_eval \
      --config_file=example_configs_torch/text2speech/wavenet_LJ.py
"""
import os

from openseq2seq_tpu_torch.data.text2speech import WavenetDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import WavenetEncoder
from openseq2seq_tpu_torch.losses import WavenetLoss
from openseq2seq_tpu_torch.models import Text2SpeechWavenet

_DATA = os.environ.get("LJSPEECH_DIR", "/data/LJSpeech-1.1")

base_model = Text2SpeechWavenet
base_params = {
    "random_seed": 0,
    "num_epochs": 1000,
    "logdir": os.environ.get("OS2S_LOGDIR", "wavenet_log_folder"),
    "batch_size_per_gpu": 2,
    "print_loss_steps": 50,
    "save_summaries_steps": 200,
    "save_checkpoint_steps": 5000,
    "num_checkpoints": 3,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "lr_policy": "exp_decay",
    "lr_policy_params": {"decay_steps": 20000, "decay_rate": 0.1,
                         "use_staircase_decay": False,
                         "begin_decay_at": 45000, "min_lr": 1e-5},
    "dtype": "mixed",
    "max_grad_norm": 1.0,
    "encoder": WavenetEncoder,
    "encoder_params": {
        "layer_type": "conv1d",
        "kernel_size": 3,
        "strides": 1,
        "padding": "SAME",
        "blocks": 4,
        "layers_per_block": 10,
        "filters": 64,
        "quantization_channels": 256,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": WavenetLoss,
    "loss_params": {},
    "data_layer": WavenetDataLayer,
    "data_layer_params": {
        "dataset": "LJ",
        "dataset_location": _DATA,
        "num_audio_features": 80,
        "output_type": "mel",
        "vocab_file": os.path.join(_DATA, "vocab_tts.txt"),
        "dataset_files": [os.path.join(_DATA, "metadata.csv")],
        "feature_normalize": False,
        "n_fft": 1024,
        "sample_freq": 22050,
        "num_samples": 16384,
    },
}
eval_params = {"data_layer_params": {"shuffle": False,
                                     "n_samples_eval": 16}}
