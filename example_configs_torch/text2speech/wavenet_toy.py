"""Toy WaveNet on four tones, for the PyTorch port: the configuration of
the JAX package's WaveNet test (``tests/test_wavenet.py``: 2 blocks x 3
gated layers of 16 filters, k 3; 64 mu-law channels; chunks of 2,048
samples at 16 kHz conditioned on 20 mel bins of ``n_fft`` 256; batches
of 2; fp32; Adam 1e-3; 100 epochs of the four 0.5 s tones, 200 steps),
whose bar is a loss below 3.0. The tones are written on first use by
``test_utils/fake_ljspeech.tones`` under ``os2s_toy_wavenet`` in the
temporary directory (or ``OS2S_TOY_WAVENET_DIR``); logs under
``OS2S_TOY_LOGDIR``, a checkpoint every 100 steps.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --config_file=example_configs_torch/text2speech/wavenet_toy.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.text2speech import WavenetDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import WavenetEncoder
from openseq2seq_tpu_torch.losses import WavenetLoss
from openseq2seq_tpu_torch.models import Text2SpeechWavenet
from openseq2seq_tpu_torch.test_utils import fake_ljspeech

_DATA = os.environ.get("OS2S_TOY_WAVENET_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_toy_wavenet"))
if not os.path.exists(os.path.join(_DATA, "meta.csv")):
    fake_ljspeech.tones(_DATA)

base_model = Text2SpeechWavenet
base_params = {
    "random_seed": 0,
    "num_epochs": 100,
    "logdir": os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_toy_wavenet_logs")),
    "batch_size_per_gpu": 2,
    "print_loss_steps": 20,
    "eval_steps": 100,
    "save_checkpoint_steps": 100,
    "num_checkpoints": 2,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "dtype": "float32",
    "encoder": WavenetEncoder,
    "encoder_params": {
        "layer_type": "conv1d",
        "kernel_size": 3,
        "strides": 1,
        "padding": "SAME",
        "blocks": 2,
        "layers_per_block": 3,
        "filters": 16,
        "quantization_channels": 64,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": WavenetLoss,
    "loss_params": {},
    "data_layer": WavenetDataLayer,
    "data_layer_params": {
        "dataset_location": _DATA,
        "dataset": "LJ",
        "num_audio_features": 20,
        "output_type": "mel",
        "vocab_file": os.path.join(_DATA, "vocab.txt"),
        "dataset_files": [os.path.join(_DATA, "meta.csv")],
        "feature_normalize": False,
        "n_fft": 256,
        "sample_freq": 16000,
        "num_samples": 2048,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
infer_params = {"data_layer_params": {"shuffle": False}}
