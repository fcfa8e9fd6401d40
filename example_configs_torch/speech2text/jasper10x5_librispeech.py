"""Jasper DR 10x5 on LibriSpeech, the headline ASR recipe, for the
PyTorch port: the twin of
``example_configs/speech2text/jasper10x5_LibriSpeech.py``, key for key
(reference `example_configs/speech2text/
jasper10x5_LibriSpeech_nvgrad_masks.py`: NovoGrad + LARC + poly decay,
bf16 "mixed", SpecAugment-style masks), at full width, read from wav
files by the port's ``Speech2TextDataLayer``:

  LIBRISPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train \\
      --config_file=example_configs_torch/speech2text/jasper10x5_librispeech.py

``LIBRISPEECH_DIR`` holds the LibriSpeech CSVs
(wav_filename,wav_filesize,transcript) built by scripts/import_librivox
-style preprocessing and the 28-char ``vocab.txt``;
``openseq2seq_tpu_torch/test_utils/fake_librispeech.py`` writes a corpus
of that layout and those shapes (add ``librivox-test-clean.csv`` for
infer).
"""
import os

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.zoo import jasper_model_params

_DATA = os.environ.get("LIBRISPEECH_DIR", "/data/librispeech")

base_model = Speech2Text
base_params = jasper_model_params(
    data_layer=Speech2TextDataLayer,
    data_layer_params={
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
        "backend": "librosa",
        # base logfbank features are cached to npz in the first epoch and
        # the SpecAugment masks drawn per epoch on load: this recipe's
        # augmentation is masks-only, so caching is safe
        "cache_features": True,
        # the features go to the card in bf16, the encoder's compute
        # type under "mixed": half the bytes of the host-to-device copy
        "features_dtype": "bfloat16",
    },
    num_blocks=10, block_repeat=5,
    batch_size_per_gpu=32,
    dtype="mixed",
    num_epochs=400,
    logdir=os.environ.get("OS2S_LOGDIR", "jasper_log_folder"),
    print_loss_steps=10,
    print_samples_steps=2200,
    eval_steps=2200,
    save_checkpoint_steps=1100,
    num_checkpoints=2,
    save_summaries_steps=100,
)
base_params["data_layer_params"]["augmentation"] = {
    "n_freq_mask": 2, "n_time_mask": 2,
    "width_freq_mask": 6, "width_time_mask": 6,
}

# max_duration filters TRAINING utterances only (reference puts it in
# train_params:199 — eval/infer must score every utterance)
train_params = {"data_layer_params": {"shuffle": True,
                                      "max_duration": 16.7}}
eval_params = {
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "librivox-dev-clean.csv")],
        "shuffle": False,
        "augmentation": {},
    },
}
infer_params = {
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA,
                                       "librivox-test-clean.csv")],
        "shuffle": False,
        "augmentation": {},
    },
}
