"""QuartzNet-15x5 (``quartznet15x5_librispeech.py``'s model and training
setup, at full width) on synthetic batches at the recipe's longest
utterance: 64 log-mel features, 1,670 frames (16.7 s, the recipe's
``max_duration``; 835 frames after the stride-2 prologue) and
240-label transcripts (LibriSpeech's about 15 characters a second), V 29.
For timing the training step without the host's featurization:

  python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \\
      --config_file=example_configs_torch/speech2text/quartznet15x5_synthetic.py
"""
import os
import runpy

from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer

_base = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "quartznet15x5_librispeech.py"))

base_model = _base["base_model"]
base_params = dict(_base["base_params"])
base_params["data_layer"] = SyntheticSpeechDataLayer
base_params["data_layer_params"] = {
    "num_audio_features": 64,
    "tgt_vocab_size": 29,
    "time_steps": 1670,
    "label_length": 240,
    "num_batches": 4,
}
base_params["logdir"] = "quartznet15x5_synthetic_logs"
base_params.pop("num_epochs")
# in base_params, so that --max_steps overrides them
base_params.update(max_steps=20, print_loss_steps=5,
                   save_checkpoint_steps=20, print_samples_steps=None,
                   eval_steps=20)
