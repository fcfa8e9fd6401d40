"""The toy Wave2Letter+ config (``w2lplus_toy.py``) trained from raw-audio
batches, for the PyTorch port: the twin of
``example_configs/speech2text/w2lplus_toy_ondevice.py``. The data layer
ships padded wav samples and the model's forward computes the log-mel
features on the device (``featurize_on_device``,
``ops/features_device.py``).

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --config_file=example_configs_torch/speech2text/w2lplus_toy_ondevice.py
"""
import os
import runpy
import tempfile

_here = os.path.dirname(os.path.abspath(__file__))
_base = runpy.run_path(os.path.join(_here, "w2lplus_toy.py"))

base_model = _base["base_model"]
base_params = dict(_base["base_params"])
base_params["data_layer_params"] = dict(base_params["data_layer_params"])
base_params["data_layer_params"]["featurize_on_device"] = True
base_params["logdir"] = os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
    tempfile.gettempdir(), "os2s_torch_toy_ondevice_logs"))
eval_params = _base.get("eval_params", {})
infer_params = _base.get("infer_params", {})
