"""WaveNet on LJSpeech in fp32, for the PyTorch port: the twin of
``example_configs/text2speech/wavenet_float.py`` (``wavenet_LJ.py``'s
network and data, ``dtype`` "float32").

Run:
  LJSPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run --mode=train_eval \
      --config_file=example_configs_torch/text2speech/wavenet_float.py
"""
import os
import runpy

_here = os.path.dirname(os.path.abspath(__file__))
_base = runpy.run_path(os.path.join(_here, "wavenet_LJ.py"))

base_model = _base["base_model"]
base_params = dict(_base["base_params"])
base_params["dtype"] = "float32"
base_params["logdir"] = os.environ.get("OS2S_LOGDIR",
                                       "wavenet_float_log_folder")
train_params = _base.get("train_params", {})
eval_params = _base.get("eval_params", {})
infer_params = _base.get("infer_params", {})
