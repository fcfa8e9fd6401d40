"""The small LM test recipe in bf16 "mixed" with Backoff loss scaling, for
the PyTorch port: the twin of
``example_configs/lm/lstm_test_small_mixed.py`` (``lstm_test_small.py``
with the dtype, the scaling and the log directory changed)."""
import os
import runpy

_here = os.path.dirname(os.path.abspath(__file__))
_base = runpy.run_path(os.path.join(_here, "lstm_test_small.py"))

base_model = _base["base_model"]
base_params = dict(_base["base_params"])
base_params["dtype"] = "mixed"
base_params["loss_scaling"] = "Backoff"
base_params["logdir"] = os.environ.get("OS2S_LOGDIR",
                                       "lstm_small_mixed_log")
train_params = _base.get("train_params", {})
eval_params = _base.get("eval_params", {})
infer_params = _base.get("infer_params", {})
