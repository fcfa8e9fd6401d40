"""Toy transformer NMT on the synthetic reversal task, for the PyTorch
port: the twin of ``example_configs/text2text/nmt_reversal_toy.py``, key
for key, on the port's ``test_utils/toy_nmt.py`` (2 + 2 layers of width
64, 4 heads, Adam with the transformer schedule, 100 epochs of 512
sentences of 3 to 8 digits in batches of 32). It reaches a validation
BLEU above 80 (NMT's toy run).

Generates the toy corpus on first use under ``os2s_toy_nmt`` in the
temporary directory (or ``OS2S_TOY_NMT_DIR``) and logs under
``OS2S_TOY_NMT_LOGDIR``.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --config_file=example_configs_torch/text2text/nmt_reversal_toy.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.models import Text2Text
from openseq2seq_tpu_torch.test_utils import toy_nmt

_DATA_DIR = os.environ.get("OS2S_TOY_NMT_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_toy_nmt"))
if not os.path.exists(os.path.join(_DATA_DIR, "train.src")):
    toy_nmt.generate(_DATA_DIR)
_DATA = {"train_src": os.path.join(_DATA_DIR, "train.src"),
         "train_tgt": os.path.join(_DATA_DIR, "train.tgt"),
         "eval_src": os.path.join(_DATA_DIR, "eval.src"),
         "eval_tgt": os.path.join(_DATA_DIR, "eval.tgt"),
         "vocab": os.path.join(_DATA_DIR, "vocab.txt")}

base_model = Text2Text
base_params = toy_nmt.transformer_toy_config(_DATA, "train", num_epochs=100)
base_params["logdir"] = os.environ.get("OS2S_TOY_NMT_LOGDIR", os.path.join(
    tempfile.gettempdir(), "os2s_torch_toy_nmt_logs"))
base_params["save_checkpoint_steps"] = 400
base_params["print_loss_steps"] = 100

eval_params = {
    "data_layer_params": {
        "source_file": _DATA["eval_src"],
        "target_file": _DATA["eval_tgt"],
        "shuffle": False,
    },
}
infer_params = {
    "data_layer_params": {
        "source_file": _DATA["eval_src"],
        "target_file": _DATA["eval_tgt"],
        "shuffle": False,
        "use_targets": False,
    },
}
