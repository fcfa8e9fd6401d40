"""``las_large_8gpus.py`` with ``fused_rnn: True``, for the PyTorch port.

``fused_rnn`` is the JAX package's own model key
(``openseq2seq_tpu/models/model.py:165``). In both packages it puts the
listener's LSTM recurrences on the fused scan: the JAX package's Pallas
``lstm_pallas`` and, here, kernel B3 (``ops/lstm_scan.py``,
``csrc/lstm_scan_{fwd,bwd}.cu``), forward and, in training, backward. At
batches of 64 that is three bidirectional layers, six launches a batch
(each two tiles of 32 rows at H 512; T 400, then 200 after each pyramid
step's pooling), and six backward launches a training step.

  LIBRISPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train_eval \\
      --config_file=example_configs_torch/speech2text/las_large_librispeech.py
"""
import copy
import os
import runpy

_LAS = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "las_large_8gpus.py"))

base_model = _LAS["base_model"]
base_params = dict(copy.deepcopy(_LAS["base_params"]), fused_rnn=True)
eval_params = copy.deepcopy(_LAS["eval_params"])
