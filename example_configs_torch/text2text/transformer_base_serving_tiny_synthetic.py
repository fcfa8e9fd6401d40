# A tiny fp32 twin of transformer_base_serving_synthetic.py for the CPU, for
# the tests and the docs (never timed): 2 + 2 layers of width 128 with 2
# heads of 64 (the flash kernel's head dim), filter 512, a 61-token
# vocabulary, batches of 3 sentences of 12 tokens, every dropout rate 0.
# tests/test_torch_serving.py exports and serves it on the CPU as
# scripts_torch/bench_serving.py serves the full-width config on the card.
import copy
import os
import runpy

_full = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "transformer_base_serving_synthetic.py"))

d_model = 128

base_model = _full["base_model"]
base_params = copy.deepcopy(_full["base_params"])
base_params.update({
    "batch_size_per_gpu": 3,
    "dtype": "float32",
    "logdir": "transformer_base_serving_tiny_synthetic_logs",
})
for _side, _layers in (("encoder_params", "encoder_layers"),
                       ("decoder_params", "num_hidden_layers")):
    base_params[_side].update({_layers: 2, "hidden_size": d_model,
                               "num_heads": 2, "filter_size": 4 * d_model})
base_params["decoder_params"]["extra_decode_length"] = 4
base_params["data_layer_params"].update({
    "src_vocab_size": 61, "tgt_vocab_size": 61, "src_length": 12,
    "tgt_length": 12})
