"""A tiny LAS for CPU runs of the PyTorch port: ``las_toy.py`` narrowed
(a conv of 32 channels, a BiLSTM of 32 with one pyramid step and
``fused_rnn`` on, so that the listener runs the LSTM kernels' plain
versions on the CPU and kernel B3 on the card; a one-head speller of 32
with coverage and dropout 0.9), 8 epochs with checkpoints and an eval
every 4 steps. The card's twin of it is held against the CPU by
``chip_smoke.py --group=las``.

  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --config_file=example_configs_torch/speech2text/las_tiny.py
"""
import copy
import os
import runpy
import tempfile

_TOY = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "las_toy.py"))

base_model = _TOY["base_model"]
base_params = copy.deepcopy(_TOY["base_params"])
base_params.update(
    num_epochs=8, eval_steps=4, save_checkpoint_steps=4, print_loss_steps=1,
    fused_rnn=True,
    logdir=os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_las_tiny_logs")))
base_params["encoder_params"] = dict(
    base_params["encoder_params"],
    convnet_layers=[{"type": "conv1d", "repeat": 1, "kernel_size": [7],
                     "stride": [2], "num_channels": 32,
                     "padding": "SAME"}],
    recurrent_layers=[{"type": "lstm", "num_units": 32, "pool": 2}])
base_params["decoder_params"] = dict(
    base_params["decoder_params"], tgt_emb_size=32, hidden_dim=32,
    dropout_keep_prob=0.9, pos_embedding=False,
    attention_params={"attention_dim": 32, "attention_type": "chorowski",
                      "use_coverage": True, "num_heads": 1,
                      "plot_attention": True})
eval_params = copy.deepcopy(_TOY["eval_params"])
infer_params = copy.deepcopy(_TOY["infer_params"])
