# The repository's WikiText-103 LSTM language model
# (example_configs/lm/lstm_wkt103.py) at full width on synthetic token
# tracks, as scripts/bench_lm.py runs it, for the PyTorch port's training,
# eval and infer:
#
#   python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \
#       --config_file=example_configs_torch/lm/lstm_wkt103_synthetic.py
#
# and --mode=eval / --mode=infer from the checkpoint it writes. Vocabulary
# 267,744 (WikiText-103's, padded to a multiple of eight), a 320-wide
# embedding, three unidirectional 1024-unit LSTM layers, an untied softmax;
# 96-token windows, 224 rows a batch (21,504 tokens); bf16 compute from fp32
# params ("mixed"), the logits and the sampled softmax in fp32. `fused_rnn`
# runs each recurrence on csrc/lstm_scan_fwd.cu (3 launches a batch) and, in
# training, its backward on csrc/lstm_scan_bwd.cu (3 more). Training is the
# recipe's (Adam, exp_decay, max_grad_norm 0.25, 8192 sampled candidates,
# dropout keep 0.9 on whole words and 0.8 before and after each layer)
# but for the learning rate: 2e-4 where the recipe has 1e-3, because the
# synthetic layer repeats its batches and at 1e-3 the sampled-softmax loss
# diverges within ~40 steps (scripts/bench_lm.py:19-27, 80-86); 20 steps
# with a checkpoint at the end. Eval and infer take the full softmax, whose
# fp32 logits are 23.0 GB a batch. Data: 4 synthetic batches.
from openseq2seq_tpu_torch.data.synthetic import SyntheticLMDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import BasicSampledSequenceLoss
from openseq2seq_tpu_torch.models import LSTMLM

base_model = LSTMLM

base_params = {
    "random_seed": 0,
    "fused_rnn": True,
    "logdir": "lstm_wkt103_synthetic_logs",
    "batch_size_per_gpu": 224,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 2e-4},
    "lr_policy": "exp_decay",
    "lr_policy_params": {"decay_steps": 40000, "decay_rate": 0.9,
                         "use_staircase_decay": True,
                         "begin_decay_at": 100000, "min_lr": 1e-6},
    "max_grad_norm": 0.25,
    "dtype": "mixed",
    "encoder": LMEncoder,
    "encoder_params": {
        "emb_size": 320,
        "encoder_layers": 3,
        "encoder_use_skip_connections": False,
        "core_cell": None,
        "core_cell_params": {"num_units": 1024},
        "use_cudnn_rnn": True,
        "cudnn_rnn_type": "cudnn_lstm",
        "weight_tied": False,
        "num_sampled": 8192,
        "encoder_emb_keep_prob": 0.9,
        "encoder_dp_input_keep_prob": 0.8,
        "encoder_dp_output_keep_prob": 0.8,
        "encoder_last_output_keep_prob": 0.8,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": BasicSampledSequenceLoss,
    "loss_params": {},
    "data_layer": SyntheticLMDataLayer,
    "data_layer_params": {
        "vocab_size": 267744,
        "bptt": 96,
        "num_batches": 4,
    },
}

train_params = {
    "max_steps": 20,
    "print_loss_steps": 1,
    "save_checkpoint_steps": 20,
}
