# The LSTM language model cut to a 1000-word vocabulary, a 32-wide
# embedding and two 128-unit LSTM layers, fp32, on small synthetic batches
# (8 rows of 16 tokens) with 64 sampled candidates: the port's LM training,
# eval and infer on the CPU in seconds, never timed, e.g.
#
#   python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
#       --logdir=<dir> \
#       --config_file=example_configs_torch/lm/lstm_lm_tiny_synthetic.py
#
# B = 8 and H = 128 are the smallest sizes the fused recurrence takes, so
# `fused_rnn` runs the LSTM kernels' plain versions here, forward and
# backward (and the kernels on the card). Adam 5e-3 with the recipe's four
# dropouts at keep 0.9; the synthetic layer repeats one batch, so the loss
# falls within the 20 steps.
from openseq2seq_tpu_torch.data.synthetic import SyntheticLMDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import BasicSampledSequenceLoss
from openseq2seq_tpu_torch.models import LSTMLM

base_model = LSTMLM

base_params = {
    "random_seed": 0,
    "fused_rnn": True,
    "logdir": "lstm_lm_tiny_synthetic_logs",
    "batch_size_per_gpu": 8,
    "dtype": "float32",
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 5e-3},
    "max_grad_norm": 0.25,
    # in base_params, not train_params, so that --max_steps can override
    # them
    "max_steps": 20,
    "print_loss_steps": 5,
    "save_checkpoint_steps": 10,
    "eval_steps": 10,
    "encoder": LMEncoder,
    "encoder_params": {
        "emb_size": 32,
        "encoder_layers": 2,
        "encoder_use_skip_connections": False,
        "core_cell": None,
        "core_cell_params": {"num_units": 128},
        "use_cudnn_rnn": True,
        "cudnn_rnn_type": "cudnn_lstm",
        "weight_tied": False,
        "num_sampled": 64,
        "encoder_emb_keep_prob": 0.9,
        "encoder_dp_input_keep_prob": 0.9,
        "encoder_dp_output_keep_prob": 0.9,
        "encoder_last_output_keep_prob": 0.9,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": BasicSampledSequenceLoss,
    "loss_params": {},
    "data_layer": SyntheticLMDataLayer,
    "data_layer_params": {
        "vocab_size": 1000,
        "bptt": 16,
        "num_batches": 2,
    },
}
