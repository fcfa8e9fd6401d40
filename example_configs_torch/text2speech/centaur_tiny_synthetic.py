"""A tiny Centaur on synthetic batches, the CPU twin of
``centaur_synthetic.py`` for tests and quick runs: batches of 4 texts of
12 characters x 16 frames of 8 mel bins, an encoder of a 16-wide
embedding, one SAME conv of 32 and a projection to 32; a decoder of one
16-unit prenet layer and two causal conv and attention blocks of 32 with
two heads, reduction 2, ``window_size`` 2 forced on layer 1, 12 frames in
infer; fp32, NovoGrad with ``poly_decay``, 10 steps.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --logdir=<dir> \\
      --config_file=example_configs_torch/text2speech/centaur_tiny_synthetic.py
"""
from openseq2seq_tpu_torch.data import SyntheticTTSDataLayer
from openseq2seq_tpu_torch.decoders import CentaurDecoder
from openseq2seq_tpu_torch.encoders import CentaurEncoder
from openseq2seq_tpu_torch.losses import Text2SpeechLoss
from openseq2seq_tpu_torch.models import Text2SpeechCentaur


def _conv(ch, causal=False):
    return {"kernel_size": [3], "stride": [1], "num_channels": ch,
            "padding": "CAUSAL" if causal else "SAME"}


base_model = Text2SpeechCentaur
base_params = {
    "random_seed": 0,
    "logdir": "centaur_tiny_synthetic_logs",
    "max_steps": 10,
    "batch_size_per_gpu": 4,
    "print_loss_steps": 1,
    "eval_steps": 5,
    "save_checkpoint_steps": 5,
    "max_grad_norm": 1.0,
    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.98, "epsilon": 1e-8,
                         "weight_decay": 0.001},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.02, "power": 2.0,
                         "decay_steps": 1000},
    "dtype": "float32",
    "encoder": CentaurEncoder,
    "encoder_params": {
        "embedding_size": 16,
        "output_size": 32,
        "pad_embeddings_2_eight": True,
        "cnn_dropout_prob": 0.1,
        "conv_layers": [_conv(32)],
    },
    "decoder": CentaurDecoder,
    "decoder_params": {
        "attention_layers": 2,
        "self_attention_conv_params": _conv(32, causal=True),
        "window_size": 2,
        "back_step_size": 0,
        "force_layers": [1],
        "hidden_size": 32,
        "reduction_factor": 2,
        "prenet_layers": 1,
        "prenet_hidden_size": 16,
        "prenet_use_inference_dropout": False,
        "cnn_dropout_prob": 0.1,
        "prenet_dropout": 0.5,
        "conv_layers": [_conv(32, causal=True)] * 2,
        "mag_conv_layers": [_conv(32, causal=True)] * 2,
        "attention_dropout": 0.1,
        "attention_heads": 2,
        "layer_postprocess_dropout": 0.1,
        "infer_max_steps": 12,
    },
    "loss": Text2SpeechLoss,
    "loss_params": {"use_mask": True, "l1_norm": True},
    "data_layer": SyntheticTTSDataLayer,
    "data_layer_params": {
        "src_vocab_size": 10,
        "num_audio_features": 8,
        "text_length": 12,
        "spec_length": 16,
        "num_batches": 2,
    },
}
