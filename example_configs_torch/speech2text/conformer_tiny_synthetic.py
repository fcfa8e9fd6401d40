# Conformer cut to two blocks of width 128 (4 heads, depthwise kernel 7),
# fp32, on small synthetic batches (4 x 40 frames x 16 features, 10 frames
# after the 4x subsampling, 6-label transcripts): the port's Conformer eval
# and infer on the CPU in seconds, never timed, e.g.
#
#   python -m openseq2seq_tpu_torch.run --mode=eval --device=cpu \
#       --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/conformer_tiny_synthetic.py
#
# from a checkpoint in <dir>. Both kernel flags are on, so the CPU runs the
# kernels' plain versions (and the card the kernels); the width is 128 so
# that the JAX package's fused conv module takes its kernel path too
# (conformer_pallas.supported wants D % 128 == 0).
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "logdir": "conformer_tiny_synthetic_logs",
    "batch_size_per_gpu": 4,
    "dtype": "float32",
    "encoder": ConformerEncoder,
    "encoder_params": {
        "num_layers": 2,
        "hidden_size": 128,
        "num_heads": 4,
        "conv_kernel_size": 7,
        "ffn_expansion": 4,
        "conv_norm": "layer_norm",
        "flash_attention": True,
        "fused_conv_module": True,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"use_language_model": False},
    "loss": CTCLoss,
    "loss_params": {"use_pallas": True},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {
        "num_audio_features": 16,
        "tgt_vocab_size": 29,
        "time_steps": 40,
        "label_length": 6,
        "num_batches": 2,
    },
}
