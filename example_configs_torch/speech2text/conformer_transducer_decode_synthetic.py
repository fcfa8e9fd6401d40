# Conformer-Transducer (RNN-T) batch decode at full width on synthetic
# speech, for the PyTorch port's infer (and eval):
#
#   python -m openseq2seq_tpu_torch.run --mode=infer --logdir=<dir> \
#       --infer_output_file=<csv> \
#       --config_file=example_configs_torch/speech2text/conformer_transducer_decode_synthetic.py
#
# The repository's transducer decode bench (scripts/bench_transducer_decode
# .py:44-92): Conformer-M (16 blocks of width 256, 4 heads, depthwise
# kernel 31, FFN x4) with the prediction network, embedding and joint of
# width 320, at most 3 labels a frame, bf16 compute ("mixed"), batches of
# 64 synthetic 10 s utterances (1000 frames x 80 features, 250 after the
# subsampling) over 29 symbols; greedy decode, and the frame-synchronous
# beam with --decoder_params/beam_width=4. The encoder's attention and
# conv module run on the rel-pos flash and conv module kernels, 16
# launches of each a batch, as in conformer_transducer_synthetic.py,
# whose checkpoints this config reads.
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import TransducerDecoder
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.losses import TransducerLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "logdir": "conformer_transducer_synthetic_logs",
    "batch_size_per_gpu": 64,
    "dtype": "mixed",
    "encoder": ConformerEncoder,
    "encoder_params": {
        "num_layers": 16,
        "hidden_size": 256,
        "num_heads": 4,
        "conv_kernel_size": 31,
        "ffn_expansion": 4,
        "conv_norm": "layer_norm",
        "flash_attention": True,
        "fused_conv_module": True,
    },
    "decoder": TransducerDecoder,
    "decoder_params": {
        "pred_embed_size": 320,
        "pred_units": 320,
        "pred_layers": 1,
        "joint_dim": 320,
        "max_symbols_per_frame": 3,
        "beam_width": 1,
        "fused_loss": True,
    },
    "loss": TransducerLoss,
    "loss_params": {},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {
        "num_audio_features": 80,
        "tgt_vocab_size": 29,
        "time_steps": 1000,
        "label_length": 160,
        "num_batches": 2,
    },
}
