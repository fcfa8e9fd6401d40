# Jasper cut to 2 blocks x 2 sub-layers at 1/8 width, fp32, on small
# synthetic batches (16 features, 41 frames, 6-label transcripts): the
# port's training, eval and infer on the CPU in seconds, e.g.
#
#   python -m openseq2seq_tpu_torch.run --mode=train_eval --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/jasper_tiny_synthetic.py
#
# The synthetic layer repeats one batch, so the loss falls within the 30
# steps; the WER stays near 1 at this size.
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.zoo import jasper_model_params

base_model = Speech2Text

base_params = jasper_model_params(
    data_layer=SyntheticSpeechDataLayer,
    data_layer_params={
        "num_audio_features": 16,
        "tgt_vocab_size": 29,
        "time_steps": 41,
        "label_length": 6,
        "num_batches": 2,
    },
    num_blocks=2, block_repeat=2, width_scale=0.125,
    batch_size_per_gpu=4,
    dtype="float32",
    logdir="jasper_tiny_synthetic_logs",
    # in base_params, not train_params, so that --max_steps and the
    # --benchmark rewrite can override them
    max_steps=30,
    print_loss_steps=5,
    save_checkpoint_steps=10,
    eval_steps=10,
)
