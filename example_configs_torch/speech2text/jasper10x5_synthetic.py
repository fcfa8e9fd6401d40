# Jasper-10x5 at full published width on synthetic speech, for the
# PyTorch port:
#
#   python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/jasper10x5_synthetic.py
#
# and --mode=eval / --mode=infer from the checkpoint it writes. Shapes
# follow the repository's Jasper bench: 64 log-filterbank features, 1000
# frames (10 s), 160-label transcripts over a 29-symbol vocabulary, bf16
# compute from fp32 params ("mixed"); 4 batches of 32 per epoch (the
# synthetic layer repeats one batch). Training is the zoo's recipe,
# NovoGrad + LARC + poly_decay, for 20 steps, with a checkpoint at the end.
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.zoo import jasper_model_params

base_model = Speech2Text

base_params = jasper_model_params(
    data_layer=SyntheticSpeechDataLayer,
    data_layer_params={
        "num_audio_features": 64,
        "tgt_vocab_size": 29,
        "time_steps": 1000,
        "label_length": 160,
        "num_batches": 4,
    },
    num_blocks=10, block_repeat=5,
    batch_size_per_gpu=32,
    dtype="mixed",
    logdir="jasper10x5_synthetic_logs",
)

train_params = {
    "max_steps": 20,
    "print_loss_steps": 5,
    "save_checkpoint_steps": 20,
}
