#!/usr/bin/env python3
"""Profile the PyTorch port's eval step, its infer step or its train
step, on one NVIDIA GPU.

    python3 scripts_torch/profile_eval.py [--train | --infer | --train-nmt |
        --train-lm | --eval-lm | --train-gnmt | --infer-gnmt |
        --train-tacotron | --infer-tacotron | --train-transducer |
        --infer-transducer | --train-lm-wkt | --train-txl | --eval-txl |
        --train-resnet | --eval-resnet | --train-las | --infer-las |
        --train-jca | --train-quartznet | --train-ondevice |
        --stream={jasper,transducer}]
        [--beam-width=K] [--config_file=PATH] [--steps=4] [--repeats=3]
        [--batches=N] [--trace=PATH]

Builds the model of a port config (default: Jasper-10x5 at full width on
synthetic speech, ``example_configs_torch/speech2text/
jasper10x5_synthetic.py``; for the NMT transformer-big,
``example_configs_torch/text2text/transformer_big_synthetic.py``; for
DeepSpeech2-medium, ``example_configs_torch/speech2text/
ds2_medium_synthetic.py``, whose train step ``--train`` profiles with
it; for Conformer-M, ``example_configs_torch/speech2text/
conformer_m_synthetic.py``, whose train step ``--train`` profiles too)
on the card with seeded
weights, in eval mode, in infer mode with
``--infer``
(for the transformer: the beam decode alone) or, with ``--train``, in
train mode (the config's ``train_params`` merged in; dropout drawn from
a generator seeded per step). ``--train-nmt`` is ``--train`` on the
transformer-big training config,
``example_configs_torch/text2text/transformer_big_train_synthetic.py``;
``--train-lm`` and ``--eval-lm`` are ``--train`` and the eval step on the
LSTM language model at full width, ``example_configs_torch/lm/
lstm_wkt103_synthetic.py`` (tokens are its objects); ``--train-gnmt``
and ``--infer-gnmt`` are ``--train`` and ``--infer`` (the beam-10 decode
of a batch of 32 sentences) on GNMT-like at full width,
``example_configs_torch/text2text/en_de_gnmt_like_wmt.py``, over 8
batches of a WMT-shaped corpus written first into a temporary directory
(``test_utils/fake_wmt.py``: 256 sentence pairs, the recipe's 32K
vocabulary); ``--train-tacotron`` and ``--infer-tacotron`` are ``--train``
and ``--infer`` (1,000 free-running frames a batch) on Tacotron-2 at full
width on synthetic batches,
``example_configs_torch/text2speech/tacotron2_synthetic.py`` (mel frames
are its objects); ``--train-transducer`` is ``--train`` on the
Conformer-Transducer at full width, ``example_configs_torch/speech2text/
conformer_transducer_synthetic.py`` (batches of 128 x 1000 frames, the
fused loss), and ``--infer-transducer`` is ``--infer`` on its decode
config, ``conformer_transducer_decode_synthetic.py`` (batches of 64,
greedy; ``--beam-width=4`` for the frame-synchronous beam), both from
seeded weights. ``--train-lm-wkt`` is ``--train`` on the WikiText-103 LSTM
LM read from text files (``example_configs_torch/lm/lstm_wkt103.py``),
``--train-txl`` and ``--eval-txl`` the train and eval steps of
Transformer-XL at full width (``txl_wkt103.py``), each on a
WikiText-103-shaped corpus written first into a temporary directory
(``test_utils/fake_wikitext.py``: the recipes' 267,736 words, 200,000
training tokens beside one of each word); ``--train-resnet`` and
``--eval-resnet`` the train and eval steps of ResNet-50 v2 at
``scripts/bench_resnet.py``'s width (``example_configs_torch/
image2label/resnet50_v2_synthetic.py``: batches of 128 x 224 x 224
images, "mixed", NovoGrad; images are its objects); ``--train-las`` and
``--infer-las`` the train step and the beam-4 infer step of LAS at full
width (``example_configs_torch/speech2text/las_large_librispeech.py``:
"mixed", the listener's LSTMs on kernel B3) and ``--train-jca`` the train
step of joint CTC-attention (``jca_large_8gpus.py``, fp32, its CTC half
on B1a and B1b), each over 2 batches of 64 utterances of 16.0 s with
240-character transcripts written first into a temporary directory
(``test_utils/fake_librispeech.py``, one unused symbol added to its
vocabulary so that <S> and </S> take the recipes' ids 29 and 30; audio
frames are the objects). ``--train-quartznet`` is ``--train`` on
QuartzNet-15x5 at full width on synthetic batches at its recipe's
longest utterance (``example_configs_torch/speech2text/
quartznet15x5_synthetic.py``: B 32 x 1,670 frames, L 240, its CTC loss on
B1a and B1b); ``--train-ondevice`` the train step of Jasper-10x5's
LibriSpeech recipe with ``featurize_on_device`` (SpecAugment off, which
the device path refuses): raw audio in, the log-mel features computed on
the card inside the step, over 2 batches of 32 utterances of 16.0 s
written first (``fake_librispeech``); ``--stream=jasper`` and
``--stream=transducer`` a step of streaming recognition at full width on
seeded weights: one 0.2 s frame through ``apps/frame_asr.FrameASR`` over
Jasper-10x5 (greedy; a 5.0 s buffer) or ``TransducerFrameASR`` over the
Conformer-Transducer LibriSpeech recipe (flash and fused: B5 and B6
forward at B 1, T' 128), the energy gate off, over the frames of one
16 s wav (a step and an object are a frame). ``--batches`` keeps the
first N batches of the epoch.
It prints:

1. wall milliseconds per step without the profiler, for each of
   ``--repeats`` passes over the epoch (host batches made beforehand;
   the step copies each to the card), and utterances (sentences) and
   objects (the model's count: frames, or source plus target tokens) per
   second;
2. from one ``torch.profiler`` trace of ``--steps`` steps: device busy
   time (the union of kernel, memcpy and memset intervals) against the
   span from the first device activity to the last, so the idle share;
   and device milliseconds and launches per step for each kernel group
   (the port's own kernels each have theirs: "ctc kernel", "flash
   attention kernel" forward and backward, "fused dropout kernel", "rnn
   scan kernels" and "rnn scan backward kernels" for the GRU and LSTM
   recurrences, "rel-pos flash kernel" and "conformer conv kernel" for the
   Conformer's attention and conv module, and in training "rel-pos flash
   backward kernels" and "conformer conv backward kernels"; the LM's
   sampled softmax gathers and scatters rows of its weight, "sampled
   softmax gathers and scatters");
3. FLOP per step of the convolutions and dense layers, counted from the
   shapes their forward hooks see (in training also their backward: the
   weight gradient, and the input gradient where the input needs one),
   and the rate they reach over the time of the conv and GEMM kernels,
   and over the whole busy time; and apart, the FLOP of the recurrent
   layers' products h W_h, which the scan kernels do (in training also
   the backward kernels' products and the dW_h GEMMs);
4. the host's busiest operators and the number of kernel launches per
   step.

The card's name and power limit come first; a JSON summary is the last
line. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "example_configs_torch", "speech2text",
                      "jasper10x5_synthetic.py")
NMT_TRAIN_CONFIG = os.path.join(REPO, "example_configs_torch", "text2text",
                                "transformer_big_train_synthetic.py")
LM_CONFIG = os.path.join(REPO, "example_configs_torch", "lm",
                         "lstm_wkt103_synthetic.py")
GNMT_CONFIG = os.path.join(REPO, "example_configs_torch", "text2text",
                           "en_de_gnmt_like_wmt.py")
TACOTRON_CONFIG = os.path.join(REPO, "example_configs_torch", "text2speech",
                               "tacotron2_synthetic.py")
TRANSDUCER_CONFIG = os.path.join(REPO, "example_configs_torch", "speech2text",
                                 "conformer_transducer_synthetic.py")
TRANSDUCER_DECODE_CONFIG = os.path.join(
    REPO, "example_configs_torch", "speech2text",
    "conformer_transducer_decode_synthetic.py")
# the GNMT profile's corpus: 8 batches of 32 sentence pairs, and the word
# types that give the recipe's vocabulary, 4 + 3 x 10921 = 32,767 tokens
GNMT_CORPUS = dict(n_train=256, n_dev=32, n_test=32, n_types=10921,
                   with_t2t=False)
LM_WKT_CONFIG = os.path.join(REPO, "example_configs_torch", "lm",
                             "lstm_wkt103.py")
RESNET_CONFIG = os.path.join(REPO, "example_configs_torch", "image2label",
                             "resnet50_v2_synthetic.py")
TXL_CONFIG = os.path.join(REPO, "example_configs_torch", "lm",
                          "txl_wkt103.py")
LAS_CONFIG = os.path.join(REPO, "example_configs_torch", "speech2text",
                          "las_large_librispeech.py")
JCA_CONFIG = os.path.join(REPO, "example_configs_torch", "speech2text",
                          "jca_large_8gpus.py")
# the LAS and JCA profiles' corpus: 2 batches of 64 utterances of 16.0 s
LAS_CORPUS = dict(n_utts=128, duration=16.0, transcript_chars=240)
QUARTZNET_CONFIG = os.path.join(REPO, "example_configs_torch", "speech2text",
                                "quartznet15x5_synthetic.py")
JASPER_LIBRI_CONFIG = os.path.join(REPO, "example_configs_torch",
                                   "speech2text", "jasper10x5_librispeech.py")
TRANSDUCER_LIBRI_CONFIG = os.path.join(
    REPO, "example_configs_torch", "speech2text",
    "conformer_transducer_librispeech.py")
# the on-device and streaming profiles' corpus: 2 batches of 32
# utterances of 16.0 s
ASR_CORPUS = dict(n_utts=64, duration=16.0, transcript_chars=240)
# the WikiText profiles' corpus: every word of the vocabulary once, and
# enough Zipf tokens beside them for a few batches
WKT_CORPUS = dict(n_train_tokens=200_000, n_eval_tokens=60_000,
                  n_reviews=1, n_sentences=1)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# (group, substrings of the kernel name), first match wins
GROUPS = (
    # cuFFT's kernels (regular_fft, vector_fft, ...): the on-device log-mel
    # features' rfft
    ("log-mel features' FFT", ("fft",)),
    # ctc_alpha_fwd_kernel<K, floor>; the backward's ctc_beta_bwd_kernel<K>
    # (the recursion) and ctc_beta_bwd_scatter_kernel
    ("ctc kernel", ("ctc_alpha_fwd", "ctc_beta_bwd")),
    ("rel-pos flash kernel", ("flash_relpos_fwd",)),
    # flash_relpos_bwd_dq_kernel and flash_relpos_bwd_dkv_kernel
    ("rel-pos flash backward kernels", ("flash_relpos_bwd",)),
    # the conv module backward's launches, in the namespace
    # conformer_conv_backward (bf16: round_weights_kernel, front_kernel,
    # glu_bwd_kernel, dh0_kernel, weight_grads_kernel, reduce_all_kernel)
    ("conformer conv backward kernels", ("conformer_conv_backward::",)),
    # the conv module forward's launches: bf16
    # conformer_conv_round_weights_kernel and conformer_conv_fused_kernel;
    # fp32 conformer_conv_pw1_kernel and conformer_conv_dw_pw2_kernel
    ("conformer conv kernel", ("conformer_conv_",)),
    # bf16: flash_attn_fwd_mma_kernel, flash_attn_bwd_{dq,dkv}_mma_kernel;
    # fp32: the same names without _mma
    ("flash attention kernel", ("flash_attn_fwd", "flash_attn_bwd")),
    ("fused dropout kernel", ("dropout_mask",)),
    # the GRU and LSTM kernels, rnn_scan::scan_fwd_kernel<...> and
    # rnn_scan::scan_bwd_kernel<...> (bf16: scan_fwd_mma_kernel<...>,
    # scan_bwd_mma_kernel<...>)
    ("rnn scan kernels", ("scan_fwd_kernel", "scan_fwd_mma_kernel")),
    ("rnn scan backward kernels", ("scan_bwd_kernel",
                                   "scan_bwd_mma_kernel")),
    # cuDNN's direct NHWC kernel takes the one-channel first conv of DS2
    ("convs (implicit GEMM, k > 1)", ("fprop", "dgrad", "wgrad",
                                      "convolve_common_engine")),
    # cuBLAS names its kernels *gemm*, cuBLASLt's newer ones nvjet_*
    ("GEMMs (1x1 residual convs, dense)", ("gemm", "nvjet")),
    ("batch norm", ("bn_fw", "bn_bw", "batch_norm")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("dropout RNG", ("distribution", "philox")),
    ("reductions", ("reduce_kernel",)),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    # the image models' SAME pools (after their padding) and global pool
    ("pools", ("max_pool", "avg_pool", "MaxPool", "AvgPool")),
    ("sorts and top-k (beam search)", ("sort", "Sort", "topk", "TopK")),
    # the sampled softmax's rows of its weight, w[labels] and w[sampled]
    # (aten::index: index_elementwise_kernel or vectorized_gather_kernel)
    # and their gradients' accumulation (indexing_backward_kernel or
    # index_put_with_sort_kernel); the embedding's F.embedding is
    # indexSelect* and embedding_backward* below
    ("sampled softmax gathers and scatters", ("index_elementwise",
                                              "vectorized_gather",
                                              "indexing_backward",
                                              "index_put")),
    ("gathers and scatters (embedding, beam reorder)", ("index", "gather",
                                                        "scatter")),
    ("H2D copies", ("HtoD",)),
    ("dtype casts and copies", ("copy", "DtoD")),
    ("elementwise", ("elementwise",)),
)
MATMUL_GROUPS = ["convs (implicit GEMM, k > 1)",
                 "GEMMs (1x1 residual convs, dense)"]


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def count_flops(module, run, train: bool = False) -> int:
    """FLOP (2 x multiply-adds) of ``module``'s convs and dense layers
    during ``run()``, from the output shapes their forward hooks see.
    With ``train``, also their backward: the weight gradient costs what
    the forward does, and so does the input gradient where the input
    needs one. The language model's vocabulary products count too: the
    logits, 2 E V a token (in training with ``train`` three times), or in
    training the sampled softmax's product with its S candidates, 3 x 2 E
    S a token (its true logits are an elementwise product, uncounted).
    The recurrent products h W_h of the GRU and LSTM layers (2 G H^2 per
    row and step, in the scan kernels) are not counted:
    :func:`count_recurrent_flops` counts them."""
    from openseq2seq_tpu_torch.decoders.fc_decoders import Dense
    from openseq2seq_tpu_torch.encoders.conformer_encoder import DenseGeneral
    from openseq2seq_tpu_torch.encoders.ds2_encoder import SameConv2d
    from openseq2seq_tpu_torch.encoders.lm_encoders import LMNet
    from openseq2seq_tpu_torch.encoders.tdnn_encoder import SameConv1d
    from openseq2seq_tpu_torch.encoders.transformer_xl_encoder import \
        TransformerXLNet
    from openseq2seq_tpu_torch.parts.transformer.common import \
        Dense as TransformerDense
    total = [0]

    def passes(inp):
        if not train:
            return 1
        return 2 + int(inp[0].requires_grad)

    def conv_hook(mod, inp, out):
        # weight (out, in, k) or (out, in, kt, kf): one output's taps
        total[0] += passes(inp) * 2 * out.numel() * mod.weight[0].numel()

    def dense_hook(mod, inp, out):
        total[0] += passes(inp) * 2 * out.numel() * mod.weight.shape[1]

    def dense_general_hook(mod, inp, out):
        total[0] += passes(inp) * 2 * out.numel() * mod.n_in

    def lm_head_hook(mod, inp, out):
        if "logits" not in out and "num_sampled" not in out:
            return                  # a classifier, counted as dense layers
        h = out["outputs"]
        width = h.shape[0] * h.shape[1] * h.shape[2]
        n = out["logits"].shape[-1] if "logits" in out \
            else out["num_sampled"]
        total[0] += (3 if train else 1) * 2 * width * n

    handles = [m.register_forward_hook(conv_hook)
               for m in module.modules()
               if isinstance(m, (SameConv1d, SameConv2d))]
    handles += [m.register_forward_hook(dense_hook)
                for m in module.modules()
                if isinstance(m, (Dense, TransformerDense))]
    handles += [m.register_forward_hook(dense_general_hook)
                for m in module.modules() if isinstance(m, DenseGeneral)]
    handles += [m.register_forward_hook(lm_head_hook)
                for m in module.modules()
                if isinstance(m, (LMNet, TransformerXLNet))]
    run()
    for h in handles:
        h.remove()
    return total[0]


def count_recurrent_flops(module, run, train: bool = False) -> int:
    """FLOP of the recurrent products h W_h of ``module``'s GRU and LSTM
    layers during ``run()``: 2 G H^2 for every row and step, masked steps
    included (the scan kernels compute them). With ``train`` three times
    that: the backward kernel's product with W_h^T and the dW_h GEMM
    outside it cost what the forward's does."""
    from openseq2seq_tpu_torch.parts.rnns.rnn import GRU, LSTM
    total = [0]

    def hook(mod, inp, out):
        B, T = inp[0].shape[:2]
        total[0] += (3 if train else 1) * 2 * B * T * \
            mod.recurrent_kernel.numel()

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (GRU, LSTM))]
    run()
    for h in handles:
        h.remove()
    return total[0]


def make_step(model, train: bool):
    """``(module, step)``: the model's seeded module and ``step(batch)``,
    its eval step or, with ``train``, a train step with the dropout
    generator seeded per step as the trainer seeds it. The train step
    updates the module in place."""
    import torch
    from openseq2seq_tpu_torch.parts.dropout import step_seed
    from openseq2seq_tpu_torch.training import trainer
    holder = [trainer.restore_state(model)]
    generator = torch.Generator(device=model.device)
    seed = model.params.get("random_seed", 0)

    def step(batch):
        state = holder[0]
        if not train:
            return model.eval_step(state, batch)
        generator.manual_seed(step_seed(seed, state.step))
        holder[0], metrics = model.train_step(state, batch, generator)
        return metrics

    return holder[0].module, step


def stream_step(model, which: str, train_csv: str):
    """``(module, step, frames)``: a streaming recognizer over ``model``
    (``FrameASR`` greedy for "jasper", ``TransducerFrameASR`` for
    "transducer"; seeded weights, the energy gate off), ``step(frame)``
    feeding it one frame, and the 0.2 s frames of the first wav of
    ``train_csv``."""
    import csv as csvmod
    import numpy as np
    from scipy.io import wavfile
    from openseq2seq_tpu_torch.apps.frame_asr import (FrameASR,
                                                      TransducerFrameASR)
    if which == "jasper":
        asr = FrameASR(model, timestep_duration=0.02, silence_threshold=0.0)
    else:
        asr = TransducerFrameASR(model, timestep_duration=0.04,
                                 silence_threshold=0.0)
    with open(train_csv) as f:
        wav = next(csvmod.DictReader(f))["wav_filename"]
    _, signal = wavfile.read(wav)
    signal = signal.astype(np.float32) / 32767.0
    n = asr.n_frame_len
    frames = [signal[i:i + n] for i in range(0, len(signal) - n + 1, n)]
    return asr.state.module, asr.transcribe, frames


def device_intervals(trace_path: str):
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
            for e in events if e.get("cat") in DEVICE_CATS]


def busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--train", action="store_true",
                       help="profile the train step (default: the eval "
                            "step)")
    which.add_argument("--infer", action="store_true",
                       help="profile the infer step")
    which.add_argument("--train-nmt", action="store_true",
                       help="profile the transformer-big train step (the "
                            "train step on {})".format(
                                os.path.relpath(NMT_TRAIN_CONFIG, REPO)))
    which.add_argument("--train-lm", action="store_true",
                       help="profile the LSTM LM's train step (the train "
                            "step on {})".format(
                                os.path.relpath(LM_CONFIG, REPO)))
    which.add_argument("--eval-lm", action="store_true",
                       help="profile the LSTM LM's eval step on {}".format(
                           os.path.relpath(LM_CONFIG, REPO)))
    which.add_argument("--train-gnmt", action="store_true",
                       help="profile GNMT-like's train step (the train "
                            "step on {} over a WMT-shaped corpus)".format(
                                os.path.relpath(GNMT_CONFIG, REPO)))
    which.add_argument("--infer-gnmt", action="store_true",
                       help="profile GNMT-like's beam-10 infer step")
    which.add_argument("--train-tacotron", action="store_true",
                       help="profile Tacotron-2's train step (the train "
                            "step on {})".format(
                                os.path.relpath(TACOTRON_CONFIG, REPO)))
    which.add_argument("--infer-tacotron", action="store_true",
                       help="profile Tacotron-2's infer step (1,000 "
                            "free-running frames)")
    which.add_argument("--train-transducer", action="store_true",
                       help="profile the Conformer-Transducer's train step "
                            "(the train step on {})".format(
                                os.path.relpath(TRANSDUCER_CONFIG, REPO)))
    which.add_argument("--train-lm-wkt", action="store_true",
                       help="the WikiText-103 LSTM LM's train step from "
                            "text files")
    which.add_argument("--train-txl", action="store_true",
                       help="Transformer-XL's train step at full width")
    which.add_argument("--eval-txl", action="store_true",
                       help="Transformer-XL's eval step at full width")
    which.add_argument("--train-resnet", action="store_true",
                       help="ResNet-50 v2's train step at full width")
    which.add_argument("--eval-resnet", action="store_true",
                       help="ResNet-50 v2's eval step at full width")
    which.add_argument("--train-las", action="store_true",
                       help="LAS's train step at full width")
    which.add_argument("--infer-las", action="store_true",
                       help="LAS's beam-4 infer step at full width")
    which.add_argument("--train-jca", action="store_true",
                       help="joint CTC-attention's train step at full "
                            "width")
    which.add_argument("--train-quartznet", action="store_true",
                       help="QuartzNet-15x5's train step at full width")
    which.add_argument("--train-ondevice", action="store_true",
                       help="Jasper-10x5's train step from raw audio, "
                            "featurized on the card")
    which.add_argument("--stream", choices=["jasper", "transducer"],
                       default=None,
                       help="a 0.2 s frame of streaming recognition at "
                            "full width")
    which.add_argument("--infer-transducer", action="store_true",
                       help="profile the Conformer-Transducer's decode of "
                            "a batch (the infer step on {})".format(
                                os.path.relpath(TRANSDUCER_DECODE_CONFIG,
                                                REPO)))
    ap.add_argument("--beam-width", type=int, default=None,
                    help="the transducer decode's beam (default: the "
                         "config's, 1: greedy)")
    ap.add_argument("--config_file", default=None,
                    help="the port config (default: Jasper-10x5, the "
                         "transformer-big training config with "
                         "--train-nmt, the LSTM LM with --train-lm and "
                         "--eval-lm, GNMT-like with --train-gnmt and "
                         "--infer-gnmt, Tacotron-2 with --train-tacotron "
                         "and --infer-tacotron, the Conformer-Transducer "
                         "with --train-transducer and --infer-transducer)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batches", type=int, default=None,
                    help="keep the first N batches of the epoch")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="where to keep the chrome trace (default: a "
                         "temporary file)")
    args = ap.parse_args(argv)
    args.gnmt = args.train_gnmt or args.infer_gnmt
    tacotron = args.train_tacotron or args.infer_tacotron
    args.wikitext = args.train_lm_wkt or args.train_txl or args.eval_txl
    args.librispeech = args.train_las or args.infer_las or args.train_jca
    args.asr_corpus = args.train_ondevice or args.stream is not None
    if args.config_file is None:
        args.config_file = NMT_TRAIN_CONFIG if args.train_nmt else \
            LM_CONFIG if args.train_lm or args.eval_lm else \
            GNMT_CONFIG if args.gnmt else \
            TACOTRON_CONFIG if tacotron else \
            TRANSDUCER_CONFIG if args.train_transducer else \
            TRANSDUCER_DECODE_CONFIG if args.infer_transducer else \
            LM_WKT_CONFIG if args.train_lm_wkt else \
            TXL_CONFIG if args.train_txl or args.eval_txl else \
            RESNET_CONFIG if args.train_resnet or args.eval_resnet else \
            LAS_CONFIG if args.train_las or args.infer_las else \
            JCA_CONFIG if args.train_jca else \
            QUARTZNET_CONFIG if args.train_quartznet else \
            JASPER_LIBRI_CONFIG if args.train_ondevice or \
            args.stream == "jasper" else \
            TRANSDUCER_LIBRI_CONFIG if args.stream == "transducer" else \
            CONFIG
    args.train = args.train or args.train_nmt or args.train_lm or \
        args.train_gnmt or args.train_tacotron or args.train_transducer or \
        args.train_lm_wkt or args.train_txl or args.train_resnet or \
        args.train_las or args.train_jca or args.train_quartznet or \
        args.train_ondevice
    args.infer = args.infer or args.infer_gnmt or args.infer_tacotron or \
        args.infer_transducer or args.infer_las
    return args


def main(argv=None):
    args = parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: no CUDA device")
    sys.path.insert(0, REPO)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    if args.gnmt:
        from openseq2seq_tpu_torch.test_utils import fake_wmt
        # removed when main returns
        corpus = tempfile.TemporaryDirectory()
        os.environ["WMT16_DIR"] = fake_wmt.generate(corpus.name,
                                                    **GNMT_CORPUS)
    if args.wikitext:
        from openseq2seq_tpu_torch.test_utils import fake_wikitext
        corpus = tempfile.TemporaryDirectory()
        os.environ["WIKITEXT103_DIR"] = fake_wikitext.generate(
            corpus.name, **WKT_CORPUS)["wikitext"]
    if args.librispeech:
        from openseq2seq_tpu_torch.test_utils import fake_librispeech
        corpus = tempfile.TemporaryDirectory()
        data = fake_librispeech.generate(corpus.name, **LAS_CORPUS)[0]
        with open(os.path.join(data, "vocab.txt"), "a") as f:
            f.write("_\n")
        os.environ["LIBRISPEECH_DIR"] = data
    if args.asr_corpus:
        from openseq2seq_tpu_torch.test_utils import fake_librispeech
        corpus = tempfile.TemporaryDirectory()
        data, train_csv = fake_librispeech.generate(corpus.name,
                                                    **ASR_CORPUS)
        os.environ["LIBRISPEECH_DIR"] = data
    config = runpy.run_path(args.config_file)
    mode = "train" if args.train else "infer" if args.infer else "eval"
    params = dict(config["base_params"])
    if args.train:
        params.update({k: v for k, v in config.get("train_params",
                                                   {}).items()
                       if k != "data_layer_params"})
        params["data_layer_params"] = dict(
            params["data_layer_params"],
            **config.get("train_params", {}).get("data_layer_params", {}))
    if args.beam_width is not None:
        params["decoder_params"] = dict(params["decoder_params"],
                                        beam_width=args.beam_width)
    if args.asr_corpus:
        params["data_layer_params"] = dict(
            params["data_layer_params"], augmentation={},
            featurize_on_device=args.train_ondevice)
    if args.stream:
        mode = "interactive_infer"
    model = config["base_model"](params=params, mode=mode, device="cuda")
    if args.stream:
        module, step, batches = stream_step(model, args.stream, train_csv)
        utts = objects = len(batches)
    else:
        module, step = make_step(model, args.train)
        batches = list(model.get_data_layer().iterate_one_epoch())
        if args.batches:
            batches = batches[:args.batches]
        utts = sum(len(b["source_ids"]) for b in batches)
        objects = sum(model.get_num_objects_per_step(b) for b in batches)
    # the warm-up steps count the FLOP
    flop_per_batch = count_flops(module, lambda: step(batches[0]),
                                 args.train)
    rnn_flop_per_batch = count_recurrent_flops(
        module, lambda: step(batches[0]), args.train)
    torch.cuda.synchronize()
    print("[model] {}: {} step, {} batches of {}, dtype {}; {:.4e} FLOP "
          "per step in convs and dense layers, {:.4e} in recurrent "
          "products".format(
              os.path.relpath(args.config_file, REPO), mode, len(batches),
              "one 0.2 s frame" if args.stream else "{} x {} steps".format(
                  len(batches[0]["source_ids"]),
                  batches[0]["source_tensors"][0].shape[1]),
              model.params["dtype"], flop_per_batch, rnn_flop_per_batch),
          flush=True)

    walls = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / len(batches))
    print("[wall] ms per step, {} passes: {}; utterances (sentences) "
          "per s: {}; objects (frames or tokens) per s: {} ({})".format(
        args.repeats, ", ".join("{:.3f}".format(w) for w in walls),
        ", ".join("{:.1f}".format(utts / len(batches) / w * 1e3)
                  for w in walls),
        ", ".join("{:.1f}".format(objects / len(batches) / w * 1e3)
                  for w in walls), card), flush=True)

    from torch.profiler import ProfilerActivity, profile
    steps = [batches[i % len(batches)] for i in range(args.steps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in steps:
            step(b)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = args.trace or os.path.join(tmp, "trace.json")
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)),
                    exist_ok=True)
        prof.export_chrome_trace(trace_path)
        intervals = device_intervals(trace_path)
    if not intervals:
        raise SystemExit("profile_eval: the trace holds no device activity")
    span = max(e for _, e, _ in intervals) - min(s for s, _, _ in intervals)
    busy = busy_us(intervals)
    n = args.steps
    print("[trace] {} steps: device busy {:.3f} ms per step of a {:.3f} ms "
          "span, idle share {:.2%}".format(n, busy / n / 1e3, span / n / 1e3,
                                           1 - busy / span), flush=True)
    groups, group_launches = collections.Counter(), collections.Counter()
    for s, e, name in intervals:
        groups[group_of(name)] += e - s
        group_launches[group_of(name)] += 1
    total = sum(groups.values())
    for g, us in groups.most_common():
        print("[trace] {:36s} {:8.3f} ms per step, {:5.1%} of device "
              "time, {:.0f} launches per step".format(
                  g, us / n / 1e3, us / total, group_launches[g] / n),
              flush=True)
    kernels = collections.Counter()
    for s_, e, name in intervals:
        kernels[name] += e - s_
    for name, us in kernels.most_common(8):
        print("[kernel] {:8.3f} ms per step  {}".format(us / n / 1e3,
                                                       name[:110]),
              flush=True)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:8]:
        print("[host] {:48s} {:8.3f} ms self CPU per step, {} calls".format(
            e.key[:48], e.self_cpu_time_total / n / 1e3, e.count // n),
            flush=True)
    launches = sum(1 for _, _, name in intervals
                   if "Memcpy" not in name and "Memset" not in name) / n
    print("[host] {:.0f} device kernels per step".format(launches),
          flush=True)
    mm_us = sum(groups[g] for g in MATMUL_GROUPS) / n
    print("[flops] {:.1f} TFLOP/s over the conv and GEMM kernels "
          "({:.3f} ms per step); {:.1f} TFLOP/s over the busy time "
          "({})".format(flop_per_batch / mm_us / 1e6, mm_us / 1e3,
                        flop_per_batch / (busy / n) / 1e6, card), flush=True)
    print(json.dumps({
        "card": card, "mode": mode, "wall_ms_per_batch": walls,
        "utt_per_s": [utts / len(batches) / w * 1e3 for w in walls],
        "objects_per_s": [objects / len(batches) / w * 1e3 for w in walls],
        "busy_ms_per_batch": busy / n / 1e3,
        "span_ms_per_batch": span / n / 1e3, "idle_share": 1 - busy / span,
        "group_ms_per_batch": {g: us / n / 1e3 for g, us in groups.items()},
        "group_launches_per_batch": {g: c / n for g, c in
                                     group_launches.items()},
        "kernels_per_batch": launches,
        "flop_per_batch": flop_per_batch,
        "recurrent_flop_per_batch": rnn_flop_per_batch}), flush=True)


if __name__ == "__main__":
    main()
