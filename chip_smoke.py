#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check
them.

    python3 chip_smoke.py [--group=NAME]

With no argument it runs every phase below and ends with the kernels
line and the contract line: the kernel group first, alone on the card so
that its times are clean, then each other group in a process of its own
(``--group=NAME``), up to three at a time as their budgets of device
memory allow (``GROUP_GIB``), its output relayed when it ends and its
launches added up; the first group to fail stops the others. Their
rates and idle shares are thus read beside two other groups: a rate to
keep comes from a ``--group`` run, which has the card to itself. ``--group`` runs the environment, the build
and one group of phases, then a line of that group's kernel launches and
seconds, and the contract line: ``kernels`` (3 to 4j), ``speech`` (5 to
7, 7r, 7s), ``nmt`` (7a to 7e, 7u to 7x, 7zu to 7zx), ``rnn`` (7f to 7k,
the DS2 toy), ``conformer`` (7l to 7n, the Conformer toy), ``lm`` (7o to
7q, 7zf to 7zi), ``tts`` (7y to 7za, 7zp to 7zt), ``transducer`` (7zb to
7ze), ``image`` (7zj to 7zo), ``las`` (7zy to 7zzc), ``asr_stack``
(7zzd to 7zzk) and ``serving`` (the int8 products, 7zzl, 7zzm). Each
phase's
seconds are printed on a line of their own (``[time] phase ...``), then
each group's and the total.

Phases, one informative line or a few each:

1. environment: torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``); TF32 off for the fp32 phases;
2. build: the CTC kernels (``openseq2seq_tpu_torch/csrc/ctc_alpha_fwd.cu``
   and ``ctc_beta_bwd.cu``), the flash attention forward and backward
   (``flash_attn_fwd.cu``, ``flash_attn_bwd.cu``), the fused dropout
   (``dropout_mask.cu``), the GRU and LSTM scans, forward and backward
   (``{gru,lstm}_scan_{fwd,bwd}.cu``), the rel-pos flash attention
   forward and backward (``flash_relpos_{fwd,bwd}.cu``) and the Conformer
   conv module forward and backward (``conformer_conv_{fwd,bwd}.cu``),
   one ``nvcc`` each for ``sm_90a``,
   started together, and what ``ptxas`` reports for them (registers,
   spills; of the scans' instantiations, the main paths' and a
   summary);
3. the forward kernel against its plain PyTorch version, both fp32 on the
   card, at the Jasper eval shape (B=32, T=500, L=160, V=29), at
   Conformer-M's (B=64, T=250), at JCA's (B=64, T=401, L=241, V=30), at
   QuartzNet-15x5's (B=32, T=835, L=240), at L=600 (two states a
   thread), at T=37
   and at lengths that end on either side of the kernels' chunk edges
   (``ctc_chunk_case``): max relative error 1e-5 on the NLL of feasible
   rows, exact zeros on infeasible ones; the kernels' resources
   (``ctc_resources``) at L=160, 600, JCA's 241 and QuartzNet's 240;
   times from CUDA events (at the Jasper, JCA and QuartzNet shapes); wrong
   inputs refused, and L=3000, whose CTA does not fit an SM, refused with
   ValueError and nothing counted;
4. the backward's two launches (after the forward with its alpha
   lattice) against the plain versions at the same shapes, through
   ``ctc_cuda.readings``: NLL max relative error 1e-5, d log-probs max abs
   error 1e-5 against ``ctc_nll_grad``, exact zeros on infeasible rows and
   past each length, the posteriors of a live frame summing to 1 within
   1e-4, the first launch's posteriors within 1e-5 of ``ctc_posteriors``
   on the kernel forward's own NLL and lattice, element by element, two
   calls bit-identical; at the Jasper, Conformer-M, JCA and QuartzNet
   shapes and the chunk case the planted faults of ``ctc_cuda.planted_faults`` (frame t+1's
   emission at a chunk edge; a lattice frame read from its neighbour; a
   repeated symbol's state left out of the scatter; d log-probs zeroed but
   on row 1), each of whose largest reading must pass 1 and is printed;
   times of kernel fwd+bwd against plain fwd+bwd; ``F.ctc_loss`` timed at
   the Jasper, Conformer-M and JCA shapes, forward and forward plus
   backward, as their library yardstick;
4b. the flash kernel against ``flash_attention_plain`` at the
   transformer-big eval shapes (encoder B=64, H=16, T=64, D=64 with key
   padding; decoder causal T=63; cross Tq=63, Tk=64), causal at T=113,
   D=128, D=256, Tk=1000 and transformer-base scoring's encoder shape
   (B=64, H=8, T=64, D=64, timed too): fp32 (TF32 off; the CUDA-core kernel) max
   abs err 2e-5; bf16 (the tensor-core kernel) against the rounding plain
   version (weights rounded to bf16 where JAX's stock kernel rounds them)
   max abs err 2^-7, two calls bit-identical, and against the plain
   version's fp32 math max abs err 1e-2; times of the kernel, the rounding
   plain version and ``scaled_dot_product_attention`` (timed only, never
   on the path) at the eval shapes, in bf16;
4c. the flash backward kernels (after the forward with its lse) against
   ``flash_attention_bwd_plain`` at the same shapes: lse within 1e-5, fp32
   (TF32 off) dq, dk, dv max abs err 1e-4; bf16 against the rounding plain
   version (p^T, ds^T, ds rounded to bf16 as JAX's stock kernels round
   them) within 2^-7 of each gradient's largest magnitude, and against
   fp32 math within 2^-6 of it; two calls bit-identical; times of each
   kernel, the rounding plain backward and SDPA forward plus backward
   (timed only) at the train step's shapes, in bf16;
4d. the fused dropout kernel against its plain version, forward and
   backward, with and without the residual, bf16 and fp32, at the FFN
   shape (4096 x 4096) and at M=600, D=256: bit-identical; times
   of the kernel and the plain version (``F.dropout``, another function,
   timed for information);
4e. the GRU and LSTM scan kernels (bf16 ``scan_fwd_mma_kernel``: the
   tensor cores in clusters of two; fp32 on the CUDA cores) against
   ``gru_scan_plain`` and ``lstm_scan_plain`` at the main paths' shapes
   (GRU B=32, T=500, H=1024; LSTM B=32, T=500, H=512; the LSTM language
   model's B=224, T=96, H=1024, seven tiles of 32 rows a step; GNMT-like's
   encoder, B=32, T=50, H=1024, one tile; the Tacotron-2 encoder's LSTM,
   B=48, T=96, H=256, a full tile of 32 rows and a ragged one of 16; the
   LAS listener's BiLSTMs, B=64, H=512, T=400 and 200, two tiles; the
   GST reference encoder's GRU, B=48, T=8, H=128), at B=8,
   T=37, H=128, LSTMs at H=1024 and 1280 and the DS2 toy's GRU (fp32,
   B=10, T=48, H=64; bf16 refused there), forward and reverse, lengths from
   1 to T, with the residual outputs: fp32 (TF32 off) max abs error 1e-5
   at T=37 and 1e-4 at T=500 (the fp32 LSTM at H=1280 refused with
   ValueError before any launch); bf16 each step held from the kernel's
   own state (ys[t_prev], cs) element by element within
   ``ops/scan_bounds``'s bounds (reading at most 1), four wrong kernels
   refused (ys zeroed but in row 1; one step without the recurrent
   product for one CTA's units; h carried unrounded; the LSTM's c carried
   in bf16; and past one tile of rows, at B=224 and at the ragged B=48, a
   step whose second tile of rows takes the first tile's h, and ys zeroed
   on the second tile's rows alone), and end to end max abs error 3 bf16
   ulps and mean 1e-3
   (both of max(1, |value|)) as a sanity check; ys zero past each
   length, two calls bit-identical; times of the kernel, the plain
   version and cuDNN's ``torch.nn.GRU``/``torch.nn.LSTM`` (timed only,
   never on the path; its input GEMM timed beside it, and cuDNN's time
   less it; the speech layers' with a 2H-wide input, the LM's with an
   H-wide one, as GNMT's) at the main shapes in bf16, with the tiles and
   the time a
   step, and the per-step floor (B=8, T=500, H=128); a GRU layer at
   H=800, which ``supported`` rejects, runs
   the scan with no launch; what the kernels do not take, they refuse;
4f. the GRU and LSTM backward kernels (bf16 on the tensor cores in
   clusters of two) against ``gru_scan_bwd_plain`` and
   ``lstm_scan_bwd_plain`` on the forward kernel's residuals, at the same
   shapes, forward and reverse, h0 and c0 non-zero, lengths from 1 to T,
   the cotangent of ys non-zero past each length: the forward's fp32
   tolerances and bf16 sanity check, and bf16 each step held from the
   kernel's own fp32 carries (an output the check asks for, from a
   launch whose dx, dh0 and dc0 must be bit-identical to the launch's
   without them) within the bounds, dx, the next carries, dh0 and dc0,
   with three wrong kernels refused: dx zeroed but in row 1; the carry
   into one step without the recurrent product for one CTA's units, dx
   recomputed from it; every carry rounded to bf16 (refused at every
   width, the LM's G H 4096 among them: the carry's bound sums at the
   kernel's own depth, ``scan_bounds.sum_depth``); past one tile of rows
   (B=224, B=48) the carry into one step of the second tile of rows taken
   from the first tile's, dx recomputed from it, and dx zeroed on the
   second tile's rows alone; dx_proj zero past each length, two calls
   bit-identical; times of the kernel, the plain version, the dW_h GEMM
   outside it (fp32) and cuDNN's ``torch.nn.GRU``/``torch.nn.LSTM``
   forward plus backward (timed only, never on the path) at the main
   shapes in bf16, and the backward's per-step floor (the fp32 LSTM's
   backward at H=1280 refused before any launch);
4g. the rel-pos flash kernel against ``relpos_attention_plain`` on the
   same folded inputs at Conformer-M's shape (B=64, H=4, T=250, Dh=64,
   D=256), Conformer-L's (H=8, D=512), a ragged T=37 (Dh=32, D=128) and
   the Conformer-Transducer's (B=128 at T=250 and at T=418, the
   LibriSpeech recipe's 16.7 s cap) and its streaming window's (B=1,
   T=128 with 126 valid: ``TransducerFrameASR``'s default 5.0 s
   buffer), lengths from 1 to T and one 0
   (clamped to 1): fp32 (TF32 off) context
   max abs err 2e-5 and lse 1e-5, bf16 against the plain version on the
   same bf16 inputs (which rounds the weights as the kernel and the TPU
   kernel do, against the running maximum of 128-key blocks) each
   element within ``relpos_attention_bound``, a planted fault (the
   context zeroed but in batch row 1) refused, lse within 1e-5 of max(1,
   |lse|), two calls bit-identical; the CTAs an SM holds of each bf16
   kernel at Conformer-M's and -L's widths; times of the kernel, the
   plain version and ``scaled_dot_product_attention`` on the
   materialised q~, k~ and v with the length mask (timed only, never on
   the path) at Conformer-M's shape, the transducer's and the streaming
   window's in bf16;
4h. the Conformer conv module kernel against
   ``conformer_conv_module_plain`` at Conformer-M's shape (B=64, T=250,
   D=256, k=31), at D=512, at an odd T=37 with a zero-length row and at
   the transducer's B=128, T=250 and 418 and the streaming window's B=1,
   T=128 with 126 valid: fp32 (TF32 off) max abs err 1e-4; bf16 (one fused launch after the
   weights' rounding pre-pass; its tile, shared memory and CTAs an SM
   printed) the kernel's u (written out by the CTA that owns the frame)
   held from x and y from that u within ``conformer_conv_module_bounds``
   (reading at most 1), the planted faults of ``fwd_faults`` (y zeroed
   but in row 1; a tile's y from u without its halo) refused, y
   bit-identical with u written out and at every other tile of frames
   that fits (other tile edges); two calls bit-identical; times of the
   kernel and the plain version, and of the module's unfused torch chain
   for information (no single PyTorch call computes the module), at
   Conformer-M's shape, the transducer's and the streaming window's;
   what it does not take it
   refuses, a tile that does not fit an SM too;
4i. the rel-pos flash backward kernels (dq, then dkv, after the forward
   kernel with its lse) against ``relpos_attention_bwd_plain`` at the
   shapes of 4g: fp32 (TF32 off) dqu, dqp, dk, dv max abs err 1e-4; bf16
   against the plain version on the same bf16 inputs (p and ds rounded
   where the kernels round them) each element within
   ``relpos_attention_bwd_bound`` and within twice it against the plain
   version's fp32 math, a planted fault (dv zeroed but in batch row 1)
   refused; two calls bit-identical; times of each kernel, the plain
   backward and ``scaled_dot_product_attention`` forward plus backward on
   the materialised q~, k~ (timed only, never on the path) at
   Conformer-M's shape and the transducer's in bf16; what the backward
   does not take, it refuses;
4j. the conv module backward kernels against
   ``conformer_conv_module_bwd_plain`` at the shapes of 4h: dx and the ten
   weight gradients, fp32 (TF32 off) within 1e-5 of max(1, |gradient|)
   (sums over up to 16,000 rows in another order); bf16 (six launches;
   their tiles, shared memory, CTAs an SM and the workspace printed) each
   of the kernels' fp32 intermediates (written out where asked for) held
   from the ones before it, dx and the ten weight gradients from them,
   within ``conformer_conv_module_bwd_bounds`` (db1, dwd, dw1 and dw2 at
   the kernels' summation depth: dw1 and dw2 at a split's rows of
   ``dw_splits`` and the splits' partials, so that one CTA's partial
   left out of dw1 reads well above 1 at every shape; reading at most
   1), the planted faults of
   ``bwd_faults`` (dx zeroed but in row 1; a CTA's partial left out of
   dw1 and of dwd; db1 from bf16 da) refused, the gradients bit-identical
   with the intermediates written out, the second launch's a the
   first's, and the intermediates, dx, dw1 and dw2 bit-identical at every
   other tile that fits; two calls bit-identical;
   times of the kernels and the plain version, and of the module's
   unfused torch chain forward plus backward under autograd as the
   yardstick, at Conformer-M's shape and the transducer's in bf16; what
   it does not take, it refuses;
5. a small fp32 Jasper on the card and on the CPU: eval outputs agree, and
   one ``train_step`` gives the same loss and updated weights (rtol 1e-4);
6. the eval/infer slice: Jasper-10x5 at full width from
   ``example_configs_torch/speech2text/jasper10x5_synthetic.py`` ("mixed"
   precision, synthetic batches of 32 x 1000 frames), a seeded-init
   checkpoint, then ``openseq2seq_tpu_torch.run.main`` in ``--mode=eval``
   and ``--mode=infer``: the forward kernel launches once per eval batch,
   the loss is finite and agrees with the plain version on the same
   logits, and the infer CSV has 128 rows;
7. the training slice: the same config through ``run.main`` in
   ``--mode=train`` for 20 steps: the loss is finite at every printed
   step and lower at the last than at the first, each kernel launches once
   per step, a checkpoint is written, ``--mode=eval`` runs from it, and
   ``--continue_learning`` takes 3 more steps from it; the train
   throughput is printed as information;
7b. the tiny fp32 transformer on the card (through the flash kernel) and
   on the CPU: teacher-forced logits within 1e-4, identical beams;
7c. transformer-big NMT from
   ``example_configs_torch/text2text/transformer_big_synthetic.py`` (d
   1024, 16 heads, 6 + 6 layers, V 32768, "mixed", beam 4, 2 batches of
   64 x 64 tokens), a seeded-init checkpoint, then ``run.main`` in
   ``--mode=eval`` and ``--mode=infer``: flash launches 18 per eval batch
   and 6 per infer batch, a finite loss, a BLEU, 128 infer lines; the
   beam-4 infer rate is printed as information;
7d. the tiny fp32 transformer training config on the card (through the
   flash kernels, forward and backward) and on the CPU, dropout 0: one
   ``train_step`` gives the same loss and updated weights (rtol 1e-4);
7e. transformer-big training from
   ``example_configs_torch/text2text/transformer_big_train_synthetic.py``
   (dropout on, u8 masks, the fused relu dropout, NovoGrad) through
   ``run.main --mode=train`` for 20 steps with the warmup cut to 20 steps
   (printed): the loss is finite at every step and falls, each step
   launches the flash forward 18 times, each flash backward kernel 18
   times and the dropout kernel 24 times (12 forward, 12 backward), a
   checkpoint is written, ``--mode=eval`` runs from it and
   ``--continue_learning`` takes 3 more steps; tokens per second are
   printed as information;
7f. the tiny fp32 DeepSpeech2 config on the card (through the GRU
   kernel, then with LSTM cells through the LSTM kernel, 4 launches each)
   and on the CPU: eval logits within 1e-4, identical greedy ids;
7g. DeepSpeech2-medium from
   ``example_configs_torch/speech2text/ds2_medium_synthetic.py`` (three
   2-D convs, 3 x 1024 bidirectional GRU, "mixed", 4 batches of 32 x
   1000 frames), a seeded-init checkpoint, then ``run.main`` in
   ``--mode=eval`` and ``--mode=infer``: the GRU kernel launches 6 times
   per batch, the CTC forward once per eval batch (never in infer), a
   finite loss equal to the plain CTC on the same logits, a WER, 128
   infer rows; eval utterances per second printed as information;
7h. ``example_configs_torch/speech2text/lstm_small_synthetic.py`` (4 x
   512 bidirectional LSTM) the same way, 8 LSTM launches per batch;
7i. the tiny fp32 DeepSpeech2 config, dropout off, tanh activations, on
   the card (GRU, then LSTM cells, 4 forward and 4 backward launches
   each) and on the CPU: one ``train_step`` gives the same loss and
   weights (rtol 1e-4);
7j. DeepSpeech2-medium through ``run.main --mode=train`` for its config's
   20 steps: the loss is finite at every step and falls, each step
   launches the GRU forward and backward kernels 6 times each and the CTC
   forward and backward once, a checkpoint is written, ``--mode=eval``
   runs from it and ``--continue_learning`` takes 3 more steps; the train
   throughput is printed as information;
7k. lstm_small the same way, 8 LSTM forward and 8 backward launches per
   step;
7l. the tiny fp32 Conformer config (both kernel flags on) on the card
   (2 rel-pos flash and 2 conv module launches) and on the CPU (their
   plain versions): eval logits within 1e-4, the same lengths and greedy
   ids;
7m. Conformer-M from ``example_configs_torch/speech2text/
   conformer_m_synthetic.py`` (16 blocks, d 256, 4 heads, k 31, "mixed",
   4 batches of 64 x 1000 frames), a seeded-init checkpoint, then
   ``run.main`` in ``--mode=eval`` and ``--mode=infer``: each kernel
   launches 16 times per batch, the CTC forward once per eval batch
   (never in infer), a finite loss equal to the plain CTC on the same
   logits, a WER, 256 infer rows; eval utterances per second printed as
   information;
7n. the tiny fp32 Conformer config, dropout off, on the card (2 launches
   of each Conformer kernel, forward and backward, a step) and on the CPU:
   three AdamW steps give the same losses and weights (rtol 1e-4, atol
   1e-5); then Conformer-M through ``run.main --mode=train`` for its
   config's 20 steps with the warmup cut to 20 (printed): the loss is
   finite at every step and falls, each step launches the rel-pos flash
   forward, dq and dkv kernels and the conv module forward and backward
   16 times each and the CTC forward and backward once, a checkpoint is
   written, ``--mode=eval`` runs from it and ``--continue_learning``
   takes 3 more steps; the train rate is printed as information;
7o. the tiny fp32 LSTM LM config (``example_configs_torch/lm/
   lstm_lm_tiny_synthetic.py``), dropout off and ``num_sampled`` 0, on the
   card (2 LSTM forward launches an eval step, 2 forward and 2 backward a
   train step) and on the CPU: eval logits within 1e-4 and the same loss,
   one Adam ``train_step`` gives the same loss and weights (rtol 1e-4,
   atol 1e-6; epsilon 1e-5); ``sampled_softmax_nll`` on the same inputs
   and candidate ids, one an accidental hit, the same loss and gradients;
7p. the LSTM language model from ``example_configs_torch/lm/
   lstm_wkt103_synthetic.py`` (V 267,744, embedding 320, 3 x 1024 LSTM,
   "mixed", 2 batches of 224 x 96 tokens), a seeded-init checkpoint, then
   ``run.main`` in ``--mode=eval`` and ``--mode=infer``: the LSTM forward
   kernel launches 3 times per batch and its backward never, a finite
   loss and a perplexity, 448 infer lines of 96 ids, one batch's loss
   equal to the plain fp64 NLL of the same fp32 logits (rtol 1e-5); the
   parameter count, the peak device memory and the eval tokens per second
   printed as information;
7q. the same config through ``run.main --mode=train`` for its 20 steps
   (8192 sampled candidates, dropout on): the loss is finite at every
   step and falls, each step launches the LSTM forward and backward
   kernels 3 times each, a checkpoint is written, ``--mode=eval`` runs
   from it and ``--continue_learning`` takes 3 more steps; the train
   tokens per second and the peak device memory printed as information;
7r. the Jasper-10x5 LibriSpeech recipe
   (``example_configs_torch/speech2text/jasper10x5_librispeech.py``, full
   width, "mixed", bf16 features, SpecAugment masks, dither, the feature
   cache) from wav files: a LibriSpeech-shaped corpus of 256 utterances
   of 10 s (``test_utils/fake_librispeech``, 8 batches of 32; the first
   64 its dev and test lists); the data layer's featurization rates alone
   over the first 128 (cold and warm cache on its thread pool, cold on a
   pool of worker processes); ``run.main --mode=train`` for 20 steps (the
   first epoch fills the cache, the later ones read it): the loss finite
   and falling,
   the CTC forward and backward once a step, the train rate in utt/s
   against the synthetic config's in phase 7; 6 more steps with
   ``--continue_learning`` under the profiler, the card's idle share over
   the last 4 (past the new process's cuDNN autotuning); ``--mode=eval``
   ("Validation WER" over the 64 dev utterances, the CTC forward once a
   batch) and ``--mode=infer`` (the CSV names each wav of the test list
   once, in order); rates with the card's name and power
   limit;
7s. the w2lplus toy recipe (``w2lplus_toy.py``, the 10 toy wavs) through
   ``run.main --mode=train_eval`` for 75 of its 150 epochs (cut for the
   script's clock): its last validation must read WER 0.0000; eval and
   infer from its checkpoint (the infer CSV's transcripts the toy
   sentences);
7t. the DeepSpeech2 toy (``ds2_toy_config.py``: its GRU fp32 at B 10,
   H 64 on the scan kernels, 2 forward and 2 backward launches a step)
   and the Conformer toy (``conformer_toy.py``, no kernel flag) from the
   toy wavs, each cut to 20 steps: the loss finite and falling, then eval
   and infer from the checkpoint;
7u. the transformer reversal toy (``example_configs_torch/text2text/
   nmt_reversal_toy.py``, 512 digit sequences) through ``run.main
   --mode=train_eval`` for 400 steps (its 100 epochs, 1,600 steps, cut
   for the script's clock; its BLEU passes 90 by step 400): its
   last "Validation BLEU" above 80 (NMT's toy run); eval and infer from
   its checkpoint (32 lines);
7v. the RNN reversal toy (``nmt_reversal_toy_rnn.py``: a bidirectional
   LSTM encoder, a Bahdanau attention LSTM decoder, beam 4) the same way
   for 400 steps (its 1,920 cut; BLEU 100.0 by step 400), its BLEU above
   80 too;
7w. transformer-big from text (``transformer_big_wmt.py``, every key of
   the JAX recipe, flash attention on) on a WMT-shaped corpus written
   first (``test_utils/fake_wmt``: 60,000 pairs, the recipe's 32K
   vocabulary, dev and test cut to 64 sentences): ``run.main --mode=train``
   for 20 steps of 256 sentence pairs with the warmup cut to 200 steps,
   the loss finite at every step and its mean over the last five steps
   below that over the first five, the flash forward, dq and dkv kernels 18
   times each a step, the parameter count and the peak device memory;
   eval from the checkpoint ("Validation BLEU" over the 64 dev sentences,
   18 flash launches a batch of 16) and infer (64 lines, 6 launches a
   batch);
7x. GNMT-like at full width from text (``en_de_gnmt_like_wmt.py``, every
   key of the JAX recipe) on the same corpus the same way: 20 steps of 32
   pairs, the LSTM forward and backward kernels 8 times each a step (the
   encoder's bidirectional layer and six unidirectional ones), eval with
   beam 10 ("Validation BLEU", 8 forward launches a batch) and infer (64
   lines);
7y. the tiny fp32 Tacotron config (``example_configs_torch/text2speech/
   tacotron_tiny_synthetic.py``), dropout and zoneout off, every prenet
   mask keeping, on the card (its LSTM on the scan kernels, 2 forward
   launches an eval batch, 2 and 2 a train step) and on the CPU: eval
   outputs within 1e-4, one Adam step the same loss and weights (rtol
   1e-4); then Tacotron-2 at full width (``tacotron2_synthetic.py``, the
   flagship recipe's widths: batch 48, 96 characters x 512 mel frames,
   "mixed", ``fused_rnn``) through ``run.main --mode=train`` for 10 steps:
   the loss finite at every step, the mean of the last five below that of
   the first five, the LSTM forward and backward kernels exactly 2 times
   each a step, the parameter count the JAX model's, the peak device
   memory and mel frames per second; ``--mode=eval`` from the checkpoint
   (2 batches, "Validation loss" with the attention's sharpness, 2 forward
   launches a batch), and one infer batch of 1,000 free-running frames
   through the model's eval step (every length at least 1, 2 forward
   launches), Griffin-Lim on its first example;
7z. Tacotron-2 with Global Style Tokens at full width
   (``tacotron_gst_synthetic.py``) through ``run.main --mode=train`` for
   3 steps: the GRU kernels 1 forward and 1 backward launch a step (the
   style encoder's GRU over 8 frames), the LSTM kernels 2 and 2;
7za. the Tacotron toy (``tacotron_toy.py``, the 10 tone wavs of
   ``test_utils/toy_tts``) through ``run.main --mode=train_eval`` for 225
   steps (the JAX test's 400 cut for the script's clock; the loss passes
   the bar near step 190) to a loss below 12.0 (the JAX package's bar),
   then eval and
   infer (a wav a toy sentence) from its checkpoint;
7zb. the tiny fp32 Conformer-Transducer (``conformer_transducer_tiny_
   synthetic.py``, both kernel flags on), dropout off, on the card and on
   the CPU: the lattice and fused losses of one batch and every
   parameter's gradient (card against CPU, fused against lattice), the
   greedy ids, lengths and emission frames identical, the beam of 4's best
   ids identical and its n-best scores within rtol 1e-4, one AdamW step's
   loss and weights;
7zc. the Conformer-Transducer at full width (``conformer_transducer_
   synthetic.py``: every key of scripts/bench_transducer.py, B 128 x 1000
   frames x 80, U 160, the fused loss) through ``run.main --mode=train``
   for 20 steps with the warmup cut to 20: the loss finite and falling
   (7n's rule), the rel-pos flash forward, dq and dkv and the conv module
   forward and backward exactly 16 times each a step, utt/s, the peak
   device memory beside the 3.1 GiB that the lattice's tanh input alone
   would hold; from the checkpoint the parameter count (the JAX model's),
   the fused and the lattice loss of one batch within rel 1e-3, eval
   (WER, loss) and, through ``conformer_transducer_decode_synthetic.py``,
   infer batches of 64, greedy and beam 4, each with its utt/s, device
   kernels, busy time and idle share;
7zd. the Conformer-Transducer's LibriSpeech recipe on a fake corpus of
   128 ten-second utterances: 10 training steps (16 launches of each
   Conformer kernel a step) and eval over the 64 dev utterances;
7ze. the transducer toy (``conformer_transducer_toy.py``) from the toy
   wavs through ``run.main --mode=train_eval`` to its end: the last
   validation's WER below 0.1, eval and infer from its checkpoint;
7zf. the WikiText-103 LSTM LM from text files (``example_configs_torch/
   lm/lstm_wkt103.py``, every key of the JAX recipe, ``fused_rnn``) on a
   corpus of WikiText-103's vocabulary written first
   (``test_utils/fake_wikitext``: 267,734 word types, ~3.3M training
   tokens; its aclImdb- and SST-2-shaped sets beside it), ``Corpus``'s
   build and cached times, V 267,736: ``run.main --mode=train`` for 20
   steps of 224 x 96 tokens (the loss finite at every step and falling,
   the LSTM kernels 3 forward and 3 backward launches a step, tokens per
   second, the peak device memory); ``--mode=eval`` from the checkpoint
   (3 forward launches a batch, a perplexity), one batch's loss against
   the plain fp64 NLL of its logits (rtol 1e-5); ``generate`` of 20 words
   from the checkpoint (B 1: the scan, no launch);
7zg. Transformer-XL at full width (``txl_wkt103.py``, every key of the
   JAX recipe: 16 layers, d 410, 10 heads, d_inner 2100, 64 x 192
   tokens, "mixed") on the same corpus: its parameter count the JAX
   model's (151,119,016, ``tests/test_torch_transformer_xl.py`` holds it
   with ``jax.eval_shape``); ``run.main --mode=train`` for 14 steps with
   the warmup cut to 1 step (the loss finite and falling, tokens per
   second, the peak device memory, the tied softmax's fp32 product timed
   beside a bf16 one); ``--mode=eval`` from the checkpoint (a perplexity,
   the peak device memory); two consecutive segments scored with
   ``mems`` against the 384-token context (the NLL of the second
   segment's tokens within rel 1e-2, bf16); ``NeuralRescorer`` over
   n-best lists with both LMs from their checkpoints (the LSTM LM's
   batch of 16 hypotheses on the LSTM kernels, 3 forward launches);
7zh. the IMDB transfer recipe (``example_configs_torch/transfer/
   imdb_wkt103.py``, fp32, batch 16, at most 256 words) from 7zf's
   checkpoint through ``load_model`` (the LM's embedding and LSTM
   tensors copied and equal to the checkpoint's, its softmax left out,
   the classifier drawn from the seed) on the generated review tree:
   ``run.main --mode=train_eval`` for 8 steps, "Validation accuracy",
   no LSTM kernel launch (no ``fused_rnn``: the scan, as in the JAX
   recipe);
7zi. the LM toy (``lstm_toy.py``, the cycle corpus of tests/test_lm.py)
   through ``run.main --mode=train_eval`` to its end: "Validation
   perplexity" below 2.0 (the LM family's toy run); then each new LM
   cell (SLSTM, FLSTM with ``num_proj``, LayerNormLSTM, GLSTM on the
   fp32 LSTM kernels at 128 units a group) and a tiny Transformer-XL
   with ``mems``, fp32, on the card against the CPU with the same
   weights: outputs, states and every gradient within rtol 1e-4, atol
   1e-5;
7zj. the tiny ResNet v2 and a tiny CNN (conv, batch norm, SAME max and
   average pools, dense), fp32, from one seed on the card and on the CPU:
   three NovoGrad steps (losses, weights, running statistics) and the
   eval logits within rtol 1e-4, atol 1e-5;
7zk. ResNet-50 v2 at ``scripts/bench_resnet.py``'s width
   (``example_configs_torch/image2label/resnet50_v2_synthetic.py``: 224 x
   224, batch 128, "mixed", NovoGrad, 1,000 classes) through ``run.main
   --mode=train`` for 20 steps with the warm-up cut to 10: the loss
   finite and falling on the repeated batch, 25,549,352 parameters (the
   JAX model's), images/s, the peak device memory, the memorised batch's
   top-1; ``--mode=eval`` and ``--mode=infer`` (128 csv rows) from its
   checkpoint;
7zl. AlexNet (``alexnet_owt_synthetic.py``: 227 x 227, batch 256) for 12
   steps: the loss finite, images/s, the peak device memory;
7zm. the CIFAR toy: ``cifar10_nv.py``'s network on a fake CIFAR-10 set
   (``test_utils/fake_cifar``, ten stripe classes) for 5 epochs at lr 0.003
   (the recipe's 0.05 diverges on it, in the JAX package too), then
   eval: top-1 above 0.9;
7zn. ``jasper_speech_commands.py`` and ``resnet_commands.py`` at full
   width on labelled tone clips (``test_utils/fake_speech_commands``, 8
   labels): 4 and 6 steps, the losses finite, then eval;
7zo. where Pillow is installed, ``resnet50_v2_imagenet.py`` on a fake
   ImageNet JPEG tree (``test_utils/fake_imagenet``) for one step and
   eval, and the TFRecord layer's eval batch equal to the JPEG layer's on
   the same images; without Pillow a line says so (the layers are then
   held on the CPU only); no image phase launches a kernel: the JAX
   image family reaches no ``pallas_call``;
7zp. the causal-convolution families (Centaur, WaveNet, ConvS2S), whose
   paths reach no ``pallas_call`` and launch no kernel (each checked):
   the tiny Centaur (windowed infer forced) and tiny WaveNet, fp32, card
   against CPU from one seed: eval outputs, the infer decode and two
   training steps within rtol 1e-4, atol 1e-5;
7zq. Centaur at ``centaur_float.py``'s width
   (``centaur_synthetic.py``: 32 x 96 characters x 512 frames of 80 mel
   bins, fp32, NovoGrad): 20 training steps (the JAX model's parameter
   count, the loss falling), eval, an infer batch of 200 frames (100
   re-runs of the stack), and again at ``window_size`` 1, whose
   alignments must be one-hot;
7zr. ``wavenet_LJ.py`` at full width (4 x 10 gated layers of 64 filters,
   256 channels, 16,384-sample chunks, "mixed") on a ``fake_ljspeech``
   tree of 64 clips: 20 training steps, eval, infer (a wav a clip); then
   ``wavenet_generate`` of 4,096 samples at B 2, fp32, conditioned on
   mel frames, sampled (more than 8 distinct ids), its logits against
   the parallel net's on the generated audio within atol 2e-4, rtol 1e-3
   (the JAX test's), samples/s;
7zs. the Centaur toy: ``centaur_float.py``'s network on the same tree for
   25 steps, the loss falling, eval, infer (a wav a text);
7zt. the WaveNet toy (``wavenet_toy.py``) to a loss below 3.0 in 200
   steps (the JAX test's bar), eval, infer;
7zu. the tiny ConvS2S, fp32, card against CPU: eval logits, beam-3 ids,
   two Momentum steps;
7zv. ``en_de_convs2s_wmt.py`` at full width (15 + 15 GLU blocks of 512 to
   2,048 channels, V 32,768, batch 64, "mixed", 8-bit masks) on the
   WMT-shaped corpus: 20 training steps at lr 0.05 (the recipe's 0.5 with
   momentum 0.99 swings the loss over 20 steps; the JAX model's parameter
   count), the beam-5 eval of one dev batch of 16, infer over 16 test
   sentences;
7zw. the ConvS2S reversal toy, 400 of its 1,920 steps (BLEU 100.0 by
   step 400), to "Validation BLEU" above 70 (the JAX test's bar);
7zx. the CR and RC toys (ConvS2S encoder and RNN decoder, and the other
   way round) for 20 steps each, then eval;
7zy. the tiny LAS (``las_tiny.py`` at H 64, fp32: the listener's LSTM on
   B3's fp32 path) and the tiny JCA (``jca_tiny.py``: its CTC half on B1a
   and B1b), dropout off, card against CPU from one seed: eval logits
   (and LAS's alignments), two Adam steps, the beam decode's ids, within
   rtol 1e-4, atol 1e-5, and their launches;
7zz. ``ctc_cuda.check_fits`` at JCA's shape (L 240 and 241, V 30), then
   ``las_large_librispeech.py`` at full width ("mixed", the listener's
   three BiLSTMs on B3) on a LibriSpeech-shaped corpus of 256 utterances
   of 16.0 s with 240-character transcripts: 20 training steps of 64
   (B3 6 forward and 6 backward launches a step), the last 3 traced (the
   idle share), utt/s and the peak memory; eval over the
   64 dev utterances ("Validation WER", B3 6) and a beam-4 infer batch
   of the 64 test utterances (a CSV row a wav, B3 6);
7zza. ``jca_large_8gpus.py`` at full width (fp32) the same way: B1a 1 and
   B1b 1 launch a step, B1a 1 an eval batch;
7zzb. the LAS toy (``las_toy.py``, 150 epochs of the 10 toy utterances)
   to a last training loss below 0.5 (``tests/test_las_jca.py``'s bar),
   in a process of its own beside 7zz's evals and 7zzc;
7zzc. Jasper-10x5 in infer (``jasper10x5_beam_librispeech.py``: the
   on-device prefix beam 16 fused with a character 3-gram) at B 32, T'
   500: its top beam's ids equal the CPU beam's on the same logits; then
   ``infer_logits_to_pickle`` and ``scripts_torch/decode.py`` with the
   native decoder and a word 2-gram from ``scripts_torch/build_lm.py``;
7zzd. the tiny QuartzNet (``quartznet_tiny_synthetic.py``: separable
   blocks, NovoGrad, cosine decay, ``use_pallas``), card against CPU,
   fp32: eval logits and loss, two train steps' losses and weights;
7zze. QuartzNet-15x5 at full width: ``quartznet15x5_synthetic.py`` (B 32,
   1,670 frames, T' 835, L 240) for 14 steps, the last 3 traced (utt/s,
   idle share, peak memory; B1a 1 and B1b 1 launches a step) and an eval
   of its 4 batches; then ``quartznet15x5_librispeech.py`` on a
   LibriSpeech-shaped corpus of 128 utterances of 16.0 s with
   240-character transcripts, 14 steps the same way and an eval over the
   64 dev utterances; the warmup cut to 20 steps in both;
7zzf. ``jasper_mini.py`` (separable blocks, no ``use_pallas``: no kernel)
   for 5 steps on the same corpus;
7zzg. Jasper-10x5's recipe from the same wavs with ``featurize_on_device``
   (the log-mel features on the card) and then featurized on the host,
   SpecAugment off in both (the JAX layer refuses it on the device path)
   and the feature cache off: utt/s and idle share side by side, for
   information;
7zzh. ``w2lplus_toy_ondevice.py`` to "Validation WER: 0.0000" in 75 of
   its 150 epochs;
7zzi. streaming over a trained toy (``tests/test_asr_inference_stack.py``'s
   recipe: ``w2l_test_config`` with the corpus's feature statistics, 150
   epochs) at each of 6 seeds, 3 processes at a time: ``FrameASR``
   greedy, host beam 8 and
   device beam 8 each within 3 edits of "abc bca" at one seed at least
   (the recipe passes at some seeds only, in both packages), the two
   beams equal at every seed;
7zzj. streaming at full width on random weights: ``FrameASR`` over
   Jasper-10x5 (greedy, device beam 16) and ``TransducerFrameASR`` over
   the Conformer-Transducer recipe (B5 and B6 forward 16 launches a
   window at B 1, T' 128 with 126 valid), ms a 0.2 s frame;
7zzk. the GatedConv toy (``gatedconv_toy.py``) to an eval loss below 1.0
   (``tests/test_extending_tutorial.py``'s bar);
7zzl. serving (``openseq2seq_tpu_torch/serving``): the int8 products
   (``torch._int_mm``) against bf16 ``torch.mm`` at the scoring step's
   shapes (M 4096; K, N of 512, 1536, 2048), then transformer-base
   teacher-forced scoring at ``scripts/bench_serving.py``'s width
   (``transformer_base_serving_synthetic.py``: B 64, T 64, V 32768,
   "mixed", ``train=True`` with every dropout rate 0): eagerly (exactly 18
   B7 forward launches a batch, tokens/s, the step's idle share), from
   the fp artifact reloaded in a fresh interpreter that imports only
   ``openseq2seq_tpu_torch.serving`` (18 launches a batch, logits within
   1e-5 of eager), from the int8 weight-only artifact (its size against
   the fp one's, the JAX test's bars) and with int8 activations live and
   from an artifact (72 calibrated layers, 72 int8 products a live batch
   and 72 ``_int_mm`` nodes in the artifact, the artifact within 1e-5 of
   the live int8 path on the dequantized weights, argmax agreement >=
   0.97, max |d| < 0.35 std, each layer bit for bit its float64 plain
   version, one layer's x_scale doubled refused), tokens/s and the
   speedup over bf16, measured with ``scripts_torch/bench_serving.py``'s
   helpers;
7zzm. Jasper-10x5's eval forward (``jasper10x5_synthetic.py``) exported
   at full width and reloaded: logits and greedy ids equal to eager; with
   the on-device beam of width 4 at T' 32 (B 32): ids and lengths equal,
   scores within 1e-5, the export's seconds;
8. one JSON line for the kernels (the LSTM scans' entries with their
   times at the LM's shape under ``at_lm_shape``, at GNMT's under
   ``at_gnmt_shape``, at Tacotron-2's under ``at_tacotron_shape`` and at
   the LAS listener's (B 64, H 512, T 400 and 200) under
   ``at_las_shape`` and ``at_las_pyramid_shape``; the GRU scans' at
   GST's under ``at_gst_shape``; the CTC kernels' at JCA's B 64, T' 401,
   L 241, V 30 under ``at_jca_shape`` and at QuartzNet's B 32, T' 835, L
   240 under ``at_quartznet_shape``; the rel-pos flash and conv module
   kernels' at the transducer's B 128, T' 250 and 418 under
   ``at_transducer_shape`` and the forward kernels' at the streaming
   window's B 1, T' 128 under ``at_streaming_shape``; the flash forward's
   at the serving shape, B 64, H 8, T 64, D 64, under
   ``at_serving_shape``), then ``{"ok": true, "device": ...}`` last.

Each path is driven with the launch counts set to 0 just before it and
read just after. Any failed check raises, and the script exits non-zero
without the last line. It needs a CUDA device and refuses to run without
one.
"""
from __future__ import annotations

import contextlib
import copy
import csv
import io
import json
import math
import os
import re
import runpy
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "example_configs_torch", "speech2text",
                      "jasper10x5_synthetic.py")
NMT_CONFIG = os.path.join(REPO, "example_configs_torch", "text2text",
                          "transformer_big_synthetic.py")
NMT_TINY = os.path.join(REPO, "example_configs_torch", "text2text",
                        "transformer_tiny_synthetic.py")
NMT_TRAIN = os.path.join(REPO, "example_configs_torch", "text2text",
                         "transformer_big_train_synthetic.py")
NMT_TINY_TRAIN = os.path.join(REPO, "example_configs_torch", "text2text",
                              "transformer_tiny_train_synthetic.py")
DS2_MEDIUM = os.path.join(REPO, "example_configs_torch", "speech2text",
                          "ds2_medium_synthetic.py")
LSTM_SMALL = os.path.join(REPO, "example_configs_torch", "speech2text",
                          "lstm_small_synthetic.py")
DS2_TINY = os.path.join(REPO, "example_configs_torch", "speech2text",
                        "ds2_tiny_synthetic.py")
CONFORMER_M = os.path.join(REPO, "example_configs_torch", "speech2text",
                           "conformer_m_synthetic.py")
CONFORMER_TINY = os.path.join(REPO, "example_configs_torch", "speech2text",
                              "conformer_tiny_synthetic.py")
LM_CONFIG = os.path.join(REPO, "example_configs_torch", "lm",
                         "lstm_wkt103_synthetic.py")
LM_TINY = os.path.join(REPO, "example_configs_torch", "lm",
                       "lstm_lm_tiny_synthetic.py")
LIBRI_CONFIG = os.path.join(REPO, "example_configs_torch", "speech2text",
                            "jasper10x5_librispeech.py")
W2L_TOY = os.path.join(REPO, "example_configs_torch", "speech2text",
                       "w2lplus_toy.py")
DS2_TOY = os.path.join(REPO, "example_configs_torch", "speech2text",
                       "ds2_toy_config.py")
CONFORMER_TOY = os.path.join(REPO, "example_configs_torch", "speech2text",
                             "conformer_toy.py")
NMT_TOY = os.path.join(REPO, "example_configs_torch", "text2text",
                       "nmt_reversal_toy.py")
NMT_TOY_RNN = os.path.join(REPO, "example_configs_torch", "text2text",
                           "nmt_reversal_toy_rnn.py")
NMT_WMT = os.path.join(REPO, "example_configs_torch", "text2text",
                       "transformer_big_wmt.py")
GNMT_WMT = os.path.join(REPO, "example_configs_torch", "text2text",
                        "en_de_gnmt_like_wmt.py")
# the recipes' parameter counts at the 32,768 vocabulary
TACOTRON = os.path.join(REPO, "example_configs_torch", "text2speech",
                        "tacotron2_synthetic.py")
TACOTRON_GST = os.path.join(REPO, "example_configs_torch", "text2speech",
                            "tacotron_gst_synthetic.py")
TACOTRON_TINY = os.path.join(REPO, "example_configs_torch", "text2speech",
                             "tacotron_tiny_synthetic.py")
TACOTRON_TOY = os.path.join(REPO, "example_configs_torch", "text2speech",
                            "tacotron_toy.py")
TRANSFORMER_PARAMS = 209915904
GNMT_PARAMS = 308382720
# Tacotron-2 and its GST variant at the recipes' width: the JAX models'
# parameter counts by ``jax.eval_shape`` of their init
# (``tests/test_torch_tacotron.py::test_full_width_parameter_counts``)
TACOTRON_PARAMS = 26042529
GST_PARAMS = 27630465
# the Conformer-Transducer at bench_transducer.py's width: the JAX model's
# count by ``jax.eval_shape`` of its init
# (``tests/test_torch_transducer_model.py::test_full_width_parameter_count``)
TRANSDUCER_PARAMS = 26796701
# the causal-convolution families at their recipes' width: the JAX models'
# counts by ``jax.eval_shape`` of their init
# (``tests/test_torch_{convs2s,centaur,wavenet}.py``)
CONVS2S_PARAMS = 208802816
WAVENET_PARAMS = 1805696
CENTAUR_PARAMS = 9932194
TRANSDUCER = os.path.join(REPO, "example_configs_torch", "speech2text",
                          "conformer_transducer_synthetic.py")
TRANSDUCER_DECODE = os.path.join(REPO, "example_configs_torch",
                                 "speech2text",
                                 "conformer_transducer_decode_synthetic.py")
TRANSDUCER_TINY = os.path.join(REPO, "example_configs_torch", "speech2text",
                               "conformer_transducer_tiny_synthetic.py")
TRANSDUCER_LIBRI = os.path.join(REPO, "example_configs_torch", "speech2text",
                                "conformer_transducer_librispeech.py")
TRANSDUCER_TOY = os.path.join(REPO, "example_configs_torch", "speech2text",
                              "conformer_transducer_toy.py")
# transformer_policy recipes warm up over thousands of steps (transformer-
# big 8000: lr under 2e-6 for 20 steps; Conformer-M 10,000); the smoke
# runs cut the warmup so that the loss falls within their 20 steps
WARMUP_OVERRIDE = "--lr_policy_params/warmup_steps=20"
RTOL = 1e-5
# fp32 operations per live CTC lattice state: the forward's log-sum-exp
# of up to three predecessors plus the emission (2 max, 3 sub, 3 exp,
# 2 add, 1 log, 1 add); the backward's beta recursion the same, plus the
# posterior exp(alpha + beta - logZ), its normalization and its scatter
CTC_OPS_FWD = 12
CTC_OPS_BWD = 17


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + what)


# a head start for the host in cuda_ms: about 20 ms at the H100's clocks
SLEEP_CYCLES = 40_000_000


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds of one ``fn()``: ``reps`` calls enqueued back
    to back behind a sleep kernel, between two CUDA events, over ``reps``.
    The sleep lets the host enqueue ahead of the card, so that a short
    kernel is timed without its wrapper's host time (an event pair around
    each synchronised call would add it); code that launches slower than
    the card runs it is still timed at its launch rate."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ctc_case(B, T, L, V, seed, device):
    """fp32 logits and int32 lengths/labels on ``device`` with mixed
    lengths, an empty label (row 1), one repeated symbol (row 2) and an
    infeasible row (row 3)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(B, T, V)).astype(np.float32)
    logit_lens = rng.randint(int(0.7 * T), T + 1, size=B).astype(np.int32)
    labels = rng.randint(0, V - 1, size=(B, L)).astype(np.int32)
    label_lens = rng.randint(L // 2, L + 1, size=B).astype(np.int32)
    label_lens[1] = 0
    labels[2, :] = labels[2, 0]
    logit_lens[2], label_lens[2] = T, min(L, (T + 1) // 2)
    logit_lens[3], label_lens[3] = max(L // 2, 1), L
    return [torch.from_numpy(a).to(device)
            for a in (logits, logit_lens, labels, label_lens)]


def ctc_chunk_case(device, seed=41):
    """Like ``ctc_case`` (B=12, T=41, L=6, V=29), with lengths that end on
    either side of the CTC kernels' chunk edges: the forward's chunks of
    CHUNK = 32 frames start at frames 1, 33, the backward's at len - 1,
    len - 33, ... Row 1 keeps an empty label, row 2 a repeated symbol;
    every row is feasible."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    logit_lens = np.array([41, 34, 33, 32, 31, 18, 17, 16, 15, 9, 2, 1],
                          dtype=np.int32)
    B, T, L, V = len(logit_lens), 41, 6, 29
    logits = (2.0 * rng.randn(B, T, V)).astype(np.float32)
    labels = rng.randint(0, V - 1, size=(B, L)).astype(np.int32)
    label_lens = np.minimum(rng.randint(1, 5, size=B),
                            logit_lens // 2).astype(np.int32)
    label_lens[1], label_lens[2] = 0, 4
    labels[2, :] = labels[2, 0]
    return [torch.from_numpy(a).to(device)
            for a in (logits, logit_lens, labels, label_lens)]


# name, (B, T, L[, V]) or None for ctc_chunk_case: the CTC kernels'
# checks (V 29 where it is left out); "jca" is JCA's CTC half at its
# recipe's shape: B 64, T' 401 after two stride-2 convs of 16 s, the 241
# columns of 240-character targets without <S>, V 30 (blank 29);
# "quartznet" is QuartzNet-15x5's at its recipe's longest utterance: B
# 32, T' 835 after the stride-2 prologue of 16.7 s, 240-character
# transcripts
CTC_CASES = (("jasper", (32, 500, 160)), ("conformer-m", (64, 250, 160)),
             ("L=600", (8, 1400, 600)), ("T=37", (8, 37, 12)),
             ("chunk edges", None), ("jca", (64, 401, 241, 30)),
             ("quartznet", (32, 835, 240)))
# the cases whose kernel times (and F.ctc_loss's) are kept: the kernels
# line's own, its ``at_jca_shape`` and ``at_quartznet_shape``
CTC_TIMED = ("jasper", "jca", "quartznet")
CTC_JCA = {}
CTC_QUARTZNET = {}
CTC_SHAPE_TIMES = {"jca": CTC_JCA, "quartznet": CTC_QUARTZNET}


def ctc_check_case(name, shape, seed, dev):
    if shape is None:
        return ctc_chunk_case(dev, seed)
    B, T, L = shape[:3]
    return ctc_case(B, T, L, shape[3] if len(shape) > 3 else 29, seed, dev)


def phase_kernel(card):
    import torch
    from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
    dev = torch.device("cuda")
    worst_abs = 0.0
    timing = None
    for L, V in ((160, 29), (600, 29), (241, 30), (240, 29)):
        print("[kernel] resources at L={}, V={}: {}".format(
            L, V, ctc_cuda.ctc_resources(L, V)), flush=True)
    for name, shape in CTC_CASES:
        case = ctc_check_case(name, shape, shape[1] if shape else 41, dev)
        B, T, _ = case[0].shape
        L = case[2].shape[1]
        got = ctc_cuda.ctc_loss_cuda(*case, average_across_batch=False)
        want = ctc.ctc_loss(*case, average_across_batch=False)
        torch.cuda.synchronize()
        feasible = ctc.feasible_rows(case[1], case[2], case[3])
        if shape is not None:
            check(bool(torch.all(feasible[[0, 1, 2]])) and
                  not bool(feasible[3]), "{}: edge rows".format(name))
        check(bool(torch.all(got[~feasible] == 0)) and
              bool(torch.all(want[~feasible] == 0)),
              "{}: infeasible rows not zero".format(name))
        check(bool(torch.all(torch.isfinite(got))),
              "{}: non-finite NLL".format(name))
        abs_err = (got - want).abs()
        rel_err = float((abs_err[feasible] / want[feasible].abs()).max())
        worst_abs = max(worst_abs, float(abs_err.max()))
        print("[kernel] {} B={} T={} L={} S={}: max rel err {:.3e}, "
              "max abs err {:.3e} (NLL ~{:.1f})".format(
                  name, B, T, L, 2 * L + 1, rel_err, float(abs_err.max()),
                  float(want[feasible].mean())), flush=True)
        check(rel_err <= RTOL, "{}: rel err {} > {}".format(
            name, rel_err, RTOL))
        if name in CTC_TIMED:
            lp = ctc.log_probs(case[0]).contiguous()
            args = (lp, case[1], case[2], case[3], case[0].shape[2] - 1)
            times = (cuda_ms(lambda: ctc_cuda.ctc_nll_cuda(*args), 50),
                     cuda_ms(lambda: ctc_cuda.ctc_nll_plain(*args), 10))
            print("[kernel] {} eval shape: kernel {:.4f} ms, plain {:.4f} "
                  "ms (CUDA events, back to back; {})".format(
                      name, *times, card), flush=True)
            if name == "jasper":
                timing = times
            else:
                CTC_SHAPE_TIMES[name]["fwd_ms"], \
                    CTC_SHAPE_TIMES[name]["fwd_plain_ms"] = times
    # what the kernel does not take, it refuses
    lp = ctc.log_probs(ctc_case(4, 9, 3, 29, 0, dev)[0])
    n = torch.full((4,), 9, dtype=torch.int32, device=dev)
    lab = torch.ones((4, 3), dtype=torch.int32, device=dev)
    for bad in ((lp.double(), n, lab, n), (lp.transpose(0, 1), n, lab, n),
                (lp, n.long(), lab, n)):
        try:
            ctc_cuda.ctc_nll_cuda(*bad, 28)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad input launched")
    # a label length whose CTA does not fit an SM: refused, nothing counted
    big = torch.ones((4, 3000), dtype=torch.int32, device=dev)
    before = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
    res = ctc_cuda.ctc_resources(3000, 29)
    for fn in (lambda: ctc_cuda.alpha_fwd(lp, n, big, n, 28, False),
               lambda: ctc_cuda.beta_bwd(
                   lp, n, big, n, 28, torch.zeros(4, device=dev),
                   torch.zeros((4, 9, 6001), device=dev))):
        try:
            fn()
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: L=3000 launched")
    check((ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES) == before and
          res["fwd"][4] == 0 and res["bwd"][4] == 0,
          "L=3000: counted or reported to fit: {}".format(res))
    print("[kernel] wrong dtype and layout are refused; L=3000 refused "
          "before any launch ({})".format(res), flush=True)
    return worst_abs, timing


def phase_backward(card):
    """The backward's two launches after the forward with its lattice,
    against the plain versions on the card (``ctc_cuda.readings``): the
    NLL, d log-probs and their zeros and sums against ``ctc_nll_grad``'s
    composition, the first launch's posteriors against ``ctc_posteriors``
    on the kernel forward's own NLL and lattice; and the planted faults of
    ``ctc_cuda.planted_faults``, which the same readings must refuse."""
    import torch
    from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
    dev = torch.device("cuda")
    worst_abs = 0.0
    timing = None
    for name, shape in CTC_CASES:
        logits, lens, labels, label_lens = ctc_check_case(
            name, shape, shape[1] + 1 if shape else 42, dev)
        B, T, _ = logits.shape
        L = labels.shape[1]
        lp = ctc.log_probs(logits).contiguous()
        args = (lp, lens, labels, label_lens, logits.shape[2] - 1)

        def kernels():
            nll, lattice = ctc_cuda.alpha_fwd(*args, True)
            return (nll, lattice) + ctc_cuda.beta_bwd(*args, nll, lattice,
                                                      posteriors=True)

        nll, lattice, got, post = kernels()
        again = kernels()[2]
        plain = ctc_cuda.plain_results(*args)
        want = {"nll": plain["nll"], "dlp": plain["dlp"],
                "post": ctc.ctc_posteriors(*args, nll, lattice)}
        torch.cuda.synchronize()
        reads = ctc_cuda.readings({"nll": nll, "dlp": got, "post": post},
                                  want, lens, labels, label_lens)
        worst_abs = max(worst_abs, reads["dlp"] * ctc_cuda.DLP_ATOL)
        print("[backward] {} B={} T={} L={}: NLL max rel err {:.3e}, "
              "dlogprobs max abs err {:.3e}, |sum_v dlp + 1| max {:.3e}, "
              "posteriors max abs err {:.3e}, repeat bit-identical: {}; "
              "readings {}".format(
                  name, B, T, L, reads["nll"] * ctc_cuda.NLL_RTOL,
                  reads["dlp"] * ctc_cuda.DLP_ATOL,
                  reads["sums"] * ctc_cuda.SUM_ATOL,
                  reads["post"] * ctc_cuda.POST_ATOL,
                  bool(torch.equal(got, again)),
                  {k: round(v, 4) for k, v in reads.items()}), flush=True)
        check(reads["nll"] <= 1, "{}: NLL rel err".format(name))
        check(reads["dlp"] <= 1, "{}: dlogprobs abs err".format(name))
        check(reads["zeros"] <= 1, "{}: gradient not zero on infeasible "
              "rows or past the length".format(name))
        check(reads["sums"] <= 1, "{}: posteriors sum to 1".format(name))
        check(reads["post"] <= 1, "{}: posteriors abs err".format(name))
        check(bool(torch.equal(got, again)), "{}: two calls differ".format(
            name))
        if name in ("jasper", "conformer-m", "chunk edges", "jca",
                    "quartznet"):
            faults = ctc_cuda.planted_faults(*args, plain)
            worst = {k: max(ctc_cuda.readings(f, plain, lens, labels,
                                              label_lens).values())
                     for k, f in faults.items()}
            print("[backward] {} planted faults, largest reading each: {}"
                  .format(name, {k: round(v, 1) for k, v in worst.items()}),
                  flush=True)
            check(len(worst) == 4, "{}: faults missing".format(name))
            check(all(v > 1 for v in worst.values()),
                  "{}: a planted fault passed: {}".format(name, worst))
        if name in CTC_TIMED:
            nll, lattice = ctc_cuda.alpha_fwd(*args, True)
            times = (cuda_ms(kernels, 50),
                     cuda_ms(lambda: ctc.ctc_nll_grad(*args), 5),
                     cuda_ms(lambda: ctc_cuda.beta_bwd(*args, nll, lattice),
                             50),
                     cuda_ms(lambda: ctc_cuda.alpha_fwd(*args, True), 50))
            print("[backward] {} train shape: kernels fwd+bwd {:.4f} ms, "
                  "plain fwd+bwd {:.4f} ms; backward kernels alone {:.4f} "
                  "ms, forward with lattice {:.4f} ms (CUDA events, back to "
                  "back; {})".format(name, *times, card), flush=True)
            if name == "jasper":
                timing = times
            else:
                CTC_SHAPE_TIMES[name]["bwd_ms"], \
                    CTC_SHAPE_TIMES[name]["bwd_plain_ms"] = times[:2]
    return worst_abs, timing


# H100 SXM data sheet: HBM rate and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

# name, B, Tq, Tk, H, D, causal, key padding. The first three are the
# transformer-big eval path's shapes (encoder self-attention; decoder
# causal self-attention and cross-attention over the 63 teacher-forced
# positions); the rest cover a ragged causal tile, D = 128 and 256 and a
# long key axis.
FLASH_CASES = (
    ("encoder", 64, 64, 64, 16, 64, False, True),
    ("decoder causal", 64, 63, 63, 16, 64, True, False),
    ("cross", 64, 63, 64, 16, 64, False, True),
    ("causal T=113", 8, 113, 113, 16, 64, True, False),
    ("D=128", 8, 100, 130, 8, 128, False, True),
    ("D=256", 4, 70, 200, 4, 256, False, True),
    ("Tk=1000", 4, 64, 1000, 8, 64, False, True),
    # transformer-base scoring's encoder self-attention (serving, 7zzl)
    ("serving", 64, 64, 64, 8, 64, False, True),
)
FLASH_FP32_ATOL = 2e-5
FLASH_BF16_ATOL = 1e-2
# bf16 kernels against the rounding plain versions: each output element
# within flash_attention_bound / flash_attention_bwd_bound, built from its
# own terms (one bf16 ulp of each rounded weight or ds that may round the
# other way, the fp32 sums in another order, one ulp of the element); the
# reading is the largest |kernel - plain| / bound, at most 1. Against the
# plain version's fp32 math (nothing rounded but the output) a gradient
# may sit twice the bound away: once for the kernel against the rounding
# plain version, once for that against fp32 math (half an ulp of each
# rounded operand and of the output).
FLASH_BWD_BF16_FP32_MATH_BOUNDS = 2.0


def bound_reading(got, want, bound):
    """The largest |got - want| / bound; an element whose bound is 0 (a
    masked key's gradient) must match exactly."""
    import torch
    err = (got.float() - want.float()).abs()
    return float(torch.where(err > 0, err / bound, 0.0).max())


def planted_fault_reading(x, want, bound):
    """The reading of ``x`` with every batch row but row 1 (the one with a
    single valid key where the case pads) zeroed: a fault the bound must
    refuse."""
    bad = x.clone()
    bad[:1] = 0
    bad[2:] = 0
    return bound_reading(bad, want, bound)


def flash_case(B, Tq, Tk, H, D, padded, seed, device):
    """Unit-scale fp32 q, k ~ N(0, 1) and v ~ U(-1, 1) in (B, T, H, D),
    and a (B, Tk) key-valid mask (None without padding) with row 0
    unpadded and row 1 keeping one key."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    q, k = (torch.randn((B, T, H, D), generator=g, device=device)
            for T in (Tq, Tk))
    v = 2 * torch.rand((B, Tk, H, D), generator=g, device=device) - 1
    if not padded:
        return q, k, v, None
    lengths = torch.randint(max(Tk // 2, 1), Tk + 1, (B,), generator=g,
                            device=device)
    lengths[0] = Tk
    if B > 1:
        lengths[1] = 1
    valid = torch.arange(Tk, device=device)[None, :] < lengths[:, None]
    return q, k, v, valid.contiguous()


def attention_pairs(q, k, kv_valid, causal) -> int:
    """(query, key) pairs that the attention's result depends on: valid
    keys times queries, or the causal triangle."""
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    if causal:
        return B * sum(min(i + 1, Tk) for i in range(Tq))
    if kv_valid is not None:
        return int(kv_valid.sum()) * Tq
    return B * Tq * Tk


def bound_ms(nbytes, flop, dtype):
    """The larger of ``nbytes`` over the HBM rate and ``flop`` over the
    peak of ``dtype``: (ms, "bytes" | "operations")."""
    import torch
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / peak
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def attention_bound_ms(q, k, kv_valid, causal):
    """The least time of one attention call on the H100 in its dtype:
    q, k, v, o (and the mask) read or written once, 4 D FLOP per (query,
    valid key) pair."""
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if kv_valid is not None:
        nbytes += kv_valid.numel()
    flop = 4.0 * q.shape[2] * q.shape[3] * attention_pairs(q, k, kv_valid,
                                                           causal)
    return bound_ms(nbytes, flop, q.dtype)


def attention_bwd_bound_ms(q, k, kv_valid, causal, kernel):
    """The least time of one backward kernel: ``dq`` reads q, k, v, o, dO,
    lse and writes dq and di, 6 D FLOP per pair (scores, dO.v, dq);
    ``dkv`` reads q, k, v, dO, lse, di and writes dk and dv, 8 D FLOP per
    pair (scores, dO.v, dv, dk); ``all`` is the whole backward: q, k, v,
    o, dO and lse read, dq, dk, dv written, 10 D FLOP per pair."""
    B, Tq, H, D = q.shape
    nq, nk = q.numel() * q.element_size(), k.numel() * k.element_size()
    rows = B * H * Tq * 4                    # lse or di, fp32
    mask = 0 if kv_valid is None else kv_valid.numel()
    nbytes, per_pair = {"dq": (4 * nq + 2 * nk + 2 * rows + mask, 6),
                        "dkv": (2 * nq + 4 * nk + 2 * rows + mask, 8),
                        "all": (4 * nq + 4 * nk + rows + mask, 10)}[kernel]
    flop = per_pair * H * D * attention_pairs(q, k, kv_valid, causal)
    return bound_ms(nbytes, flop, q.dtype)


def phase_flash(card):
    """``flash_attn_fwd`` against ``flash_attention_plain`` on the card:
    fp32 (TF32 off, the CUDA-core kernel) within FLASH_FP32_ATOL; bf16 (the
    tensor-core kernel) against the rounding plain version
    (``round_weights=True``) within ``flash_attention_bound``, element by
    element, and refusing a planted fault, two calls
    bit-identical, and against the plain version's fp32 math on the same
    bf16 inputs within FLASH_BF16_ATOL (the weights' rounding moves an
    output by at most 2^-9 of the mass, the output's own rounding by 2^-9).
    Times at the eval path's shapes, in bf16, against the rounding plain
    version and SDPA. Returns the worst bf16 error against the rounding
    plain version and the timings, by case name."""
    import torch
    import torch.nn.functional as F
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    worst = 0.0
    times = {}
    for i, (name, B, Tq, Tk, H, D, causal, padded) in enumerate(
            FLASH_CASES):
        q, k, v, valid = flash_case(B, Tq, Tk, H, D, padded, i, dev)
        got = fa.flash_attention(q, k, v, valid, causal)
        want = fa.flash_attention_plain(q, k, v, valid, causal)
        qb, kb, vb = (x.bfloat16() for x in (q, k, v))
        got_b = fa.flash_attention(qb, kb, vb, valid, causal)
        again = fa.flash_attention(qb, kb, vb, valid, causal)
        want_r = fa.flash_attention_plain(qb, kb, vb, valid, causal,
                                          round_weights=True)
        want_b = fa.flash_attention_plain(qb.float(), kb.float(),
                                          vb.float(), valid, causal)
        bound = fa.flash_attention_bound(qb, kb, vb, valid, causal)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_r = float((got_b.float() - want_r.float()).abs().max())
        err_b = float((got_b.float() - want_b).abs().max())
        reading = bound_reading(got_b, want_r, bound)
        planted = planted_fault_reading(got_b, want_r, bound)
        same = torch.equal(got_b, again)
        worst = max(worst, err_r)
        print("[flash] {}: B={} Tq={} Tk={} H={} D={} causal={} padded={}: "
              "fp32 max abs err {:.3e}; bf16 {:.3e} against the rounding "
              "plain version ({:.4f} of the bound at most; a planted fault, "
              "o zeroed but in batch row 1, reads {:.1f}), {:.3e} against "
              "fp32 math; bf16 repeat bit-identical: {}".format(
                  name, B, Tq, Tk, H, D, causal, padded, err, err_r, reading,
                  planted, err_b, same), flush=True)
        check(err <= FLASH_FP32_ATOL and bool(torch.isfinite(got).all()),
              "{}: fp32 err {}".format(name, err))
        check(reading <= 1.0 and got_b.dtype == torch.bfloat16 and
              bool(torch.isfinite(got_b).all()),
              "{}: bf16 err {} times the bound against the rounding plain "
              "version".format(name, reading))
        check(planted > 1.0, "{}: the bound takes a planted fault".format(
            name))
        check(err_b <= FLASH_BF16_ATOL, "{}: bf16 err {} against fp32 "
              "math".format(name, err_b))
        check(same, "{}: two bf16 forward calls differ".format(name))
        if i >= 3 and name != "serving":
            continue
        mask = None if valid is None else valid[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (qb, kb, vb))
        t = {"ms": cuda_ms(lambda: fa.flash_attention(qb, kb, vb, valid,
                                                      causal), 50),
             "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(
                 qb, kb, vb, valid, causal, round_weights=True), 20),
             "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=mask, is_causal=causal), 50)}
        t["bound_ms"], t["bound_by"] = attention_bound_ms(qb, kb, valid,
                                                          causal)
        times[name] = t
        print("[flash] {} bf16: kernel {:.4f} ms, plain {:.4f} ms, SDPA "
              "{:.4f} ms, bound {:.4f} ms ({}) (CUDA events, back to "
              "back; {})".format(name, t["ms"], t["plain_ms"], t["library_ms"],
                      t["bound_ms"], t["bound_by"], card), flush=True)
    # what the kernel does not take, it refuses
    q, k, v, valid = flash_case(2, 8, 8, 2, 64, True, 0, dev)
    for bad in ((q.half(), k.half(), v.half(), valid),
                (q[..., :32].contiguous(), k[..., :32].contiguous(),
                 v[..., :32].contiguous(), valid),
                (q.transpose(1, 2), k, v, valid),
                (q, k, v, valid.int()),
                (q, k.bfloat16(), v, valid)):
        try:
            fa.flash_attention(*bad)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad flash input "
                           "launched")
    # the bf16 kernels copy 16 bytes at a time
    n = q.numel()
    odd = torch.empty(n + 1, dtype=torch.bfloat16, device=dev)[1:].view(
        q.shape)
    try:
        fa.flash_attention(odd, odd, odd)
    except ValueError:
        pass
    else:
        raise RuntimeError("chip_smoke check failed: a misaligned bf16 "
                           "flash input launched")
    print("[flash] wrong dtype, head dim, layout, mask and a misaligned "
          "bf16 input are refused", flush=True)
    return worst, times


FLASH_BWD_FP32_ATOL = 1e-4


def _bwd_kernel_ms(kernel, q, k, v, o, lse, do, valid, causal, reps):
    """Device ms of one backward kernel alone, launched through the same
    entry point as ``flash_attention_bwd_cuda`` (not counted)."""
    import torch
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    B, Tq, H, D = q.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    di = torch.empty_like(lse)
    mask = None if valid is None else valid.data_ptr()
    ints = (B, Tq, k.shape[1], H, D, int(q.dtype == torch.bfloat16),
            int(causal))
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "dq":
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), mask, dq.data_ptr(),
                di.data_ptr())
    else:
        di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), mask, dk.data_ptr(),
                dv.data_ptr())
    fn = fa._kernel("flash_attn_bwd_" + kernel)

    def launch():
        check(fn(*args, *ints, float(D ** -0.5), stream) == 0,
              "flash_attn_bwd_{} launch".format(kernel))
    return cuda_ms(launch, reps)


def phase_flash_bwd(card):
    """The forward's lse and the backward kernels against
    ``flash_attention_plain`` and ``flash_attention_bwd_plain`` on the
    card: fp32 (the CUDA-core kernels) against fp32 math within
    FLASH_BWD_FP32_ATOL; bf16 (the tensor-core kernels) against the
    rounding plain version (``round_weights=True``, from the kernel
    forward's own o and lse) within ``flash_attention_bwd_bound``, element
    by element, refusing a planted fault, and against fp32 math within
    FLASH_BWD_BF16_FP32_MATH_BOUNDS times that bound; two calls
    bit-identical.
    Times at the train step's shapes in bf16. Returns the worst bf16
    errors of dq and of dk/dv against the rounding plain version, and the
    timings by case name."""
    import torch
    import torch.nn.functional as F
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    worst_dq = worst_dkv = worst_bf16_dq = worst_bf16_dkv = 0.0
    times = {}
    for i, (name, B, Tq, Tk, H, D, causal, padded) in enumerate(
            FLASH_CASES):
        q, k, v, valid = flash_case(B, Tq, Tk, H, D, padded, 10 + i, dev)
        do = torch.randn(q.shape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(i))
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
            o, lse = fa.flash_attention_cuda(
                qd, kd, vd, valid, causal, D ** -0.5, return_lse=True)
            got = fa.flash_attention_bwd_cuda(qd, kd, vd, o, lse, dod, valid,
                                              causal)
            again = fa.flash_attention_bwd_cuda(qd, kd, vd, o, lse, dod,
                                                valid, causal)
            up = [x.float() for x in (qd, kd, vd)]
            _, want_lse = fa.flash_attention_plain(*up, valid, causal,
                                                   return_lse=True)
            want = fa.flash_attention_bwd_plain(*up, o.float(), want_lse,
                                                dod.float(), valid, causal)
            rounded = fa.flash_attention_bwd_plain(
                qd, kd, vd, o, lse, dod, valid, causal, round_weights=True)
            torch.cuda.synchronize()
            lse_err = float((lse - want_lse).abs().max())
            errs = [float((g.float() - w).abs().max())
                    for g, w in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print("[flash bwd] {} {}: lse max abs err {:.3e}; dq, dk, dv max "
                  "abs err {:.3e}, {:.3e}, {:.3e} against fp32 math (|dq|, "
                  "|dk|, |dv| max {:.2f}, {:.2f}, {:.2f}); repeat "
                  "bit-identical: {}".format(
                      name, str(dtype)[6:], lse_err, *errs,
                      *(float(w.abs().max()) for w in want), same),
                  flush=True)
            check(lse_err <= 1e-5 * max(1.0, float(want_lse.abs().max())),
                  "{}: lse err {}".format(name, lse_err))
            check(same, "{}: two backward calls differ".format(name))
            check(all(g.dtype == dtype and bool(torch.isfinite(g).all())
                      for g in got), "{}: gradient dtype or non-finite"
                  .format(name))
            if dtype == torch.float32:
                worst_dq = max(worst_dq, errs[0])
                worst_dkv = max(worst_dkv, errs[1], errs[2])
                check(max(errs) <= FLASH_BWD_FP32_ATOL,
                      "{}: fp32 gradient err {}".format(name, errs))
                continue
            bounds = fa.flash_attention_bwd_bound(qd, kd, vd, o, lse, dod,
                                                  valid, causal)
            fp32_math = fa.flash_attention_bwd_plain(qd, kd, vd, o, lse, dod,
                                                     valid, causal)
            readings = [bound_reading(g, w, b)
                        for g, w, b in zip(got, rounded, bounds)]
            math_readings = [bound_reading(g, w, b)
                             for g, w, b in zip(got, fp32_math, bounds)]
            planted = planted_fault_reading(got[2], rounded[2], bounds[2])
            print("[flash bwd] {} bf16: dq, dk, dv {:.4f}, {:.4f}, {:.4f} of "
                  "the bound at most against the rounding plain version "
                  "(max abs err {:.3e}, {:.3e}, {:.3e}), {:.4f}, {:.4f}, "
                  "{:.4f} against fp32 math; a planted fault, dv zeroed but "
                  "in batch row 1, reads {:.1f}".format(
                      name, *readings, *(
                          float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, rounded)),
                      *math_readings, planted), flush=True)
            worst_bf16_dq = max(worst_bf16_dq, float(
                (got[0].float() - rounded[0].float()).abs().max()))
            worst_bf16_dkv = max(worst_bf16_dkv, *(
                float((g.float() - w.float()).abs().max())
                for g, w in zip(got[1:], rounded[1:])))
            check(max(readings) <= 1.0, "{}: bf16 gradient err {} times "
                  "the bound against the rounding plain version".format(
                      name, readings))
            check(max(math_readings) <= FLASH_BWD_BF16_FP32_MATH_BOUNDS,
                  "{}: bf16 gradient err {} times the bound against fp32 "
                  "math".format(name, math_readings))
            check(planted > 1.0, "{}: the bound takes a planted fault"
                  .format(name))
        if i >= 3:
            continue
        qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
        o, lse = fa.flash_attention_cuda(qb, kb, vb, valid, causal,
                                          D ** -0.5, return_lse=True)
        leaves = [x.transpose(1, 2).detach().requires_grad_()
                  for x in (qb, kb, vb)]
        mask = None if valid is None else valid[:, None, None, :]
        do_t = dob.transpose(1, 2)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, is_causal=causal).backward(do_t)
        t = {"ms": cuda_ms(lambda: fa.flash_attention_bwd_cuda(
                qb, kb, vb, o, lse, dob, valid, causal), 50),
             "dq_ms": _bwd_kernel_ms("dq", qb, kb, vb, o, lse, dob, valid,
                                     causal, 50),
             "dkv_ms": _bwd_kernel_ms("dkv", qb, kb, vb, o, lse, dob, valid,
                                      causal, 50),
             "plain_ms": cuda_ms(lambda: fa.flash_attention_bwd_plain(
                 qb, kb, vb, o, lse, dob, valid, causal,
                 round_weights=True), 20),
             "library_ms": cuda_ms(sdpa_fwd_bwd, 50)}
        for part in ("all", "dq", "dkv"):
            t[part + "_bound"] = attention_bwd_bound_ms(qb, kb, valid, causal,
                                                        part)
        times[name] = t
        print("[flash bwd] {} bf16: dq+dkv {:.4f} ms (dq {:.4f}, dkv "
              "{:.4f}), bound {:.4f} ms ({}; dq {:.4f}, dkv {:.4f}); plain "
              "backward {:.4f} ms; SDPA forward+backward {:.4f} ms (CUDA "
              "events, back to back; {})".format(
                  name, t["ms"], t["dq_ms"], t["dkv_ms"], t["all_bound"][0],
                  t["all_bound"][1], t["dq_bound"][0], t["dkv_bound"][0],
                  t["plain_ms"], t["library_ms"], card), flush=True)
    # what the backward does not take, it refuses
    q, k, v, valid = flash_case(2, 8, 8, 2, 64, True, 0, dev)
    o, lse = fa.flash_attention_cuda(q, k, v, valid, False, 0.125,
                                      return_lse=True)
    for bad in ((q, k, v, o.bfloat16(), lse, q, valid),
                (q, k, v, o, lse.double(), q, valid),
                (q, k, v, o, lse, q.transpose(1, 2), valid)):
        try:
            fa.flash_attention_bwd_cuda(*bad)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad flash backward "
                           "input launched")
    print("[flash bwd] wrong dtype and layout are refused", flush=True)
    print("[flash bwd] worst fp32 errors against fp32 math: dq {:.3e}, "
          "dk/dv {:.3e}".format(worst_dq, worst_dkv), flush=True)
    return worst_bf16_dq, worst_bf16_dkv, times


# ~14 integer operations per element: the hash (two multiplies, xor-shifts
# and adds), the compare, the scale and the select; at the CUDA cores'
# fp32 rate, which the int32 rate does not exceed
DROPOUT_OPS = 14


def phase_dropout(card):
    """``dropout_mask`` against ``fused_dropout_plain`` on the card,
    forward and backward (the mask regenerated on the cotangent), with and
    without the residual: bit-identical. Times of the FFN site's variant
    (no residual) at the FFN shape in bf16."""
    import torch
    import torch.nn.functional as F
    from openseq2seq_tpu_torch.ops import fused_dropout as fd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    timing, worst = None, 0.0
    for shape in ((4096, 4096), (600, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            y, x, g = (torch.randn(shape, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            seed = fd.draw_seed(gen, dev)
            results = []
            for residual in (False, True):
                leaves = [t.clone().requires_grad_() for t in (x, y)]
                out = (fd.fused_dropout_add(leaves[0], leaves[1], 0.3, seed)
                       if residual else fd.fused_dropout(leaves[1], 0.3, seed))
                out.backward(g)
                want = (fd.fused_dropout_add_plain(x, y, 0.3, seed)
                        if residual else fd.fused_dropout_plain(y, 0.3, seed))
                want_dy = fd.fused_dropout_plain(g, 0.3, seed)
                torch.cuda.synchronize()
                worst = max(worst,
                            float((out.detach() - want).abs().max()),
                            float((leaves[1].grad - want_dy).abs().max()))
                same = torch.equal(out, want) and \
                    torch.equal(leaves[1].grad, want_dy) and \
                    (not residual or torch.equal(leaves[0].grad, g))
                results.append(same)
            kept = float((fd.fused_dropout(y, 0.3, seed) != 0).float()
                         .mean())
            print("[dropout] {} {}: forward and backward bit-identical to "
                  "the plain version: without residual {}, with {}; kept "
                  "{:.4f} (keep 0.7)".format(shape, str(dtype)[6:],
                                             *results, kept), flush=True)
            check(all(results), "fused dropout {} {} differs from its plain "
                  "version".format(shape, dtype))
            if shape == (4096, 4096) and dtype == torch.bfloat16:
                nbytes = 2 * y.numel() * y.element_size()
                timing = {
                    "ms": cuda_ms(lambda: fd.fused_dropout_cuda(
                        y, None, 0.3, seed), 50),
                    "plain_ms": cuda_ms(lambda: fd.fused_dropout_plain(
                        y, 0.3, seed), 20),
                    "other_ms": cuda_ms(lambda: F.dropout(y, 0.3), 50),
                    "bound": bound_ms(nbytes, DROPOUT_OPS * y.numel(),
                                      torch.float32)}
                print("[dropout] FFN shape (4096, 4096) bf16, no residual: "
                      "kernel {:.4f} ms, plain {:.4f} ms, bound {:.4f} ms "
                      "({}); F.dropout, another function (torch's own "
                      "mask), {:.4f} ms (CUDA events, back to back; {})"
                      .format(
                          timing["ms"], timing["plain_ms"],
                          *timing["bound"], timing["other_ms"], card),
                      flush=True)
    y = torch.randn((4, 100), device=dev)
    seed = fd.draw_seed(gen, dev)
    for bad in ((y, None, 0.3, seed),
                (torch.randn((64, 16), device=dev).t(), None, 0.3, seed),
                (y[:, :64].contiguous(), None, 0.3, seed.cpu())):
        try:
            fd.fused_dropout_cuda(*bad)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad dropout input "
                           "launched")
    print("[dropout] wrong width, layout and seed are refused", flush=True)
    timing["max_abs_err"] = worst
    return timing


# the scan kernels' checks: fp32 (TF32 off) max abs error by sequence
# length (sums in another order, over up to 500 dependent steps); bf16
# mean abs error and max abs error in bf16 ulps of 1 (another sum order
# can flip one rounding of the carried h, and the recurrence carries it),
# both relative to max(1, |value|) (the GRU's hn and the LSTM's c are not
# bounded by 1)
SCAN_FP32_ATOL = {37: 1e-5, 500: 1e-4}
SCAN_BF16_MEAN, SCAN_BF16_MAX = 1e-3, 3 * 2.0 ** -7
# bf16, besides that end-to-end sanity check: each step held on its own,
# from the state the kernel carried into it, element by element within
# ``ops/scan_bounds``'s bounds (the forward's rounded outputs a rounding
# of a value within the recompute's error, the backward's within one ulp
# of each rounding to bf16; the fp32 sums in another order, the fp32 cell
# math); the reading is the largest |kernel - one-step fp64 recompute| /
# bound, at most 1, and planted faults must read above 1: the output
# zeroed on every batch row but row 1, and one step without the recurrent
# product for one CTA's block of units (the forward's ys; the backward's
# carry into the step, with dx recomputed from it); in the forward the
# state carried unrounded (h) or rounded to bf16 (the LSTM's c)
# (``scan_bounds.fwd_faults``), in the backward every carry rounded to
# bf16 (``scan_bounds.bwd_faults``)
# name, cell, B, T, H: the main paths' shapes (DS2-medium's GRU layers,
# lstm_small's LSTM layers, the LSTM language model's, whose 224 rows are
# seven tiles of 32 a step, GNMT-like's encoder, and Tacotron-2's encoder
# LSTM and GST's GRU, whose 48 rows are a full tile and a ragged one of
# 16: the tiles' hand-off through the CTA's reduction buffer and
# multicast rooms runs only past one tile), the smallest
# shape the kernels take, an LSTM
# at H = 1024, whose bf16 backward stages each warp's slice of dg in two
# windows (its slice does not fit the warp's room at once), and one at the
# widest H the kernels take, 1280, where the fp32 forward and backward are
# refused before any launch (their fp32 copy of W_h passes a CTA's shared
# memory; the bf16 kernels keep W_h in registers), and the DS2 toy's GRU
# (fp32, B 10, about 48 frames after its stride-2 conv, H 64: 64 CTAs of
# one unit, a width the bf16 kernels refuse), and the LAS listener's
# BiLSTMs at B 64, H 512 (two tiles of 32 rows): T 400, then 200 after
# the pyramid's second pooling
SCAN_CASES = (
    ("ds2-medium", "gru", 32, 500, 1024),
    ("lstm_small", "lstm", 32, 500, 512),
    ("lstm-lm", "lstm", 224, 96, 1024),
    ("gnmt", "lstm", 32, 50, 1024),
    ("tacotron", "lstm", 48, 96, 256),
    ("gst", "gru", 48, 8, 128),
    ("small gru", "gru", 8, 37, 128),
    ("small lstm", "lstm", 8, 37, 128),
    ("wide lstm", "lstm", 8, 37, 1024),
    ("widest lstm", "lstm", 8, 37, 1280),
    ("ds2-toy", "gru", 10, 48, 64),
    ("las-400", "lstm", 64, 400, 512),
    ("las-200", "lstm", 64, 200, 512),
)


# the timed cases: name, the layer's input width over H (the speech
# layers' are bidirectional stacks, the LM's are not); cuDNN's one layer
# is timed with that input width
SCAN_TIMED = {"ds2-medium": 2, "lstm_small": 2, "lstm-lm": 1, "gnmt": 1,
              "las-400": 1.5, "las-200": 4,
              "tacotron": 2, "gst": 2}
# the timed cases kept apart from their cell's main entry
SCAN_OWN_ENTRY = ("lstm-lm", "gnmt", "tacotron", "gst", "las-400",
                  "las-200")
# the bf16 kernels walk a step's batch rows in tiles of 32 (kRows in
# csrc/rnn_scan.cuh and csrc/rnn_scan_bwd.cuh)
SCAN_TILE_ROWS = 32


def scan_fits(cell, way, H, dtype):
    """Whether a CTA of the scan kernel (``way`` "fwd" or "bwd") at width
    H in ``dtype`` fits an SM, as its own resources entry reports; fails
    unless the only ones that do not are the fp32 LSTM's at H = 1280."""
    import torch
    from openseq2seq_tpu_torch.ops import rnn_scan
    fits = rnn_scan.resources("{}_scan_{}".format(cell, way), H,
                              dtype == torch.bfloat16)[1] > 0
    check(fits or (cell, H, dtype) == ("lstm", 1280, torch.float32),
          "{} {} at H = {} in {} does not fit".format(cell, way, H, dtype))
    return fits


def check_refused(fn, counter, tag):
    """``fn()`` must raise ValueError with nothing launched: ``counter()``
    unchanged and no CUDA error after."""
    import torch
    before = counter()
    try:
        fn()
    except ValueError as e:
        torch.cuda.synchronize()
        check(counter() == before, "{}: launched".format(tag))
        print("[scan] {}: refused before any launch ({})".format(tag, e),
              flush=True)
        return
    raise RuntimeError("chip_smoke check failed: {} was not refused"
                       .format(tag))
# gate math per (row, step, hidden unit) beyond the recurrent product:
# GRU 3 sigmoid/tanh (~4 operations each) and ~10 adds and multiplies;
# LSTM 5 sigmoid/tanh and ~8 adds and multiplies; negligible beside the
# 2 G H multiply-adds, counted for completeness
SCAN_GATE_OPS = {"gru": 22, "lstm": 28}


def scan_case(cell, B, T, H, seed, device, full=False):
    """fp32 inputs of a scan kernel: x_proj ~ N(0, 1), W_h ~ N(0, 1/H),
    b_h ~ N(0, 0.09), h0 ~ N(0, 0.25), c0 ~ N(0, 1), and int32 lengths:
    all T with ``full``, else T in row 0, 1 in row 1, about T / 2 in row 2
    and uniform in [1, T] elsewhere."""
    import torch
    G = 4 if cell == "lstm" else 3
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=device)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    if full:
        lengths.fill_(T)
    else:
        lengths[0], lengths[1], lengths[2] = T, 1, (T + 1) // 2
    return {"x_proj": randn(B, T, G * H), "wh": randn(H, G * H) / H ** 0.5,
            "bh": randn(G * H, scale=0.3), "h0": randn(B, H, scale=0.5),
            "c0": randn(B, H), "lengths": lengths.int()}


def scan_call(cell, case, dtype, reverse, residuals, plain=False):
    """The scan kernel (or its plain version) on ``case`` in ``dtype``:
    the flat list of its outputs (ys, h_last[, c_last][, residuals])."""
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    xp, h0 = case["x_proj"].to(dtype), case["h0"].to(dtype)
    if cell == "gru":
        fn = gru_scan.gru_scan_plain if plain else gru_scan.gru_scan
        out = fn(xp, case["wh"], case["bh"], h0, case["lengths"], reverse,
                 residuals)
        return [out[0], out[1]] + (list(out[2]) if residuals else [])
    fn = lstm_scan.lstm_scan_plain if plain else lstm_scan.lstm_scan
    out = fn(xp, case["wh"], h0, case["c0"], case["lengths"], 1.0, reverse,
             residuals)
    return [out[0], *out[1]] + (list(out[2]) if residuals else [])


def scan_bound_ms(cell, case):
    """The least time of one scan launch in bf16 on the H100: x_proj,
    W_h (bf16), b_h, h0, c0, lengths read once and ys, h_last, c_last
    written once, over the HBM rate; 2 G H multiply-adds of the recurrent
    product plus the gate math for each live (row, step, unit), over the
    bf16 tensor-core peak."""
    import torch
    B, T, GH = case["x_proj"].shape
    H = case["h0"].shape[1]
    nbytes = 2 * (B * T * GH + H * GH + B * T * H + 2 * B * H) + 4 * B
    if cell == "lstm":
        nbytes += 2 * 4 * B * H
    else:
        nbytes += 4 * GH
    live = int(case["lengths"].long().sum())
    flop = live * H * (2 * GH + SCAN_GATE_OPS[cell])
    return bound_ms(nbytes, flop, torch.bfloat16)


def _fault_units(H):
    """The hidden units of the middle CTA of a scan's grid: the block a
    planted fault leaves the recurrent product out for."""
    from openseq2seq_tpu_torch.ops import rnn_scan
    U = rnn_scan.units_per_cta(H)
    j = H // U // 2
    return slice(j * U, (j + 1) * U)


def scan_fwd_readings(cell, case, dtype, reverse, got):
    """The one-step bounds' readings of the forward kernel's outputs
    ``got`` (ys, h_last[, c_last], acts, hn or cs), by output, and of the
    wrong kernels of ``scan_bounds.fwd_faults``: ys zeroed but in row 1,
    a step without the recurrent product, h carried unrounded, the
    LSTM's c carried in bf16."""
    from openseq2seq_tpu_torch.ops import bounds as eb
    from openseq2seq_tpu_torch.ops import scan_bounds as sb
    xp, h0, lengths = case["x_proj"].to(dtype), case["h0"].to(dtype), \
        case["lengths"]
    kw = dict(x_proj=xp, wh=case["wh"], h0=h0, lengths=lengths, ys=got[0],
              reverse=reverse)
    if cell == "gru":
        ys, h_last, acts, hn = got
        outs = {"ys": ys, "h_last": h_last, "acts": acts, "hn": hn}
        kw["bh"] = case["bh"]
        bounds = sb.gru_fwd_bounds(xp, case["wh"], case["bh"], h0, lengths,
                                   ys, reverse)
    else:
        ys, h_last, c_last, acts, cs = got
        outs = {"ys": ys, "h_last": h_last, "c_last": c_last, "acts": acts,
                "cs": cs}
        kw.update(c0=case["c0"], cs=cs)
        bounds = sb.lstm_fwd_bounds(xp, case["wh"], h0, case["c0"], lengths,
                                    ys, cs, 1.0, reverse)
    faults = sb.fwd_faults(cell, ys.shape[1] // 2, _fault_units(ys.shape[2]),
                           **kw)
    return eb.readings(outs, bounds), faults


def print_readings(tag, readings, faults):
    """One line of bound readings and planted-fault readings (dicts by
    name); fails unless every reading is at most 1 and every fault reads
    above 1."""
    worst = max(readings.values())
    print("[{}] bound readings {} (largest {:.4f}); planted faults read "
          "{}".format(tag, ", ".join("{} {:.4f}".format(k, v)
                                     for k, v in readings.items()), worst,
                      ", ".join("{:.1f} ({})".format(v, k)
                                for k, v in faults.items())), flush=True)
    check(worst <= 1.0, "{}: a bound reading above 1: {}".format(
        tag, readings))
    check(min(faults.values()) > 1.0, "{}: a planted fault passed: "
          "{}".format(tag, faults))
    return worst


def _scan_errors(got, want, dtype, T):
    """[(max abs err, mean abs err, bound excess)] per output of a scan
    over T steps: the excess is the largest error beyond its bound (<= 0
    passes)."""
    import torch
    out = []
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        rel = err / torch.clamp(w.float().abs(), min=1.0) \
            if dtype == torch.bfloat16 else err
        if dtype == torch.float32:
            excess = float(rel.max()) - SCAN_FP32_ATOL[37 if T <= 37
                                                       else 500]
        else:
            excess = max(float(rel.max()) - SCAN_BF16_MAX,
                         float(rel.mean()) - SCAN_BF16_MEAN)
        out.append((float(err.max()), float(err.mean()), excess))
    return out


def phase_scan(card):
    """``gru_scan_fwd`` and ``lstm_scan_fwd`` against their plain versions
    on the card, forward and reverse, fp32 (TF32 off) and bf16, with the
    residual outputs; two calls bit-identical. Times at the main paths'
    shapes in bf16 (full lengths, as the synthetic batches give them):
    the kernel, the plain version, and cuDNN's ``torch.nn.GRU`` /
    ``torch.nn.LSTM`` on the same (B, T, H) with a 2H-wide input (timed
    only, never on the path) with its input projection's GEMM timed
    beside it. What a kernel cannot fit (the fp32 LSTM at H = 1280) is
    refused with ValueError before any launch. Then a layer whose shape
    ``supported`` rejects takes the scan and launches nothing, and what
    the kernels do not take, they refuse. Returns the worst fp32 error and
    the timings, by cell."""
    import torch
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan, rnn_scan
    from openseq2seq_tpu_torch.parts.rnns import rnn
    dev = torch.device("cuda")
    worst = {"gru": 0.0, "lstm": 0.0}
    times = {}
    reading = {"gru": 0.0, "lstm": 0.0}
    for i, (name, cell, B, T, H) in enumerate(SCAN_CASES):
        case = scan_case(cell, B, T, H, 20 + i, dev)
        for dtype in (torch.float32, torch.bfloat16):
            if not rnn_scan.takes(H, dtype):
                kernel = gru_scan if cell == "gru" else lstm_scan
                check_refused(lambda: scan_call(cell, case, dtype, False,
                                                True),
                              lambda: kernel.LAUNCHES, "{} {} bf16 at H = "
                              "{}".format(name, cell, H))
                continue
            if not scan_fits(cell, "fwd", H, dtype):
                kernel = gru_scan if cell == "gru" else lstm_scan
                check_refused(lambda: scan_call(cell, case, dtype, False,
                                                True),
                              lambda: kernel.LAUNCHES, "{} {} {}".format(
                                  name, cell, str(dtype)[6:]))
                continue
            for reverse in (False, True):
                got = scan_call(cell, case, dtype, reverse, True)
                again = scan_call(cell, case, dtype, reverse, True)
                want = scan_call(cell, case, dtype, reverse, True, plain=True)
                torch.cuda.synchronize()
                if dtype == torch.bfloat16:
                    reading[cell] = max(reading[cell], print_readings(
                        "scan {} {} {}".format(
                            name, cell, "reverse" if reverse else "forward"),
                        *scan_fwd_readings(cell, case, dtype, reverse, got)))
                errs = _scan_errors(got, want, dtype, T)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                print("[scan] {} {} B={} T={} H={} {} {}: max abs err ys {:.3e}"
                      ", last state(s) {}, residuals {} (mean ys {:.3e}); "
                      "repeat bit-identical: {}".format(
                          name, cell, B, T, H, str(dtype)[6:],
                          "reverse" if reverse else "forward", errs[0][0],
                          ", ".join("{:.3e}".format(e[0])
                                    for e in errs[1:-2]),
                          ", ".join("{:.3e}".format(e[0])
                                    for e in errs[-2:]),
                          errs[0][1], same), flush=True)
                check(same, "{} {}: two calls differ".format(name, dtype))
                check(all(e[2] <= 0 for e in errs) and all(
                    bool(torch.isfinite(g).all()) for g in got),
                    "{} {} reverse={}: errors {}".format(name, dtype, reverse,
                                                         errs))
                check(got[0].dtype == dtype, "ys dtype {}".format(
                    got[0].dtype))
                live = torch.arange(T, device=dev)[None, :] < \
                    case["lengths"][:, None]
                check(not bool(got[0][~live].any()), "ys not zero past the "
                      "length")
                if dtype == torch.float32:
                    worst[cell] = max(worst[cell],
                                      max(e[0] for e in errs))
        if name not in SCAN_TIMED:
            continue
        width = int(SCAN_TIMED[name] * H)
        full = scan_case(cell, B, T, H, 30 + i, dev, full=True)
        mod = (torch.nn.GRU if cell == "gru" else torch.nn.LSTM)(
            width, H, batch_first=True).to(dev, torch.bfloat16)
        mod.flatten_parameters()
        x = torch.randn((B, T, width), device=dev, dtype=torch.bfloat16)
        w_ih = mod.weight_ih_l0
        with torch.no_grad():
            t = {"ms": cuda_ms(lambda: scan_call(
                     cell, full, torch.bfloat16, False, False), 10),
                 "plain_ms": cuda_ms(lambda: scan_call(
                     cell, full, torch.bfloat16, False, False, plain=True),
                     2),
                 "library_ms": cuda_ms(lambda: mod(x), 10),
                 "gemm_ms": cuda_ms(lambda: x.view(-1, width) @ w_ih.t(),
                                    20)}
        t["bound_ms"], t["bound_by"] = scan_bound_ms(cell, full)
        t["tiles_per_step"] = -(-B // SCAN_TILE_ROWS)
        t["us_per_step"] = 1e3 * t["ms"] / T
        times[name if name in SCAN_OWN_ENTRY else cell] = t
        print("[scan] {} {} bf16 B={} T={} H={}: kernel "
              "(scan_fwd_mma_kernel) {:.4f} ms, plain {:.4f} ms, bound "
              "{:.4f} ms ({}; {} dependent steps, each ending in a "
              "grid-wide barrier, make it latency-bound); cuDNN torch.nn.{} "
              "with a {}-wide input {:.4f} ms, of which its input GEMM alone "
              "takes {:.4f} ms: cuDNN less its GEMM {:.4f} ms; {} tiles of "
              "{} rows a step, {:.2f} us a step (CUDA events, back to back; "
              "{})".format(
                  name, cell, B, T, H, t["ms"], t["plain_ms"],
                  t["bound_ms"], t["bound_by"], T, cell.upper(), width,
                  t["library_ms"], t["gemm_ms"],
                  t["library_ms"] - t["gemm_ms"], t["tiles_per_step"],
                  SCAN_TILE_ROWS, t["us_per_step"], card), flush=True)
    # the per-step floor: one hidden unit per CTA and few rows, so the
    # products are negligible and what is left is the step's latency (the
    # h and x_proj reads, the gate math, the grid-wide barrier)
    for cell in ("gru", "lstm"):
        floor = scan_case(cell, 8, 500, 128, 40, dev, full=True)
        ms = cuda_ms(lambda: scan_call(cell, floor, torch.bfloat16, False,
                                       False), 10)
        times[cell]["floor_us_per_step"] = 1e3 * ms / 500
        times[cell]["bound_reading"] = reading[cell]
        print("[scan] {} bf16 B=8 T=500 H=128: {:.4f} ms, {:.2f} us per "
              "step, the latency floor; at the main shape {:.2f} us per "
              "step (CUDA events, back to back; {})".format(
                  cell, ms, 1e3 * ms / 500, 1e3 * times[cell]["ms"] / 500,
                  card), flush=True)
    lm = times["lstm-lm"]
    print("[scan] lstm-lm: {:.2f} us a step of {} tiles against {:.2f} us a "
          "step of one tile at lstm_small's shape (B 32, H 512) and a floor "
          "of {:.2f} us ({})".format(
              lm["us_per_step"], lm["tiles_per_step"],
              times["lstm"]["us_per_step"],
              times["lstm"]["floor_us_per_step"], card), flush=True)
    # a shape that `supported` rejects (DS2-large's H = 800) takes the scan
    check(gru_scan.supported(32, 500, 1024, torch.bfloat16) and
          not gru_scan.supported(32, 500, 800, torch.bfloat16),
          "supported()")
    layer = rnn.GRU(64, 800, dtype=torch.bfloat16, fused=True).to(dev)
    before = gru_scan.LAUNCHES
    with torch.no_grad():
        out, _ = layer(torch.randn((32, 20, 64), device=dev),
                       torch.full((32,), 20, device=dev))
    torch.cuda.synchronize()
    check(gru_scan.LAUNCHES == before and out.shape == (32, 20, 800),
          "H = 800 launched the kernel")
    print("[scan] a GRU layer at H = 800 (not supported) ran the scan with "
          "no launch", flush=True)
    # what the kernels do not take, they refuse
    case = scan_case("gru", 8, 9, 128, 0, dev)
    bad_cases = (dict(case, x_proj=case["x_proj"].half()),
                 dict(case, x_proj=case["x_proj"][..., :3 * 96].contiguous(),
                      wh=case["wh"][:96, :3 * 96].contiguous(),
                      h0=case["h0"][:, :96].contiguous(),
                      bh=case["bh"][:3 * 96].contiguous()),
                 dict(case, lengths=case["lengths"].cpu()),
                 dict(case, h0=case["h0"][:4]))
    for bad in bad_cases:
        try:
            scan_call("gru", bad, bad["x_proj"].dtype, False, False)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad scan input "
                           "launched")
    lcase = scan_case("lstm", 8, 9, 128, 0, dev)
    try:
        scan_call("lstm", dict(lcase, c0=lcase["c0"][:4]), torch.float32,
                  False, False)
    except ValueError:
        pass
    else:
        raise RuntimeError("chip_smoke check failed: a bad c0 launched")
    print("[scan] wrong dtype, width, device and shape are refused",
          flush=True)
    return worst, times


# the backward's gate math per (row, step, hidden unit) beyond the
# recurrent product: GRU about 20 adds and multiplies, LSTM a tanh and
# about 25
SCAN_BWD_GATE_OPS = {"gru": 20, "lstm": 30}


def scan_bwd_fn(cell, case, dtype, reverse, plain=False):
    """The forward kernel with its residuals on ``case``, then a function
    that runs the backward kernel (or its plain version) on them, with
    the cotangents ``case["dys"]``, ``case["dh"]`` (and ``case["dc"]``),
    and returns the flat list (dx_proj, dh0[, dc0])."""
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    xp, h0 = case["x_proj"].to(dtype), case["h0"].to(dtype)
    dys, dh = case["dys"].to(dtype), case["dh"].to(dtype)
    lengths = case["lengths"]
    if cell == "gru":
        ys, _, (acts, hn) = gru_scan.gru_scan(xp, case["wh"], case["bh"], h0,
                                              lengths, reverse, True)
        fn = gru_scan.gru_scan_bwd_plain if plain else gru_scan._bwd_cuda
        return lambda: list(fn(case["wh"], h0, lengths, ys, acts, hn, dys,
                               dh, reverse))
    _, _, (acts, cs) = lstm_scan.lstm_scan(xp, case["wh"], h0, case["c0"],
                                           lengths, 1.0, reverse, True)
    fn = lstm_scan.lstm_scan_bwd_plain if plain else lstm_scan._bwd_cuda
    return lambda: list(fn(case["wh"], case["c0"], lengths, acts, cs, dys,
                           dh, case["dc"], reverse))


def scan_bwd_readings(cell, case, dtype, reverse, got):
    """The backward kernel with its carries on the forward kernel's
    residuals: the one-step bounds' readings by output, and those of the
    wrong kernels of ``scan_bounds.bwd_faults``, each of which a check
    must refuse. Fails unless its dx, dh0 (and dc0) are
    bit-identical to ``got``, the outputs of the launch without carries
    on the same inputs."""
    import torch
    from openseq2seq_tpu_torch.ops import bounds as eb
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    from openseq2seq_tpu_torch.ops import scan_bounds as sb
    xp, h0 = case["x_proj"].to(dtype), case["h0"].to(dtype)
    dys, dh = case["dys"].to(dtype), case["dh"].to(dtype)
    lengths, wh = case["lengths"], case["wh"]
    if cell == "gru":
        ys, _, (acts, hn) = gru_scan.gru_scan(xp, wh, case["bh"], h0,
                                              lengths, reverse, True)
        dx, dh0, carries = gru_scan._bwd_cuda(wh, h0, lengths, ys, acts, hn,
                                              dys, dh, reverse, carries=True)
        outs = {"dx": dx, "carry": carries, "dh0": dh0}
        kw = dict(h0=h0, ys=ys, hn=hn)
        flat = [dx, dh0]
    else:
        _, _, (acts, cs) = lstm_scan.lstm_scan(xp, wh, h0, case["c0"],
                                               lengths, 1.0, reverse, True)
        dx, dh0, dc0, carries, ccarries = lstm_scan._bwd_cuda(
            wh, case["c0"], lengths, acts, cs, dys, dh, case["dc"], reverse,
            carries=True)
        outs = {"dx": dx, "carry": carries, "ccarry": ccarries, "dh0": dh0,
                "dc0": dc0}
        kw = dict(c0=case["c0"], cs=cs, dc_last=case["dc"],
                  ccarries=ccarries)
        flat = [dx, dh0, dc0]
    check(all(torch.equal(a, b) for a, b in zip(flat, got)),
          "{}: the backward with carries differs from the one without"
          .format(cell))
    T, H = acts.shape[1], dys.shape[2]
    kw.update(wh=wh, lengths=lengths, acts=acts, dys=dys, dh_last=dh,
              carries=carries, reverse=reverse,
              depth=sb.sum_depth(acts.shape[2] // H, H, dtype))
    faults = sb.bwd_faults(cell, T // 2, _fault_units(H), dx, **kw)
    return eb.readings(outs, sb.bwd_bounds(cell, **kw)), faults


def scan_bwd_bound_ms(cell, case):
    """The least time of one backward launch in bf16 on the H100: the
    residuals (acts; the GRU's hn and ys, the LSTM's fp32 cs), dys, W_h,
    h0 or c0, the lengths and the incoming carries read once, dx_proj and
    dh0 (and dc0) written once, over the HBM rate; 2 G H multiply-adds of
    the product dg W_h^T plus the gate math for each live (row, step,
    unit), over the bf16 tensor-core peak."""
    import torch
    B, T, GH = case["x_proj"].shape
    H = case["h0"].shape[1]
    nbytes = 2 * (2 * B * T * GH + H * GH + B * T * H + 3 * B * H) + 4 * B
    if cell == "lstm":
        nbytes += 4 * B * T * H + 4 * 3 * B * H      # cs, c0, dc_last, dc0
    else:
        nbytes += 2 * 2 * B * T * H                  # hn, ys
    live = int(case["lengths"].long().sum())
    flop = live * H * (2 * GH + SCAN_BWD_GATE_OPS[cell])
    return bound_ms(nbytes, flop, torch.bfloat16)


def phase_scan_bwd(card):
    """``gru_scan_bwd`` and ``lstm_scan_bwd`` against their plain versions
    on the card, on the residuals of the forward kernel: the main paths'
    shapes and B=8, T=37, H=128, forward and reverse, h0 and c0 non-zero,
    lengths from 1 to T, the cotangent of ys non-zero past each length
    (it must be dropped), fp32 (TF32 off) and bf16 with the forward's
    tolerances; two calls bit-identical. Times at the main shapes in bf16
    (full lengths): the kernel, the plain version, the dW_h GEMM outside
    it (fp32, as the JAX VJP computes it), and cuDNN's ``torch.nn.GRU`` /
    ``torch.nn.LSTM`` forward plus backward on a 2H-wide input (the
    yardstick, never on the path). Returns the worst fp32 error and the
    timings, by cell."""
    import torch
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan, rnn_scan
    dev = torch.device("cuda")
    worst = {"gru": 0.0, "lstm": 0.0}
    times = {}
    reading = {"gru": 0.0, "lstm": 0.0}

    def with_cotangents(case, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        B, T, _ = case["x_proj"].shape
        H = case["h0"].shape[1]
        return dict(case, dys=torch.randn((B, T, H), generator=g, device=dev),
                    dh=torch.randn((B, H), generator=g, device=dev),
                    dc=torch.randn((B, H), generator=g, device=dev))

    for i, (name, cell, B, T, H) in enumerate(SCAN_CASES):
        case = with_cotangents(scan_case(cell, B, T, H, 50 + i, dev), 60 + i)
        for dtype in (torch.float32, torch.bfloat16):
            if not rnn_scan.takes(H, dtype):
                xp = case["x_proj"].to(dtype)
                check_refused(lambda: gru_scan._bwd_cuda(
                    case["wh"], xp[:, 0, :H], case["lengths"], xp[..., :H],
                    xp, xp[..., :H], xp[..., :H], xp[:, 0, :H], False),
                    lambda: gru_scan.BWD_LAUNCHES, "{} {} backward bf16 at "
                    "H = {}".format(name, cell, H))
                continue
            if not scan_fits(cell, "bwd", H, dtype):
                # the residuals' shapes, from the inputs: the forward
                # that would make them is refused too
                xp, c0 = case["x_proj"], case["c0"]
                kernel = gru_scan if cell == "gru" else lstm_scan
                check_refused(lambda: lstm_scan._bwd_cuda(
                    case["wh"], c0, case["lengths"], xp, xp[..., :H],
                    xp[..., :H], c0, c0, False),
                    lambda: kernel.BWD_LAUNCHES, "{} {} backward {}".format(
                        name, cell, str(dtype)[6:]))
                continue
            for reverse in (False, True):
                kernel = scan_bwd_fn(cell, case, dtype, reverse)
                got, again = kernel(), kernel()
                want = scan_bwd_fn(cell, case, dtype, reverse, plain=True)()
                torch.cuda.synchronize()
                errs = _scan_errors(got, want, dtype, T)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                print("[scan bwd] {} {} B={} T={} H={} {} {}: max abs err "
                      "dx_proj {:.3e} (mean {:.3e}), initial state(s) {}; "
                      "repeat bit-identical: {}".format(
                          name, cell, B, T, H, str(dtype)[6:],
                          "reverse" if reverse else "forward", errs[0][0],
                          errs[0][1], ", ".join("{:.3e}".format(e[0])
                                                for e in errs[1:]), same),
                      flush=True)
                if dtype == torch.bfloat16:
                    reading[cell] = max(reading[cell], print_readings(
                        "scan bwd {} {} {}".format(
                            name, cell, "reverse" if reverse else "forward"),
                        *scan_bwd_readings(cell, case, dtype, reverse,
                                           got)))
                check(same, "{} {}: two backward calls differ".format(
                    name, dtype))
                check(all(e[2] <= 0 for e in errs) and all(
                    bool(torch.isfinite(g).all()) for g in got),
                    "{} {} reverse={}: backward errors {}".format(
                        name, dtype, reverse, errs))
                live = torch.arange(T, device=dev)[None, :] < \
                    case["lengths"][:, None]
                check(got[0].dtype == dtype and
                      not bool(got[0][~live].any()),
                      "dx_proj dtype or not zero past the length")
                if dtype == torch.float32:
                    worst[cell] = max(worst[cell], max(e[0] for e in errs))
        if name not in SCAN_TIMED:
            continue
        width = int(SCAN_TIMED[name] * H)
        full = with_cotangents(scan_case(cell, B, T, H, 70 + i, dev,
                                         full=True), 80 + i)
        G = 4 if cell == "lstm" else 3
        # fp32 stand-ins of h_prev (B T, H) and dhp or dgates (B T, G H)
        h_prev = full["x_proj"][..., :H].reshape(-1, H)
        dg = full["x_proj"].reshape(-1, G * H)
        mod = (torch.nn.GRU if cell == "gru" else torch.nn.LSTM)(
            width, H, batch_first=True).to(dev, torch.bfloat16)
        mod.flatten_parameters()
        x = torch.randn((B, T, width), device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        dy = full["dys"].bfloat16()

        def cudnn_fwd_bwd():
            mod(x)[0].backward(dy)

        t = {"ms": cuda_ms(scan_bwd_fn(cell, full, torch.bfloat16, False),
                           10),
             "fwd_ms": cuda_ms(lambda: scan_call(
                 cell, full, torch.bfloat16, False, True), 10),
             "plain_ms": cuda_ms(scan_bwd_fn(cell, full, torch.bfloat16,
                                             False, plain=True), 2),
             "library_ms": cuda_ms(cudnn_fwd_bwd, 5),
             "gemm_ms": cuda_ms(lambda: h_prev.t() @ dg, 10)}
        t["bound_ms"], t["bound_by"] = scan_bwd_bound_ms(cell, full)
        t["tiles_per_step"] = -(-B // SCAN_TILE_ROWS)
        t["us_per_step"] = 1e3 * t["ms"] / T
        times[name if name in SCAN_OWN_ENTRY else cell] = t
        print("[scan bwd] {} {} bf16 B={} T={} H={}: backward kernel {:.4f} "
              "ms (its forward with residuals {:.4f} ms), plain {:.4f} ms, "
              "bound {:.4f} ms ({}); the dW_h GEMM outside it, fp32, "
              "{:.4f} ms ({:.1f} TFLOP/s); cuDNN torch.nn.{} forward plus "
              "backward with a {}-wide input {:.4f} ms; {} tiles of {} rows "
              "a step, {:.2f} us a step (CUDA events, back to back; {})"
              .format(name, cell, B, T, H, t["ms"], t["fwd_ms"],
                      t["plain_ms"], t["bound_ms"], t["bound_by"],
                      t["gemm_ms"],
                      2 * B * T * H * G * H / t["gemm_ms"] / 1e9,
                      cell.upper(), width, t["library_ms"],
                      t["tiles_per_step"], SCAN_TILE_ROWS, t["us_per_step"],
                      card), flush=True)
    # the per-step floor, as the forward's (4e)
    for cell in ("gru", "lstm"):
        floor = with_cotangents(scan_case(cell, 8, 500, 128, 90, dev,
                                          full=True), 91)
        ms = cuda_ms(scan_bwd_fn(cell, floor, torch.bfloat16, False), 10)
        times[cell]["floor_us_per_step"] = 1e3 * ms / 500
        times[cell]["bound_reading"] = reading[cell]
        print("[scan bwd] {} bf16 B=8 T=500 H=128: {:.4f} ms, {:.2f} us per "
              "step, the latency floor; at the main shape {:.2f} us per "
              "step (CUDA events, back to back; {})".format(
                  cell, ms, 1e3 * ms / 500, 1e3 * times[cell]["ms"] / 500,
                  card), flush=True)
    lm = times["lstm-lm"]
    print("[scan bwd] lstm-lm: {:.2f} us a step of {} tiles against {:.2f} "
          "us a step of one tile at lstm_small's shape (B 32, H 512) and a "
          "floor of {:.2f} us ({})".format(
              lm["us_per_step"], lm["tiles_per_step"],
              times["lstm"]["us_per_step"],
              times["lstm"]["floor_us_per_step"], card), flush=True)
    return worst, times


# the Conformer-Transducer's shapes: B 128 (conformer_transducer_synthetic
# .py's batch, scripts/bench_transducer.py's) at T' 250 (its 10 s
# utterances) and 418 (the LibriSpeech recipe's 16.7 s cap); held and
# timed like each kernel's first case, the Conformer-M CTC path's
TRANSDUCER_SHAPES = ("transducer T'=250", "transducer T'=418")
# TransducerFrameASR's window over the Conformer-Transducer: B 1, its
# defaults' 5.0 s buffer (0.2 s frames, 2.4 s of overlap each side: 501
# feature frames, padded to 512), T' 128 after the 4x subsampling with 126
# valid: one partial 128-key block; held and timed in the forward phases
# only (streaming runs no backward)
STREAMING_SHAPE = "streaming T'=128"
STREAMING_VALID = {STREAMING_SHAPE: 126}


def transducer_shape_times(times, part=None):
    """The kernels line's ``at_transducer_shape`` of a kernel's timings:
    for each of the transducer's shapes its time, its plain version's,
    its bound and the library call's (``part`` "dq" or "dkv": that launch
    of the rel-pos backward)."""
    out = {}
    for name, t in times["at_transducer_shape"].items():
        bound = t[part + "_bound"] if part else (t["bound_ms"],
                                                 t["bound_by"])
        out[name] = {"ms": t[part + "_ms" if part else "ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": bound[0],
                     "bound_by": bound[1],
                     "library_ms": t.get("library_ms")}
    return out


def with_transducer_times(timed, main):
    """The timings of case ``main``, with those of the transducer's
    shapes under ``at_transducer_shape`` (and of the streaming window
    under ``at_streaming_shape``, where it was timed)."""
    out = dict(timed[main], at_transducer_shape={
        name: timed[name] for name in TRANSDUCER_SHAPES})
    if STREAMING_SHAPE in timed:
        out["at_streaming_shape"] = timed[STREAMING_SHAPE]
    return out


def streaming_shape_times(times):
    """The kernels line's ``at_streaming_shape`` of a forward kernel's
    timings."""
    t = times["at_streaming_shape"]
    return {"ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")}


# name, B, H, T, Dh, D: Conformer-M's attention (the main path's), then
# Conformer-L's (bench_conformer.py with BENCH_SCALE=l), a ragged tile and
# the transducer's shapes
RELPOS_CASES = (
    ("conformer-m", 64, 4, 250, 64, 256),
    ("conformer-l", 64, 8, 250, 64, 512),
    ("ragged T=37", 3, 4, 37, 32, 128),
    ("transducer T'=250", 128, 4, 250, 64, 256),
    ("transducer T'=418", 128, 4, 418, 64, 256),
    (STREAMING_SHAPE, 1, 4, 128, 64, 256),
)
RELPOS_FP32_ATOL, RELPOS_LSE_ATOL = 2e-5, 1e-5
# bf16: each context element within relpos_attention_bound of the plain
# version, which rounds the weights where the kernel and the TPU kernel
# round them (against the running maximum of 128-key blocks): one bf16 ulp
# of each weight that may round the other way, the fp32 sums in another
# order, one ulp of the element; the reading is the largest |kernel -
# plain| / bound, at most 1, and a planted fault (the context zeroed on
# every batch row but row 1) must read above 1. lse within RELPOS_LSE_ATOL
# of max(1, |lse|).


def relpos_case(B, H, T, Dh, D, seed, device, valid=None):
    """The kernel's inputs folded from unit-scale q + u, q + w, k ~ N(0, 1)
    and v ~ U(-1, 1) (B, T, H, Dh) with a (D, H, Dh) table projection of
    lecun scale, and int32 lengths with row 0 at T (or ``valid``), row 1
    at 1 and row 2 at 0 (clamped to 1)."""
    import torch
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    g = torch.Generator(device=device).manual_seed(seed)
    q_u, q_w, k = (torch.randn((B, T, H, Dh), generator=g, device=device)
                   for _ in range(3))
    v = 2 * torch.rand((B, T, H, Dh), generator=g, device=device) - 1
    r_kernel = torch.randn((D, H, Dh), generator=g, device=device) / D ** 0.5
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    lengths[:3] = torch.tensor([valid or T, 1, 0])[:B]
    qu, qp, kk, kp = fr._operands(q_u, q_w, k, r_kernel)
    return qu, qp, kk, kp, v, lengths.int()


def relpos_bound_ms(qu, qp, kp, lengths):
    """The least time of one rel-pos flash call: qu, qp, k, kp, v and the
    context read or written once, 2 (Dh + D + Dh) FLOP per (query, valid
    key) pair."""
    B, T, H, Dh = qu.shape
    D = kp.shape[-1]
    nbytes = (4 * qu.numel() + qp.numel() + kp.numel()) * qu.element_size() \
        + 4 * B
    pairs = H * T * int(lengths.clamp(min=1, max=T).sum())
    return bound_ms(nbytes, 2.0 * (2 * Dh + D) * pairs, qu.dtype)


def phase_relpos(card):
    """``flash_relpos_fwd`` against ``relpos_attention_plain`` on the
    card: fp32 within RELPOS_FP32_ATOL; bf16 within
    ``relpos_attention_bound``, element by element, refusing a planted
    fault; two calls bit-identical. Prints the CTAs an SM holds of each
    bf16 kernel at Conformer-M's and Conformer-L's widths. Returns the
    worst fp32 error and the timings at Conformer-M's shape (and at the
    transducer's)."""
    import torch
    import torch.nn.functional as F
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    dev = torch.device("cuda")
    worst, timed = 0.0, {}
    for name, D in (("conformer-m", 256), ("conformer-l", 512)):
        print("[relpos] {} (Dh 64, D {}) bf16 CTAs an SM: forward {}, dq {}, "
              "dkv {}".format(name, D, *(fr.ctas_per_sm(kernel, 64, D)
                                         for kernel in ("fwd", "dq", "dkv"))),
              flush=True)
    for i, (name, B, H, T, Dh, D) in enumerate(RELPOS_CASES):
        case = relpos_case(B, H, T, Dh, D, 40 + i, dev,
                           STREAMING_VALID.get(name))
        scale = Dh ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            qu, qp, k, kp, v = (x.to(dtype) for x in case[:5])
            args = (qu, qp, k, kp, v, case[5], scale)
            before = fr.LAUNCHES
            got, lse = fr.relpos_attention(*args, return_lse=True)
            again, lse2 = fr.relpos_attention(*args, return_lse=True)
            want, want_lse = fr.relpos_attention_plain(*args)
            torch.cuda.synchronize()
            check(fr.LAUNCHES == before + 2, "{}: launches".format(name))
            err = float((got.float() - want.float()).abs().max())
            lse_err = float(((lse - want_lse).abs() /
                             want_lse.abs().clamp(min=1.0)).max())
            same = torch.equal(got, again) and torch.equal(lse, lse2)
            print("[relpos] {} B={} H={} T={} Dh={} D={} {}: context max abs "
                  "err {:.3e}, lse {:.3e}, repeat bit-identical: {}".format(
                      name, B, H, T, Dh, D, str(dtype)[6:], err, lse_err,
                      same), flush=True)
            check(same and got.dtype == dtype and
                  bool(torch.isfinite(got).all()),
                  "{}: repeat or dtype".format(name))
            check(lse_err <= RELPOS_LSE_ATOL, "{}: lse err {}".format(
                name, lse_err))
            if dtype == torch.float32:
                worst = max(worst, err)
                check(err <= RELPOS_FP32_ATOL, "{}: fp32 err {}".format(
                    name, err))
            else:
                bound = fr.relpos_attention_bound(*args)
                reading = bound_reading(got, want, bound)
                planted = planted_fault_reading(got, want, bound)
                math_reading = bound_reading(got, fr.relpos_attention_plain(
                    *args, round_weights=False)[0], bound)
                print("[relpos] {} bf16: {:.4f} of the bound at most against "
                      "the plain version ({:.4f} against its fp32 math); a "
                      "planted fault, the context zeroed but in batch row 1, "
                      "reads {:.1f}".format(name, reading, math_reading,
                                            planted), flush=True)
                check(reading <= 1.0, "{}: bf16 err {} times the bound"
                      .format(name, reading))
                check(planted > 1.0, "{}: the bound takes a planted fault"
                      .format(name))
            if dtype == torch.float32 or \
                    (i > 0 and name not in TRANSDUCER_SHAPES +
                     (STREAMING_SHAPE,)):
                continue
            q_aug = torch.cat([qu.transpose(1, 2), qp], dim=-1)
            k_aug = torch.cat([k.transpose(1, 2),
                               kp.expand(B, H, T, D)], dim=-1)
            v_t = v.transpose(1, 2).contiguous()
            mask = (torch.arange(T, device=dev)[None, :] <
                    case[5].clamp(min=1)[:, None])[:, None, None, :]
            times = timed[name] = {
                "ms": cuda_ms(lambda: fr.relpos_attention(*args), 50),
                "plain_ms": cuda_ms(
                    lambda: fr.relpos_attention_plain(*args), 10),
                "library_ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q_aug, k_aug, v_t, attn_mask=mask,
                        scale=scale), 50)}
            times["bound_ms"], times["bound_by"] = relpos_bound_ms(
                qu, qp, kp, case[5])
            print("[relpos] {} bf16: kernel {:.4f} ms, plain {:.4f} ms, SDPA "
                  "on q~, k~, v {:.4f} ms, bound {:.4f} ms ({}) (CUDA events, "
                  "back to back; {})".format(
                      name, times["ms"], times["plain_ms"],
                      times["library_ms"], times["bound_ms"],
                      times["bound_by"], card), flush=True)
    # what the kernel does not take, it refuses
    qu, qp, k, kp, v, lengths = relpos_case(2, 2, 8, 32, 128, 0, dev)
    for bad in ((qu.half(), qp.half(), k.half(), kp.half(), v.half(),
                 lengths),
                (qu, qp[..., :100].contiguous(), k,
                 kp[:, :100].contiguous(), v, lengths),
                (qu[..., :16].contiguous(), qp, k[..., :16].contiguous(), kp,
                 v[..., :16].contiguous(), lengths),
                (qu.transpose(1, 2), qp, k, kp, v, lengths),
                (qu, qp, k, kp, v, lengths.long())):
        try:
            fr.relpos_attention_cuda(*bad, 0.25)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad rel-pos input "
                           "launched")
    print("[relpos] wrong dtype, widths, layout and lengths are refused",
          flush=True)
    return worst, with_transducer_times(timed, RELPOS_CASES[0][0])


# name, B, T, D, k: Conformer-M's conv module (the main path's), D = 512
# (Conformer-L's width), an odd T with a zero-length row and the
# transducer's shapes
CONV_CASES = (
    ("conformer-m", 64, 250, 256, 31),
    ("D=512", 64, 250, 512, 31),
    ("odd T=37", 5, 37, 256, 31),
    ("transducer T'=250", 128, 250, 256, 31),
    ("transducer T'=418", 128, 418, 256, 31),
    (STREAMING_SHAPE, 1, 128, 256, 31),
)
CONV_FP32_ATOL = 1e-4
# bf16: the kernel's u (written out by the CTA that owns the frame) held
# from x and its y from that u, element by element within
# ``conformer_conv_module_bounds`` (one ulp of each rounding to bf16, sums
# in another order, the fp32 chain); the reading is the largest |kernel -
# fp64 recompute| / bound, at most 1, and each of ``fwd_faults`` must read
# above 1


def conv_case(B, T, D, k, seed, device, valid=None):
    """x ~ N(0, 1) (B, T, D), lengths with row 0 at T (or ``valid``) and
    row 1 at 0, and the module's ten fp32 weights at lecun scale, norms
    near 1, biases near 0."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(shape, generator=g,
                                            device=device)

    x = randn(B, T, D)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    lengths[:2] = torch.tensor([valid or T, 0])[:B]
    weights = (randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1),
               randn(D, 2 * D, scale=D ** -0.5), randn(2 * D, scale=0.1),
               randn(k, D, scale=k ** -0.5), randn(D, scale=0.1),
               randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1),
               randn(D, D, scale=D ** -0.5), randn(D, scale=0.1))
    return x, lengths.int(), weights


def conv_bound_ms(x, weights):
    """The least time of one conv module call: x and y read or written
    once with the fp32 weights and the lengths; 2 D (2D + D + k) FLOP a
    frame (the two pointwise products and the depthwise taps)."""
    B, T, D = x.shape
    k = weights[4].shape[0]
    nbytes = 2 * x.numel() * x.element_size() + 4 * B + \
        sum(w.numel() for w in weights) * 4
    return bound_ms(nbytes, 2.0 * B * T * D * (3 * D + k), x.dtype)


def phase_conformer_conv(card):
    """``conformer_conv_fwd`` against ``conformer_conv_module_plain`` on
    the card. Returns the worst fp32 error and the timings at
    Conformer-M's shape (and at the transducer's)."""
    import torch
    from openseq2seq_tpu_torch.encoders.conformer_encoder import _ConvModule
    from openseq2seq_tpu_torch.ops import conformer_conv as cc
    from openseq2seq_tpu_torch.ops import bounds as eb
    dev = torch.device("cuda")
    worst, timed, reading = 0.0, {}, 0.0
    for i, (name, B, T, D, k) in enumerate(CONV_CASES):
        x, lengths, weights = conv_case(B, T, D, k, 60 + i, dev,
                                        STREAMING_VALID.get(name))
        for dtype in (torch.float32, torch.bfloat16):
            args = (x.to(dtype), lengths) + weights
            before = cc.LAUNCHES
            got = cc.conformer_conv_module(*args)
            again = cc.conformer_conv_module(*args)
            want = cc.conformer_conv_module_plain(*args)
            torch.cuda.synchronize()
            check(cc.LAUNCHES == before + 2, "{}: launches".format(name))
            if dtype == torch.bfloat16:
                y, inter = cc.conformer_conv_module_cuda(
                    *args, intermediates=True)
                check(torch.equal(y, got), "{}: y differs with u written "
                      "out".format(name))
                tile, smem, ctas = cc.fwd_resources(D, k)
                print("[conv] {} bf16: one fused launch of {} frames a CTA, "
                      "{} bytes of shared memory, {} CTA(s) an SM, after a "
                      "pre-pass that rounds w1 and w2 to bf16 ({} bytes); y "
                      "bit-identical with u written out".format(
                          name, tile, smem, ctas, 6 * D * D), flush=True)
                bounds = cc.conformer_conv_module_bounds(
                    args[0], lengths, inter["u"], *weights)
                reading = max(reading, print_readings(
                    "conv " + name, eb.readings(dict(inter, y=y), bounds),
                    cc.fwd_faults(bounds, inter["u"], y, weights, tile)))
                # other tiles put the tile edges elsewhere: a halo frame's
                # u must be its owner's bits
                for t in (64, 32, 16):
                    if t != tile and cc.fwd_resources(D, k, t)[2] > 0:
                        yt, it = cc.conformer_conv_module_cuda(
                            *args, intermediates=True, tile=t)
                        check(torch.equal(yt, y) and
                              torch.equal(it["u"], inter["u"]),
                              "{}: tile {} differs".format(name, t))
                        print("[conv] {} bf16: y and u at {} frames a CTA "
                              "bit-identical to {}".format(name, t, tile),
                              flush=True)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            rel = float((diff / want.float().abs().clamp(min=1.0)).max())
            same = torch.equal(got, again)
            print("[conv] {} B={} T={} D={} k={} {}: max abs err {:.3e}, of "
                  "max(1, |y|) {:.3e} (|y| max {:.2f}), repeat "
                  "bit-identical: {}".format(
                      name, B, T, D, k, str(dtype)[6:], err, rel,
                      float(want.float().abs().max()), same), flush=True)
            check(same and got.dtype == dtype and
                  bool(torch.isfinite(got).all()),
                  "{}: repeat or dtype".format(name))
            if dtype == torch.float32:
                worst = max(worst, err)
                check(err <= CONV_FP32_ATOL, "{}: fp32 err {}".format(name,
                                                                     err))
            if dtype == torch.float32 or \
                    (i > 0 and name not in TRANSDUCER_SHAPES +
                     (STREAMING_SHAPE,)):
                continue
            module = _ConvModule(D, k, dtype, False,
                                 torch.Generator().manual_seed(0)).to(dev)
            with torch.no_grad():
                for p, w in zip(module.parameters(), weights):
                    p.copy_(w)
                times = timed[name] = {"ms": cuda_ms(
                    lambda: cc.conformer_conv_module(*args), 50),
                    "plain_ms": cuda_ms(
                        lambda: cc.conformer_conv_module_plain(*args), 10),
                    "unfused_ms": cuda_ms(
                        lambda: module(args[0], lengths), 20)}
            times["bound_ms"], times["bound_by"] = conv_bound_ms(args[0],
                                                                 weights)
            print("[conv] {} bf16: kernel {:.4f} ms, plain {:.4f} ms, bound "
                  "{:.4f} ms ({}); the module's unfused torch chain {:.4f} "
                  "ms, for information (CUDA events, back to back; {})"
                  .format(name, times["ms"], times["plain_ms"],
                          times["bound_ms"], times["bound_by"],
                          times["unfused_ms"], card), flush=True)
    # what the kernel does not take, it refuses
    x, lengths, w = conv_case(2, 9, 96, 7, 0, dev)
    x2, lengths2, w2 = conv_case(2, 9, 128, 65, 0, dev)
    x3, lengths3, w3 = conv_case(2, 9, 512, 63, 0, dev)
    before = cc.LAUNCHES
    for bad, tile in (((x, lengths) + w, 0), ((x2, lengths2) + w2, 0),
                      ((x2[..., :64].double(), lengths2) + w2, 0),
                      ((x2.transpose(0, 1), lengths2) + w2, 0),
                      ((x2, lengths2.long()) + w2, 0),
                      ((x3.bfloat16(), lengths3) + w3, 64)):
        try:
            cc.conformer_conv_module_cuda(*bad, tile=tile)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad conv module "
                           "input launched")
    check(cc.LAUNCHES == before, "a refused conv module input counted")
    print("[conv] widths, taps, dtype, layout and lengths outside the "
          "kernel's limits are refused, and a tile of 64 frames at D 512, "
          "k 63 (more shared memory than an SM gives a CTA), before any "
          "launch", flush=True)
    times = with_transducer_times(timed, CONV_CASES[0][0])
    times["bound_reading"] = reading
    return worst, times


RELPOS_BWD_FP32_ATOL = 1e-4
# bf16: each gradient element within relpos_attention_bwd_bound of the
# plain version on the same bf16 inputs (one bf16 ulp of each p or ds
# that may round the other way, the fp32 sums in another order, one ulp of
# the element), and within twice it of the plain version's fp32 math (the
# bf16 inputs upcast, p and ds unrounded); a planted fault, dv zeroed on
# every batch row but row 1, must read above 1


def relpos_bwd_bound_ms(qu, qp, kp, lengths, kernel):
    """The least time of the rel-pos backward: ``dq`` reads qu, qp, k, kp,
    v, o, dO and lse and writes dqu, dqp and delta, 2 (Dh + D) + 2 Dh + 2
    (Dh + D) FLOP per (query, valid key) pair (scores, dO.v, dq~); ``dkv``
    reads qu, qp, k, kp, v, dO, lse and delta and writes dk and dv, 2 (Dh +
    D) + 6 Dh per pair (scores, dO.v, dv, dk); ``all`` is the whole
    backward: the inputs and gradients read or written once, the scores,
    dO.v, dv, dk and dq~ once each, 4 (Dh + D) + 6 Dh per pair."""
    B, T, H, Dh = qu.shape
    D = kp.shape[-1]
    e = qu.element_size()
    head, pos, table = qu.numel() * e, qp.numel() * e, kp.numel() * e
    rows = B * H * T * 4                     # lse or delta, fp32
    pairs = H * T * int(lengths.clamp(min=1, max=T).sum())
    nbytes, per_pair = {
        "dq": (6 * head + 2 * pos + table + 2 * rows + 4 * B,
               4 * (Dh + D) + 2 * Dh),
        "dkv": (6 * head + pos + table + 2 * rows + 4 * B,
                2 * (Dh + D) + 6 * Dh),
        "all": (8 * head + 2 * pos + table + rows + 4 * B,
                4 * (Dh + D) + 6 * Dh)}[kernel]
    return bound_ms(nbytes, float(per_pair) * pairs, qu.dtype)


def _relpos_bwd_kernel_ms(kernel, qu, qp, k, kp, v, lengths, o, lse, do,
                          scale, reps):
    """Device ms of one rel-pos backward kernel alone, launched through
    the same entry point as ``relpos_attention_bwd_cuda`` (not counted)."""
    import torch
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    B, T, H, Dh = k.shape
    dqu, dqp, dk, dv = (torch.empty_like(x) for x in (qu, qp, k, v))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    ints = (B, T, H, Dh, kp.shape[-1], int(k.dtype == torch.bfloat16))
    inputs = (qu.data_ptr(), qp.data_ptr(), k.data_ptr(), kp.data_ptr(),
              v.data_ptr(), lengths.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "dq":
        args = inputs + (o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         torch.empty_like(lse).data_ptr(), dqu.data_ptr(),
                         dqp.data_ptr())
    else:
        args = inputs + (do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                         dk.data_ptr(), dv.data_ptr())
    fn = fr._kernel("flash_relpos_bwd_" + kernel)

    def launch():
        check(fn(*args, *ints, float(scale), stream) == 0,
              "flash_relpos_bwd_{} launch".format(kernel))
    return cuda_ms(launch, reps)


def phase_relpos_bwd(card):
    """The rel-pos backward kernels (after the forward kernel with its lse)
    against ``relpos_attention_bwd_plain`` on the card: fp32 (TF32 off)
    against the plain version on the same inputs within
    RELPOS_BWD_FP32_ATOL; bf16 against the plain version on the same bf16
    inputs (its math in fp32, p and ds rounded where the kernels round
    them) within ``relpos_attention_bwd_bound``, element by element, and
    within FLASH_BWD_BF16_FP32_MATH_BOUNDS times it against the plain
    version's fp32 math, refusing a planted fault; two calls
    bit-identical. Times at Conformer-M's shape (and at the transducer's)
    in bf16. Returns the worst fp32 errors of dq~ and of dk/dv, and the
    timings."""
    import torch
    import torch.nn.functional as F
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    dev = torch.device("cuda")
    worst_dq = worst_dkv = 0.0
    timed = {}
    for i, (name, B, H, T, Dh, D) in enumerate(RELPOS_CASES):
        if name == STREAMING_SHAPE:
            continue
        case = relpos_case(B, H, T, Dh, D, 70 + i, dev)
        scale = Dh ** -0.5
        do = torch.randn((B, T, H, Dh), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(i))
        for dtype in (torch.float32, torch.bfloat16):
            qu, qp, k, kp, v = (x.to(dtype) for x in case[:5])
            lens, dod = case[5], do.to(dtype)
            args = (qu, qp, k, kp, v, lens)
            o, lse = fr.relpos_attention_cuda(*args, scale, return_lse=True)
            before = fr.BWD_DQ_LAUNCHES, fr.BWD_DKV_LAUNCHES
            got = fr.relpos_attention_bwd_cuda(*args, o, lse, dod, scale)
            again = fr.relpos_attention_bwd_cuda(*args, o, lse, dod, scale)
            check((fr.BWD_DQ_LAUNCHES, fr.BWD_DKV_LAUNCHES) ==
                  (before[0] + 2, before[1] + 2), "{}: launches".format(name))
            want = fr.relpos_attention_bwd_plain(*args, o, lse, dod, scale)
            up = [x.float() for x in args[:5]]
            want32 = fr.relpos_attention_bwd_plain(
                *up, lens, o.float(), lse, dod.float(), scale)
            torch.cuda.synchronize()
            errs = [float((g.float() - w.float()).abs().max())
                    for g, w in zip(got, want)]
            tops = [float(w.float().abs().max()) for w in want]
            errs32 = [float((g.float() - w).abs().max())
                      for g, w in zip(got, want32)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print("[relpos bwd] {} B={} H={} T={} Dh={} D={} {}: dqu, dqp, "
                  "dk, dv max abs err {} (|max| {}); against the plain "
                  "version's fp32 math {}; repeat bit-identical: {}".format(
                      name, B, H, T, Dh, D, str(dtype)[6:],
                      ", ".join("{:.3e}".format(e) for e in errs),
                      ", ".join("{:.2f}".format(t) for t in tops),
                      ", ".join("{:.3e}".format(e) for e in errs32), same),
                  flush=True)
            check(same and all(g.dtype == dtype and
                               bool(torch.isfinite(g).all()) for g in got),
                  "{}: repeat, dtype or non-finite".format(name))
            if dtype == torch.float32:
                worst_dq = max(worst_dq, errs[0], errs[1])
                worst_dkv = max(worst_dkv, errs[2], errs[3])
                check(max(errs) <= RELPOS_BWD_FP32_ATOL,
                      "{}: fp32 err {}".format(name, errs))
            else:
                bounds = fr.relpos_attention_bwd_bound(*args, o, lse, dod,
                                                       scale)
                readings = [bound_reading(g, w, b)
                            for g, w, b in zip(got, want, bounds)]
                math_readings = [bound_reading(g, w, b)
                                 for g, w, b in zip(got, want32, bounds)]
                planted = planted_fault_reading(got[3], want[3], bounds[3])
                print("[relpos bwd] {} bf16: dqu, dqp, dk, dv {} of the "
                      "bound at most against the plain version, {} against "
                      "its fp32 math; a planted fault, dv zeroed but in "
                      "batch row 1, reads {:.1f}".format(
                          name, ", ".join("{:.4f}".format(r)
                                          for r in readings),
                          ", ".join("{:.4f}".format(r)
                                    for r in math_readings), planted),
                      flush=True)
                check(max(readings) <= 1.0, "{}: bf16 gradient err {} times "
                      "the bound".format(name, readings))
                check(max(math_readings) <= FLASH_BWD_BF16_FP32_MATH_BOUNDS,
                      "{}: bf16 gradient err {} times the bound against fp32 "
                      "math".format(name, math_readings))
                check(planted > 1.0, "{}: the bound takes a planted fault"
                      .format(name))
            if dtype == torch.float32 or \
                    (i > 0 and name not in TRANSDUCER_SHAPES):
                continue
            q_aug = torch.cat([qu.transpose(1, 2), qp], dim=-1)
            k_aug = torch.cat([k.transpose(1, 2), kp.expand(B, H, T, D)],
                              dim=-1)
            leaves = [x.detach().requires_grad_()
                      for x in (q_aug, k_aug, v.transpose(1, 2))]
            mask = (torch.arange(T, device=dev)[None, :] <
                    lens.clamp(min=1)[:, None])[:, None, None, :]
            do_t = dod.transpose(1, 2)

            def sdpa_fwd_bwd():
                F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, scale=scale).backward(do_t)
            bwd_args = args + (o, lse, dod, scale)
            times = timed[name] = {
                "ms": cuda_ms(lambda: fr.relpos_attention_bwd_cuda(
                    *bwd_args), 10),
                "dq_ms": _relpos_bwd_kernel_ms("dq", *bwd_args, 10),
                "dkv_ms": _relpos_bwd_kernel_ms("dkv", *bwd_args, 10),
                "plain_ms": cuda_ms(lambda: fr.relpos_attention_bwd_plain(
                    *bwd_args), 10),
                "library_ms": cuda_ms(sdpa_fwd_bwd, 20)}
            for part in ("all", "dq", "dkv"):
                times[part + "_bound"] = relpos_bwd_bound_ms(qu, qp, kp,
                                                             lens, part)
            print("[relpos bwd] {} bf16: dq+dkv {:.4f} ms (dq {:.4f}, dkv "
                  "{:.4f}), bound {:.4f} ms ({}; dq {:.4f}, dkv {:.4f}); "
                  "plain backward {:.4f} ms; SDPA forward+backward on q~, "
                  "k~, v {:.4f} ms (CUDA events, back to back; {})".format(
                      name, times["ms"], times["dq_ms"], times["dkv_ms"],
                      times["all_bound"][0], times["all_bound"][1],
                      times["dq_bound"][0], times["dkv_bound"][0],
                      times["plain_ms"], times["library_ms"], card),
                  flush=True)
    # what the backward does not take, it refuses
    qu, qp, k, kp, v, lengths = relpos_case(2, 2, 8, 32, 128, 0, dev)
    o, lse = fr.relpos_attention_cuda(qu, qp, k, kp, v, lengths, 0.25,
                                      return_lse=True)
    for bad in ((qu, qp, k, kp, v, lengths, o.bfloat16(), lse, o),
                (qu, qp, k, kp, v, lengths, o, lse.double(), o),
                (qu, qp, k, kp, v, lengths, o, lse, o.transpose(1, 2)),
                (qu, qp, k, kp, v, lengths.long(), o, lse, o)):
        try:
            fr.relpos_attention_bwd_cuda(*bad, 0.25)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad rel-pos backward "
                           "input launched")
    print("[relpos bwd] wrong dtype, layout and lengths are refused",
          flush=True)
    return worst_dq, worst_dkv, with_transducer_times(timed,
                                                      RELPOS_CASES[0][0])


# the gradients' largest error, relative to max(1, their largest
# magnitude): fp32 (TF32 off) sums over up to 16,000 rows in another order.
# bf16: each of the kernels' fp32 intermediates held from the ones before
# it, dx from their dh0 and the ten weight gradients from their
# intermediates, element by element within
# ``conformer_conv_module_bwd_bounds`` (db1, dwd, dw1 and dw2 at the
# kernels' summation depth, ``sum_depth``); the reading is the largest |kernel -
# fp64 recompute| / bound, at most 1, and each of ``bwd_faults`` must read
# above 1
CONV_BWD_FP32_TOL = 1e-5


def conv_bwd_bound_ms(x, weights):
    """The least time of the conv module's backward: x and dy read, dx
    written, the fp32 weights read and their gradients written, the
    lengths; 16 D^2 + 6 D k FLOP a frame (pw1 again, dw2, ds, dw1, dh0; the
    taps, du and dwd)."""
    B, T, D = x.shape
    k = weights[4].shape[0]
    nbytes = 3 * x.numel() * x.element_size() + 4 * B + \
        2 * sum(w.numel() for w in weights) * 4
    return bound_ms(nbytes, float(B * T) * (16 * D * D + 6 * D * k),
                    x.dtype)


def phase_conformer_conv_bwd(card):
    """``conformer_conv_bwd`` against ``conformer_conv_module_bwd_plain``
    on the card, on the same inputs; times at Conformer-M's shape (and at
    the transducer's) in bf16 beside the module's unfused torch chain,
    forward plus backward under autograd. Returns the worst fp32 absolute
    error and the timings."""
    import torch
    from openseq2seq_tpu_torch.encoders.conformer_encoder import _ConvModule
    from openseq2seq_tpu_torch.ops import conformer_conv as cc
    from openseq2seq_tpu_torch.ops import bounds as eb
    dev = torch.device("cuda")
    worst, timed, reading = 0.0, {}, 0.0
    for i, (name, B, T, D, k) in enumerate(CONV_CASES):
        if name == STREAMING_SHAPE:
            continue
        x, lengths, weights = conv_case(B, T, D, k, 80 + i, dev)
        dy = torch.randn(x.shape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(i))
        for dtype in (torch.float32, torch.bfloat16):
            args = (x.to(dtype), lengths) + weights + (dy.to(dtype),)
            before = cc.BWD_LAUNCHES
            got = cc.conformer_conv_module_cuda_bwd(*args)
            again = cc.conformer_conv_module_cuda_bwd(*args)
            check(cc.BWD_LAUNCHES == before + 2, "{}: launches".format(name))
            want = cc.conformer_conv_module_bwd_plain(*args)
            torch.cuda.synchronize()
            rel = [float((g.float() - w.float()).abs().max()) /
                   max(1.0, float(w.float().abs().max()))
                   for g, w in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print("[conv bwd] {} B={} T={} D={} k={} {}: max abs err of "
                  "max(1, |gradient|) {}; repeat bit-identical: {}".format(
                      name, B, T, D, k, str(dtype)[6:],
                      ", ".join("{} {:.2e}".format(n, e)
                                for n, e in zip(cc.GRADS, rel)), same),
                  flush=True)
            check(same and got[0].dtype == dtype and
                  all(g.dtype == torch.float32 for g in got[1:]) and
                  all(bool(torch.isfinite(g).all()) for g in got),
                  "{}: repeat, dtype or non-finite".format(name))
            if dtype == torch.float32:
                worst = max(worst, max(float((g - w).abs().max())
                                       for g, w in zip(got, want)))
                check(max(rel) <= CONV_BWD_FP32_TOL,
                      "{}: fp32 err {}".format(name, rel))
            else:
                grads, inter = cc.conformer_conv_module_cuda_bwd(
                    *args, intermediates=True)
                check(all(torch.equal(a, b) for a, b in zip(grads, got)),
                      "{}: gradients differ with the intermediates written "
                      "out".format(name))
                check(torch.equal(inter["a again"], inter["a"]),
                      "{}: the second launch's a differs".format(name))
                res = cc.bwd_resources(D, k)
                print("[conv bwd] {} bf16: 6 launches (the weights' pre-"
                      "pass; then, as (tile, bytes of shared memory, CTAs "
                      "an SM), launch 1 {}, 2 {}, 3 {}, 4 {}; the "
                      "reduction); workspace {} bytes; the gradients "
                      "bit-identical with the intermediates written out, "
                      "the second launch's a the first's".format(
                          name, *res, cc.bwd_workspace(B, T, D, k)),
                      flush=True)
                tile = res[1][0]
                bounds = cc.conformer_conv_module_bwd_bounds(
                    args[0], lengths, inter, *weights, args[-1],
                    depth=cc.sum_depth(B, T, tile))
                reading = max(reading, print_readings(
                    "conv bwd " + name, eb.readings(
                        dict(inter, **dict(zip(cc.GRADS, grads))), bounds),
                    cc.bwd_faults(bounds, lengths, inter, grads, weights[4],
                                  tile)))
                for t in (64, 32, 16):
                    if all(r[0] == t or j > 1 for j, r in enumerate(res)) \
                            or not all(r[2] > 0 for r in
                                       cc.bwd_resources(D, k, t)):
                        continue
                    gt, it = cc.conformer_conv_module_cuda_bwd(
                        *args, intermediates=True, tile=t)
                    check(all(torch.equal(it[n], inter[n]) for n in inter)
                          and all(torch.equal(gt[j], grads[j])
                                  for j in (0, 3, 9)),
                          "{}: tile {} differs".format(name, t))
                    print("[conv bwd] {} bf16: the intermediates, dx, dw1 "
                          "and dw2 at {} frames a CTA bit-identical".format(
                              name, t), flush=True)
            if dtype == torch.float32 or \
                    (i > 0 and name not in TRANSDUCER_SHAPES):
                continue
            module = _ConvModule(D, k, dtype, False,
                                 torch.Generator().manual_seed(0)).to(dev)
            with torch.no_grad():
                for p, w in zip(module.parameters(), weights):
                    p.copy_(w)
            xg = args[0].detach().requires_grad_()

            def unfused_fwd_bwd():
                module(xg, lengths).backward(args[-1])
            times = timed[name] = {"ms": cuda_ms(
                lambda: cc.conformer_conv_module_cuda_bwd(*args), 20),
                "plain_ms": cuda_ms(
                    lambda: cc.conformer_conv_module_bwd_plain(*args), 10),
                "unfused_ms": cuda_ms(unfused_fwd_bwd, 20)}
            times["bound_ms"], times["bound_by"] = conv_bwd_bound_ms(
                args[0], weights)
            print("[conv bwd] {} bf16: kernels {:.4f} ms, plain {:.4f} ms, "
                  "bound {:.4f} ms ({}); the module's unfused torch chain, "
                  "forward plus backward under autograd, {:.4f} ms, the "
                  "yardstick (CUDA events, back to back; {})".format(
                      name, times["ms"], times["plain_ms"],
                      times["bound_ms"], times["bound_by"],
                      times["unfused_ms"], card), flush=True)
    # what the backward does not take, it refuses
    x, lengths, w = conv_case(2, 9, 128, 7, 0, dev)
    x3, lengths3, w3 = conv_case(2, 9, 512, 63, 0, dev)
    before = cc.BWD_LAUNCHES
    for bad, tile in (((x, lengths) + w + (x.bfloat16(),), 0),
                      ((x, lengths) + w + (x[:, :8],), 0),
                      ((x.transpose(0, 1), lengths) + w + (x,), 0),
                      ((x, lengths.long()) + w + (x,), 0),
                      ((x3.bfloat16(), lengths3) + w3 + (x3.bfloat16(),),
                       64)):
        try:
            cc.conformer_conv_module_cuda_bwd(*bad, tile=tile)
        except ValueError:
            continue
        raise RuntimeError("chip_smoke check failed: a bad conv module "
                           "backward input launched")
    check(cc.BWD_LAUNCHES == before, "a refused conv backward counted")
    print("[conv bwd] wrong dtype, shape, layout and lengths are refused, "
          "and a tile of 64 frames at D 512, k 63, before any launch",
          flush=True)
    times = with_transducer_times(timed, CONV_CASES[0][0])
    times["bound_reading"] = reading
    return worst, times


def _small_params(data_layer, no_dropout=False, **overrides):
    from openseq2seq_tpu_torch.zoo import jasper_model_params
    params = jasper_model_params(
        data_layer,
        {"num_audio_features": 64, "tgt_vocab_size": 29,
         "time_steps": 200, "label_length": 30, "num_batches": 1},
        num_blocks=2, block_repeat=2, width_scale=0.25,
        batch_size_per_gpu=4, dtype="float32", **overrides)
    if no_dropout:
        enc = params["encoder_params"]
        enc["dropout_keep_prob"] = 1.0
        for layer in enc["convnet_layers"]:
            layer["dropout_keep_prob"] = 1.0
    return params


def phase_small_reference(config):
    """A small fp32 Jasper, same seed and the config's data layer, on the
    card and on the CPU: an eval step, and one train step without dropout
    (the conv biases that feed a batch norm frozen: their gradient is
    rounding noise, which NovoGrad scales to a full-size update)."""
    import numpy as np
    from openseq2seq_tpu_torch.training import trainer
    data_layer = config["base_params"]["data_layer"]
    out, trained = {}, {}
    for device in ("cuda", "cpu"):
        model = config["base_model"](_small_params(data_layer), mode="eval",
                                     device=device)
        state = trainer.restore_state(model)
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        out[device] = trainer.to_host(model.eval_step(state, batch))

        model = config["base_model"](_small_params(
            data_layer, no_dropout=True, max_steps=1,
            freeze_variables_regex=r"/(conv|res)\d+_\d+/bias$"),
            mode="train", device=device)
        state = trainer.restore_state(model)
        state, metrics = model.train_step(state, batch)
        trained[device] = (float(metrics["loss"]), {
            n: p.detach().cpu().numpy()
            for n, p in state.module.named_parameters()})
    (loss_gpu, w_gpu), (loss_cpu, w_cpu) = trained["cuda"], trained["cpu"]
    w_err = max(float(np.max(np.abs(w_gpu[n] - w_cpu[n]) /
                             (1e-6 + 1e-4 * np.abs(w_cpu[n]))))
                for n in w_cpu)
    print("[slice] small fp32 Jasper, one train step, card vs CPU: loss "
          "{:.6f} vs {:.6f}; largest weight difference {:.3f} of the "
          "tolerance (rtol 1e-4, atol 1e-6)".format(loss_gpu, loss_cpu,
                                                     w_err), flush=True)
    check(abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu) and w_err <= 1.0,
          "small Jasper train step disagrees between card and CPU")
    lg = [out[d]["outputs"]["decoder_output"]["logits"]
          for d in ("cuda", "cpu")]
    logit_err = float(abs(lg[0] - lg[1]).max())
    loss_rel = abs(out["cuda"]["loss"] - out["cpu"]["loss"]) / \
        abs(out["cpu"]["loss"])
    print("[slice] small fp32 Jasper, card vs CPU: logits max abs err "
          "{:.3e} (|logits| max {:.2f}), loss {:.6f} vs {:.6f}".format(
              logit_err, float(abs(lg[1]).max()), float(out["cuda"]["loss"]),
              float(out["cpu"]["loss"])), flush=True)
    check(logit_err <= 1e-3 and loss_rel <= 1e-4,
          "small Jasper disagrees between card and CPU")


def phase_slice(config, card):
    import torch
    from openseq2seq_tpu_torch import run
    from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.training import CheckpointManager, trainer

    with tempfile.TemporaryDirectory() as logdir:
        params = dict(config["base_params"], logdir=logdir)
        n_batches = params["data_layer_params"]["num_batches"]
        t0 = time.time()
        model = config["base_model"](params=params, mode="eval",
                                     device="cuda")
        state = trainer.restore_state(model)
        CheckpointManager(logdir).save(state, 0)
        n_params = sum(p.numel() for p in state.module.parameters())
        print("[slice] Jasper-10x5 built: {} parameters, dtype {}, seeded "
              "checkpoint saved in {:.1f} s".format(
                  n_params, params["dtype"], time.time() - t0), flush=True)

        argv = ["--config_file=" + CONFIG, "--logdir=" + logdir]
        out_csv = os.path.join(logdir, "infer.csv")
        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0
        metrics = run.main(argv + ["--mode=eval"])
        run.main(argv + ["--mode=infer", "--infer_output_file=" + out_csv])
        launches = ctc_cuda.LAUNCHES
        check(ctc_cuda.BWD_LAUNCHES == 0, "eval launched the backward")
        print("[slice] eval: loss {:.6f}, WER {:.4f}; CTC kernel launches "
              "in eval+infer: {} for {} eval batches".format(
                  metrics["eval_loss"], metrics["Eval WER"], launches,
                  n_batches), flush=True)
        check(launches == n_batches, "kernel launched {} times for {} "
              "eval batches".format(launches, n_batches))
        check(math.isfinite(metrics["eval_loss"]) and
              metrics["eval_loss"] > 0, "eval loss not finite")
        check(0.0 <= metrics["Eval WER"], "WER not computed")
        with open(out_csv) as f:
            rows = list(csv.reader(f))[1:]
        print("[slice] infer: {} rows in the CSV".format(len(rows)),
              flush=True)
        check(len(rows) == n_batches * params["batch_size_per_gpu"],
              "infer CSV has {} rows".format(len(rows)))

        # one batch's loss recomputed from its logits by the plain version
        dl = model.get_data_layer()
        batch = next(iter(dl.iterate_one_epoch()))
        out = model.eval_step(state, batch)
        dec = out["outputs"]["decoder_output"]
        logits = dec["logits"]
        check(tuple(logits.shape) == (32, 500, 29) and
              bool(torch.all(torch.isfinite(logits))),
              "logits shape {} or not finite".format(tuple(logits.shape)))
        labels, label_lens = to_device_batch(batch, "cuda")["target_tensors"]
        plain = ctc.ctc_loss(logits, dec["src_length"], labels, label_lens)
        rel = abs(float(out["loss"]) - float(plain)) / abs(float(plain))
        print("[slice] batch loss: kernel {:.6f}, plain {:.6f}, rel err "
              "{:.3e}".format(float(out["loss"]), float(plain), rel),
              flush=True)
        check(rel <= RTOL, "batch loss disagrees with the plain version")

        # eval throughput over the epoch (information, not a claim)
        batches = list(dl.iterate_one_epoch())
        model.eval_step(state, batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            model.eval_step(state, b)
        torch.cuda.synchronize()
        utt = sum(len(b["source_ids"]) for b in batches) / \
            (time.perf_counter() - t0)
        print("[slice] eval throughput {:.1f} utt/s (batch 32, 10 s "
              "utterances, bf16; {})".format(utt, card), flush=True)
    return launches


def phase_small_transformer():
    """The tiny fp32 transformer config, same seed, on the card (through
    the flash kernel) and on the CPU: teacher-forced logits agree and
    the beams are identical."""
    import numpy as np
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    from openseq2seq_tpu_torch.training import trainer
    config = runpy.run_path(NMT_TINY)
    out = {}
    for device in ("cuda", "cpu"):
        model = config["base_model"](config["base_params"], mode="eval",
                                     device=device)
        state = trainer.restore_state(model)
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        launches = fa.LAUNCHES
        out[device] = trainer.to_host(model.eval_step(state, batch))
        out[device]["launches"] = fa.LAUNCHES - launches
    gpu, cpu = (out[d]["outputs"]["decoder_output"] for d in ("cuda", "cpu"))
    logit_err = float(np.abs(gpu["logits"] - cpu["logits"]).max())
    same = all(np.array_equal(gpu[k], cpu[k]) for k in ("beams",)) and \
        all(np.array_equal(a, b) for a, b in zip(gpu["outputs"],
                                                 cpu["outputs"]))
    print("[nmt] tiny fp32 transformer, card vs CPU: logits max abs err "
          "{:.3e} (|logits| max {:.2f}), loss {:.6f} vs {:.6f}, beams "
          "identical: {}; flash launches on the card {}, on the CPU {}"
          .format(logit_err, float(np.abs(cpu["logits"]).max()),
                  float(out["cuda"]["loss"]), float(out["cpu"]["loss"]), same,
                  out["cuda"]["launches"], out["cpu"]["launches"]),
          flush=True)
    check(out["cuda"]["launches"] == 6 and out["cpu"]["launches"] == 0,
          "flash launches in the tiny eval step")
    check(logit_err <= 1e-4 and same, "tiny transformer disagrees between "
          "card and CPU")


def phase_transformer(card):
    """Transformer-big from a seeded-init checkpoint through ``run.main``
    in eval and infer; returns the flash launches of both runs."""
    import torch
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    from openseq2seq_tpu_torch.training import CheckpointManager, trainer
    config = runpy.run_path(NMT_CONFIG)
    with tempfile.TemporaryDirectory() as logdir:
        params = dict(config["base_params"], logdir=logdir)
        n_batches = params["data_layer_params"]["num_batches"]
        batch_size = params["batch_size_per_gpu"]
        t0 = time.time()
        model = config["base_model"](params, mode="infer", device="cuda")
        state = trainer.restore_state(model)
        CheckpointManager(logdir).save(state, 0)
        n_params = sum(p.numel() for p in state.module.parameters())
        print("[nmt] transformer-big built: {} parameters, dtype {}, seeded "
              "checkpoint saved in {:.1f} s".format(
                  n_params, params["dtype"], time.time() - t0), flush=True)

        argv = ["--config_file=" + NMT_CONFIG, "--logdir=" + logdir]
        fa.LAUNCHES = 0
        t0 = time.time()
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        eval_launches = fa.LAUNCHES
        print("[nmt] eval: loss {:.6f}, BLEU {:.4f}; flash launches {} for "
              "{} batches; {:.1f} s with the build".format(
                  metrics["eval_loss"], metrics["Eval BLEU"], eval_launches,
                  n_batches, time.time() - t0), flush=True)
        check(eval_launches == 18 * n_batches, "flash launched {} times in "
              "{} eval batches".format(eval_launches, n_batches))
        check(math.isfinite(metrics["eval_loss"]) and
              metrics["eval_loss"] > 0, "eval loss not finite")
        check(math.isfinite(metrics["Eval BLEU"]) and
              metrics["Eval BLEU"] >= 0, "BLEU not computed")

        out = os.path.join(logdir, "infer.txt")
        fa.LAUNCHES = 0
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        infer_launches = fa.LAUNCHES
        with open(out) as f:
            lines = f.read().splitlines()
        print("[nmt] infer: {} lines; flash launches {} for {} batches"
              .format(len(lines), infer_launches, n_batches), flush=True)
        check(infer_launches == 6 * n_batches, "flash launched {} times in "
              "{} infer batches".format(infer_launches, n_batches))
        check(len(lines) == n_batches * batch_size and
              all(line.strip() for line in lines),
              "infer file has {} lines".format(len(lines)))

        # beam-4 infer rate over the epoch (information, not a claim)
        batches = list(model.get_data_layer().iterate_one_epoch())
        out = model.eval_step(state, batches[0])["outputs"]
        ids = out["decoder_output"]["outputs"][0]
        check(tuple(ids.shape) == (batch_size, 64 + 50),
              "decoded ids shape {}".format(tuple(ids.shape)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            model.eval_step(state, b)
        torch.cuda.synchronize()
        rate = n_batches * batch_size / (time.perf_counter() - t0)
        print("[nmt] beam-4 infer {:.2f} sentences/s (batch {}, 64 source "
              "tokens, up to 114 steps, bf16; {})".format(rate, batch_size,
                                                         card), flush=True)
    return eval_launches + infer_launches


def phase_small_transformer_train():
    """The tiny fp32 transformer training config without dropout, same
    seed, on the card (through the flash kernels, forward and backward)
    and on the CPU: one ``train_step`` gives the same loss and updated
    weights. The key projections' biases are frozen: their gradient is
    exactly zero (softmax ignores a constant per row), which in fp32 is
    rounding noise that NovoGrad would scale to a full-size update."""
    import numpy as np
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    from openseq2seq_tpu_torch.training import trainer
    config = runpy.run_path(NMT_TINY_TRAIN)
    params = dict(config["base_params"],
                  freeze_variables_regex=r"/(k|qkv)/bias$")
    for side in ("encoder_params", "decoder_params"):
        params[side] = dict(params[side], attention_dropout=0.0,
                            relu_dropout=0.0, layer_postprocess_dropout=0.0)
    trained = {}
    for device in ("cuda", "cpu"):
        model = config["base_model"](params, mode="train", device=device)
        state = trainer.restore_state(model)
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        before = fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES
        state, metrics = model.train_step(state, batch)
        launches = (fa.BWD_DQ_LAUNCHES - before[0],
                    fa.BWD_DKV_LAUNCHES - before[1])
        trained[device] = (float(metrics["loss"]), launches, {
            n: p.detach().cpu().numpy()
            for n, p in state.module.named_parameters()})
    (loss_gpu, l_gpu, w_gpu), (loss_cpu, l_cpu, w_cpu) = \
        trained["cuda"], trained["cpu"]
    w_err = max(float(np.max(np.abs(w_gpu[n] - w_cpu[n]) /
                             (1e-6 + 1e-4 * np.abs(w_cpu[n]))))
                for n in w_cpu)
    print("[nmt train] tiny fp32 transformer, one train step, card vs CPU: "
          "loss {:.6f} vs {:.6f}; largest weight difference {:.3f} of the "
          "tolerance (rtol 1e-4, atol 1e-6); flash backward launches (dq, "
          "dkv) on the card {}, on the CPU {}".format(
              loss_gpu, loss_cpu, w_err, l_gpu, l_cpu), flush=True)
    check(l_gpu == (6, 6) and l_cpu == (0, 0),
          "flash backward launches in the tiny train step")
    check(abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu) and w_err <= 1.0,
          "tiny transformer train step disagrees between card and CPU")


def phase_transformer_train(card):
    """Transformer-big through ``run.main --mode=train`` for the config's
    20 steps, then eval from its checkpoint and a resumed run. Returns
    the launches of the flash forward, its two backward kernels and the
    dropout kernel over these paths."""
    import torch
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    from openseq2seq_tpu_torch.ops import fused_dropout as fd

    def reset():
        fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
        fd.LAUNCHES = 0

    def counts():
        return (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES,
                fd.LAUNCHES)

    total = [0, 0, 0, 0]
    steps = runpy.run_path(NMT_TRAIN)["base_params"]["max_steps"]
    with tempfile.TemporaryDirectory() as logdir:
        argv = ["--config_file=" + NMT_TRAIN, "--logdir=" + logdir,
                WARMUP_OVERRIDE, "--print_loss_steps=1"]
        print("[nmt train] transformer-big, {} steps of 64 x (64 + 64) "
              "tokens, mixed, dropout on, fused relu dropout; overrides: "
              "{} --print_loss_steps=1".format(steps, WARMUP_OVERRIDE),
              flush=True)
        reset()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        wall = time.time() - t0
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        losses = _losses(lines)
        print("[nmt train] losses {}; launches flash fwd {}, bwd dq {}, "
              "bwd dkv {}, dropout {}; {:.1f} s with the build of the "
              "model".format(losses, *launches, wall), flush=True)
        check(result["steps"] == steps, "trained {} steps".format(
            result["steps"]))
        check(len(losses) == steps and all(math.isfinite(x)
                                           for x in losses),
              "losses not finite at every step: {}".format(losses))
        check(sum(losses[-3:]) < sum(losses[:3]),
              "loss did not fall: {}".format(losses))
        check(launches == (18 * steps, 18 * steps, 18 * steps, 24 * steps),
              "launches {} in {} steps".format(launches, steps))
        print("[nmt train] throughput {:.1f} tokens/s (source + target) "
              "over steps {}-{} (batch 64, 64 + 64 tokens, bf16, a host "
              "read of the loss every step; {})".format(
                  result["objects_per_sec"], 11, steps, card), flush=True)
        ckpt = os.path.join(logdir, "checkpoints", str(steps), "model.pt")
        check(os.path.exists(ckpt), "no checkpoint at {}".format(ckpt))

        reset()
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        print("[nmt train] eval from the step-{} checkpoint: loss {:.6f}, "
              "BLEU {:.4f}; launches flash fwd {}, bwd dq {}, bwd dkv {}, "
              "dropout {}".format(steps, metrics["eval_loss"],
                                  metrics["Eval BLEU"], *launches),
              flush=True)
        check(math.isfinite(metrics["eval_loss"]) and
              launches == (18 * 4, 0, 0, 0), "eval from the trained "
              "checkpoint")

        reset()
        result, lines = _run_quiet(argv + [
            "--mode=train", "--continue_learning",
            "--max_steps={}".format(steps + 3)])
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        started = [x for x in lines if "Starting training from step" in x]
        print("[nmt train] --continue_learning: {}; reached step {}; "
              "launches flash fwd {}, bwd dq {}, bwd dkv {}, dropout {}"
              .format(started[0].strip(), result["steps"], *launches),
              flush=True)
        check(started and started[0].endswith("step {}".format(steps)) and
              result["steps"] == steps + 3 and
              launches == (54, 54, 54, 72), "resumed run")
        torch.cuda.synchronize()
    return total


def phase_small_ds2():
    """The tiny fp32 DeepSpeech2 config, same seed, on the card (through
    the GRU kernel, then with LSTM cells through the LSTM kernel) and on
    the CPU (the kernels' plain versions): eval logits within 1e-4, the
    same lengths and greedy ids."""
    import numpy as np
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    from openseq2seq_tpu_torch.training import trainer
    config = runpy.run_path(DS2_TINY)
    for cell in ("gru", "lstm"):
        params = dict(config["base_params"])
        params["encoder_params"] = dict(params["encoder_params"],
                                        rnn_type="cudnn_" + cell)
        kernel = gru_scan if cell == "gru" else lstm_scan
        out = {}
        for device in ("cuda", "cpu"):
            model = config["base_model"](params, mode="eval", device=device)
            state = trainer.restore_state(model)
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            before = kernel.LAUNCHES
            out[device] = trainer.to_host(model.eval_step(state, batch))
            out[device]["launches"] = kernel.LAUNCHES - before
        gpu, cpu = (out[d]["outputs"]["decoder_output"]
                    for d in ("cuda", "cpu"))
        err = float(np.abs(gpu["logits"] - cpu["logits"]).max())
        same = np.array_equal(gpu["src_length"], cpu["src_length"]) and \
            all(np.array_equal(a, b) for a, b in zip(gpu["outputs"],
                                                     cpu["outputs"]))
        print("[ds2] tiny fp32 DeepSpeech2, {} cells, card vs CPU: logits "
              "max abs err {:.3e} (|logits| max {:.2f}), loss {:.6f} vs "
              "{:.6f}, greedy ids identical: {}; {} launches on the card "
              "{}, on the CPU {}".format(
                  cell.upper(), err, float(np.abs(cpu["logits"]).max()),
                  float(out["cuda"]["loss"]), float(out["cpu"]["loss"]),
                  same, kernel.KERNEL, out["cuda"]["launches"],
                  out["cpu"]["launches"]), flush=True)
        check(out["cuda"]["launches"] == 4 and out["cpu"]["launches"] == 0,
              "{} launches in the tiny eval step".format(kernel.KERNEL))
        check(err <= 1e-4 and same, "tiny DeepSpeech2 ({}) disagrees "
              "between card and CPU".format(cell))


def phase_small_ds2_train():
    """The tiny fp32 DeepSpeech2 config, dropout keep 1.0, same seed, on
    the card (through the GRU kernels, forward and backward, then with
    LSTM cells through the LSTM kernels) and on the CPU (their plain
    versions): one ``train_step`` gives the same loss and updated weights
    (rtol 1e-4, atol 1e-6), with 4 forward and 4 backward launches on the
    card. Momentum in place of the config's Adam and the conv biases
    that feed a batch norm frozen, as ``tests/test_torch_ds2_train.py``
    does: Adam would scale the rounding noise of a near-zero gradient
    element to a full-size update. And tanh in place of relu: with relu,
    one batch-norm output of the 20,480 after the first conv lay within
    rounding of zero, the two devices took opposite sides of the kink,
    and that one element moved the first conv's weight gradient by 1.4%
    of its largest value (every later layer's gradient agreed within
    4e-6 of its largest)."""
    import numpy as np
    import torch
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    from openseq2seq_tpu_torch.training import trainer
    config = runpy.run_path(DS2_TINY)
    for cell in ("gru", "lstm"):
        params = dict(config["base_params"], max_steps=1,
                      optimizer="Momentum",
                      optimizer_params={"learning_rate": 0.01,
                                        "momentum": 0.9},
                      freeze_variables_regex=r"/conv\d+/bias$")
        params["encoder_params"] = dict(params["encoder_params"],
                                        rnn_type="cudnn_" + cell,
                                        dropout_keep_prob=1.0,
                                        activation_fn=torch.tanh)
        kernel = gru_scan if cell == "gru" else lstm_scan
        trained = {}
        for device in ("cuda", "cpu"):
            model = config["base_model"](params, mode="train", device=device)
            state = trainer.restore_state(model)
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            before = kernel.LAUNCHES, kernel.BWD_LAUNCHES
            state, metrics = model.train_step(state, batch)
            launches = (kernel.LAUNCHES - before[0],
                        kernel.BWD_LAUNCHES - before[1])
            trained[device] = (float(metrics["loss"]), launches, {
                n: p.detach().cpu().numpy()
                for n, p in state.module.named_parameters()})
        (loss_gpu, l_gpu, w_gpu), (loss_cpu, l_cpu, w_cpu) = \
            trained["cuda"], trained["cpu"]
        w_err = max(float(np.max(np.abs(w_gpu[n] - w_cpu[n]) /
                                 (1e-6 + 1e-4 * np.abs(w_cpu[n]))))
                    for n in w_cpu)
        print("[ds2 train] tiny fp32 DeepSpeech2, {} cells, one train "
              "step, card vs CPU: loss {:.6f} vs {:.6f}; largest weight "
              "difference {:.3f} of the tolerance (rtol 1e-4, atol 1e-6); "
              "launches (forward, backward) on the card {}, on the CPU {}"
              .format(cell.upper(), loss_gpu, loss_cpu, w_err, l_gpu, l_cpu),
              flush=True)
        check(l_gpu == (4, 4) and l_cpu == (0, 0),
              "{} launches in the tiny train step".format(cell))
        check(abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu) and
              w_err <= 1.0, "tiny DeepSpeech2 ({}) train step disagrees "
              "between card and CPU".format(cell))


def phase_rnn_train(path, name, kernel, per_step, card):
    """A recurrent speech config at full width through ``run.main
    --mode=train`` for its ``train_params``' steps: the loss is finite at
    every step and falls, each step launches ``kernel``'s forward and
    backward ``per_step`` times each and the CTC forward and backward
    once; a checkpoint is written, ``--mode=eval`` runs from it, and
    ``--continue_learning`` takes 3 more steps. The recipes' own learning
    rates move both losses within the 20 steps, so nothing is overridden.
    Returns the forward, backward, CTC forward and CTC backward launches
    over these paths."""
    import torch
    from openseq2seq_tpu_torch.ops import ctc_cuda

    def reset():
        kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0

    def counts():
        return (kernel.LAUNCHES, kernel.BWD_LAUNCHES, ctc_cuda.LAUNCHES,
                ctc_cuda.BWD_LAUNCHES)

    total = [0, 0, 0, 0]
    config = runpy.run_path(path)
    steps = config["train_params"]["max_steps"]
    n_batches = config["base_params"]["data_layer_params"]["num_batches"]
    with tempfile.TemporaryDirectory() as logdir:
        argv = ["--config_file=" + path, "--logdir=" + logdir]
        print("[{}] {} training steps of 32 x 1000 frames, mixed, dropout "
              "on".format(name, steps), flush=True)
        reset()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        wall = time.time() - t0
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        losses = _losses(lines)
        print("[{}] losses {}; launches {} {}, {} {}, CTC forward {}, "
              "backward {}; {:.1f} s with the build of the model".format(
                  name, losses, kernel.KERNEL, launches[0], kernel.BWD_KERNEL,
                  launches[1], launches[2], launches[3], wall), flush=True)
        check(result["steps"] == steps, "trained {} steps".format(
            result["steps"]))
        check(len(losses) == steps and all(math.isfinite(x)
                                           for x in losses),
              "losses not finite at every step: {}".format(losses))
        check(sum(losses[-3:]) < sum(losses[:3]),
              "loss did not fall: {}".format(losses))
        check(launches == (per_step * steps, per_step * steps, steps, steps),
              "launches {} in {} steps".format(launches, steps))
        print("[{}] train throughput {:.1f} utt/s over steps {}-{} (batch "
              "32, 10 s utterances, bf16, a host read of the loss every "
              "step; {})".format(name, result["objects_per_sec"] / 1000,
                                 11, steps, card), flush=True)
        ckpt = os.path.join(logdir, "checkpoints", str(steps), "model.pt")
        check(os.path.exists(ckpt), "no checkpoint at {}".format(ckpt))

        reset()
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        print("[{}] eval from the step-{} checkpoint: loss {:.6f}, WER "
              "{:.4f}; launches {}".format(name, steps, metrics["eval_loss"],
                                           metrics["Eval WER"], launches),
              flush=True)
        check(math.isfinite(metrics["eval_loss"]) and
              launches == (per_step * n_batches, 0, n_batches, 0),
              "eval from the trained checkpoint")

        reset()
        more = _recipe_config(path, logdir, steps + 3)
        result, lines = _run_quiet(["--config_file=" + more, argv[1],
                                    "--mode=train", "--continue_learning"])
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        started = [x for x in lines if "Starting training from step" in x]
        print("[{}] --continue_learning: {}; reached step {}; launches {}"
              .format(name, started[0].strip(), result["steps"], launches),
              flush=True)
        check(started and started[0].endswith("step {}".format(steps)) and
              result["steps"] == steps + 3 and
              launches == (3 * per_step, 3 * per_step, 3, 3), "resumed run")
        torch.cuda.synchronize()
    return total


def phase_rnn_model(path, name, kernel, per_batch, card):
    """A recurrent speech config at full width from a seeded-init
    checkpoint through ``run.main`` in eval and infer: ``kernel`` (the
    GRU or LSTM scan module) launches ``per_batch`` times per batch, the
    CTC forward once per eval batch, the loss is finite and equals the
    plain CTC on the same logits, a WER, 128 infer rows; the eval rate is
    printed as information. Returns the scan and CTC launches."""
    import torch
    from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.training import CheckpointManager, trainer
    config = runpy.run_path(path)
    with tempfile.TemporaryDirectory() as logdir:
        params = dict(config["base_params"], logdir=logdir)
        n_batches = params["data_layer_params"]["num_batches"]
        batch_size = params["batch_size_per_gpu"]
        t0 = time.time()
        model = config["base_model"](params, mode="eval", device="cuda")
        state = trainer.restore_state(model)
        CheckpointManager(logdir).save(state, 0)
        n_params = sum(p.numel() for p in state.module.parameters())
        print("[{}] built: {} parameters, dtype {}, seeded checkpoint saved "
              "in {:.1f} s".format(name, n_params, params["dtype"],
                                   time.time() - t0), flush=True)

        argv = ["--config_file=" + path, "--logdir=" + logdir]
        kernel.LAUNCHES = ctc_cuda.LAUNCHES = 0
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        launches = (kernel.LAUNCHES, ctc_cuda.LAUNCHES)
        print("[{}] eval: loss {:.6f}, WER {:.4f}; {} launches {}, CTC "
              "forward launches {}, for {} batches".format(
                  name, metrics["eval_loss"], metrics["Eval WER"],
                  kernel.KERNEL, *launches, n_batches), flush=True)
        check(launches == (per_batch * n_batches, n_batches),
              "eval launches {} for {} batches".format(launches, n_batches))
        check(math.isfinite(metrics["eval_loss"]) and
              metrics["eval_loss"] > 0, "eval loss not finite")
        check(0.0 <= metrics["Eval WER"], "WER not computed")

        out_csv = os.path.join(logdir, "infer.csv")
        kernel.LAUNCHES = ctc_cuda.LAUNCHES = 0
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out_csv])
        infer_launches = (kernel.LAUNCHES, ctc_cuda.LAUNCHES)
        with open(out_csv) as f:
            rows = list(csv.reader(f))[1:]
        print("[{}] infer: {} rows in the CSV; {} launches {}, CTC forward "
              "launches {}".format(name, len(rows), kernel.KERNEL,
                                   *infer_launches), flush=True)
        check(infer_launches == (per_batch * n_batches, 0),
              "infer launches {}".format(infer_launches))
        check(len(rows) == n_batches * batch_size,
              "infer CSV has {} rows".format(len(rows)))

        # one batch's loss recomputed from its logits by the plain version
        batches = list(model.get_data_layer().iterate_one_epoch())
        out = model.eval_step(state, batches[0])
        dec = out["outputs"]["decoder_output"]
        logits = dec["logits"]
        check(tuple(logits.shape) == (batch_size, 500, 29) and
              bool(torch.all(torch.isfinite(logits))),
              "logits shape {} or not finite".format(tuple(logits.shape)))
        labels, label_lens = to_device_batch(batches[0],
                                             "cuda")["target_tensors"]
        plain = ctc.ctc_loss(logits, dec["src_length"], labels, label_lens)
        rel = abs(float(out["loss"]) - float(plain)) / abs(float(plain))
        print("[{}] batch loss: kernel {:.6f}, plain {:.6f}, rel err "
              "{:.3e}".format(name, float(out["loss"]), float(plain), rel),
              flush=True)
        check(rel <= RTOL, "batch loss disagrees with the plain version")

        # eval throughput over the epoch (information, not a claim)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            model.eval_step(state, b)
        torch.cuda.synchronize()
        utt = n_batches * batch_size / (time.perf_counter() - t0)
        print("[{}] eval throughput {:.1f} utt/s (batch {}, 10 s "
              "utterances, bf16; {})".format(name, utt, batch_size, card),
              flush=True)
    return launches[0] + infer_launches[0], launches[1] + infer_launches[1]


def phase_small_conformer():
    """The tiny fp32 Conformer config (both kernel flags on), same seed,
    on the card (through the rel-pos flash and conv module kernels) and
    on the CPU (their plain versions): eval logits within 1e-4 (fp32 sums
    in other orders through two blocks), the same lengths and greedy
    ids."""
    import numpy as np
    from openseq2seq_tpu_torch.ops import conformer_conv, flash_relpos
    from openseq2seq_tpu_torch.training import trainer
    config = runpy.run_path(CONFORMER_TINY)
    out = {}
    for device in ("cuda", "cpu"):
        model = config["base_model"](config["base_params"], mode="eval",
                                     device=device)
        state = trainer.restore_state(model)
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        before = flash_relpos.LAUNCHES, conformer_conv.LAUNCHES
        out[device] = trainer.to_host(model.eval_step(state, batch))
        out[device]["launches"] = (flash_relpos.LAUNCHES - before[0],
                                   conformer_conv.LAUNCHES - before[1])
    gpu, cpu = (out[d]["outputs"]["decoder_output"] for d in ("cuda", "cpu"))
    err = float(np.abs(gpu["logits"] - cpu["logits"]).max())
    same = np.array_equal(gpu["src_length"], cpu["src_length"]) and \
        all(np.array_equal(a, b) for a, b in zip(gpu["outputs"],
                                                 cpu["outputs"]))
    print("[conformer] tiny fp32 Conformer, card vs CPU: logits max abs err "
          "{:.3e} (|logits| max {:.2f}), loss {:.6f} vs {:.6f}, greedy ids "
          "identical: {}; (rel-pos flash, conv module) launches on the card "
          "{}, on the CPU {}".format(
              err, float(np.abs(cpu["logits"]).max()),
              float(out["cuda"]["loss"]), float(out["cpu"]["loss"]), same,
              out["cuda"]["launches"], out["cpu"]["launches"]), flush=True)
    check(out["cuda"]["launches"] == (2, 2) and
          out["cpu"]["launches"] == (0, 0), "launches in the tiny eval step")
    check(err <= 1e-4 and same, "tiny Conformer disagrees between card and "
          "CPU")


def phase_conformer(card):
    """Conformer-M from a seeded-init checkpoint through ``run.main`` in
    eval and infer: 16 rel-pos flash and 16 conv module launches per
    batch, the CTC forward once per eval batch, the loss finite and equal
    to the plain CTC on the same logits, a WER, 256 infer rows; the eval
    rate is printed as information. Returns the two kernels' launches."""
    import torch
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.ops import (conformer_conv, ctc, ctc_cuda,
                                           flash_relpos)
    from openseq2seq_tpu_torch.training import CheckpointManager, trainer

    def reset():
        flash_relpos.LAUNCHES = conformer_conv.LAUNCHES = 0
        ctc_cuda.LAUNCHES = 0

    def counts():
        return (flash_relpos.LAUNCHES, conformer_conv.LAUNCHES,
                ctc_cuda.LAUNCHES)

    config = runpy.run_path(CONFORMER_M)
    with tempfile.TemporaryDirectory() as logdir:
        params = dict(config["base_params"], logdir=logdir)
        n_batches = params["data_layer_params"]["num_batches"]
        batch_size = params["batch_size_per_gpu"]
        t0 = time.time()
        model = config["base_model"](params, mode="eval", device="cuda")
        state = trainer.restore_state(model)
        CheckpointManager(logdir).save(state, 0)
        n_params = sum(p.numel() for p in state.module.parameters())
        print("[conformer-m] built: {} parameters, dtype {}, seeded "
              "checkpoint saved in {:.1f} s".format(
                  n_params, params["dtype"], time.time() - t0), flush=True)

        argv = ["--config_file=" + CONFORMER_M, "--logdir=" + logdir]
        reset()
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        launches = counts()
        print("[conformer-m] eval: loss {:.6f}, WER {:.4f}; launches "
              "(rel-pos flash, conv module, CTC forward) {} for {} batches"
              .format(metrics["eval_loss"], metrics["Eval WER"], launches,
                      n_batches), flush=True)
        check(launches == (16 * n_batches, 16 * n_batches, n_batches),
              "eval launches {} for {} batches".format(launches, n_batches))
        check(math.isfinite(metrics["eval_loss"]) and
              metrics["eval_loss"] > 0, "eval loss not finite")
        check(0.0 <= metrics["Eval WER"], "WER not computed")

        out_csv = os.path.join(logdir, "infer.csv")
        reset()
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out_csv])
        infer_launches = counts()
        with open(out_csv) as f:
            rows = list(csv.reader(f))[1:]
        print("[conformer-m] infer: {} rows in the CSV; launches {}".format(
            len(rows), infer_launches), flush=True)
        check(infer_launches == (16 * n_batches, 16 * n_batches, 0),
              "infer launches {}".format(infer_launches))
        check(len(rows) == n_batches * batch_size,
              "infer CSV has {} rows".format(len(rows)))

        # one batch's loss recomputed from its logits by the plain version
        batches = list(model.get_data_layer().iterate_one_epoch())
        out = model.eval_step(state, batches[0])
        dec = out["outputs"]["decoder_output"]
        logits = dec["logits"]
        check(tuple(logits.shape) == (batch_size, 250, 29) and
              bool(torch.all(torch.isfinite(logits))),
              "logits shape {} or not finite".format(tuple(logits.shape)))
        labels, label_lens = to_device_batch(batches[0],
                                             "cuda")["target_tensors"]
        plain = ctc.ctc_loss(logits, dec["src_length"], labels, label_lens)
        rel = abs(float(out["loss"]) - float(plain)) / abs(float(plain))
        print("[conformer-m] batch loss: kernel {:.6f}, plain {:.6f}, rel "
              "err {:.3e}".format(float(out["loss"]), float(plain), rel),
              flush=True)
        check(rel <= RTOL, "batch loss disagrees with the plain version")

        # eval throughput over the epoch (information, not a claim)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            model.eval_step(state, b)
        torch.cuda.synchronize()
        utt = n_batches * batch_size / (time.perf_counter() - t0)
        print("[conformer-m] eval throughput {:.1f} utt/s (batch {}, 10 s "
              "utterances, bf16; {})".format(utt, batch_size, card),
              flush=True)
    return (launches[0] + infer_launches[0],
            launches[1] + infer_launches[1])


def phase_small_conformer_train():
    """The tiny fp32 Conformer config (both kernel flags on), dropout
    off, same seed, on the card (through the rel-pos flash and conv module
    kernels, forward and backward) and on the CPU (their plain versions):
    three AdamW steps give the same losses and weights (rtol 1e-4, atol
    1e-5: fp32 sums in another order through two blocks, forward and
    backward), with 2 launches of each Conformer kernel per step on the
    card. AdamW's epsilon is 1e-4 in place of the config's 1e-9, as in
    ``tests/test_torch_conformer_train.py``: at 1e-9 a gradient element
    that is zero up to rounding moves by a whole step of either sign."""
    import numpy as np
    from openseq2seq_tpu_torch.ops import conformer_conv, flash_relpos
    from openseq2seq_tpu_torch.training import trainer

    def counts():
        return (flash_relpos.LAUNCHES, flash_relpos.BWD_DQ_LAUNCHES,
                flash_relpos.BWD_DKV_LAUNCHES, conformer_conv.LAUNCHES,
                conformer_conv.BWD_LAUNCHES)

    config = runpy.run_path(CONFORMER_TINY)
    params = dict(config["base_params"], optimizer_params=dict(
        config["base_params"]["optimizer_params"], epsilon=1e-4))
    params["encoder_params"] = dict(params["encoder_params"],
                                    dropout_keep_prob=1.0,
                                    attention_dropout_keep_prob=1.0)
    trained = {}
    for device in ("cuda", "cpu"):
        model = config["base_model"](params, mode="train", device=device)
        state = trainer.restore_state(model)
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        before = counts()
        losses = []
        for _ in range(3):
            state, metrics = model.train_step(state, batch)
            losses.append(float(metrics["loss"]))
        launches = tuple(a - b for a, b in zip(counts(), before))
        trained[device] = (losses, launches, {
            n: p.detach().cpu().numpy()
            for n, p in state.module.named_parameters()})
    (loss_gpu, l_gpu, w_gpu), (loss_cpu, l_cpu, w_cpu) = \
        trained["cuda"], trained["cpu"]
    w_err = max(float(np.max(np.abs(w_gpu[n] - w_cpu[n]) /
                             (1e-5 + 1e-4 * np.abs(w_cpu[n]))))
                for n in w_cpu)
    print("[conformer train] tiny fp32 Conformer, three AdamW steps, card "
          "vs CPU: losses {} vs {}; largest weight difference {:.3f} of the "
          "tolerance (rtol 1e-4, atol 1e-5); launches (rel-pos flash, its dq "
          "and dkv, conv module, its backward) on the card {}, on the CPU {}"
          .format(["{:.6f}".format(x) for x in loss_gpu],
                  ["{:.6f}".format(x) for x in loss_cpu], w_err, l_gpu,
                  l_cpu), flush=True)
    check(l_gpu == (6, 6, 6, 6, 6) and l_cpu == (0,) * 5,
          "launches in the tiny train steps")
    check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(loss_gpu, loss_cpu))
          and loss_cpu[-1] < loss_cpu[0] and w_err <= 1.0,
          "tiny Conformer train steps disagree between card and CPU")


def phase_conformer_train(card):
    """Conformer-M through ``run.main --mode=train`` for its config's 20
    steps with the warmup cut to 20 (the config keeps the bench's 10,000,
    at which the learning rate stays under 2.4e-5 over 20 steps): the loss
    is finite at every step and falls; each step launches the rel-pos
    flash forward, its dq and dkv kernels, the conv module forward and its
    backward 16 times each and the CTC forward and backward once; a
    checkpoint is written, ``--mode=eval`` runs from it, and
    ``--continue_learning`` takes 3 more steps. Returns the launches of
    the five Conformer kernels and the two CTC kernels over these
    paths."""
    import torch
    from openseq2seq_tpu_torch.ops import conformer_conv, ctc_cuda, \
        flash_relpos

    def reset():
        flash_relpos.LAUNCHES = flash_relpos.BWD_DQ_LAUNCHES = 0
        flash_relpos.BWD_DKV_LAUNCHES = 0
        conformer_conv.LAUNCHES = conformer_conv.BWD_LAUNCHES = 0
        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0

    def counts():
        return (flash_relpos.LAUNCHES, flash_relpos.BWD_DQ_LAUNCHES,
                flash_relpos.BWD_DKV_LAUNCHES, conformer_conv.LAUNCHES,
                conformer_conv.BWD_LAUNCHES, ctc_cuda.LAUNCHES,
                ctc_cuda.BWD_LAUNCHES)

    total = [0] * 7
    config = runpy.run_path(CONFORMER_M)
    steps = config["train_params"]["max_steps"]
    n_batches = config["base_params"]["data_layer_params"]["num_batches"]
    batch_size = config["base_params"]["batch_size_per_gpu"]
    with tempfile.TemporaryDirectory() as logdir:
        argv = ["--config_file=" + CONFORMER_M, "--logdir=" + logdir]
        print("[conformer-m train] {} training steps of {} x 1000 frames, "
              "mixed, dropout 0.1 (8-bit masks), AdamW, warmup cut to 20 "
              "by {}".format(steps, batch_size, WARMUP_OVERRIDE),
              flush=True)
        reset()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train",
                                           WARMUP_OVERRIDE])
        wall = time.time() - t0
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        losses = _losses(lines)
        print("[conformer-m train] losses {}; launches (rel-pos flash, its "
              "dq, its dkv, conv module, its backward, CTC forward, CTC "
              "backward) {}; {:.1f} s with the build of the model".format(
                  losses, launches, wall), flush=True)
        check(result["steps"] == steps, "trained {} steps".format(
            result["steps"]))
        check(len(losses) == steps and all(math.isfinite(x)
                                           for x in losses),
              "losses not finite at every step: {}".format(losses))
        check(sum(losses[-3:]) < sum(losses[:3]),
              "loss did not fall: {}".format(losses))
        check(launches == (16 * steps,) * 5 + (steps, steps),
              "launches {} in {} steps".format(launches, steps))
        print("[conformer-m train] train throughput {:.1f} utt/s, {:.1f} ms "
              "per step over steps {}-{} (batch {}, 10 s utterances, bf16, "
              "a host read of the loss every step; {})".format(
                  result["objects_per_sec"] / 1000,
                  batch_size * 1000 / result["objects_per_sec"] * 1e3,
                  11, steps, batch_size, card), flush=True)
        ckpt = os.path.join(logdir, "checkpoints", str(steps), "model.pt")
        check(os.path.exists(ckpt), "no checkpoint at {}".format(ckpt))

        reset()
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        print("[conformer-m train] eval from the step-{} checkpoint: loss "
              "{:.6f}, WER {:.4f}; launches {}".format(
                  steps, metrics["eval_loss"], metrics["Eval WER"],
                  launches), flush=True)
        check(math.isfinite(metrics["eval_loss"]) and
              launches == (16 * n_batches, 0, 0, 16 * n_batches, 0,
                           n_batches, 0), "eval from the trained checkpoint")

        reset()
        more = _recipe_config(CONFORMER_M, logdir, steps + 3)
        result, lines = _run_quiet(["--config_file=" + more, argv[1],
                                    "--mode=train", "--continue_learning",
                                    WARMUP_OVERRIDE])
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        started = [x for x in lines if "Starting training from step" in x]
        print("[conformer-m train] --continue_learning: {}; reached step "
              "{}; launches {}".format(started[0].strip(), result["steps"],
                                       launches), flush=True)
        check(started and started[0].endswith("step {}".format(steps)) and
              result["steps"] == steps + 3 and
              launches == (48,) * 5 + (3, 3), "resumed run")
        torch.cuda.synchronize()
    return total


def _lm_no_dropout(params, **encoder):
    """A copy of an LM config's params with the four dropouts off and the
    encoder keys ``encoder`` set."""
    params = dict(params)
    params["encoder_params"] = dict(
        params["encoder_params"], encoder_emb_keep_prob=1.0,
        encoder_dp_input_keep_prob=1.0, encoder_dp_output_keep_prob=1.0,
        encoder_last_output_keep_prob=1.0, **encoder)
    return params


def phase_small_lm():
    """The tiny fp32 LSTM LM config, dropout off and ``num_sampled`` 0,
    same seed, on the card (through the LSTM kernels: 2 forward launches
    an eval step, 2 forward and 2 backward a train step) and on the CPU
    (their plain versions): the eval logits within 1e-4 and the same
    loss; one Adam ``train_step`` gives the same loss and updated weights
    (rtol 1e-4, atol 1e-6; Adam's epsilon 1e-5 as in
    ``tests/test_torch_lm_train.py``, since Adam divides each gradient by
    its own size and turns the rounding noise of a gradient near epsilon
    into an update of up to lr dg / (4 epsilon)). Then
    ``sampled_softmax_nll`` on the same inputs and candidate ids (one of
    them an accidental hit) gives the same loss (rtol 1e-5) and gradients
    (rtol 1e-5, atol 1e-7) on both devices."""
    import numpy as np
    import torch
    from openseq2seq_tpu_torch.losses.sequence_loss import \
        sampled_softmax_nll
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.ops import lstm_scan
    from openseq2seq_tpu_torch.training import trainer
    config = runpy.run_path(LM_TINY)
    params = _lm_no_dropout(config["base_params"], num_sampled=0)
    params.update(max_steps=1, optimizer_params={"learning_rate": 5e-3,
                                                  "epsilon": 1e-5})
    rng = np.random.RandomState(12)
    B, T, H, V, S = 8, 16, 128, 1000, 64
    arrays = (rng.randn(B, T, H).astype(np.float32),
              (0.3 * rng.randn(V, H)).astype(np.float32),
              (0.1 * rng.randn(V)).astype(np.float32))
    labels = rng.randint(0, V, (B, T))
    lengths = np.array([16, 15, 9, 1, 16, 12, 4, 16])
    sampled = np.exp(rng.uniform(0, np.log(V + 1), S)).astype(int) - 1
    labels[0, 0] = sampled[0]
    out = {}
    for device in ("cuda", "cpu"):
        model = config["base_model"](params, mode="eval", device=device)
        state = trainer.restore_state(model)
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        with torch.no_grad():
            logits = state.module(to_device_batch(batch, device), train=False
                                  )["decoder_output"]["logits"]
        before = lstm_scan.LAUNCHES
        loss = float(model.eval_step(state, batch)["loss"])
        eval_launches = lstm_scan.LAUNCHES - before
        model = config["base_model"](params, mode="train", device=device)
        state = trainer.restore_state(model)
        before = lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES
        state, metrics = model.train_step(state, batch)
        train_launches = (lstm_scan.LAUNCHES - before[0],
                          lstm_scan.BWD_LAUNCHES - before[1])
        tensors = [torch.tensor(a, device=device, requires_grad=True)
                   for a in arrays]
        nll = sampled_softmax_nll(
            *tensors, torch.tensor(labels, device=device),
            torch.tensor(lengths, device=device),
            torch.tensor(sampled, device=device), V)
        nll.backward()
        out[device] = {
            "logits": logits.cpu().numpy(), "loss": loss,
            "launches": (eval_launches, train_launches),
            "train_loss": float(metrics["loss"]),
            "weights": {n: p.detach().cpu().numpy()
                        for n, p in state.module.named_parameters()},
            "nll": nll.item(), "grads": [t.grad.cpu().numpy()
                                         for t in tensors]}
    gpu, cpu = out["cuda"], out["cpu"]
    logit_err = float(np.abs(gpu["logits"] - cpu["logits"]).max())
    w_err = max(float(np.max(np.abs(gpu["weights"][n] - cpu["weights"][n]) /
                             (1e-6 + 1e-4 * np.abs(cpu["weights"][n]))))
                for n in cpu["weights"])
    g_err = max(float(np.max(np.abs(g - c) / (1e-7 + 1e-5 * np.abs(c))))
                for g, c in zip(gpu["grads"], cpu["grads"]))
    print("[lm] tiny fp32 LSTM LM, card vs CPU: logits max abs err {:.3e} "
          "(|logits| max {:.2f}), eval loss {:.6f} vs {:.6f}; one Adam "
          "train step: loss {:.6f} vs {:.6f}, largest weight difference "
          "{:.3f} of the tolerance (rtol 1e-4, atol 1e-6); launches (eval; "
          "train forward, backward) on the card {}, on the CPU {}".format(
              logit_err, float(np.abs(cpu["logits"]).max()), gpu["loss"],
              cpu["loss"], gpu["train_loss"], cpu["train_loss"], w_err,
              gpu["launches"], cpu["launches"]), flush=True)
    print("[lm] sampled_softmax_nll (B {}, T {}, H {}, V {}, S {}, an "
          "accidental hit) card vs CPU: loss {:.7f} vs {:.7f}, largest "
          "gradient difference {:.3f} of the tolerance (rtol 1e-5, atol "
          "1e-7)".format(B, T, H, V, S, gpu["nll"], cpu["nll"], g_err),
          flush=True)
    check(gpu["launches"] == (2, (2, 2)) and cpu["launches"] == (0, (0, 0)),
          "launches in the tiny LM steps")
    check(logit_err <= 1e-4 and
          abs(gpu["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"]),
          "tiny LM eval disagrees between card and CPU")
    check(abs(gpu["train_loss"] - cpu["train_loss"]) <=
          1e-4 * abs(cpu["train_loss"]) and w_err <= 1.0,
          "tiny LM train step disagrees between card and CPU")
    check(abs(gpu["nll"] - cpu["nll"]) <= 1e-5 * abs(cpu["nll"]) and
          g_err <= 1.0, "sampled_softmax_nll disagrees between card and CPU")


def _plain_lm_nll(logits, labels):
    """The mean NLL of ``labels`` under the softmax of ``logits`` (B, T,
    V), in fp64 over blocks of 1024 rows: the plain version of the
    loss."""
    import torch
    V = logits.shape[-1]
    flat, lab = logits.reshape(-1, V), labels.reshape(-1).long()
    total = 0.0
    for i in range(0, flat.shape[0], 1024):
        block = flat[i:i + 1024].double()
        gold = block.gather(1, lab[i:i + 1024, None])[:, 0]
        total += float((torch.logsumexp(block, 1) - gold).sum())
    return total / flat.shape[0]


def phase_lm(card):
    """The LSTM language model at full width from
    ``example_configs_torch/lm/lstm_wkt103_synthetic.py`` (V 267,744, 3 x
    1024 LSTM, "mixed", 2 batches of 224 x 96 tokens by a CLI override), a
    seeded-init checkpoint, then ``run.main`` in ``--mode=eval`` and
    ``--mode=infer``: the LSTM forward kernel launches 3 times per batch
    and its backward never, a finite loss, a perplexity, 448 infer lines
    of 96 ids; one batch's loss equals the plain full-softmax NLL of the
    same logits (fp64); the peak device memory of the eval run and the
    eval tokens per second are printed as information. Returns the
    forward launches."""
    import torch
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.ops import lstm_scan
    from openseq2seq_tpu_torch.training import CheckpointManager, trainer
    config = runpy.run_path(LM_CONFIG)
    n_batches = 2
    with tempfile.TemporaryDirectory() as logdir:
        params = dict(config["base_params"], logdir=logdir)
        params["data_layer_params"] = dict(params["data_layer_params"],
                                           num_batches=n_batches)
        batch_size = params["batch_size_per_gpu"]
        bptt = params["data_layer_params"]["bptt"]
        t0 = time.time()
        model = config["base_model"](params, mode="eval", device="cuda")
        state = trainer.restore_state(model)
        CheckpointManager(logdir).save(state, 0)
        n_params = sum(p.numel() for p in state.module.parameters())
        print("[lm] built: {} parameters ({}), dtype {}, seeded checkpoint "
              "saved in {:.1f} s".format(
                  n_params, ", ".join("{} {}".format(n, p.numel()) for n, p
                                      in state.module.named_parameters()),
                  params["dtype"], time.time() - t0), flush=True)

        argv = ["--config_file=" + LM_CONFIG, "--logdir=" + logdir,
                "--data_layer_params/num_batches={}".format(n_batches)]
        lstm_scan.LAUNCHES = lstm_scan.BWD_LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        launches = (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print("[lm] eval: loss {:.6f}, perplexity {:.2f}; lstm_scan_fwd "
              "launches {}, lstm_scan_bwd {}, for {} batches; peak device "
              "memory {:.2f} GiB (with the checkpoint's model resident; "
              "{})".format(metrics["eval_loss"], metrics["Eval perplexity"],
                           *launches, n_batches, peak, card), flush=True)
        check(launches == (3 * n_batches, 0),
              "eval launches {} for {} batches".format(launches, n_batches))
        check(math.isfinite(metrics["eval_loss"]) and
              math.isfinite(metrics["Eval perplexity"]),
              "eval loss or perplexity not finite")

        out_file = os.path.join(logdir, "infer.txt")
        lstm_scan.LAUNCHES = lstm_scan.BWD_LAUNCHES = 0
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out_file])
        infer_launches = lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES
        with open(out_file) as f:
            rows = [line.split() for line in f.read().splitlines()]
        print("[lm] infer: {} lines of {} ids; lstm_scan_fwd launches {}, "
              "lstm_scan_bwd {}".format(len(rows), len(rows[0]),
                                        *infer_launches), flush=True)
        check(infer_launches == (3 * n_batches, 0),
              "infer launches {}".format(infer_launches))
        check(len(rows) == n_batches * batch_size and
              all(len(r) == bptt for r in rows),
              "infer wrote {} lines".format(len(rows)))

        # one batch's loss against the plain NLL of the same logits
        batches = list(model.get_data_layer().iterate_one_epoch())
        loss = float(model.eval_step(state, batches[0])["loss"])
        device_batch = to_device_batch(batches[0], "cuda")
        with torch.no_grad():
            logits = state.module(device_batch, train=False)[
                "decoder_output"]["logits"]
            finite = bool(torch.isfinite(logits).all())
            plain = _plain_lm_nll(logits,
                                  device_batch["target_tensors"][0])
        shape = tuple(logits.shape)
        del logits
        rel = abs(loss - plain) / abs(plain)
        print("[lm] batch loss {:.6f}, plain fp64 NLL of the same logits "
              "{:.6f}, rel err {:.3e}; logits {} fp32".format(
                  loss, plain, rel, shape), flush=True)
        check(finite and shape == (batch_size, bptt, 267744),
              "logits shape {} or not finite".format(shape))
        check(rel <= RTOL, "batch loss disagrees with the plain NLL")

        # eval throughput over the batches (information, not a claim)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            model.eval_step(state, b)
        torch.cuda.synchronize()
        rate = n_batches * batch_size * bptt / (time.perf_counter() - t0)
        print("[lm] eval throughput {:.0f} tokens/s (batch {} x {}, the "
              "fp32 logits over 267,744 words; {})".format(
                  rate, batch_size, bptt, card), flush=True)
    return launches[0] + infer_launches[0]


def phase_lm_train(card):
    """The LSTM language model at full width through ``run.main
    --mode=train`` for its config's 20 steps (8192 sampled candidates,
    dropout on): the loss is finite at every step and falls; each step
    launches the LSTM forward and backward kernels 3 times each; a
    checkpoint is written, ``--mode=eval`` runs from it (2 batches), and
    ``--continue_learning`` takes 3 more steps. The train tokens per
    second and the peak device memory are printed as information.
    Returns the forward and backward launches over these paths."""
    import torch
    from openseq2seq_tpu_torch.ops import lstm_scan

    def reset():
        lstm_scan.LAUNCHES = lstm_scan.BWD_LAUNCHES = 0

    def counts():
        return lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES

    total = [0, 0]
    config = runpy.run_path(LM_CONFIG)
    steps = config["train_params"]["max_steps"]
    with tempfile.TemporaryDirectory() as logdir:
        argv = ["--config_file=" + LM_CONFIG, "--logdir=" + logdir]
        print("[lm train] {} training steps of 224 x 96 tokens, mixed, 8192 "
              "sampled candidates, dropout on".format(steps), flush=True)
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        wall = time.time() - t0
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        losses = _losses(lines)
        print("[lm train] losses {}; launches lstm_scan_fwd {}, "
              "lstm_scan_bwd {}; {:.1f} s with the build of the model; peak "
              "device memory {:.2f} GiB".format(
                  losses, *launches, wall,
                  torch.cuda.max_memory_allocated() / 2 ** 30), flush=True)
        check(result["steps"] == steps, "trained {} steps".format(
            result["steps"]))
        check(len(losses) == steps and all(math.isfinite(x)
                                           for x in losses),
              "losses not finite at every step: {}".format(losses))
        check(sum(losses[-3:]) < sum(losses[:3]),
              "loss did not fall: {}".format(losses))
        check(launches == (3 * steps, 3 * steps),
              "launches {} in {} steps".format(launches, steps))
        print("[lm train] train throughput {:.0f} tokens/s over steps "
              "{}-{} (224 x 96 tokens a step, a host read of the loss every "
              "step; {})".format(result["objects_per_sec"], 11, steps, card),
              flush=True)
        ckpt = os.path.join(logdir, "checkpoints", str(steps), "model.pt")
        check(os.path.exists(ckpt), "no checkpoint at {}".format(ckpt))

        reset()
        metrics, _ = _run_quiet(argv + ["--mode=eval",
                                         "--data_layer_params/num_batches=2"])
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        print("[lm train] eval from the step-{} checkpoint: loss {:.6f}, "
              "perplexity {:.2f}; launches {}".format(
                  steps, metrics["eval_loss"], metrics["Eval perplexity"],
                  launches), flush=True)
        check(math.isfinite(metrics["eval_loss"]) and launches == (6, 0),
              "eval from the trained checkpoint")

        reset()
        more = _recipe_config(LM_CONFIG, logdir, steps + 3)
        result, lines = _run_quiet(["--config_file=" + more, argv[1],
                                    "--mode=train", "--continue_learning"])
        launches = counts()
        total = [a + b for a, b in zip(total, launches)]
        started = [x for x in lines if "Starting training from step" in x]
        print("[lm train] --continue_learning: {}; reached step {}; "
              "launches {}".format(started[0].strip(), result["steps"],
                                   launches), flush=True)
        check(started and started[0].endswith("step {}".format(steps)) and
              result["steps"] == steps + 3 and launches == (9, 9),
              "resumed run")
        torch.cuda.synchronize()
    return total


def phase_ctc_library(card):
    """``F.ctc_loss`` at the CTC train shapes (Jasper's B=32, T=500 and
    Conformer-M's B=64, T=250, L=160, V=29; JCA's B=64, T=401, L=241,
    V=30; QuartzNet's B=32, T=835, L=240, V=29), forward and forward plus
    backward: the CTC kernels' library yardstick, never on the path.
    Returns the Jasper shape's times (JCA's go to ``CTC_JCA``,
    QuartzNet's to ``CTC_QUARTZNET``)."""
    import torch
    import torch.nn.functional as F
    from openseq2seq_tpu_torch.ops import ctc
    dev = torch.device("cuda")
    out = None
    for B, T, L, V in ((32, 500, 160, 29), (64, 250, 160, 29),
                       (64, 401, 241, 30), (32, 835, 240, 29)):
        # the inputs of the kernels' timings: phase_kernel's eval case and
        # phase_backward's train case
        cases = []
        for seed in (T, T + 1):
            logits, lens, labels, label_lens = ctc_case(B, T, L, V, seed,
                                                        dev)
            lp = ctc.log_probs(logits).transpose(0, 1).detach()  # (T, B, V)
            cases.append((lp, labels, lens, label_lens))
        lp_grad = cases[1][0].clone().requires_grad_()

        def fwd():
            return F.ctc_loss(*cases[0], blank=V - 1, reduction="none",
                              zero_infinity=True)

        def fwd_bwd():
            F.ctc_loss(lp_grad, *cases[1][1:], blank=V - 1, reduction="sum",
                       zero_infinity=True).backward()

        times = (cuda_ms(fwd, 50), cuda_ms(fwd_bwd, 50))
        print("[ctc] F.ctc_loss at B={} T={} L={} V={}: forward {:.4f} ms, "
              "forward+backward {:.4f} ms (CUDA events, back to back; {})"
              .format(B, T, L, V, *times, card), flush=True)
        out = out or times
        if V == 30:
            CTC_JCA["lib_fwd_ms"], CTC_JCA["lib_fwd_bwd_ms"] = times
        elif T == 835:
            CTC_QUARTZNET["lib_fwd_ms"], \
                CTC_QUARTZNET["lib_fwd_bwd_ms"] = times
    return out


def ctc_bound_ms(B, T, L, V, seed, backward):
    """The least time of the CTC kernels at the ``ctc_case`` shape: the
    fp32 log-probs read once (and their gradient written once with
    ``backward``) over the HBM rate, against CTC_OPS fp32 operations per
    live lattice state (t < length, s < 2 label length + 1) over the
    fp32 peak. Returns (ms, "bytes" | "operations")."""
    import torch
    _, lens, _, label_lens = ctc_case(B, T, L, V, seed=seed,
                                      device=torch.device("cpu"))
    states = int((lens.long() * (2 * label_lens.long() + 1)).sum())
    ops = states * (CTC_OPS_FWD + (CTC_OPS_BWD if backward else 0))
    nbytes = B * T * V * 4 * (2 if backward else 1) + B * (L + 2) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def _run_quiet(argv):
    """``run.main(argv)`` with its printed lines kept; returns (result,
    lines)."""
    from openseq2seq_tpu_torch import run
    return _run_quiet_fn(lambda: run.main(argv))


def _run_quiet_fn(fn):
    """``fn()`` with its printed lines kept; returns (result, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return result, buf.getvalue().splitlines()


def _losses(lines):
    """The losses of the printed ``loss = ...`` lines, in order."""
    return [float(x) for x in re.findall(r"loss = ([-+0-9.einaf]+)",
                                         "\n".join(lines))]


def phase_train(card):
    """Jasper-10x5 through ``run.main --mode=train``, then eval from its
    checkpoint and a resumed run. Returns the launch counts of the
    forward and backward kernels over these paths, and the train rate in
    utt/s."""
    import torch
    from openseq2seq_tpu_torch.ops import ctc_cuda
    fwd = bwd = 0
    with tempfile.TemporaryDirectory() as logdir:
        steps = runpy.run_path(CONFIG)["train_params"]["max_steps"]
        argv = ["--config_file=" + CONFIG, "--logdir=" + logdir]
        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        wall = time.time() - t0
        launches = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
        fwd, bwd = fwd + launches[0], bwd + launches[1]
        losses = _losses(lines)
        print("[train] Jasper-10x5, {} steps of 32 x 1000 frames, mixed: "
              "losses at the printed steps {}; kernel launches fwd {}, bwd "
              "{}; {:.1f} s with the build of the model".format(
                  result["steps"], losses, *launches, wall), flush=True)
        check(result["steps"] == steps, "trained {} steps".format(
            result["steps"]))
        check(len(losses) >= 2 and all(math.isfinite(x) for x in losses),
              "losses not finite: {}".format(losses))
        check(losses[-1] < losses[0], "loss did not fall: {}".format(losses))
        check(launches == (steps, steps), "kernels launched {} times in {} "
              "steps".format(launches, steps))
        utt_s = result["objects_per_sec"] / 1000
        print("[train] throughput {:.1f} utt/s over steps {}-{} (batch 32, "
              "10 s utterances, bf16; {})".format(
                  utt_s, result["steps"] - 10 + 1, result["steps"], card),
              flush=True)
        ckpt = os.path.join(logdir, "checkpoints", str(steps), "model.pt")
        check(os.path.exists(ckpt), "no checkpoint at {}".format(ckpt))

        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        launches = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
        fwd, bwd = fwd + launches[0], bwd + launches[1]
        print("[train] eval from the step-{} checkpoint: loss {:.6f}, WER "
              "{:.4f}; kernel launches fwd {}, bwd {}".format(
                  steps, metrics["eval_loss"], metrics["Eval WER"],
                  *launches), flush=True)
        check(math.isfinite(metrics["eval_loss"]) and launches == (4, 0),
              "eval from the trained checkpoint")

        more = _recipe_config(CONFIG, logdir, steps + 3)
        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0
        result, lines = _run_quiet(["--config_file=" + more,
                                    "--logdir=" + logdir, "--mode=train",
                                    "--continue_learning"])
        launches = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
        fwd, bwd = fwd + launches[0], bwd + launches[1]
        started = [x for x in lines if "Starting training from step" in x]
        print("[train] --continue_learning: {}; reached step {}; kernel "
              "launches fwd {}, bwd {}".format(started[0].strip(),
                                               result["steps"], *launches),
              flush=True)
        check(started and started[0].endswith("step {}".format(steps)) and
              result["steps"] == steps + 3 and launches == (3, 3),
              "resumed run")
        torch.cuda.synchronize()
    return fwd, bwd, utt_s


def _recipe_config(path, logdir, steps, **base):
    """A config file in ``logdir`` that is ``path`` run for ``steps``
    training steps (its ``train_params``' ``max_steps``, in place of any
    ``num_epochs``), its ``base_params`` updated with ``base``."""
    cut = os.path.join(logdir, "cut_" + os.path.basename(path))
    with open(cut, "w") as f:
        f.write("import runpy\n_c = runpy.run_path({!r})\n"
                "base_model = _c['base_model']\n"
                "base_params = dict(_c['base_params'], **{!r})\n"
                "base_params.pop('num_epochs', None)\n"
                "train_params = dict(_c.get('train_params', {{}}), "
                "max_steps={})\n"
                "eval_params = _c.get('eval_params', {{}})\n"
                "infer_params = _c.get('infer_params', {{}})\n"
                .format(path, base, steps))
    return cut


def _infer_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    check(rows and rows[0] == ["wav_filename", "predicted_transcript"],
          "infer CSV header {}".format(rows[:1]))
    return rows[1:]


def featurization_rates(params, cache_dir, card):
    """utt/s of the wav data layer alone over one epoch of the train list
    with the feature cache cold, then one with it warm (the recipe's
    thread pool), and one cold epoch in a pool of worker processes, one
    for each CPU core."""
    from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
    rates = {}
    runs = (("cold", dict(params, cache_format=cache_dir + "/threads")),
            ("warm", dict(params, cache_format=cache_dir + "/threads")),
            ("cold, processes", dict(params, cache_format=cache_dir +
                                     "/processes", use_process_pool=True,
                                     map_parallel_calls=os.cpu_count())))
    for name, p in runs:
        dl = Speech2TextDataLayer(dict(p), None)
        dl.seed(0)
        t0 = time.perf_counter()
        n = sum(int(b["batch_valid"]) for b in dl.iterate_one_epoch())
        rates[name] = n / (time.perf_counter() - t0)
        print("[wav] featurization, the data layer alone, {}: {} "
              "utterances of 10 s at {:.1f} utt/s ({} workers; {} CPU "
              "cores; {})".format(name, n, rates[name],
                                  p.get("map_parallel_calls", 4),
                                  os.cpu_count(), card), flush=True)
    return rates


def device_idle_share(argv, skip):
    """``run.main(argv)`` (a training run) under the profiler, device
    activity only: the idle share of the card, 1 - busy / span, from the
    CTC forward kernel of step ``skip`` + 1 (past the model's build, its
    restore and the first steps' cuDNN autotuning) to the end of the
    last CTC kernel. Returns (share, busy ms, span ms, steps in the
    window, lines)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, lines = _run_quiet(argv)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                     for e in events if e.get("cat") in ("kernel",
                                                         "gpu_memcpy",
                                                         "gpu_memset"))
    starts = [k[0] for k in kernels if "ctc_alpha_fwd" in k[2]]
    check(len(starts) > skip, "the trace holds {} CTC forward kernels"
          .format(len(starts)))
    t0, t1 = starts[skip], max(k[1] for k in kernels if "ctc" in k[2])
    busy, end = 0.0, t0
    for s, e, _ in kernels:
        s, e = max(s, t0), min(e, t1)
        if e > end:
            busy += e - max(s, end)
            end = e
    return (1 - busy / (t1 - t0), busy / 1e3, (t1 - t0) / 1e3,
            len(starts) - skip, lines)


def phase_librispeech(card, synthetic_utt_s):
    """Jasper-10x5 at full width, its LibriSpeech recipe
    (``jasper10x5_librispeech.py``) from wav files: a LibriSpeech-shaped
    corpus of 256 ten-second utterances (8 batches of 32) written by
    ``test_utils/fake_librispeech``, with a copy of its dev list as the
    test list that infer reads. The data layer's featurization rates
    alone, over the first 128 utterances; 20 training steps through ``run.main --mode=train`` (the
    first epoch featurizes into the cold feature cache, the later ones
    read it warm): the loss finite and falling, one CTC forward and
    backward launch a step, the train rate in utt/s over steps 11-20
    against the synthetic config's (``phase_train``, same process);
    6 more steps with ``--continue_learning`` under the profiler, the
    card's idle share over the last 4; eval from the checkpoint
    ("Validation WER" over the 64 dev utterances, one CTC forward a
    batch); infer, whose CSV names each wav of the test list once.
    Returns the CTC forward and backward launches over these paths."""
    import torch
    from openseq2seq_tpu_torch.ops import ctc_cuda
    from openseq2seq_tpu_torch.test_utils import fake_librispeech
    fwd = bwd = 0
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "librispeech")
        t0 = time.time()
        fake_librispeech.generate(data, n_utts=256)
        shutil.copy(os.path.join(data, "librivox-dev-clean.csv"),
                    os.path.join(data, "librivox-test-clean.csv"))
        print("[wav] a LibriSpeech-shaped corpus of 256 utterances of 10 s "
              "(140-char transcripts; dev and test lists: the first 64) "
              "written in {:.1f} s".format(time.time() - t0), flush=True)
        os.environ["LIBRISPEECH_DIR"] = data
        config = runpy.run_path(LIBRI_CONFIG)
        # the rates over the first 128 utterances of the train list (the
        # whole list's three passes took 28 s of the script's clock)
        rate_list = os.path.join(data, "rate-128.csv")
        with open(os.path.join(data, "librivox-train-clean-100.csv")) as f:
            head = f.read().splitlines()[:129]
        with open(rate_list, "w") as f:
            f.write("\n".join(head) + "\n")
        params = dict(config["base_params"]["data_layer_params"],
                      **config["train_params"]["data_layer_params"],
                      mode="train", batch_size=32,
                      dataset_files=[rate_list])
        rates = featurization_rates(params, os.path.join(tmp, "rate_cache"),
                                    card)

        logdir = os.path.join(tmp, "logs")
        os.makedirs(logdir)
        steps = 20
        cut = _recipe_config(LIBRI_CONFIG, logdir, steps,
                             print_loss_steps=5)
        argv = ["--config_file=" + cut, "--logdir=" + logdir]
        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        wall = time.time() - t0
        launches = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
        fwd, bwd = fwd + launches[0], bwd + launches[1]
        losses = _losses(lines)
        print("[wav] Jasper-10x5 recipe from wav files, {} steps of 32 "
              "utterances, mixed, bf16 features: losses at the printed steps "
              "{}; CTC launches fwd {}, bwd {}; {:.1f} s with the build of "
              "the model".format(result["steps"], losses, *launches, wall),
              flush=True)
        check(result["steps"] == steps, "trained {} steps".format(
            result["steps"]))
        check(len(losses) == steps // 5 and
              all(math.isfinite(x) for x in losses),
              "losses not finite: {}".format(losses))
        check(losses[-1] < losses[0], "loss did not fall: {}".format(losses))
        check(launches == (steps, steps), "CTC launched {} times in {} "
              "steps".format(launches, steps))
        frames = 1 + 10 * 16000 // 160      # a 10 s utterance's frames
        utt_s = result["objects_per_sec"] / frames
        print("[wav] train rate fed from wav files {:.1f} utt/s over steps "
              "11-20 (warm feature cache), against {:.1f} utt/s of the "
              "synthetic config's one repeated batch in this process; the "
              "data layer alone featurizes {:.1f} utt/s cold, {:.1f} warm, "
              "{:.1f} cold in {} processes ({})".format(
                  utt_s, synthetic_utt_s, rates["cold"], rates["warm"],
                  rates["cold, processes"], os.cpu_count(), card),
              flush=True)

        more = _recipe_config(LIBRI_CONFIG, logdir, steps + 6,
                              print_loss_steps=5)
        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0
        share, busy, span, window, lines = device_idle_share(
            ["--config_file=" + more, argv[1], "--mode=train",
             "--continue_learning"], skip=2)
        launches = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
        fwd, bwd = fwd + launches[0], bwd + launches[1]
        started = [x for x in lines if "Starting training from step" in x]
        print("[wav] --continue_learning from step {}, 6 steps under the "
              "profiler: over the last {} (warm cache) the card busy "
              "{:.3f} ms of a {:.3f} ms span, idle share {:.2%}; CTC "
              "launches fwd {}, bwd {} ({})".format(
                  steps, window, busy, span, share, *launches, card),
              flush=True)
        check(started and started[0].endswith("step {}".format(steps)) and
              launches == (6, 6), "resumed run")

        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        launches = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
        fwd, bwd = fwd + launches[0], bwd + launches[1]
        wer = [x for x in lines if "Validation WER" in x]
        print("[wav] eval from the step-{} checkpoint over the 64 dev "
              "utterances: {}, loss {:.6f}; CTC launches fwd {}, bwd {}"
              .format(steps + 6, wer[-1].strip() if wer else None,
                      metrics["eval_loss"], *launches), flush=True)
        check(wer and math.isfinite(metrics["eval_loss"]) and
              launches == (2, 0), "eval from the trained checkpoint")

        out = os.path.join(tmp, "infer.csv")
        ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        launches = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
        fwd, bwd = fwd + launches[0], bwd + launches[1]
        rows = _infer_rows(out)
        with open(os.path.join(data, "librivox-test-clean.csv")) as f:
            wavs = [r["wav_filename"] for r in csv.DictReader(f)]
        print("[wav] infer: {} rows, each wav of the test list once, in "
              "its order: {}; CTC launches fwd {}, bwd {}".format(
                  len(rows), [r[0] for r in rows] == wavs, *launches),
              flush=True)
        check([r[0] for r in rows] == wavs, "the infer CSV does not name "
              "each wav of the test list once")
        torch.cuda.synchronize()
    return fwd, bwd


def _toy_env(tmp):
    os.environ["OS2S_TOY_DATA_DIR"] = os.path.join(tmp, "toy_speech")
    os.environ["OS2S_TOY_LOGDIR"] = os.path.join(tmp, "logs")


def phase_w2lplus_toy(card):
    """The w2lplus toy recipe (``w2lplus_toy.py``: the 10 toy utterances,
    featurized from their wavs every epoch) through ``run.main
    --mode=train_eval`` for 75 of its 150 epochs (``--num_epochs=75``, cut
    for the script's clock: its first validation, at step 75, reads WER
    0.0000 already): its last validation must read WER 0.0000;
    then eval and infer from its checkpoint, the infer
    CSV's transcripts the toy sentences, in order."""
    from openseq2seq_tpu_torch.test_utils import toy_speech
    with tempfile.TemporaryDirectory() as tmp:
        _toy_env(tmp)
        argv = ["--config_file=" + W2L_TOY]
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train_eval",
                                           "--num_epochs=75"])
        wer = [x.strip() for x in lines if "Validation WER" in x]
        losses = _losses(lines)
        print("[toy] w2lplus_toy --mode=train_eval: {} steps in {:.1f} s, "
              "losses at the printed steps {}; validations {} ({})".format(
                  result["steps"], time.time() - t0, losses, wer, card),
              flush=True)
        check(result["steps"] == 75 and wer and
              wer[-1].endswith("Validation WER: 0.0000"),
              "the w2lplus toy did not reach WER 0")
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        out = os.path.join(tmp, "infer.csv")
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        rows = _infer_rows(out)
        print("[toy] eval from the checkpoint: WER {:.4f}; infer: {}"
              .format(metrics["Eval WER"], [r[1] for r in rows]), flush=True)
        check(metrics["Eval WER"] == 0.0 and
              [r[1] for r in rows] == toy_speech.TRANSCRIPTS,
              "eval or infer from the toy checkpoint")


def phase_toy(path, name, kernel, per_step, card):
    """A toy recipe (``ds2_toy_config.py``, ``conformer_toy.py``) from the
    toy wavs, cut to 20 steps through ``run.main --mode=train``: the loss
    finite and falling; ``kernel`` (the GRU scan module, or None) launches
    ``per_step`` forward and backward kernels a step and ``per_step``
    forward kernels a batch in eval and infer; then eval and infer from
    the checkpoint (10 rows, one a wav). Returns the kernel's forward and
    backward launches."""
    total = [0, 0]

    def launches():
        return (kernel.LAUNCHES, kernel.BWD_LAUNCHES) if kernel else (0, 0)

    def reset():
        if kernel:
            kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        _toy_env(tmp)
        steps = 20
        cut = _recipe_config(path, tmp, steps, print_loss_steps=5)
        argv = ["--config_file=" + cut]
        reset()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        got = launches()
        losses = _losses(lines)
        print("[toy] {}: {} steps in {:.1f} s, losses {}; launches forward "
              "{}, backward {} ({})".format(name, result["steps"],
                                            time.time() - t0, losses, *got,
                                            card), flush=True)
        check(result["steps"] == steps and len(losses) == 4 and
              all(math.isfinite(x) for x in losses) and
              losses[-1] < losses[0], "{} losses {}".format(name, losses))
        check(got == (per_step * steps, per_step * steps),
              "{}: launches {}".format(name, got))
        total = [a + b for a, b in zip(total, got)]
        reset()
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        out = os.path.join(tmp, "infer.csv")
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        got = launches()
        rows = _infer_rows(out)
        print("[toy] {}: eval WER {:.4f}, loss {:.4f}; infer {} rows; "
              "launches forward {}, backward {}".format(
                  name, metrics["Eval WER"], metrics["eval_loss"], len(rows),
                  *got), flush=True)
        check(math.isfinite(metrics["eval_loss"]) and len(rows) == 10 and
              got == (2 * per_step, 0), "{} eval and infer".format(name))
        total = [a + b for a, b in zip(total, got)]
    return total


def _bleu_lines(lines):
    return [float(x) for x in re.findall(r"Validation BLEU: ([0-9.]+)",
                                         "\n".join(lines))]


def _toy_nmt_env(tmp):
    os.environ["OS2S_TOY_NMT_DIR"] = os.path.join(tmp, "toy_nmt")
    os.environ["OS2S_TOY_NMT_LOGDIR"] = os.path.join(tmp, "logs")


def phase_nmt_toy(path, name, bar, card, steps):
    """A reversal toy recipe (``nmt_reversal_toy.py``: the transformer;
    ``nmt_reversal_toy_rnn.py``: the RNN pair;
    ``nmt_reversal_toy_convs2s.py``) through ``run.main
    --mode=train_eval``, cut to ``steps`` (their BLEU passes 80 within 400
    steps of the recipes' 1,600 to 1,920; cut for the script's clock, PR
    22): the losses finite and falling, its last "Validation
    BLEU" above ``bar`` where one is given (else printed); then eval and
    infer from its checkpoint, one line for each of the 32 eval
    sentences. No recipe sets a kernel flag. Returns the last validation
    BLEU."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        _toy_nmt_env(tmp)
        argv = ["--config_file=" + _recipe_config(
            path, tmp, steps, save_checkpoint_steps=steps)]
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train_eval"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        bleu, losses = _bleu_lines(lines), _losses(lines)
        print("[toy nmt] {} --mode=train_eval: {} steps in {:.1f} s, losses "
              "at the printed steps {}; validation BLEU {} ({})".format(
                  name, result["steps"], wall, losses, bleu, card),
              flush=True)
        check(len(losses) >= 2 and all(math.isfinite(x) for x in losses) and
              losses[-1] < losses[0], "{} losses {}".format(name, losses))
        check(bool(bleu) and (bar is None or bleu[-1] > bar),
              "{}: validation BLEU {}".format(name, bleu))
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        out = os.path.join(tmp, "infer.txt")
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        with open(out) as f:
            rows = f.read().splitlines()
        print("[toy nmt] {}: eval from the checkpoint BLEU {:.4f}, loss "
              "{:.4f}; infer {} lines, the first {}".format(
                  name, metrics["Eval BLEU"], metrics["eval_loss"],
                  len(rows), rows[:3]), flush=True)
        check(math.isfinite(metrics["eval_loss"]) and len(rows) == 32,
              "{} eval and infer".format(name))
    return bleu[-1]


def phase_wmt(path, name, wmt_dir, kernel, per_step, per_batch, n_params,
              card, **base):
    """A full-width NMT recipe from the WMT-shaped text files in
    ``wmt_dir`` through ``run.main``: ``--mode=train`` for 20 steps (the
    loss of every step finite, and the mean of the last five below that
    of the first five: each step's batch differs; the parameter count
    ``n_params``; the peak device memory), then ``--mode=eval`` from the
    checkpoint over the dev split ("Validation BLEU" printed) and
    ``--mode=infer`` over the test split (one line a source sentence).
    ``kernel()`` reads the launch counts of the path's kernels and
    ``kernel(0)`` sets them to 0; a step launches ``per_step`` of them, an
    eval or infer batch ``per_batch`` (eval) and ``per_batch`` less the
    teacher-forced pass's (infer; ``base["infer_per_batch"]``). Returns
    the launch counts over the three runs."""
    import torch
    infer_per_batch = base.pop("infer_per_batch")
    os.environ["WMT16_DIR"] = wmt_dir
    config = runpy.run_path(path)
    eval_batch = config.get("eval_params", {}).get(
        "batch_size_per_gpu", config["base_params"]["batch_size_per_gpu"])
    infer_batch = config.get("infer_params", {}).get(
        "batch_size_per_gpu", config["base_params"]["batch_size_per_gpu"])
    with open(os.path.join(wmt_dir, "wmt13-en-de.src.BPE_common.32K.tok")) \
            as f:
        n_dev = len(f.read().splitlines())
    with open(os.path.join(wmt_dir, "wmt14-en-de.src.BPE_common.32K.tok")) \
            as f:
        n_test = len(f.read().splitlines())
    steps = 20
    total = [0] * len(kernel())
    with tempfile.TemporaryDirectory() as logdir:
        cut = _recipe_config(path, logdir, steps, print_loss_steps=1,
                             save_checkpoint_steps=steps, **base)
        argv = ["--config_file=" + cut, "--logdir=" + logdir]
        kernel(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = kernel()
        total = [a + b for a, b in zip(total, got)]
        losses = _losses(lines)
        count = sum(p.numel() for p in result["state"].module.parameters())
        print("[wmt] {}: {} parameters, {} steps of {} sentence pairs from "
              "text, {}; losses {}; launches {} ({} a "
              "step); peak device memory {:.2f} GiB; {:.1f} s with the "
              "build of the model; {:.1f} tokens/s (source + target) over "
              "steps 11-20 ({})".format(
                  name, count, result["steps"],
                  config["base_params"]["batch_size_per_gpu"],
                  config["base_params"]["dtype"], losses, got,
                  [x / steps for x in got], peak, wall,
                  result["objects_per_sec"], card), flush=True)
        check(count == n_params, "{}: {} parameters".format(name, count))
        check(result["steps"] == steps and len(losses) == steps and
              all(math.isfinite(x) for x in losses) and
              sum(losses[-5:]) < sum(losses[:5]),
              "{} losses {}".format(name, losses))
        check(tuple(got) == tuple(steps * x for x in per_step),
              "{}: launches {} in {} steps".format(name, got, steps))
        del result

        kernel(0)
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        got = kernel()
        total = [a + b for a, b in zip(total, got)]
        batches = -(-n_dev // eval_batch)
        bleu = [x.strip() for x in lines if "Validation BLEU" in x]
        print("[wmt] {}: eval from the step-{} checkpoint over the {} dev "
              "sentences: {}, loss {:.4f}; launches {}".format(
                  name, steps, n_dev, bleu, metrics["eval_loss"], got),
              flush=True)
        check(bool(bleu) and math.isfinite(metrics["eval_loss"]) and
              tuple(got) == tuple(batches * x for x in per_batch),
              "{} eval".format(name))

        kernel(0)
        out = os.path.join(logdir, "infer.txt")
        t0 = time.time()
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = kernel()
        total = [a + b for a, b in zip(total, got)]
        with open(out) as f:
            rows = f.read().splitlines()
        batches = -(-n_test // infer_batch)
        print("[wmt] {}: infer over the {} test sentences: {} lines in "
              "{:.1f} s with the build of the model, the first {}; "
              "launches {}".format(name, n_test, len(rows), wall, rows[:2],
                                   got), flush=True)
        check(len(rows) == n_test and
              tuple(got) == tuple(batches * x for x in infer_per_batch),
              "{} infer".format(name))
    return total


def wmt_corpus(root):
    """The WMT-shaped corpus of the full-width NMT phases: 60,000 training
    pairs, dev and test splits cut to 64 sentences each, and 10,921 word
    types, so that the shared vocabulary holds 4 + 3 x 10921 = 32,767
    tokens, the recipes' 32K."""
    from openseq2seq_tpu_torch.test_utils import fake_wmt
    t0 = time.time()
    out = fake_wmt.generate(os.path.join(root, "wmt"), n_train=60000,
                            n_dev=64, n_test=64, n_types=10921,
                            with_t2t=False)
    with open(os.path.join(out, "m_common.vocab")) as f:
        vocab = len(f.read().splitlines())
    print("[wmt] fake_wmt corpus: 60,000 training pairs, 64 dev and 64 test "
          "sentences, a vocabulary of {} tokens, in {:.1f} s".format(
              vocab, time.time() - t0), flush=True)
    check(vocab == 32767, "vocabulary of {}".format(vocab))
    return out


def phase_nmt_text(card):
    """7u to 7x and 7zu to 7zx: the reversal toys, then transformer-big,
    GNMT-like and ConvS2S at full width from text files. Returns the
    flash attention's (forward, dq, dkv) launches and the LSTM scan's
    (forward, backward)."""
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    from openseq2seq_tpu_torch.ops import fused_dropout as fd
    from openseq2seq_tpu_torch.ops import lstm_scan

    def flash(zero=None):
        if zero is not None:
            fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
            fd.LAUNCHES = 0
        return (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES,
                fd.LAUNCHES)

    def scan(zero=None):
        if zero is not None:
            lstm_scan.LAUNCHES = lstm_scan.BWD_LAUNCHES = 0
        return (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES)

    phase_nmt_toy(NMT_TOY, "nmt_reversal_toy", 80.0, card, 400)
    phase_nmt_toy(NMT_TOY_RNN, "nmt_reversal_toy_rnn", 80.0, card, 400)
    # 7zu to 7zx: ConvS2S (no kernel on its path)
    timed(phase_small_convs2s)
    with _launches_none("the ConvS2S toy"):
        timed(phase_nmt_toy, NMT_TOY_CONVS2S, "nmt_reversal_toy_convs2s",
              70.0, card, 400)
    timed(phase_mixed_toys, card)
    with tempfile.TemporaryDirectory() as tmp:
        wmt_dir = wmt_corpus(tmp)
        # Adam at the recipe's lr 2.0 (x d^-0.5) with the warmup cut to 200
        # steps: 4.4e-4 at step 20
        fl = phase_wmt(NMT_WMT, "transformer-big", wmt_dir, flash,
                       (18, 18, 18, 0), (18, 0, 0, 0), TRANSFORMER_PARAMS,
                       card, infer_per_batch=(6, 0, 0, 0),
                       lr_policy_params={"learning_rate": 2.0,
                                         "warmup_steps": 200,
                                         "d_model": 1024})
        sc = phase_wmt(GNMT_WMT, "GNMT-like", wmt_dir, scan, (8, 8), (8, 0),
                       GNMT_PARAMS, card, infer_per_batch=(8, 0))
        # 7zv: ConvS2S at full width, its beam-5 eval over one dev batch
        # of 16; Momentum at lr 0.05 (the recipe's 0.5 with momentum 0.99
        # swings the loss up and down over the first 20 steps)
        with _launches_none("ConvS2S"):
            timed(phase_wmt, CONVS2S_WMT, "ConvS2S",
                  convs2s_corpus(wmt_dir, tmp), lambda zero=None: (), (),
                  (), CONVS2S_PARAMS, card, infer_per_batch=(),
                  eval_batch_size_per_gpu=16,
                  optimizer_params={"learning_rate": 0.05,
                                    "momentum": 0.99})
    return fl[:3], sc


def _tiny_tacotron_params(**overrides):
    """The tiny Tacotron config (``tacotron_tiny_synthetic.py``) with its
    dropout and zoneout off and Adam's epsilon 1e-5 (at its default 1e-8
    a gradient near epsilon turns its fp32 rounding into a large change
    of the update)."""
    import copy
    params = copy.deepcopy(runpy.run_path(TACOTRON_TINY)["base_params"])
    params.update(overrides)
    params["optimizer_params"]["epsilon"] = 1e-5
    params["encoder_params"].update(cnn_dropout_prob=0.0,
                                    rnn_dropout_prob=0.0)
    params["decoder_params"]["zoneout_prob"] = 0.0
    return params


@contextlib.contextmanager
def _prenet_keeps_all():
    """Every prenet mask keeps: the card's and the CPU's generators draw
    different masks, so a comparison of the two takes none."""
    import torch
    from openseq2seq_tpu_torch.decoders.tacotron2_decoder import \
        Tacotron2DecoderModule as module
    draw = module.keep_mask
    module.keep_mask = lambda self, shape, generator, device: torch.ones(
        shape, dtype=torch.bool, device=device)
    try:
        yield
    finally:
        module.keep_mask = draw


def phase_small_tacotron():
    """7y, first: the tiny fp32 Tacotron config on the card (its
    bidirectional LSTM of 64 on the LSTM kernels, fp32, forward and
    backward: 2 launches each a step) and on the CPU (their plain
    versions), dropout and zoneout off and every prenet mask keeping: the
    eval outputs within 1e-4, and one Adam step the same loss and weights
    (rtol 1e-4, atol 1e-6; the biases of the convs that feed a batch norm
    frozen, their gradient rounding noise)."""
    import numpy as np
    import torch
    from openseq2seq_tpu_torch.models import Text2SpeechTacotron
    from openseq2seq_tpu_torch.ops import lstm_scan
    from openseq2seq_tpu_torch.training import trainer
    out, trained = {}, {}
    with _prenet_keeps_all():
        for device in ("cuda", "cpu"):
            model = Text2SpeechTacotron(_tiny_tacotron_params(), mode="eval",
                                        device=device)
            state = trainer.restore_state(model)
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            lstm_scan.LAUNCHES = lstm_scan.BWD_LAUNCHES = 0
            out[device] = trainer.to_host(model.eval_step(state, batch))
            launches = [(lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES)]
            model = Text2SpeechTacotron(_tiny_tacotron_params(
                max_steps=1, freeze_variables_regex=r"/(conv|postnet_conv)"
                r"\d+/bias$"), mode="train", device=device)
            state = trainer.restore_state(model)
            lstm_scan.LAUNCHES = lstm_scan.BWD_LAUNCHES = 0
            state, metrics = model.train_step(
                state, batch, torch.Generator(device=device))
            launches.append((lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES))
            check(launches == ([(2, 0), (2, 2)] if device == "cuda"
                               else [(0, 0), (0, 0)]),
                  "tiny Tacotron on {}: LSTM launches {}".format(device,
                                                                 launches))
            trained[device] = (float(metrics["loss"]), {
                n: p.detach().cpu().numpy()
                for n, p in state.module.named_parameters()})
    errs = {}
    for key in ("decoder_spec", "post_net_spec", "stop_token_logits",
                "alignments"):
        a, b = (out[d]["outputs"]["decoder_output"][key]
                for d in ("cuda", "cpu"))
        errs[key] = float(np.abs(a - b).max())
    (loss_gpu, w_gpu), (loss_cpu, w_cpu) = trained["cuda"], trained["cpu"]
    w_err, worst = max((float(np.max(np.abs(w_gpu[n] - w_cpu[n]) /
                                     (1e-6 + 1e-4 * np.abs(w_cpu[n])))), n)
                       for n in w_cpu)
    print("[tacotron] tiny fp32 Tacotron, card vs CPU: eval outputs max abs "
          "err {}; loss {:.6f} vs {:.6f}; one Adam step: loss {:.6f} vs "
          "{:.6f}, largest weight difference {:.3f} of the tolerance (rtol "
          "1e-4, atol 1e-6), in {}".format(
              ", ".join("{} {:.2e}".format(k, v) for k, v in errs.items()),
              float(out["cuda"]["loss"]), float(out["cpu"]["loss"]),
              loss_gpu, loss_cpu, w_err, worst), flush=True)
    check(max(errs.values()) <= 1e-4 and abs(
        out["cuda"]["loss"] - out["cpu"]["loss"]) <= 1e-4 * abs(
            out["cpu"]["loss"]), "tiny Tacotron eval disagrees")
    check(abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu) and w_err <= 1.0,
          "tiny Tacotron train step disagrees between card and CPU")


def phase_tacotron(path, name, n_params, counters, per_step, card):
    """Tacotron-2 at full width on synthetic batches (``path``:
    ``tacotron2_synthetic.py`` or ``tacotron_gst_synthetic.py``) through
    ``run.main --mode=train`` for its ``train_params``' steps: the loss
    finite at every step and, over 10 steps, the mean of the last five
    below that of the first five (GST's 3 steps are too few to read a
    trend in);
    ``n_params`` parameters; each step launches the kernels of
    ``counters`` (a list of (module, forward and backward launches a
    step)) exactly so often; frames per second and the peak device
    memory. With ``per_step`` set (Tacotron-2 alone), then
    ``--mode=eval`` from the checkpoint over its 2 batches ("Validation
    loss", the attention's sharpness, the forward kernels per_step times
    a batch) and one infer batch of ``infer_max_steps`` free-running
    frames from the checkpoint through the model's eval step (every
    length at least 1, finite frames, the forward kernels per_step
    times), Griffin-Lim on its first example. Returns the launches by
    counter module, (forward, backward)."""
    import numpy as np
    import torch
    from openseq2seq_tpu_torch.training import trainer
    from openseq2seq_tpu_torch.utils.config import _latest_checkpoint
    total = {k: [0, 0] for k, _ in counters}

    def reset():
        for k, _ in counters:
            k.LAUNCHES = k.BWD_LAUNCHES = 0

    def read():
        for k, _ in counters:
            total[k][0] += k.LAUNCHES
            total[k][1] += k.BWD_LAUNCHES
        return {k.KERNEL: (k.LAUNCHES, k.BWD_LAUNCHES) for k, _ in counters}

    config = runpy.run_path(path)
    steps = config["train_params"]["max_steps"]
    p = config["base_params"]
    T = p["data_layer_params"]["spec_length"]
    with tempfile.TemporaryDirectory() as logdir:
        # rates over the steps after the first 2 (the first is cuDNN's
        # autotuning)
        cut = _recipe_config(path, logdir, steps, print_loss_steps=1,
                             save_checkpoint_steps=steps, bench_start=2)
        argv = ["--config_file=" + cut, "--logdir=" + logdir]
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = read()
        losses = _losses(lines)
        count = sum(x.numel() for x in result["state"].module.parameters())
        print("[{}] {} parameters, {} steps of {} x {} characters x {} mel "
              "frames, {}; losses {}; launches (forward, backward) {}; "
              "peak device memory {:.2f} GiB; {:.1f} s with the build of "
              "the model; {:.1f} mel frames/s over steps 3-{} ({})".format(
                  name, count, result["steps"], p["batch_size_per_gpu"],
                  p["data_layer_params"]["text_length"], T, p["dtype"],
                  losses, got, torch.cuda.max_memory_allocated() / 2 ** 30,
                  wall, result["objects_per_sec"], steps, card), flush=True)
        check(count == n_params, "{}: {} parameters".format(name, count))
        check(result["steps"] == steps and len(losses) == steps and
              all(math.isfinite(x) for x in losses) and
              (steps < 10 or sum(losses[-5:]) < sum(losses[:5])),
              "{} losses {}".format(name, losses))
        for k, n in counters:
            check(got[k.KERNEL] == (n * steps, n * steps),
                  "{}: {} launches {} in {} steps".format(
                      name, k.KERNEL, got[k.KERNEL], steps))
        del result
        if not per_step:
            return total

        reset()
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        got = read()
        n_batches = config["eval_params"]["data_layer_params"]["num_batches"]
        val = [x.strip() for x in lines if "Validation loss" in x]
        print("[{}] eval from the step-{} checkpoint over {} batches: {}; "
              "Griffin-Lim audio of the first example: {}; launches "
              "{}".format(name, steps, n_batches, val,
                          "audio/synthesized" in metrics, got), flush=True)
        check(bool(val) and "attention sharpness" in val[0] and
              math.isfinite(metrics["eval_loss"]) and
              all(v == (per_step * n_batches, 0) for v in got.values()),
              "{} eval".format(name))

        reset()
        params = dict(p, **config.get("infer_params", {}))
        params["data_layer_params"] = dict(
            p["data_layer_params"], **config["infer_params"].get(
                "data_layer_params", {}))
        model = config["base_model"](params, mode="infer", device="cuda")
        state = trainer.restore_state(model, _latest_checkpoint(logdir))
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        torch.cuda.synchronize()
        t0 = time.time()
        out = model.eval_step(state, batch)["outputs"]["decoder_output"]
        spec, lengths = trainer.to_host(out["outputs"])
        infer_s = time.time() - t0
        got = read()
        steps_inf = p["decoder_params"]["infer_max_steps"]
        t0 = time.time()
        wav = model.synthesize_wav(spec[0, :int(lengths[0])])
        gl_s = time.time() - t0
        print("[{}] infer, one batch of {} from the checkpoint: {} "
              "free-running frames in {:.2f} s ({:.1f} frames/s of the "
              "batch), lengths {} to {}; Griffin-Lim of the first example "
              "({} frames): {} samples in {:.2f} s; launches {} ({})".format(
                  name, spec.shape[0], steps_inf, infer_s,
                  spec.shape[0] * steps_inf / infer_s, int(lengths.min()),
                  int(lengths.max()), int(lengths[0]), len(wav), gl_s, got,
                  card), flush=True)
        check(spec.shape == (p["batch_size_per_gpu"], steps_inf,
                             p["data_layer_params"]["num_audio_features"])
              and bool(np.isfinite(spec).all()) and lengths.min() >= 1 and
              bool(np.isfinite(wav).all()),
              "{} infer: shape {}, lengths {}".format(name, spec.shape,
                                                      lengths))
        check(all(v == (per_step, 0) for v in got.values()),
              "{} infer launches {}".format(name, got))
    return total


def phase_tacotron_toy(card):
    """7za: the toy recipe (``tacotron_toy.py``: the 10 tone wavs of
    ``test_utils/toy_tts``, written first) through ``run.main
    --mode=train_eval`` for 225 steps (``--num_epochs=225``; its own 40
    epochs stop near a loss of 110; the JAX test trains 400, and the loss
    passes 12.0 near step 190 (11.2 at 210, 10.2 at 250): cut from 400
    for the script's clock, first to 250 steps, then to 225), validating
    at its last step (``--eval_steps=225``; the recipe's 20): the last
    printed loss below the JAX test's bar of 12.0;
    then
    ``--mode=eval`` ("Validation loss") and ``--mode=infer`` (a wav a toy
    sentence, listed in order) from the checkpoint. The toy sets no kernel
    flag."""
    import torch
    from scipy.io import wavfile
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["OS2S_TOY_TTS_DIR"] = os.path.join(tmp, "toy_tts")
        os.environ["OS2S_TOY_LOGDIR"] = os.path.join(tmp, "logs")
        argv = ["--config_file=" + TACOTRON_TOY]
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train_eval",
                                           "--num_epochs=225",
                                           "--eval_steps=225"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        losses = _losses(lines)
        val = [x.strip() for x in lines if "Validation loss" in x]
        print("[toy tts] tacotron_toy --mode=train_eval: {} steps in {:.1f} "
              "s, losses at the printed steps {}; the last validation {} "
              "({})".format(result["steps"], wall, losses[::4] + losses[-1:],
                            val[-1:], card), flush=True)
        check(result["steps"] == 225 and all(math.isfinite(x)
                                             for x in losses) and
              losses[-1] < 12.0, "the Tacotron toy's loss {}".format(
                  losses[-1:]))
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        out = os.path.join(tmp, "infer", "infer.csv")
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        with open(out) as f:
            rows = [line.split(",") for line in f.read().splitlines()]
        sizes = [len(wavfile.read(r[1])[1]) for r in rows]
        print("[toy tts] eval from the checkpoint: {}; infer: {} wavs of {} "
              "to {} samples".format(
                  [x.strip() for x in lines if "Validation loss" in x],
                  len(rows), min(sizes), max(sizes)), flush=True)
        check(math.isfinite(metrics["eval_loss"]) and
              [int(r[0]) for r in rows] == list(range(10)) and
              min(sizes) > 0, "the Tacotron toy's eval and infer")


def phase_tts(card):
    """7y to 7za: the tiny Tacotron card vs CPU, Tacotron-2 and its GST
    variant at full width, the toy from wav files; then Centaur and
    WaveNet (7zp to 7zt). Returns the LSTM and GRU scans' (forward,
    backward) launches."""
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    phase_small_tacotron()
    taco = phase_tacotron(TACOTRON, "tacotron2", TACOTRON_PARAMS,
                          [(lstm_scan, 2)], 2, card)
    gst = phase_tacotron(TACOTRON_GST, "tacotron-gst", GST_PARAMS,
                         [(lstm_scan, 2), (gru_scan, 1)], 0, card)
    phase_tacotron_toy(card)
    timed(phase_causal_tts, card)
    return ([a + b for a, b in zip(taco[lstm_scan], gst[lstm_scan])],
            gst[gru_scan])


# the transducer checks' tolerances: card against CPU in fp32, rtol 1e-4
# on losses and scores (two Conformer blocks, then the lattice's sums, in
# other orders), and each gradient within 1e-4 of its tensor's largest
# element plus 1e-4 of itself; the fused loss against the lattice loss on
# the card in bf16 ("mixed"): the same bf16 joint over another batching
# of its GEMM rows, rel 1e-3
TRANSDUCER_RTOL = 1e-4
TRANSDUCER_FUSED_RTOL = 1e-3


def _conformer_counts():
    from openseq2seq_tpu_torch.ops import conformer_conv, flash_relpos
    return (flash_relpos.LAUNCHES, flash_relpos.BWD_DQ_LAUNCHES,
            flash_relpos.BWD_DKV_LAUNCHES, conformer_conv.LAUNCHES,
            conformer_conv.BWD_LAUNCHES)


def _reset_conformer_counts():
    from openseq2seq_tpu_torch.ops import conformer_conv, flash_relpos
    flash_relpos.LAUNCHES = flash_relpos.BWD_DQ_LAUNCHES = 0
    flash_relpos.BWD_DKV_LAUNCHES = 0
    conformer_conv.LAUNCHES = conformer_conv.BWD_LAUNCHES = 0


def _tiny_transducer(device, mode, fused=False, beam=1):
    """The tiny Conformer-Transducer, dropout off, AdamW's epsilon 1e-4
    (as ``phase_small_conformer_train``)."""
    config = runpy.run_path(TRANSDUCER_TINY)
    p = config["base_params"]
    params = dict(p, optimizer_params=dict(p["optimizer_params"],
                                           epsilon=1e-4),
                  encoder_params=dict(p["encoder_params"],
                                      dropout_keep_prob=1.0,
                                      attention_dropout_keep_prob=1.0),
                  decoder_params=dict(p["decoder_params"],
                                      dropout_keep_prob=1.0,
                                      fused_loss=fused, beam_width=beam))
    return config["base_model"](params, mode=mode, device=device)


def _grad_reading(got, want):
    """The largest |got - want| over TRANSDUCER_RTOL (max|want| + |want|),
    tensor by tensor."""
    import numpy as np
    return max(float(np.max(np.abs(got[n] - w) / (
        TRANSDUCER_RTOL * (np.abs(w).max() + np.abs(w)) + 1e-30)))
        for n, w in want.items())


def phase_small_transducer():
    """7zb: the tiny fp32 Conformer-Transducer (both kernel flags on: the
    rel-pos flash kernels at head dim 32, the conv module's at width 64),
    dropout off, same seed, on the card and on the CPU: the lattice and
    fused losses of one batch and every parameter's gradient, card against
    CPU and fused against lattice; greedy ids and lengths equal; the beam
    of 4's best ids equal and its n-best scores within TRANSDUCER_RTOL;
    one AdamW step's loss and weights (rtol 1e-4, atol 1e-5). On the card
    each forward launches the two Conformer kernels twice (two blocks) and
    each backward their backward kernels twice; on the CPU nothing."""
    import numpy as np
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.training import trainer
    res = {}
    for device in ("cuda", "cpu"):
        before = _conformer_counts()
        for fused in (False, True):
            model = _tiny_transducer(device, "train", fused)
            state = trainer.restore_state(model)
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            dev_batch = to_device_batch(batch, device)
            loss = model.compute_loss(state.module(dev_batch, train=True),
                                      dev_batch)
            loss.backward()
            res[device, fused] = (float(loss.detach()), {
                n: p.grad.detach().cpu().numpy()
                for n, p in state.module.named_parameters()})
        for beam in (1, 4):
            model = _tiny_transducer(device, "eval", beam=beam)
            state = trainer.restore_state(model)
            out = trainer.to_host(model.eval_step(state, batch))
            res[device, "beam", beam] = out["outputs"]["decoder_output"]
        model = _tiny_transducer(device, "train", True)
        state = trainer.restore_state(model)
        state, metrics = model.train_step(state, batch)
        res[device, "step"] = (float(metrics["loss"]), {
            n: p.detach().cpu().numpy()
            for n, p in state.module.named_parameters()})
        res[device, "launches"] = tuple(
            a - b for a, b in zip(_conformer_counts(), before))
    readings = {
        "card vs CPU, lattice": _grad_reading(res["cuda", False][1],
                                              res["cpu", False][1]),
        "card vs CPU, fused": _grad_reading(res["cuda", True][1],
                                            res["cpu", True][1]),
        "fused vs lattice, card": _grad_reading(res["cuda", True][1],
                                                res["cuda", False][1]),
        "fused vs lattice, CPU": _grad_reading(res["cpu", True][1],
                                               res["cpu", False][1])}
    print("[transducer] tiny fp32 Conformer-Transducer, losses card (lattice, "
          "fused) {:.6f}, {:.6f}, CPU {:.6f}, {:.6f}; gradients' largest "
          "reading against 1e-4 of each tensor's largest element plus 1e-4 "
          "of itself: {}".format(
              res["cuda", False][0], res["cuda", True][0],
              res["cpu", False][0], res["cpu", True][0],
              ", ".join("{} {:.3f}".format(k, v)
                        for k, v in readings.items())), flush=True)
    loss_vals = [res[d, f][0] for d in ("cuda", "cpu") for f in (False,
                                                                   True)]
    check(max(loss_vals) - min(loss_vals) <= TRANSDUCER_RTOL *
          abs(loss_vals[-1]) and max(readings.values()) <= 1.0,
          "tiny transducer losses or gradients disagree")
    g1, c1 = res["cuda", "beam", 1], res["cpu", "beam", 1]
    g4, c4 = res["cuda", "beam", 4], res["cpu", "beam", 4]
    same_greedy = all(np.array_equal(a, b) for a, b in
                      zip(g1["outputs"] + [g1["emit_frames"]],
                          c1["outputs"] + [c1["emit_frames"]]))
    same_best = all(np.array_equal(a, b) for a, b in
                    zip(g4["outputs"], c4["outputs"]))
    score_err = float(np.max(np.abs(g4["nbest"][2] - c4["nbest"][2]) /
                             np.maximum(1.0, np.abs(c4["nbest"][2]))))
    print("[transducer] greedy ids, lengths and emission frames identical "
          "card vs CPU: {} (lengths {}); beam 4: best ids identical {}, "
          "n-best scores' largest error {:.3e} of max(1, |score|) (best "
          "scores {})".format(same_greedy, c1["outputs"][1].tolist(),
                              same_best, score_err,
                              np.round(c4["nbest"][2][:, 0], 4).tolist()),
          flush=True)
    check(same_greedy and same_best and score_err <= TRANSDUCER_RTOL,
          "tiny transducer decodes disagree between card and CPU")
    (loss_gpu, w_gpu), (loss_cpu, w_cpu) = res["cuda", "step"], \
        res["cpu", "step"]
    w_err = max(float(np.max(np.abs(w_gpu[n] - w_cpu[n]) /
                             (1e-5 + 1e-4 * np.abs(w_cpu[n]))))
                for n in w_cpu)
    print("[transducer] one AdamW step with the fused loss, card vs CPU: "
          "loss {:.6f} vs {:.6f}; largest weight difference {:.3f} of the "
          "tolerance (rtol 1e-4, atol 1e-5); launches (rel-pos flash, its dq "
          "and dkv, conv module, its backward) on the card {}, on the CPU "
          "{}".format(loss_gpu, loss_cpu, w_err, res["cuda", "launches"],
                      res["cpu", "launches"]), flush=True)
    check(abs(loss_gpu - loss_cpu) <= TRANSDUCER_RTOL * abs(loss_cpu) and
          w_err <= 1.0, "the tiny transducer's AdamW step disagrees")
    # forward and backward twice (lattice, fused), two eval forwards, one
    # train step: two blocks each
    check(res["cuda", "launches"] == (10, 6, 6, 10, 6) and
          res["cpu", "launches"] == (0,) * 5,
          "launches in the tiny transducer: {}".format(
              res["cuda", "launches"]))
    return res["cuda", "launches"]


def _device_profile(fn):
    """``fn()`` under the profiler, device activity only: (device kernels,
    busy ms, span ms) from the first device activity to the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_activity(prof)


def _device_activity(prof):
    """(device kernels, busy ms, span ms) of a finished profiler's trace,
    from its first device activity to its last."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["cat"])
                   for e in events if e.get("cat") in ("kernel",
                                                       "gpu_memcpy",
                                                       "gpu_memset"))
    check(bool(spans), "the trace holds no device activity")
    busy, end = 0.0, spans[0][0]
    for s, e, _ in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return (sum(1 for x in spans if x[2] == "kernel"), busy / 1e3,
            (max(x[1] for x in spans) - spans[0][0]) / 1e3)


def phase_transducer(card):
    """7zc: the Conformer-Transducer at full width
    (``conformer_transducer_synthetic.py``, bench_transducer.py's keys:
    B 128 x 1000 frames x 80, U 160, the fused loss) through ``run.main
    --mode=train`` for 20 steps with the warmup cut to 20: the loss finite
    at every step and falling (7n's rule), the rel-pos flash forward, dq
    and dkv and the conv module forward and backward 16 times each a step;
    peak memory beside what the lattice's tanh input alone would hold
    unfused; utt/s. From the step-20 checkpoint: the parameter count, the
    JAX model's; the fused and the lattice loss of one batch on the same
    weights within TRANSDUCER_FUSED_RTOL; eval over 2 batches (WER, loss,
    16 forward launches of each kernel a batch); then the decode config
    (``conformer_transducer_decode_synthetic.py``, B 64) in infer, greedy
    and beam 4: rows, launches, utt/s of a batch, and its device kernels,
    busy time and idle share. Returns the five kernels' launches."""
    import torch
    from openseq2seq_tpu_torch.training import trainer
    total = [0] * 5
    config = runpy.run_path(TRANSDUCER)
    steps = config["train_params"]["max_steps"]
    B = config["base_params"]["batch_size_per_gpu"]
    with tempfile.TemporaryDirectory() as logdir:
        argv = ["--config_file=" + TRANSDUCER, "--logdir=" + logdir]
        _reset_conformer_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train", WARMUP_OVERRIDE])
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _conformer_counts()
        total = [a + b for a, b in zip(total, launches)]
        losses = _losses(lines)
        # the lattice's tanh input alone, (B, T', U+1, J) bf16
        lattice_h = B * 250 * 161 * 320 * 2
        print("[transducer] Conformer-Transducer, {} training steps of {} x "
              "1000 frames, U 160, fused loss, mixed, dropout 0.1 (8-bit "
              "masks), AdamW, warmup cut to 20 by {}: losses {}; launches "
              "(rel-pos flash, its dq, its dkv, conv module, its backward) "
              "{}; {:.1f} s with the build of the model".format(
                  steps, B, WARMUP_OVERRIDE, losses, launches, wall),
              flush=True)
        check(result["steps"] == steps, "trained {} steps".format(
            result["steps"]))
        check(len(losses) == steps and all(math.isfinite(x)
                                           for x in losses),
              "losses not finite at every step: {}".format(losses))
        check(sum(losses[-3:]) < sum(losses[:3]),
              "loss did not fall: {}".format(losses))
        check(launches == (16 * steps,) * 5,
              "launches {} in {} steps".format(launches, steps))
        print("[transducer] train throughput {:.1f} utt/s, {:.1f} ms per "
              "step over steps 11-{} (batch {}, 10 s utterances, bf16, a "
              "host read of the loss every step); peak device memory {:.2f} "
              "GiB, where the lattice's tanh input alone, (B, T', U+1, J) "
              "bf16, would hold {:.2f} GiB ({})".format(
                  result["objects_per_sec"] / 1000,
                  B * 1000 / result["objects_per_sec"] * 1e3, steps, B,
                  peak / 2 ** 30, lattice_h / 2 ** 30, card), flush=True)
        check(peak < 80 * 2 ** 30, "peak memory")
        ckpt = os.path.join(logdir, "checkpoints", str(steps))
        check(os.path.isdir(ckpt), "no checkpoint at {}".format(ckpt))

        out = {}
        _reset_conformer_counts()
        for fused in (True, False):
            params = dict(config["base_params"], logdir=logdir,
                          decoder_params=dict(
                              config["base_params"]["decoder_params"],
                              fused_loss=fused))
            model = config["base_model"](params, mode="eval", device="cuda")
            state = trainer.restore_state(model, ckpt)
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            out[fused] = float(model.eval_step(state, batch)["loss"])
            n_params = sum(p.numel() for p in state.module.parameters())
            del model, state
        rel = abs(out[True] - out[False]) / abs(out[False])
        print("[transducer] {} parameters (the JAX model's {}); one batch "
              "from the step-{} checkpoint: fused loss {:.6f}, lattice loss "
              "{:.6f}, rel diff {:.3e}".format(
                  n_params, TRANSDUCER_PARAMS, steps, out[True], out[False],
                  rel), flush=True)
        check(n_params == TRANSDUCER_PARAMS, "parameter count")
        check(rel <= TRANSDUCER_FUSED_RTOL, "fused and lattice losses")
        total = [a + b for a, b in zip(total, _conformer_counts())]
        torch.cuda.empty_cache()

        _reset_conformer_counts()
        metrics, lines = _run_quiet(argv + ["--mode=eval",
                                            "--data_layer_params/"
                                            "num_batches=2"])
        launches = _conformer_counts()
        total = [a + b for a, b in zip(total, launches)]
        wer = [x.strip() for x in lines if "Validation WER" in x]
        print("[transducer] eval from the step-{} checkpoint over 2 batches: "
              "{}, loss {:.6f}; launches {}".format(
                  steps, wer, metrics["eval_loss"], launches), flush=True)
        check(wer and math.isfinite(metrics["eval_loss"]) and
              launches == (32, 0, 0, 32, 0), "eval from the checkpoint")

        for beam in (1, 4):
            dec = ["--config_file=" + TRANSDUCER_DECODE,
                   "--logdir=" + logdir,
                   "--decoder_params/beam_width={}".format(beam)]
            csv_path = os.path.join(logdir, "infer_{}.csv".format(beam))
            _reset_conformer_counts()
            _run_quiet(dec + ["--mode=infer",
                              "--infer_output_file=" + csv_path])
            launches = _conformer_counts()
            total = [a + b for a, b in zip(total, launches)]
            rows = _infer_rows(csv_path)
            check(len(rows) == 128 and launches == (32, 0, 0, 32, 0),
                  "infer beam {}: {} rows, launches {}".format(
                      beam, len(rows), launches))
            _reset_conformer_counts()
            dconfig = runpy.run_path(TRANSDUCER_DECODE)
            params = dict(dconfig["base_params"], logdir=logdir,
                          decoder_params=dict(
                              dconfig["base_params"]["decoder_params"],
                              beam_width=beam))
            model = dconfig["base_model"](params, mode="infer",
                                          device="cuda")
            state = trainer.restore_state(model, ckpt)
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            model.eval_step(state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = model.eval_step(state, batch)
            lengths = result["outputs"]["decoder_output"]["outputs"][1]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            kernels, busy, span = _device_profile(
                lambda: model.eval_step(state, batch))
            launches = _conformer_counts()
            total = [a + b for a, b in zip(total, launches)]
            check(launches == (48, 0, 0, 48, 0), "three infer batches "
                  "launched {}".format(launches))
            print("[transducer] infer, {} of a batch of 64 (decode config): "
                  "{} rows; {:.1f} ms a batch, {:.1f} utt/s; labels a row "
                  "{:.1f} on average; {} device kernels a batch, busy "
                  "{:.3f} ms of a {:.3f} ms span, idle share {:.2%} ({})"
                  .format("greedy" if beam == 1 else "beam 4", len(rows), ms,
                          64e3 / ms, float(lengths.float().mean()), kernels,
                          busy, span, 1 - busy / span, card), flush=True)
            del model, state
    torch.cuda.empty_cache()
    return total


def phase_transducer_librispeech(card):
    """7zd: the Conformer-Transducer's LibriSpeech recipe
    (``conformer_transducer_librispeech.py``: batch 128, SpecAugment, the
    fused loss with FastEmit) on a LibriSpeech-shaped corpus of 128 ten-
    second utterances that ``test_utils/fake_librispeech`` writes: 10
    training steps (the first featurizes into the cold cache), the loss
    finite, 16 launches of each Conformer kernel a step; then eval from the
    checkpoint over the dev list's 64 utterances (2 batches of 32).
    Returns the five kernels' launches."""
    import torch
    from openseq2seq_tpu_torch.test_utils import fake_librispeech
    total = [0] * 5
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "librispeech")
        t0 = time.time()
        fake_librispeech.generate(data, n_utts=128)
        os.environ["LIBRISPEECH_DIR"] = data
        logdir = os.path.join(tmp, "logs")
        os.makedirs(logdir)
        steps = 10
        cut = _recipe_config(TRANSDUCER_LIBRI, logdir, steps,
                             print_loss_steps=1)
        argv = ["--config_file=" + cut, "--logdir=" + logdir]
        _reset_conformer_counts()
        result, lines = _run_quiet(argv + ["--mode=train"])
        launches = _conformer_counts()
        total = [a + b for a, b in zip(total, launches)]
        losses = _losses(lines)
        print("[transducer wav] the LibriSpeech recipe on 128 fake "
              "utterances of 10 s, {} steps of 128: losses {}; launches {}; "
              "{:.1f} s with the corpus and the model's build ({})".format(
                  result["steps"], losses, launches, time.time() - t0, card),
              flush=True)
        check(result["steps"] == steps and len(losses) == steps and
              all(math.isfinite(x) for x in losses),
              "the transducer recipe's losses {}".format(losses))
        check(launches == (16 * steps,) * 5, "launches {}".format(launches))
        _reset_conformer_counts()
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        launches = _conformer_counts()
        total = [a + b for a, b in zip(total, launches)]
        wer = [x.strip() for x in lines if "Validation WER" in x]
        print("[transducer wav] eval over the 64 dev utterances: {}, loss "
              "{:.6f}; launches {}".format(wer, metrics["eval_loss"],
                                           launches), flush=True)
        check(wer and math.isfinite(metrics["eval_loss"]) and
              launches == (32, 0, 0, 32, 0), "the recipe's eval")
        torch.cuda.synchronize()
    return total


def phase_transducer_toy(card):
    """7ze: ``conformer_transducer_toy.py`` from the toy wavs through
    ``run.main --mode=train_eval`` to its end (200 epochs of the 10
    utterances, one step each, no kernel flag): the last validation's WER
    below 0.1; eval from its checkpoint below 0.1 too, and infer writes 10
    rows."""
    with tempfile.TemporaryDirectory() as tmp:
        _toy_env(tmp)
        argv = ["--config_file=" + TRANSDUCER_TOY]
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train_eval"])
        wer = [float(x.split()[-1]) for x in lines if "Validation WER" in x]
        losses = _losses(lines)
        print("[transducer toy] conformer_transducer_toy --mode=train_eval: "
              "{} steps in {:.1f} s, losses at the printed steps {}; "
              "validation WERs {} ({})".format(
                  result["steps"], time.time() - t0, losses, wer, card),
              flush=True)
        check(wer and wer[-1] < 0.1, "the transducer toy's WER {}".format(
            wer))
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        out = os.path.join(tmp, "infer.csv")
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        rows = _infer_rows(out)
        print("[transducer toy] eval from the checkpoint: WER {:.4f}; infer: "
              "{}".format(metrics["Eval WER"], [r[1] for r in rows]),
              flush=True)
        check(metrics["Eval WER"] < 0.1 and len(rows) == 10,
              "the transducer toy's eval or infer")


def phase_transducers(card):
    """7zb to 7ze. Returns the Conformer kernels' launches (rel-pos flash,
    its dq, its dkv, conv module, its backward) over them."""
    runs = (phase_small_transducer(), phase_transducer(card),
            phase_transducer_librispeech(card))
    phase_transducer_toy(card)
    return [sum(x) for x in zip(*runs)]


# the scan kernels' instantiations that the main paths run, by their
# (gates, units per CTA) in the mangled name: DS2-medium's GRU (3, 8),
# lstm_small's LSTM (4, 4), the tiny configs' (3, 1) and (4, 1)
LM_WKT103 = os.path.join(REPO, "example_configs_torch", "lm",
                         "lstm_wkt103.py")
TXL_WKT103 = os.path.join(REPO, "example_configs_torch", "lm",
                          "txl_wkt103.py")
IMDB_WKT103 = os.path.join(REPO, "example_configs_torch", "transfer",
                           "imdb_wkt103.py")
LM_TOY = os.path.join(REPO, "example_configs_torch", "lm", "lstm_toy.py")
# WikiText-103's 267,735 types with <unk>, plus <eos>
WKT103_V = 267736
# the JAX model's count (tests/test_torch_transformer_xl.py)
TXL_PARAMS = 151119016


def _lstm_counts():
    from openseq2seq_tpu_torch.ops import lstm_scan
    return lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES


def _reset_lstm_counts():
    from openseq2seq_tpu_torch.ops import lstm_scan
    lstm_scan.LAUNCHES = lstm_scan.BWD_LAUNCHES = 0


def _peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def phase_wikitext_lm(card, corpus, logdir):
    """7zf: the WikiText-103 LSTM LM from text files. Returns the LSTM
    forward and backward launches of its train, eval and generate runs."""
    import torch
    from openseq2seq_tpu_torch.data.lm import Corpus
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.training import trainer
    wkt = corpus["wikitext"]
    processed = os.path.join(wkt, "processed")
    t0 = time.time()
    corp = Corpus(wkt, processed)
    tokens = {s: len(corp.ids(s)) for s in ("train", "valid", "test")}
    built = time.time() - t0
    t0 = time.time()
    Corpus(None, processed).ids("train")
    cached = time.time() - t0
    print("[wkt lm] Corpus: V {}, tokens {}, built (vocabulary, ids, "
          "vocab.txt) in {:.2f} s, from its cache in {:.3f} s".format(
              corp.vocab_size, tokens, built, cached), flush=True)
    check(corp.vocab_size == WKT103_V, "V {}".format(corp.vocab_size))
    check(os.path.exists(os.path.join(processed, "vocab.txt")),
          "no vocab.txt")

    steps = 20
    cut = _recipe_config(LM_WKT103, logdir, steps, print_loss_steps=1,
                         save_checkpoint_steps=steps)
    argv = ["--config_file=" + cut, "--logdir=" + logdir]
    total = [0, 0]
    _reset_lstm_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    result, lines = _run_quiet(argv + ["--mode=train"])
    wall = time.time() - t0
    launches = _lstm_counts()
    total = [a + b for a, b in zip(total, launches)]
    losses = _losses(lines)
    print("[wkt lm] lstm_wkt103.py train, {} steps of 224 x 96 tokens from "
          "text, mixed, 8192 sampled candidates, dropout on: losses {}; "
          "launches lstm_scan_fwd {}, lstm_scan_bwd {}; {:.1f} s with the "
          "build of the model; {:.0f} tokens/s over steps 11-{}; peak "
          "device memory {:.2f} GiB ({})".format(
              steps, losses, *launches, wall, result["objects_per_sec"],
              steps, _peak_gib(), card), flush=True)
    check(result["steps"] == steps and len(losses) == steps and
          all(math.isfinite(x) for x in losses), "losses {}".format(losses))
    check(sum(losses[-3:]) < sum(losses[:3]),
          "loss did not fall: {}".format(losses))
    check(launches == (3 * steps, 3 * steps),
          "launches {} in {} steps".format(launches, steps))

    config = runpy.run_path(cut)
    model = config["base_model"](dict(config["base_params"], logdir=logdir),
                                 mode="eval", device="cuda")
    batches = list(model.get_data_layer().iterate_one_epoch())
    ckpt = os.path.join(logdir, "checkpoints", str(steps))
    state = trainer.restore_state(model, ckpt)
    print("[wkt lm] {} parameters at V {}".format(
        sum(p.numel() for p in state.module.parameters()),
        corp.vocab_size), flush=True)
    _reset_lstm_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics, _ = _run_quiet(argv + ["--mode=eval"])
    launches = _lstm_counts()
    total = [a + b for a, b in zip(total, launches)]
    print("[wkt lm] eval from the step-{} checkpoint over the valid split "
          "({} batches): loss {:.6f}, perplexity {:.2f}; launches {}; peak "
          "device memory {:.2f} GiB ({})".format(
              steps, len(batches), metrics["eval_loss"],
              metrics["Eval perplexity"], launches, _peak_gib(), card),
          flush=True)
    check(math.isfinite(metrics["eval_loss"]) and
          launches == (3 * len(batches), 0), "eval from the checkpoint")

    _reset_lstm_counts()
    loss = float(model.eval_step(state, batches[0])["loss"])
    device_batch = to_device_batch(batches[0], "cuda")
    with torch.no_grad():
        logits = state.module(device_batch, train=False)[
            "decoder_output"]["logits"]
        plain = _plain_lm_nll(logits, device_batch["target_tensors"][0])
    del logits
    rel = abs(loss - plain) / abs(plain)
    total = [a + b for a, b in zip(total, _lstm_counts())]
    print("[wkt lm] a valid batch's loss {:.6f}, the plain fp64 NLL of its "
          "logits {:.6f}, rel err {:.3e}".format(loss, plain, rel),
          flush=True)
    check(rel <= RTOL, "batch loss disagrees with the plain NLL")

    seed = [corp.idx2word[int(i)] for i in batches[0]["source_tensors"][0]
            [0, :3]]
    _reset_lstm_counts()
    t0 = time.time()
    text = model.generate(state, seed_tokens=seed, num_tokens=20)
    gen_s = time.time() - t0
    launches = _lstm_counts()
    words = text.split()
    print("[wkt lm] generate from the checkpoint, greedy, prompt {}: {} "
          "words in {:.2f} s (B 1, the scan: launches {}): {}".format(
              seed, len(words) - len(seed), gen_s, launches,
              " ".join(words[len(seed):])), flush=True)
    check(len(words) == len(seed) + 20 and words[:len(seed)] == seed and
          all(w in corp.word2idx for w in words) and launches == (0, 0),
          "generate")
    del state, model
    torch.cuda.empty_cache()
    return total


def _nbest(corp, seed):
    """Four n-best lists of four hypotheses: a line of the test split and
    three of its shuffles, acoustic scores drawn from ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ids = corp.ids("test")
    lists = []
    for u in range(4):
        words = [corp.idx2word[int(i)] for i in ids[50 * u:50 * u + 10]
                 if corp.idx2word[int(i)] != "<eos>"]
        hyps = [" ".join(words)] + [" ".join(rng.permutation(words))
                                    for _ in range(3)]
        lists.append([(float(rng.randn()), h) for h in hyps])
    return lists


def _rescore(name, model, ckpt, nbest, launch_counts):
    from openseq2seq_tpu_torch.apps import NeuralRescorer
    import numpy as np
    rescorer = NeuralRescorer(model, ckpt)
    flat = [t for hyps in nbest for _, t in hyps]
    _reset_lstm_counts()
    t0 = time.time()
    scores = rescorer.lm_scores(flat)
    took = time.time() - t0
    best = rescorer.rescore(nbest, lm_weight=0.5)
    launches = _lstm_counts()
    want = [max(hyps, key=lambda h: h[0] + 0.5 * scores[
        flat.index(h[1])])[1] for hyps in nbest]
    print("[txl] NeuralRescorer with the {} from its checkpoint: {} "
          "hypotheses scored in {:.3f} s, LM log-probs {}; choices {} of 4 "
          "the unshuffled line; LSTM launches (scoring, then rescoring) "
          "{}".format(
              name, len(flat), took, np.round(scores, 2).tolist(),
              sum(b == hyps[0][1] for b, hyps in zip(best, nbest)),
              launches), flush=True)
    check(bool(np.all(np.isfinite(scores)) and np.all(scores < 0)) and
          best == want and launches == launch_counts,
          "{} rescoring".format(name))
    return launches


def phase_txl(card, corpus, logdir, lm_ckpt):
    """7zg: Transformer-XL at full width; the rescorer with both LMs.
    Returns the LSTM forward launches of the rescorer's LSTM batch."""
    import torch
    import torch.nn.functional as F
    from openseq2seq_tpu_torch.data.lm import Corpus
    from openseq2seq_tpu_torch.losses.sequence_loss import full_softmax_nll
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.training import trainer
    steps = 14
    cut = _recipe_config(TXL_WKT103, logdir, steps, print_loss_steps=1,
                         save_checkpoint_steps=steps, bench_start=4)
    argv = ["--config_file=" + cut, "--logdir=" + logdir]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    result, lines = _run_quiet(argv + ["--mode=train",
                                       "--lr_policy_params/warmup_steps=1"])
    wall = time.time() - t0
    losses = _losses(lines)
    print("[txl] txl_wkt103.py train, {} steps of 64 x 192 tokens, mixed, "
          "Adam 2.5e-4 (warmup cut to 1 step), dropout 0.1: losses {}; "
          "{:.1f} s with the build of the model; {:.0f} tokens/s over "
          "steps 5-{}; peak device memory {:.2f} GiB ({})".format(
              steps, losses, wall, result["objects_per_sec"], steps,
              _peak_gib(), card), flush=True)
    check(result["steps"] == steps and len(losses) == steps and
          all(math.isfinite(x) for x in losses), "losses {}".format(losses))
    check(sum(losses[-3:]) < sum(losses[:3]),
          "loss did not fall: {}".format(losses))

    torch.cuda.reset_peak_memory_stats()
    metrics, _ = _run_quiet(argv + ["--mode=eval"])
    print("[txl] eval from the step-{} checkpoint: loss {:.6f}, perplexity "
          "{:.2f}; peak device memory {:.2f} GiB ({})".format(
              steps, metrics["eval_loss"], metrics["Eval perplexity"],
              _peak_gib(), card), flush=True)
    check(math.isfinite(metrics["eval_loss"]), "TXL eval loss")

    config = runpy.run_path(cut)
    model = config["base_model"](dict(config["base_params"], logdir=logdir),
                                 mode="eval", device="cuda")
    ckpt = os.path.join(logdir, "checkpoints", str(steps))
    state = trainer.restore_state(model, ckpt)
    n_params = sum(p.numel() for p in state.module.parameters())
    print("[txl] {} parameters (the JAX model's: {})".format(
        n_params, TXL_PARAMS), flush=True)
    check(n_params == TXL_PARAMS, "TXL parameter count")

    net = state.module.enc.net
    D = net.out_features
    h = torch.randn((64 * 192, D), device="cuda").bfloat16()
    table = net.embedding.detach().bfloat16()
    bias = net.softmax_bias.detach()
    fp32_ms = cuda_ms(lambda: F.linear(h.float(), table.float(), bias), 5)
    bf16_ms = cuda_ms(lambda: torch.mm(h, table.t()), 5)
    print("[txl] the tied softmax's product at 64 x 192 tokens, V {}: the "
          "port's F.linear of the bf16-rounded operands in fp32 (TF32 off; "
          "the JAX product's values, fp32 sums and output) {:.3f} ms; a "
          "bf16 cuBLAS product with bf16 output, for comparison, {:.3f} ms "
          "(CUDA events; {})".format(table.shape[0], fp32_ms, bf16_ms, card),
          flush=True)
    del h

    batches = list(model.get_data_layer().iterate_one_epoch())
    x1, x2 = (to_device_batch(b, "cuda") for b in batches[:2])
    rows = 8
    net.mem_len = 192
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        out1 = net(x1["source_tensors"][0], x1["source_tensors"][1])
        mems, mems_valid = out1["mems"], out1["mems_valid"]
        del out1
        out2 = net(x2["source_tensors"][0], x2["source_tensors"][1],
                   mems=mems, mems_valid=mems_valid)
        seg = full_softmax_nll(out2["logits"], x2["target_tensors"][0])
        del out2
        torch.cuda.synchronize()
        seg_s = time.time() - t0
        net.mem_len = 0
        both = torch.cat([x1["source_tensors"][0][:rows],
                          x2["source_tensors"][0][:rows]], 1)
        full = net(both, torch.full((rows,), both.shape[1], device="cuda"))
        ctx = full_softmax_nll(full["logits"][:, 192:],
                               x2["target_tensors"][0][:rows])
        del full
    seg_nll, ctx_nll = float(seg[:rows].mean()), float(ctx.mean())
    rel = abs(seg_nll - ctx_nll) / abs(ctx_nll)
    print("[txl] two consecutive segments of 64 x 192 scored with mems "
          "(mem_len 192) in {:.3f} s: the second segment's mean NLL {:.4f} "
          "over its first {} rows, against {:.4f} from the 384-token "
          "context (rel {:.2e}, bf16); over all 64 rows {:.4f}".format(
              seg_s, seg_nll, rows, ctx_nll, rel, float(seg.mean())),
          flush=True)
    check(rel <= 1e-2, "segment memory disagrees with the full context")
    del state, model, net, mems
    torch.cuda.empty_cache()

    corp = Corpus(None, os.path.join(corpus["wikitext"], "processed"))
    nbest = _nbest(corp, 7)
    txl_model = config["base_model"](dict(config["base_params"]),
                                     mode="eval", device="cuda")
    _rescore("Transformer-XL", txl_model, ckpt, nbest, (0, 0))
    del txl_model
    lm_config = runpy.run_path(LM_WKT103)
    lm_model = lm_config["base_model"](dict(lm_config["base_params"]),
                                       mode="eval", device="cuda")
    launches = _rescore("LSTM LM", lm_model, lm_ckpt, nbest, (6, 0))
    del lm_model
    torch.cuda.empty_cache()
    return launches[0]


def phase_imdb_transfer(card, corpus, lm_logdir, logdir):
    """7zh: the IMDB transfer recipe from 7zf's checkpoint."""
    import torch
    from openseq2seq_tpu_torch.training import trainer
    steps = 8
    cut = _recipe_config(IMDB_WKT103, logdir, steps, print_loss_steps=1,
                         eval_steps=steps, save_checkpoint_steps=steps,
                         load_model=lm_logdir)
    config = runpy.run_path(cut)
    model = config["base_model"](dict(config["base_params"],
                                      **config["train_params"]),
                                 mode="train", device="cuda")
    state = trainer.restore_state(model)
    saved = torch.load(os.path.join(lm_logdir, "checkpoints", "20",
                                    "model.pt"), map_location="cuda",
                       weights_only=True)["module"]
    restored = dict(state.module.named_parameters())
    copied = [n for n in restored if n in saved]
    same = all(torch.equal(restored[n], saved[n]) for n in copied)
    head = sorted(n for n in restored if n not in saved)
    del state, model, saved
    print("[imdb] {} parameters; load_model from the LM: {} tensors "
          "copied, equal to the checkpoint's: {}; drawn from the seed: {}"
          .format(sum(p.numel() for p in restored.values()), len(copied),
                  same, head), flush=True)
    check(len(copied) == 10 and same and all(".classifier." in n
                                             for n in head),
          "partial restore")
    argv = ["--config_file=" + cut, "--logdir=" + logdir]
    _reset_lstm_counts()
    t0 = time.time()
    result, lines = _run_quiet(argv + ["--mode=train_eval"])
    wall = time.time() - t0
    launches = _lstm_counts()
    losses = _losses(lines)
    acc = [x.strip() for x in lines if "Validation accuracy" in x]
    restore = [x.strip() for x in lines if "Partial restore" in x]
    print("[imdb] imdb_wkt103.py train_eval, {} steps of 16 reviews, fp32: "
          "{}; losses {}; {}; {:.1f} s; LSTM launches {} ({})".format(
              steps, restore, losses, acc, wall, launches, card), flush=True)
    check(result["steps"] == steps and acc and
          all(math.isfinite(x) for x in losses) and launches == (0, 0),
          "IMDB transfer")


def _card_vs_cpu(name, build, x, lengths, extra=None):
    """A module built twice from one seed, on the card and on the CPU, the
    same inputs: outputs, states and every gradient of sum(out ct +
    state ct) within rtol 1e-4, atol 1e-5. Returns the largest reading
    of |card - CPU| / (1e-5 + 1e-4 |CPU|)."""
    import torch
    got = {}
    for dev in ("cuda", "cpu"):
        module = build().to(dev)
        args = [t.to(dev) for t in x] + [lengths.to(dev)]
        out = module(*args, **(extra(dev) if extra else {}))
        out, st = (out["logits"], out["mems"]) if isinstance(out, dict) \
            else out
        flat = [out] + [s for s in (st if isinstance(st, (list, tuple))
                                    else [st])]
        flat = [t for f in flat for t in (f if isinstance(f, (list, tuple))
                                          else [f])]
        gen = torch.Generator().manual_seed(1)
        loss = sum((t.float() * torch.randn(t.shape, generator=gen)
                    .to(dev)).sum() for t in flat if t.requires_grad)
        loss.backward()
        got[dev] = [t.detach().cpu() for t in flat] + \
            [p.grad.cpu() for p in module.parameters()]
        n_grads = len(got[dev]) - len(flat)
    reading = max(float(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
                  for a, b in zip(got["cuda"], got["cpu"]))
    print("[lm cells] {} fp32 card vs CPU: {} outputs and states, {} "
          "gradients, largest difference {:.3f} of the tolerance".format(
              name, len(got["cpu"]) - n_grads, n_grads, reading),
          flush=True)
    check(reading <= 1.0, "{}: card and CPU disagree".format(name))
    return reading


def phase_small_lm_cells():
    """7zi's second half: the new cells and a tiny Transformer-XL, fp32,
    card vs CPU."""
    import torch
    from openseq2seq_tpu_torch.encoders.transformer_xl_encoder import \
        TransformerXLNet
    from openseq2seq_tpu_torch.parts.rnns import rnn
    gen = torch.Generator().manual_seed(3)
    B, T, D = 8, 12, 16
    x = torch.randn((B, T, D), generator=gen)
    xg = torch.randn((B, T, 256), generator=gen)
    lengths = torch.tensor([12, 9, 1, 5, 12, 7, 3, 10])

    def seeded(cls, *a, **kw):
        return lambda: cls(*a, **kw, generator=torch.Generator()
                           .manual_seed(0))
    _card_vs_cpu("SLSTM", seeded(rnn.SLSTM, D, 24), [x], lengths)
    _card_vs_cpu("FLSTM (num_proj 10)", seeded(rnn.FLSTM, D, 24, 8, 10),
                 [x], lengths)
    _card_vs_cpu("LayerNormLSTM", seeded(rnn.LayerNormLSTM, D, 24), [x],
                 lengths)
    _reset_lstm_counts()
    _card_vs_cpu("GLSTM (2 groups of 128, fused)",
                 seeded(rnn.GLSTM, 256, 256, num_groups=2, fused=True),
                 [xg], lengths)
    launches = _lstm_counts()
    check(launches == (2, 2), "GLSTM launches {}".format(launches))
    ids = torch.randint(0, 29, (B, T), generator=gen)
    mems = [torch.randn((B, 6, 32), generator=gen) for _ in range(2)]
    _card_vs_cpu("Transformer-XL (2 layers of 32, mems of 6)",
                 lambda: TransformerXLNet(29, 2, 32, 4, 64, 0.0, 0.0, 6,
                                          torch.float32, 32,
                                          torch.Generator().manual_seed(0)),
                 [ids], torch.full((B,), T),
                 extra=lambda dev: {"mems": [m.to(dev) for m in mems]})


def phase_lm_toy(card):
    """7zi: the LM toy to a perplexity below 2.0."""
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["OS2S_TOY_LM_DIR"] = os.path.join(tmp, "data")
        os.environ["OS2S_TOY_LOGDIR"] = os.path.join(tmp, "logs")
        try:
            t0 = time.time()
            result, lines = _run_quiet(["--config_file=" + LM_TOY,
                                        "--mode=train_eval"])
            wall = time.time() - t0
            metrics, _ = _run_quiet(["--config_file=" + LM_TOY,
                                     "--mode=eval"])
        finally:
            del os.environ["OS2S_TOY_LM_DIR"], os.environ["OS2S_TOY_LOGDIR"]
    ppl = [x.strip() for x in lines if "Validation perplexity" in x]
    print("[lm toy] lstm_toy.py --mode=train_eval: {} steps in {:.1f} s, "
          "losses at the printed steps {}; {}; eval from its checkpoint: "
          "perplexity {:.4f} ({})".format(
              result["steps"], wall, _losses(lines), ppl,
              metrics["Eval perplexity"], card), flush=True)
    check(metrics["Eval perplexity"] < 2.0, "the LM toy's perplexity")


def phase_lm_family(card):
    """7zf to 7zi on one WikiText-shaped corpus. Returns the LSTM forward
    and backward launches of the main paths."""
    import torch
    from openseq2seq_tpu_torch.test_utils import fake_wikitext
    env = ("WIKITEXT103_DIR", "IMDB_DIR", "SST_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        corpus = fake_wikitext.generate(os.path.join(tmp, "data"), seed=0)
        print("[wkt lm] fake_wikitext (seed 0): WikiText-103's 267,734 "
              "word types, aclImdb and SST-2 sets, written in {:.2f} s"
              .format(time.time() - t0), flush=True)
        os.environ.update(dict(zip(env, (corpus["wikitext"],
                                         corpus["imdb"], corpus["sst"]))))
        try:
            lm_logdir = os.path.join(tmp, "lm")
            os.makedirs(lm_logdir)
            t0 = time.time()
            fwd, bwd = phase_wikitext_lm(card, corpus, lm_logdir)
            print("[wkt lm] phase 7zf in {:.1f} s".format(time.time() - t0),
                  flush=True)
            t0 = time.time()
            txl_logdir = os.path.join(tmp, "txl")
            os.makedirs(txl_logdir)
            fwd += phase_txl(card, corpus, txl_logdir,
                             os.path.join(lm_logdir, "checkpoints", "20"))
            print("[txl] phase 7zg in {:.1f} s".format(time.time() - t0),
                  flush=True)
            t0 = time.time()
            imdb_logdir = os.path.join(tmp, "imdb")
            os.makedirs(imdb_logdir)
            phase_imdb_transfer(card, corpus, lm_logdir, imdb_logdir)
            print("[imdb] phase 7zh in {:.1f} s".format(time.time() - t0),
                  flush=True)
        finally:
            for k in env:
                os.environ.pop(k, None)
    t0 = time.time()
    phase_lm_toy(card)
    phase_small_lm_cells()
    print("[lm toy] phase 7zi in {:.1f} s".format(time.time() - t0),
          flush=True)
    torch.cuda.synchronize()
    return fwd, bwd


SCAN_MAIN_INSTANCES = ("Li3ELi8E", "Li4ELi4E", "Li3ELi1E", "Li4ELi1E")


# the bf16 rel-pos kernels' instantiations at Conformer-M and Conformer-L
# (Dh 64; the dq kernel's chunk buckets 5 at D 256, 9 at D 512), by their
# mangled names: none may spill
RELPOS_MAIN_INSTANCES = ("flash_relpos_fwd_mma_kernelILi64E",
                         "flash_relpos_bwd_dq_mma_kernelILi64ELi5E",
                         "flash_relpos_bwd_dq_mma_kernelILi64ELi9E",
                         "flash_relpos_bwd_dkv_mma_kernelILi64E")


def check_relpos_spills(logs):
    """Each of RELPOS_MAIN_INSTANCES in the rel-pos build logs, with its
    registers; fails if one is missing or spills."""
    entries = re.findall(r"Compiling entry function '(\S+)'.*?"
                         r"(\d+) bytes spill stores, (\d+) bytes spill "
                         r"loads.*?Used (\d+) registers", "".join(logs),
                         re.S)
    for instance in RELPOS_MAIN_INSTANCES:
        found = [e for e in entries if instance in e[0]]
        check(len(found) == 1, "{}: not built".format(instance))
        _, stores, loads, regs = found[0]
        print("[build] {} (Conformer-M/-L): {} registers, {} bytes spilled"
              .format(instance, regs, int(stores) + int(loads)), flush=True)
        check(int(stores) + int(loads) == 0, "{} spills".format(instance))


def print_ptxas(name, log):
    """What ``ptxas`` reports for each kernel of a build log: every entry
    point's registers and spills; of the scan kernels' instantiations
    (units per CTA 1 to 10, bf16 and fp32; the bf16 ones on the tensor
    cores), the bf16 ones of the main paths, and the register range and
    spills of all."""
    entries = re.findall(r"Compiling entry function '(\S+)'.*?"
                         r"(\d+) bytes spill stores, (\d+) bytes spill "
                         r"loads.*?Used (\d+) registers", log, re.S)
    if "scan" not in name:
        for entry, stores, loads, regs in entries:
            print("[build] {}: {} registers, {} bytes spill stores, {} bytes "
                  "spill loads".format(entry, regs, stores, loads),
                  flush=True)
        return
    for entry, stores, loads, regs in entries:
        if ("bfloat16" in entry or "mma" in entry) and any(
                k in entry for k in SCAN_MAIN_INSTANCES):
            print("[build] {}: {} registers, {} bytes spill stores, {} "
                  "bytes spill loads".format(entry, regs, stores, loads),
                  flush=True)
    regs = [int(e[3]) for e in entries]
    print("[build] {}: {} instantiations, {} to {} registers, {} bytes "
          "spilled in all".format(name, len(entries), min(regs), max(regs),
                                  sum(int(e[1]) + int(e[2])
                                      for e in entries)), flush=True)


def print_kernels_line(k, launches):
    """8. one JSON line for the kernels: each one's launches over the
    whole run, its readings and times."""
    fwd_bound = ctc_bound_ms(32, 500, 160, 29, 500, backward=False)
    bwd_bound = ctc_bound_ms(32, 500, 160, 29, 501, backward=True)
    # the at_jca_shape entries time phase_kernel's and phase_backward's
    # jca cases: ctc_case seeded with T and T + 1
    jca_fwd_bound = ctc_bound_ms(64, 401, 241, 30, 401, backward=False)
    jca_bwd_bound = ctc_bound_ms(64, 401, 241, 30, 402, backward=True)
    # and at_quartznet_shape's, seeded with T and T + 1 likewise
    qn_fwd_bound = ctc_bound_ms(32, 835, 240, 29, 835, backward=False)
    qn_bwd_bound = ctc_bound_ms(32, 835, 240, 29, 836, backward=True)
    flash = k["flash_times"]["encoder"]
    flash_bwd = k["flash_bwd_times"]["encoder"]
    print(json.dumps({"kernels": [{
        "name": "ctc_alpha_fwd", "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/ctc_alpha_fwd.cu",
        "replaces": "openseq2seq_tpu/ops/ctc_pallas.py:65",
        "launches": launches["ctc_alpha_fwd"],
        "max_abs_err": k["fwd_err"],
        "ms": k["fwd_ms"], "plain_ms": k["fwd_plain_ms"],
        "bound_ms": fwd_bound[0],
        "bound_by": fwd_bound[1], "library_ms": k["ctc_lib_fwd_ms"],
        "at_jca_shape": {
            "ms": CTC_JCA["fwd_ms"], "plain_ms": CTC_JCA["fwd_plain_ms"],
            "bound_ms": jca_fwd_bound[0], "bound_by": jca_fwd_bound[1],
            "library_ms": CTC_JCA["lib_fwd_ms"]},
        "at_quartznet_shape": {
            "ms": CTC_QUARTZNET["fwd_ms"],
            "plain_ms": CTC_QUARTZNET["fwd_plain_ms"],
            "bound_ms": qn_fwd_bound[0], "bound_by": qn_fwd_bound[1],
            "library_ms": CTC_QUARTZNET["lib_fwd_ms"]}}, {
        "name": "ctc_beta_bwd", "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/ctc_beta_bwd.cu",
        "replaces": "openseq2seq_tpu/ops/ctc_pallas.py:140",
        "launches": launches["ctc_beta_bwd"],
        "max_abs_err": k["bwd_err"],
        "ms": k["bwd_ms"], "plain_ms": k["bwd_plain_ms"],
        "bound_ms": bwd_bound[0],
        "bound_by": bwd_bound[1], "library_ms": k["ctc_lib_fwd_bwd_ms"],
        "at_jca_shape": {
            "ms": CTC_JCA["bwd_ms"], "plain_ms": CTC_JCA["bwd_plain_ms"],
            "bound_ms": jca_bwd_bound[0], "bound_by": jca_bwd_bound[1],
            "library_ms": CTC_JCA["lib_fwd_bwd_ms"]},
        "at_quartznet_shape": {
            "ms": CTC_QUARTZNET["bwd_ms"],
            "plain_ms": CTC_QUARTZNET["bwd_plain_ms"],
            "bound_ms": qn_bwd_bound[0], "bound_by": qn_bwd_bound[1],
            "library_ms": CTC_QUARTZNET["lib_fwd_bwd_ms"]}}, {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/flash_attn_fwd.cu",
        "symbol": "flash_attn_fwd_mma_kernel (bf16, timed here; fp32: "
                  "flash_attn_fwd_kernel)",
        "replaces": "openseq2seq_tpu/parts/transformer/attention.py:120",
        "launches": launches["flash_attn_fwd"],
        "max_abs_err": k["flash_err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "at_serving_shape": k["flash_times"]["serving"]}] + [{
        "name": "flash_attn_bwd_" + part, "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/flash_attn_bwd.cu",
        "symbol": "flash_attn_bwd_{0}_mma_kernel (bf16, timed here; fp32: "
                  "flash_attn_bwd_{0}_kernel)".format(part),
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:"
                    + line + " (via openseq2seq_tpu/parts/transformer/"
                    "attention.py:120)",
        "launches": count, "max_abs_err": err,
        "ms": flash_bwd[part + "_ms"], "plain_ms": flash_bwd["plain_ms"],
        "bound_ms": flash_bwd[part + "_bound"][0],
        "bound_by": flash_bwd[part + "_bound"][1],
        "library_ms": flash_bwd["library_ms"]}
        for part, line, count, err in (
            ("dq", "1146", launches["flash_attn_bwd_dq"], k["dq_err"]),
            ("dkv", "796", launches["flash_attn_bwd_dkv"],
             k["dkv_err"]))] + [{
        "name": "dropout_mask", "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/dropout_mask.cu",
        "replaces": "openseq2seq_tpu/ops/dropout_pallas.py:92",
        "launches": launches["dropout_mask"],
        "max_abs_err": k["drop"]["max_abs_err"],
        "ms": k["drop"]["ms"], "plain_ms": k["drop"]["plain_ms"],
        "bound_ms": k["drop"]["bound"][0],
        "bound_by": k["drop"]["bound"][1],
        "library_ms": None}] + [{
        "name": "{}_scan_{}".format(cell, way), "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/{}_scan_{}.cu".format(cell,
                                                                    way),
        "replaces": "openseq2seq_tpu/ops/{}_pallas.py:{}".format(cell, line),
        "symbol": "rnn_scan::scan_{0}_mma_kernel (bf16, timed here; fp32: "
                  "rnn_scan::scan_{0}_kernel)".format(way),
        "launches": launches["{}_scan_{}".format(cell, way)],
        "bound_reading": times[cell]["bound_reading"],
        "max_abs_err": err[cell], "ms": times[cell]["ms"],
        "plain_ms": times[cell]["plain_ms"],
        "bound_ms": times[cell]["bound_ms"],
        "bound_by": times[cell]["bound_by"],
        "library_ms": times[cell]["library_ms"],
        **{shape: {k: times[case][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "tiles_per_step", "us_per_step")}
            for shape, case in ((("at_lm_shape", "lstm-lm"),
                                 ("at_gnmt_shape", "gnmt"),
                                 ("at_tacotron_shape", "tacotron"),
                                 ("at_las_shape", "las-400"),
                                 ("at_las_pyramid_shape", "las-200"))
                                if cell == "lstm" else
                                (("at_gst_shape", "gst"),))}}
        for cell, way, line, err, times in (
            ("lstm", "fwd", 73, k["scan_err"], k["scan_times"]),
            ("gru", "fwd", 64, k["scan_err"], k["scan_times"]),
            ("lstm", "bwd", 173, k["scan_bwd_err"], k["scan_bwd_times"]),
            ("gru", "bwd", 150, k["scan_bwd_err"],
             k["scan_bwd_times"]))] + [{
        "name": "flash_relpos_fwd", "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/flash_relpos_fwd.cu",
        "replaces": "openseq2seq_tpu/ops/flash_relpos.py:70",
        "launches": launches["flash_relpos_fwd"],
        "max_abs_err": k["relpos_err"],
        "ms": k["relpos_times"]["ms"],
        "plain_ms": k["relpos_times"]["plain_ms"],
        "bound_ms": k["relpos_times"]["bound_ms"],
        "bound_by": k["relpos_times"]["bound_by"],
        "library_ms": k["relpos_times"]["library_ms"],
        "at_transducer_shape": transducer_shape_times(k["relpos_times"]),
        "at_streaming_shape": streaming_shape_times(k["relpos_times"])}, {
        "name": "conformer_conv_fwd", "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/conformer_conv_fwd.cu",
        "replaces": "openseq2seq_tpu/ops/conformer_pallas.py:142",
        "launches": launches["conformer_conv_fwd"],
        "max_abs_err": k["conv_err"],
        "bound_reading": k["conv_times"]["bound_reading"],
        "ms": k["conv_times"]["ms"], "plain_ms": k["conv_times"]["plain_ms"],
        "bound_ms": k["conv_times"]["bound_ms"],
        "bound_by": k["conv_times"]["bound_by"], "library_ms": None,
        "at_transducer_shape": transducer_shape_times(k["conv_times"]),
        "at_streaming_shape": streaming_shape_times(k["conv_times"])}] + [{
        "name": "flash_relpos_bwd_" + part, "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/flash_relpos_bwd.cu",
        "replaces": "openseq2seq_tpu/ops/flash_relpos.py:" + line,
        "launches": count, "max_abs_err": err,
        "ms": k["relpos_bwd_times"][part + "_ms"],
        "plain_ms": k["relpos_bwd_times"]["plain_ms"],
        "bound_ms": k["relpos_bwd_times"][part + "_bound"][0],
        "bound_by": k["relpos_bwd_times"][part + "_bound"][1],
        "library_ms": k["relpos_bwd_times"]["library_ms"],
        "at_transducer_shape": transducer_shape_times(
            k["relpos_bwd_times"], part)}
        for part, line, count, err in (
            ("dq", "218", launches["flash_relpos_bwd_dq"],
             k["relpos_dq_err"]),
            ("dkv", "167", launches["flash_relpos_bwd_dkv"],
             k["relpos_dkv_err"]))] + [{
        "name": "conformer_conv_bwd", "route": "cuda",
        "source": "openseq2seq_tpu_torch/csrc/conformer_conv_bwd.cu",
        "replaces": "openseq2seq_tpu/ops/conformer_pallas.py:158",
        "launches": launches["conformer_conv_bwd"],
        "max_abs_err": k["conv_bwd_err"],
        "bound_reading": k["conv_bwd_times"]["bound_reading"],
        "ms": k["conv_bwd_times"]["ms"],
        "plain_ms": k["conv_bwd_times"]["plain_ms"],
        "bound_ms": k["conv_bwd_times"]["bound_ms"],
        "bound_by": k["conv_bwd_times"]["bound_by"], "library_ms": None,
        "at_transducer_shape": transducer_shape_times(k["conv_bwd_times"])}]}),
        flush=True)


IMAGE_DIR = os.path.join(REPO, "example_configs_torch", "image2label")
RESNET_TINY = os.path.join(IMAGE_DIR, "resnet_tiny_synthetic.py")
RESNET50 = os.path.join(IMAGE_DIR, "resnet50_v2_synthetic.py")
ALEXNET = os.path.join(IMAGE_DIR, "alexnet_owt_synthetic.py")
CIFAR_NV = os.path.join(IMAGE_DIR, "cifar10_nv.py")
RESNET_IMAGENET = os.path.join(IMAGE_DIR, "resnet50_v2_imagenet.py")
RESNET_COMMANDS = os.path.join(IMAGE_DIR, "resnet_commands.py")
JASPER_COMMANDS = os.path.join(REPO, "example_configs_torch", "speech2text",
                               "jasper_speech_commands.py")
# ResNet-50 v2 with its 1,000-way layer: the JAX model's count
# (tests/test_torch_resnet.py holds it with jax.eval_shape)
RESNET50_PARAMS = 25549352
RESNET50_STEPS = 20
# the CIFAR toy's epochs of 1,280 fake images (40 steps each) and its lr:
# the recipe's 0.05 diverges on the fake set, in the JAX package too,
# and loses its loss to spikes at 0.01 in both, on the CPU
CIFAR_TOY_EPOCHS, CIFAR_TOY_LR = 5, 0.003
CIFAR_TOY_TOP1 = 0.9


def _tiny_image_params(encoder):
    """The tiny ResNet config, or its CNN twin (conv, batch norm, pools,
    dense; no dropout so that card and CPU draw nothing)."""
    params = dict(runpy.run_path(RESNET_TINY)["base_params"])
    if encoder == "cnn":
        from openseq2seq_tpu_torch.encoders import CNNEncoder
        params.update(encoder=CNNEncoder, encoder_params={
            "cnn_layers": [
                {"type": "conv2d", "filters": 8, "kernel_size": 3,
                 "strides": 2, "activation": "relu"},
                {"type": "batch_norm"},
                {"type": "max_pool", "pool_size": 3, "strides": 2,
                 "padding": "SAME"},
                {"type": "avg_pool", "pool_size": 2, "padding": "SAME"}],
            "fc_layers": [{"type": "dense", "units": 16,
                           "activation": "relu"}]})
    return params


def phase_small_image():
    """7zj: the tiny ResNet v2 and the tiny CNN, fp32, from one seed on the
    card and on the CPU: three NovoGrad steps (losses, weights and the
    running statistics) and the eval logits after them within rtol 1e-4,
    atol 1e-5 (fp32 sums in another order, TF32 off)."""
    import numpy as np
    import torch
    from openseq2seq_tpu_torch.models import Image2Label
    from openseq2seq_tpu_torch.models.model import to_device_batch
    from openseq2seq_tpu_torch.training import trainer
    for encoder in ("resnet", "cnn"):
        got = {}
        for device in ("cuda", "cpu"):
            model = Image2Label(_tiny_image_params(encoder), mode="train",
                                device=device)
            state = trainer.restore_state(model)
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            losses = []
            for _ in range(3):
                state, metrics = model.train_step(state, batch)
                losses.append(float(metrics["loss"]))
            with torch.no_grad():
                logits = state.module(to_device_batch(batch, device),
                                      train=False)
            got[device] = (losses, {
                n: t.detach().float().cpu().numpy()
                for n, t in state.module.state_dict().items()
                if t.is_floating_point()},
                logits["decoder_output"]["logits"].float().cpu().numpy())
        (l_gpu, w_gpu, y_gpu), (l_cpu, w_cpu, y_cpu) = got["cuda"], \
            got["cpu"]

        def reading(a, b):
            return float(np.max(np.abs(a - b) / (1e-5 + 1e-4 * np.abs(b))))
        w_err = max(reading(w_gpu[n], w_cpu[n]) for n in w_cpu)
        y_err = reading(y_gpu, y_cpu)
        l_err = reading(np.array(l_gpu), np.array(l_cpu))
        print("[image] tiny fp32 {}, three NovoGrad steps, card vs CPU: "
              "losses {} vs {}; largest difference of the weights and "
              "statistics {:.3f}, the eval logits {:.3f}, the losses {:.3f} "
              "of the tolerance".format(encoder, ["{:.6f}".format(x)
                                                  for x in l_gpu],
                                        ["{:.6f}".format(x) for x in l_cpu],
                                        w_err, y_err, l_err), flush=True)
        check(max(w_err, y_err, l_err) <= 1.0,
              "tiny {}: card and CPU disagree".format(encoder))
        check(l_gpu[-1] < l_gpu[0], "tiny {}: loss did not fall {}".format(
            encoder, l_gpu))


def phase_resnet50(card):
    """7zk: ResNet-50 v2 at ``scripts/bench_resnet.py``'s width
    (``resnet50_v2_synthetic.py``: 224 x 224, batch 128, "mixed",
    NovoGrad, 1,000 classes) through ``run.main --mode=train`` for
    RESNET50_STEPS steps with the warm-up cut to 10 steps (5,000 in the
    recipe, where 20 steps would move the weights by almost nothing): the
    loss finite and falling on the repeated batch, the parameter count the
    JAX model's, images/s, the peak device memory, the memorised batch's
    top-1; then ``--mode=eval`` and ``--mode=infer`` from its
    checkpoint."""
    import numpy as np
    import torch
    from openseq2seq_tpu_torch.data.synthetic import SyntheticImageDataLayer
    from openseq2seq_tpu_torch.models.model import to_device_batch
    with tempfile.TemporaryDirectory() as logdir:
        argv = ["--config_file=" + RESNET50, "--logdir=" + logdir]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        result, lines = _run_quiet(argv + [
            "--mode=train", "--max_steps={}".format(RESNET50_STEPS),
            "--lr_policy_params/warmup_steps=10"])
        wall = time.time() - t0
        peak = _peak_gib()
        losses = _losses(lines)
        module = result["state"].module
        n_params = sum(p.numel() for p in module.parameters())
        params = runpy.run_path(RESNET50)["base_params"]
        batch = next(iter(SyntheticImageDataLayer(
            dict(params["data_layer_params"], mode="train",
                 batch_size=params["batch_size_per_gpu"]),
            None).iterate_one_epoch()))
        # with the batch's statistics: 20 steps at momentum 0.997 leave
        # the running ones near their start
        with torch.no_grad():
            logits = module(to_device_batch(batch, "cuda"), train=True)[
                "decoder_output"]["logits"]
        top1 = float(np.mean(logits.float().argmax(-1).cpu().numpy() ==
                             batch["target_tensors"][0]))
        print("[resnet50] resnet50_v2_synthetic.py train, {} steps of 128 x "
              "224 x 224 images, mixed: losses at the printed steps {}; {} "
              "parameters (the JAX model's: {}); {:.1f} images/s over steps "
              "11-{}; peak device memory {:.2f} GiB; top-1 of the memorised "
              "batch (batch statistics) {:.4f}; {:.1f} s with the build ({})".format(
                  result["steps"], losses, n_params, RESNET50_PARAMS,
                  result["objects_per_sec"], result["steps"], peak, top1,
                  wall, card), flush=True)
        check(result["steps"] == RESNET50_STEPS, "trained {} steps".format(
            result["steps"]))
        check(len(losses) >= 2 and all(math.isfinite(x) for x in losses),
              "losses not finite: {}".format(losses))
        check(losses[-1] < losses[0], "loss did not fall: {}".format(losses))
        check(n_params == RESNET50_PARAMS, "{} parameters".format(n_params))
        del module, result
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        out = os.path.join(logdir, "infer.csv")
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        with open(out, newline="") as f:
            rows = list(csv.reader(f))
        print("[resnet50] eval from the step-{} checkpoint: loss {:.4f}, "
              "top-1 {:.4f}, top-5 {:.4f}; infer: {} rows of "
              "sample_id,predicted_label".format(
                  RESNET50_STEPS, metrics["eval_loss"], metrics["Eval top-1"],
                  metrics["Eval top-5"], len(rows) - 1), flush=True)
        check(math.isfinite(metrics["eval_loss"]), "eval loss")
        check(rows[0] == ["sample_id", "predicted_label"] and
              len(rows) == 1 + 128 and
              all(0 <= int(r[1]) < 1000 for r in rows[1:]), "infer csv")
        torch.cuda.synchronize()


def phase_alexnet(card):
    """7zl: AlexNet (one weird trick) at ``alexnet_owt.py``'s width on
    synthetic 227 x 227 batches of 256, 12 steps: the loss finite,
    images/s over steps 11-12, the peak device memory."""
    import torch
    with tempfile.TemporaryDirectory() as logdir:
        torch.cuda.reset_peak_memory_stats()
        result, lines = _run_quiet(["--config_file=" + ALEXNET,
                                    "--logdir=" + logdir, "--mode=train",
                                    "--max_steps=12"])
        losses = _losses(lines)
        n_params = sum(p.numel() for p in result["state"].module.parameters())
        print("[alexnet] alexnet_owt_synthetic.py train, 12 steps of 256 x "
              "227 x 227 images, mixed: losses at the printed steps {}; {} "
              "parameters; {:.1f} images/s over steps 11-12; peak device "
              "memory {:.2f} GiB ({})".format(
                  losses, n_params, result["objects_per_sec"], _peak_gib(),
                  card), flush=True)
        check(result["steps"] == 12 and losses and
              all(math.isfinite(x) for x in losses), "AlexNet training")


def phase_cifar_toy(card):
    """7zm: the CIFAR toy: ``cifar10_nv.py``'s network on a fake CIFAR-10
    set (``test_utils/fake_cifar``: 1,280 training and 256 test images of
    ten stripe classes) for CIFAR_TOY_EPOCHS epochs at lr CIFAR_TOY_LR,
    then ``--mode=eval``: top-1 above 0.9, the JAX test's criterion."""
    from openseq2seq_tpu_torch.test_utils import fake_cifar
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CIFAR10_DIR"] = fake_cifar.generate(
            os.path.join(tmp, "cifar"))
        argv = ["--config_file=" + CIFAR_NV,
                "--logdir=" + os.path.join(tmp, "logs")]
        t0 = time.time()
        result, lines = _run_quiet(argv + [
            "--mode=train", "--num_epochs={}".format(CIFAR_TOY_EPOCHS),
            "--optimizer_params/learning_rate={}".format(CIFAR_TOY_LR)])
        losses = _losses(lines)
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        print("[cifar toy] cifar10_nv.py on fake_cifar, {} steps at lr {} "
              "in {:.1f} s: losses {}; eval top-1 {:.4f}, top-5 {:.4f} "
              "(above {} required)".format(
                  result["steps"], CIFAR_TOY_LR, time.time() - t0, losses,
                  metrics["Eval top-1"], metrics["Eval top-5"],
                  CIFAR_TOY_TOP1), flush=True)
        check(metrics["Eval top-1"] > CIFAR_TOY_TOP1, "CIFAR toy top-1")
        del os.environ["CIFAR10_DIR"]


def phase_speech_commands(card):
    """7zn: ``jasper_speech_commands.py`` (TDNN, flattened into the
    ``FullyConnectedDecoder``) and ``resnet_commands.py`` (ResNet-50 on
    128 x 128 log-mel images) at full width on labelled tone clips
    (``test_utils/fake_speech_commands``: 8 labels, 64 training and 32
    test clips): a few steps each (4 and 6), the losses finite, then
    ``--mode=eval`` from the checkpoint."""
    from openseq2seq_tpu_torch.test_utils import fake_speech_commands
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SPEECH_COMMANDS_DIR"] = fake_speech_commands.generate(
            os.path.join(tmp, "sc"), num_labels=8)
        os.environ["SC_NUM_LABELS"] = "8"
        for path, epochs, steps in ((JASPER_COMMANDS, 4, 4),
                                    (RESNET_COMMANDS, 3, 6)):
            argv = ["--config_file=" + path,
                    "--logdir=" + os.path.join(tmp, os.path.basename(path))]
            t0 = time.time()
            result, lines = _run_quiet(argv + [
                "--mode=train", "--num_epochs={}".format(epochs),
                "--print_loss_steps=1"])
            losses = _losses(lines)
            metrics, _ = _run_quiet(argv + ["--mode=eval"])
            print("[speech commands] {}: {} steps in {:.1f} s, losses {}; "
                  "eval over 32 clips: top-1 {:.4f}, loss {:.4f}".format(
                      os.path.basename(path), result["steps"],
                      time.time() - t0, losses, metrics["Eval top-1"],
                      metrics["eval_loss"]), flush=True)
            check(result["steps"] == steps and len(losses) == steps and
                  all(math.isfinite(x) for x in losses) and
                  math.isfinite(metrics["eval_loss"]),
                  "speech commands: {}".format(path))
        del os.environ["SPEECH_COMMANDS_DIR"], os.environ["SC_NUM_LABELS"]


def phase_imagenet_layers(card):
    """7zo: the ImageNet data layers from files, where Pillow is present:
    ``resnet50_v2_imagenet.py`` on a fake class-per-directory JPEG tree
    (``test_utils/fake_imagenet``: 4 classes, 3 images each a split) for
    one step and eval, and ``ImagenetTFRecordDataLayer`` on the same
    images as a TFRecord shard: its eval batch equal to the JPEG layer's.
    Returns whether Pillow was there."""
    import importlib.util
    import numpy as np
    if importlib.util.find_spec("PIL") is None:
        print("[imagenet] Pillow is not installed here: the JPEG and "
              "TFRecord ImageNet layers are held on the CPU only "
              "(tests/test_torch_image_data.py)", flush=True)
        return False
    from openseq2seq_tpu_torch.data.image2label import (
        ImagenetDataLayer, ImagenetTFRecordDataLayer)
    from openseq2seq_tpu_torch.test_utils import fake_imagenet
    with tempfile.TemporaryDirectory() as tmp:
        data = fake_imagenet.generate(os.path.join(tmp, "imagenet"))
        os.environ["IMAGENET_DIR"] = data
        argv = ["--config_file=" + RESNET_IMAGENET,
                "--logdir=" + os.path.join(tmp, "logs")]
        result, lines = _run_quiet(argv + ["--mode=train", "--num_epochs=1",
                                           "--print_loss_steps=1"])
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        del os.environ["IMAGENET_DIR"]
        params = {"mode": "eval", "data_dir": data, "batch_size": 8,
                  "image_size": 224}
        batches = [next(iter(cls(dict(params), None).iterate_one_epoch()))
                   for cls in (ImagenetDataLayer, ImagenetTFRecordDataLayer)]
        same = all(np.array_equal(batches[0][k][0], batches[1][k][0])
                   for k in ("source_tensors", "target_tensors"))
        print("[imagenet] resnet50_v2_imagenet.py on a fake JPEG tree: {} "
              "step, losses {}; eval top-1 {:.4f}, loss {:.4f}; the TFRecord "
              "layer's eval batch equal to the JPEG layer's: {}".format(
                  result["steps"], _losses(lines), metrics["Eval top-1"],
                  metrics["eval_loss"], same), flush=True)
        check(result["steps"] == 1 and len(_losses(lines)) == 1 and
              math.isfinite(metrics["eval_loss"]) and same,
              "ImageNet layers from files")
    return True


def phase_image_family(card):
    """7zj to 7zo."""
    timed(phase_small_image)
    for phase in (phase_resnet50, phase_alexnet, phase_cifar_toy,
                  phase_speech_commands, phase_imagenet_layers):
        timed(phase, card)


# ---------------------------------------------------------------------------
# 7zp to 7zx: the causal-convolution families (Centaur, WaveNet, ConvS2S);
# no TPU kernel is on their paths, so each is checked to launch none
# ---------------------------------------------------------------------------
def _tts(name):
    return os.path.join(REPO, "example_configs_torch", "text2speech", name)


def _t2t(name):
    return os.path.join(REPO, "example_configs_torch", "text2text", name)


CENTAUR_TINY = _tts("centaur_tiny_synthetic.py")
CENTAUR_SYNTHETIC = _tts("centaur_synthetic.py")
CENTAUR_FLOAT = _tts("centaur_float.py")
WAVENET_TOY = _tts("wavenet_toy.py")
WAVENET_LJ = _tts("wavenet_LJ.py")
CONVS2S_TINY = _t2t("convs2s_tiny_wmt.py")
CONVS2S_WMT = _t2t("en_de_convs2s_wmt.py")
NMT_TOY_CONVS2S = _t2t("nmt_reversal_toy_convs2s.py")
NMT_TOY_CR = _t2t("nmt_reversal_toy_cr.py")
NMT_TOY_RC = _t2t("nmt_reversal_toy_rc.py")
# the fast WaveNet generation against the parallel net on its own audio:
# the JAX test's tolerance (``tests/test_wavenet.py``)
WAVENET_ATOL, WAVENET_RTOL = 2e-4, 1e-3
# card against CPU in fp32 (TF32 off): the same sums in other orders
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-4, 1e-5


def _all_launches():
    """Every kernel wrapper's launch counts, summed."""
    from openseq2seq_tpu_torch.ops import (conformer_conv, ctc_cuda,
                                           flash_attention, flash_relpos,
                                           fused_dropout, gru_scan,
                                           lstm_scan)
    return sum(getattr(m, a) for m in (conformer_conv, ctc_cuda,
                                       flash_attention, flash_relpos,
                                       fused_dropout, gru_scan, lstm_scan)
               for a in dir(m) if a.endswith("LAUNCHES"))


@contextlib.contextmanager
def _launches_none(what):
    """The path inside launches no kernel (none of the JAX package's
    kernels is on it)."""
    before = _all_launches()
    yield
    check(_all_launches() == before, "{} launched a kernel".format(what))


def _close(a, b, rtol=CARD_CPU_RTOL, atol=CARD_CPU_ATOL):
    """The largest |a - b| / (atol + rtol |b|): at most 1 passes."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))


def _weights(state):
    return {n: p.detach().float().cpu().numpy()
            for n, p in state.module.named_parameters()}


def _model_card_vs_cpu(name, model_cls, params, eval_keys, train_steps=1,
                       infer=None):
    """``params`` built on the card and on the CPU from one seed: the eval
    outputs under ``eval_keys`` of the decoder output, ``train_steps``
    steps' losses and weights, and ``infer(model, state)``'s arrays, each
    within rtol 1e-4, atol 1e-5 (at most 1.0 of that tolerance)."""
    import torch
    from openseq2seq_tpu_torch.training import trainer
    got = {}
    for device in ("cuda", "cpu"):
        model = model_cls(copy.deepcopy(params), mode="eval", device=device)
        state = trainer.restore_state(model)
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        out = trainer.to_host(model.eval_step(state, batch))
        dec = out["outputs"]["decoder_output"]
        got[device] = {k: dec[k] for k in eval_keys}
        got[device]["loss"] = out["loss"]
        train = copy.deepcopy(params)
        train.pop("num_epochs", None)
        train["max_steps"] = train_steps
        model = model_cls(train, mode="train", device=device)
        state = trainer.restore_state(model)
        batches = model.get_data_layer().iterate_one_epoch()
        gen = torch.Generator(device=device).manual_seed(0)
        losses = []
        for _ in range(train_steps):
            state, metrics = model.train_step(state, next(batches), gen)
            losses.append(float(metrics["loss"]))
        got[device]["train loss"] = losses
        got[device]["weights"] = _weights(state)
        if infer is not None:
            model = model_cls(copy.deepcopy(params), mode="infer",
                              device=device)
            got[device].update(infer(model, trainer.restore_state(model)))
    readings, worst = {}, None
    for key, want in got["cpu"].items():
        mine = got["cuda"][key]
        if key == "weights":
            readings[key], worst = max((_close(mine[n], want[n]), n)
                                       for n in want)
        else:
            readings[key] = _close(mine, want)
    print("[causal] {}, card vs CPU (fp32): {} (of the tolerance, rtol "
          "1e-4, atol 1e-5; the weights' largest in {}); train losses {} vs "
          "{}".format(name, ", ".join("{} {:.3f}".format(k, v)
                                      for k, v in readings.items()),
                      worst, got["cuda"]["train loss"],
                      got["cpu"]["train loss"]), flush=True)
    check(max(readings.values()) <= 1.0,
          "{}: card and CPU disagree {}".format(name, readings))


def _no_dropout_centaur(path):
    """The config at ``path`` with its dropout off and the biases of the
    convs that feed a batch norm frozen: the norm removes them, so their
    gradient is rounding noise, which NovoGrad's normalisation would make
    a full-size update on either device."""
    params = copy.deepcopy(runpy.run_path(path)["base_params"])
    params["freeze_variables_regex"] = r"/conv\d+/bias$"
    params["encoder_params"]["cnn_dropout_prob"] = 0.0
    params["decoder_params"].update(cnn_dropout_prob=0.0,
                                    attention_dropout=0.0,
                                    layer_postprocess_dropout=0.0)
    return params


@contextlib.contextmanager
def _centaur_prenet_keeps_all():
    """Every Centaur prenet mask keeps: the card's and the CPU's
    generators draw different masks."""
    import torch
    from openseq2seq_tpu_torch.decoders.centaur_decoder import \
        CentaurDecoderModule as module
    draw = module.keep_mask
    module.keep_mask = lambda self, shape, generator, device: torch.ones(
        shape, dtype=torch.bool, device=device)
    try:
        yield
    finally:
        module.keep_mask = draw


def _centaur_infer(model, state):
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    batch.pop("target_tensors", None)
    from openseq2seq_tpu_torch.training import trainer
    dec = trainer.to_host(model.eval_step(state, batch))["outputs"][
        "decoder_output"]
    return {"infer frames": dec["decoder_spec"],
            "infer alignments": dec["alignments"],
            "infer lengths": dec["lengths"].astype("float64")}


def phase_small_causal():
    """7zp: the tiny Centaur (``centaur_tiny_synthetic.py``, dropout off,
    every prenet mask keeping; its windowed infer forced on layer 1) and
    the tiny WaveNet (``wavenet_tiny.py`` in fp32 on the toy's tones) on
    the card and on the CPU from one seed: eval outputs, the infer
    decode, two training steps, each within rtol 1e-4, atol 1e-5; none
    launches a kernel."""
    from openseq2seq_tpu_torch.models import (Text2SpeechCentaur,
                                              Text2SpeechWavenet)
    with _centaur_prenet_keeps_all(), _launches_none("tiny Centaur"):
        _model_card_vs_cpu("tiny Centaur", Text2SpeechCentaur,
                           _no_dropout_centaur(CENTAUR_TINY),
                           ("decoder_spec", "stop_token_logits",
                            "alignments"), train_steps=2,
                           infer=_centaur_infer)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["OS2S_TOY_WAVENET_DIR"] = os.path.join(tmp, "tones")
        params = copy.deepcopy(runpy.run_path(_tts("wavenet_tiny.py"))[
            "base_params"])
        params["dtype"] = "float32"
        with _launches_none("tiny WaveNet"):
            _model_card_vs_cpu("tiny WaveNet", Text2SpeechWavenet, params,
                               ("logits",), train_steps=2)


def phase_centaur(card):
    """7zq: Centaur at ``centaur_float.py``'s width on synthetic batches
    (``centaur_synthetic.py``: 32 x 96 characters x 512 frames of 80 mel
    bins, fp32, NovoGrad) through ``run.main --mode=train`` for 20 steps:
    the parameter count (the JAX model's), the loss finite at every step
    and the mean of the last five below that of the first five, frames/s,
    the peak device memory; ``--mode=eval`` from the checkpoint over 2
    batches ("Validation loss"); one infer batch of 200 frames (100 groups
    of 2, each a re-run of the stack) from the checkpoint, then again at
    ``window_size`` 1, whose alignments (the last block's, forced, one
    head) must be one-hot. No kernel launches."""
    import numpy as np
    import torch
    from openseq2seq_tpu_torch.training import trainer
    from openseq2seq_tpu_torch.utils.config import _latest_checkpoint
    steps = 20
    with tempfile.TemporaryDirectory() as logdir, \
            _launches_none("Centaur"):
        data = runpy.run_path(CENTAUR_SYNTHETIC)["base_params"][
            "data_layer_params"]
        cut = _recipe_config(CENTAUR_SYNTHETIC, logdir, steps,
                             data_layer_params=dict(data, num_batches=2),
                             print_loss_steps=1, save_checkpoint_steps=steps,
                             bench_start=2)
        argv = ["--config_file=" + cut, "--logdir=" + logdir]
        config = runpy.run_path(cut)
        p = config["base_params"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        losses = _losses(lines)
        count = sum(x.numel() for x in result["state"].module.parameters())
        print("[centaur] {} parameters, {} steps of 32 x 96 characters x "
              "512 mel frames, fp32; losses {}; peak device memory {:.2f} "
              "GiB; {:.1f} s with the build of the model; {:.1f} mel "
              "frames/s over steps 3-{} ({})".format(
                  count, result["steps"], losses,
                  torch.cuda.max_memory_allocated() / 2 ** 30, wall,
                  result["objects_per_sec"], steps, card), flush=True)
        check(count == CENTAUR_PARAMS, "Centaur: {} parameters".format(count))
        check(result["steps"] == steps and len(losses) == steps and
              all(math.isfinite(x) for x in losses) and
              sum(losses[-5:]) < sum(losses[:5]),
              "Centaur losses {}".format(losses))
        del result
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        val = [x.strip() for x in lines if "Validation loss" in x]
        print("[centaur] eval from the step-{} checkpoint over 2 batches: "
              "{}".format(steps, val), flush=True)
        check(bool(val) and math.isfinite(metrics["eval_loss"]),
              "Centaur eval")
        for window in (None, 1):
            params = copy.deepcopy(p)
            if window:
                params["decoder_params"]["window_size"] = window
            model = config["base_model"](params, mode="infer",
                                         device="cuda")
            state = trainer.restore_state(model, _latest_checkpoint(logdir))
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            torch.cuda.synchronize()
            t0 = time.time()
            dec = trainer.to_host(model.eval_step(state, batch))[
                "outputs"]["decoder_output"]
            secs = time.time() - t0
            spec, lengths, align = dec["decoder_spec"], dec["lengths"], \
                dec["alignments"]
            sharp = float(align.max(-1).min())
            print("[centaur] infer, one batch of {} at window_size {}: {} "
                  "frames in {:.2f} s ({:.1f} frames/s of the batch), "
                  "lengths {} to {}, the least of the steps' largest "
                  "alignment weights {:.4f} ({})".format(
                      spec.shape[0], params["decoder_params"]["window_size"],
                      spec.shape[1], secs, spec.shape[0] * spec.shape[1] /
                      secs, int(lengths.min()), int(lengths.max()), sharp,
                      card), flush=True)
            check(spec.shape == (32, 200, 80) and
                  bool(np.isfinite(spec).all()) and lengths.min() >= 1,
                  "Centaur infer: shape {}, lengths {}".format(spec.shape,
                                                               lengths))
            check(window != 1 or sharp > 0.999,
                  "Centaur's alignments at window 1 are not one-hot")


def _wavenet_fp32(net):
    """A copy of ``net`` computing in fp32 (the same weights)."""
    import torch
    net = copy.deepcopy(net).float()
    for m in net.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float32
    return net


def phase_wavenet(card, lj_dir):
    """7zr: ``wavenet_LJ.py`` at full width (4 x 10 gated layers of 64
    filters, 256 channels, 16,384-sample chunks of 22,050 Hz audio, batch
    2, "mixed") on a ``fake_ljspeech`` tree through ``run.main
    --mode=train`` for 20 steps: the parameter count (the JAX model's),
    the loss finite and falling (the mean of the last five below that of
    the first five), samples/s; ``--mode=eval`` over the recipe's 16 eval
    clips ("Validation loss"); ``--mode=infer`` over the test split (a
    teacher-forced wav a clip); then ``wavenet_generate`` from the
    checkpoint, fp32, 4,096 samples at B 2 conditioned on an eval batch's
    mel frames, sampled at
    temperature 1 from a seeded generator (argmax settles on one id after
    20 steps, and the taps would then all read alike): its logits
    against the parallel net's (fp32) on the generated audio within atol
    2e-4, rtol 1e-3 (the JAX test's), the net's labels equal to the ids,
    samples per second. No kernel launches."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    from openseq2seq_tpu_torch.encoders.wavenet_encoder import \
        wavenet_generate
    from openseq2seq_tpu_torch.training import trainer
    from openseq2seq_tpu_torch.utils.config import _latest_checkpoint
    os.environ["LJSPEECH_DIR"] = lj_dir
    steps = 20
    with tempfile.TemporaryDirectory() as logdir, \
            _launches_none("WaveNet"):
        cut = _recipe_config(WAVENET_LJ, logdir, steps, print_loss_steps=1,
                             save_checkpoint_steps=steps, bench_start=2)
        # infer over the test split's 6 clips (the recipe names every clip
        # of metadata.csv)
        with open(cut, "a") as f:
            f.write("infer_params = {{'data_layer_params': dict(base_params["
                    "'data_layer_params'], dataset_files=[{!r}])}}\n".format(
                        os.path.join(lj_dir, "test.csv")))
        argv = ["--config_file=" + cut, "--logdir=" + logdir]
        config = runpy.run_path(cut)
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        losses = _losses(lines)
        count = sum(x.numel() for x in result["state"].module.parameters())
        print("[wavenet] {} parameters, {} steps of 2 x 16,384 samples, "
              "mixed; losses {}; {:.1f} s with the build of the model; "
              "{:.1f} samples/s over steps 3-{} ({})".format(
                  count, result["steps"], losses, wall,
                  result["objects_per_sec"], steps, card), flush=True)
        check(count == WAVENET_PARAMS, "WaveNet: {} parameters".format(count))
        check(result["steps"] == steps and len(losses) == steps and
              all(math.isfinite(x) for x in losses) and
              sum(losses[-5:]) < sum(losses[:5]),
              "WaveNet losses {}".format(losses))
        del result
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        val = [x.strip() for x in lines if "Validation loss" in x]
        out = os.path.join(logdir, "infer", "infer.csv")
        t0 = time.time()
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        infer_s = time.time() - t0
        with open(out) as f:
            rows = [line.split(",") for line in f.read().splitlines()]
        sizes = [len(wavfile.read(r[1])[1]) for r in rows]
        print("[wavenet] eval from the checkpoint: {}; infer: {} wavs of {} "
              "to {} samples in {:.1f} s".format(val, len(rows), min(sizes),
                                                 max(sizes), infer_s),
              flush=True)
        check(bool(val) and math.isfinite(metrics["eval_loss"]) and
              len(rows) == 6 and min(sizes) > 0, "WaveNet eval and infer")

        model = config["base_model"](config["base_params"], mode="eval",
                                     device="cuda")
        state = trainer.restore_state(model, _latest_checkpoint(logdir))
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        n = 4096
        mel = torch.from_numpy(batch["source_tensors"][2][:, :n // 256 + 1]) \
            .cuda()
        net = state.module.enc.net
        torch.cuda.synchronize()
        t0 = time.time()
        ids, audio, logits = wavenet_generate(
            net, n, conditioning=mel, temperature=1.0,
            generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        gen_s = time.time() - t0
        with torch.no_grad():
            par = _wavenet_fp32(net)(audio, torch.full((2,), n).cuda(), mel,
                                     False)
        reading = _close(logits.cpu(), par["logits"].cpu(), WAVENET_RTOL,
                         WAVENET_ATOL)
        same = bool(torch.equal(par["labels"], ids))
        print("[wavenet] wavenet_generate, fp32, sampled at temperature 1 "
              "from a seeded generator, B 2 x {} samples conditioned on {} "
              "mel frames: {:.1f} s, {:.1f} samples/s a "
              "stream ({:.1f} in all); its logits against the parallel "
              "net's on the generated audio {:.3f} of the tolerance (atol "
              "2e-4, rtol 1e-3), labels equal to the ids: {}; {} distinct "
              "ids ({})".format(n, mel.shape[1], gen_s, n / gen_s,
                                2 * n / gen_s, reading, same,
                                len(torch.unique(ids)), card), flush=True)
        check(reading <= 1.0 and same and len(torch.unique(ids)) > 8 and
              bool(torch.isfinite(audio).all()),
              "WaveNet's fast generation disagrees with the parallel net")


def phase_centaur_toy(card, lj_dir):
    """7zs: ``centaur_float.py``'s network (batch 32, both mel and
    magnitude features, the decoder sized from the 80 mel bins) on the
    ``fake_ljspeech`` tree through ``run.main --mode=train_eval`` for 25
    steps: the loss finite and falling (the mean of the last five below
    that of the first five; the JAX package sets no bar for it); eval over
    the test split; infer over the test split (a wav a text of at least
    one frame). No kernel launches."""
    import torch
    from scipy.io import wavfile
    os.environ["LJSPEECH_DIR"] = lj_dir
    steps = 25
    with tempfile.TemporaryDirectory() as logdir, \
            _launches_none("the Centaur toy"):
        cut = os.path.join(logdir, "centaur_toy.py")
        with open(cut, "w") as f:
            f.write("import runpy\n_c = runpy.run_path({!r})\n"
                    "base_model = _c['base_model']\n"
                    "base_params = dict(_c['base_params'], max_steps={}, "
                    "print_loss_steps=1, eval_steps={}, "
                    "save_checkpoint_steps={})\n"
                    "eval_params = _c['eval_params']\n"
                    "infer_params = _c['eval_params']\n".format(
                        CENTAUR_FLOAT, steps, steps, steps))
        argv = ["--config_file=" + cut, "--logdir=" + logdir]
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train_eval"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        losses = _losses(lines)
        val = [x.strip() for x in lines if "Validation loss" in x]
        print("[toy centaur] centaur_float.py on the fake LJSpeech tree: {} "
              "steps in {:.1f} s, losses {}; {} ({})".format(
                  result["steps"], wall, losses[::5] + losses[-1:], val,
                  card), flush=True)
        check(result["steps"] == steps and len(losses) == steps and
              all(math.isfinite(x) for x in losses) and
              sum(losses[-5:]) < sum(losses[:5]) and bool(val),
              "the Centaur toy's losses {}".format(losses))
        out = os.path.join(logdir, "infer", "infer.csv")
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        with open(out) as f:
            rows = [line.split(",") for line in f.read().splitlines()]
        sizes = [len(wavfile.read(r[1])[1]) for r in rows]
        print("[toy centaur] infer over the test split: {} wavs of {} to {} "
              "samples".format(len(rows), min(sizes), max(sizes)),
              flush=True)
        check(len(rows) == 6 and min(sizes) > 0, "the Centaur toy's infer")


def phase_wavenet_toy(card):
    """7zt: the WaveNet toy (``wavenet_toy.py``: the JAX test's network
    and four tones) through ``run.main --mode=train_eval`` to its end (200
    steps): the last loss below 3.0, the JAX test's bar; eval and infer
    (a wav a tone) from the checkpoint. No kernel launches."""
    import torch
    with tempfile.TemporaryDirectory() as tmp, \
            _launches_none("the WaveNet toy"):
        os.environ["OS2S_TOY_WAVENET_DIR"] = os.path.join(tmp, "tones")
        os.environ["OS2S_TOY_LOGDIR"] = os.path.join(tmp, "logs")
        argv = ["--config_file=" + WAVENET_TOY]
        t0 = time.time()
        result, lines = _run_quiet(argv + ["--mode=train_eval"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        loss = float(result["last_metrics"]["loss"])
        val = [x.strip() for x in lines if "Validation loss" in x]
        print("[toy wavenet] wavenet_toy --mode=train_eval: {} steps in "
              "{:.1f} s, losses at the printed steps {}, the last {:.4f}; "
              "{} ({})".format(result["steps"], wall, _losses(lines), loss,
                               val, card), flush=True)
        check(result["steps"] == 200 and loss < 3.0,
              "the WaveNet toy's loss {}".format(loss))
        metrics, _ = _run_quiet(argv + ["--mode=eval"])
        out = os.path.join(tmp, "infer", "infer.csv")
        _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
        with open(out) as f:
            rows = f.read().splitlines()
        check(math.isfinite(metrics["eval_loss"]) and len(rows) == 4,
              "the WaveNet toy's eval and infer")


def phase_causal_tts(card):
    """7zp to 7zt: Centaur and WaveNet."""
    from openseq2seq_tpu_torch.test_utils import fake_ljspeech
    timed(phase_small_causal)
    timed(phase_centaur, card)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        lj_dir = fake_ljspeech.generate(os.path.join(tmp, "lj"), n_clips=64)
        print("[causal] fake_ljspeech: 64 clips of 1 to 3 s at 22,050 Hz in "
              "{:.1f} s".format(time.time() - t0), flush=True)
        timed(phase_wavenet, card, lj_dir)
        timed(phase_centaur_toy, card, lj_dir)
    timed(phase_wavenet_toy, card)


def phase_small_convs2s():
    """7zu: the tiny ConvS2S (``convs2s_tiny_wmt.py``, dropout off) on the
    card and on the CPU from one seed: the eval logits and beam-3 ids,
    two Momentum steps, within rtol 1e-4, atol 1e-5; no kernel
    launches."""
    from openseq2seq_tpu_torch.models import Text2Text
    with tempfile.TemporaryDirectory() as tmp, \
            _launches_none("tiny ConvS2S"):
        os.environ["OS2S_FAKE_WMT_TINY_DIR"] = os.path.join(tmp, "wmt")
        params = copy.deepcopy(runpy.run_path(CONVS2S_TINY)["base_params"])
        for part in ("encoder_params", "decoder_params"):
            for key in list(params[part]):
                if key.endswith("keep_prob"):
                    params[part][key] = 1.0

        def beams(model, state):
            from openseq2seq_tpu_torch.training import trainer
            batch = next(iter(model.get_data_layer().iterate_one_epoch()))
            out = trainer.to_host(model.eval_step(state, batch))
            return {"beam ids": out["outputs"]["decoder_output"]["outputs"][
                0].astype("float64")}

        _model_card_vs_cpu("tiny ConvS2S", Text2Text, params, ("logits",),
                           train_steps=2, infer=beams)


def phase_mixed_toys(card):
    """7zx: the CR and RC toys (a ConvS2S encoder under an RNN decoder, an
    RNN encoder under a ConvS2S decoder) for 20 steps each, then eval: the
    losses finite, "Validation BLEU" printed; no kernel launches."""
    for path in (NMT_TOY_CR, NMT_TOY_RC):
        name = os.path.basename(path)
        with tempfile.TemporaryDirectory() as tmp, _launches_none(name):
            _toy_nmt_env(tmp)
            cut = _recipe_config(path, tmp, 20, print_loss_steps=5,
                                 eval_steps=20, save_checkpoint_steps=20)
            result, lines = _run_quiet(["--config_file=" + cut,
                                        "--logdir=" + tmp,
                                        "--mode=train_eval"])
            losses = _losses(lines)
            bleu = _bleu_lines(lines)
            print("[toy nmt] {}: {} steps, losses {}, validation BLEU {} "
                  "({})".format(name, result["steps"], losses, bleu, card),
                  flush=True)
            check(result["steps"] == 20 and len(losses) == 4 and
                  all(math.isfinite(x) for x in losses) and bool(bleu),
                  "{} losses {}".format(name, losses))


def convs2s_corpus(wmt_dir, root):
    """``wmt_dir``'s corpus with its dev and test splits cut to 16
    sentences: one eval batch, and an infer batch of 16 at beam 5."""
    out = os.path.join(root, "wmt_dev16")
    os.makedirs(out)
    for name in os.listdir(wmt_dir):
        src = os.path.join(wmt_dir, name)
        if name.startswith(("wmt13-en-de", "wmt14-en-de")):
            with open(src) as f:
                lines = f.read().splitlines()[:16]
            with open(os.path.join(out, name), "w") as f:
                f.write("\n".join(lines) + "\n")
        else:
            os.symlink(src, os.path.join(out, name))
    return out


# ---------------------------------------------------------------------------
# 7zy to 7zzc: LAS and JCA speech recognition and the CTC beam decoders;
# their kernels are B3 (the LAS listener's LSTMs under ``fused_rnn``) and
# B1a/B1b (JCA's CTC half)
# ---------------------------------------------------------------------------
def _s2t(name):
    return os.path.join(REPO, "example_configs_torch", "speech2text", name)


LAS_TINY = _s2t("las_tiny.py")
JCA_TINY = _s2t("jca_tiny.py")
LAS_TOY = _s2t("las_toy.py")
LAS_LIBRI = _s2t("las_large_librispeech.py")
JCA_LIBRI = _s2t("jca_large_8gpus.py")
JASPER_BEAM = _s2t("jasper10x5_beam_librispeech.py")
# the biases of the convs that feed a batch norm: rounding noise in the
# gradient, frozen where the card is held against the CPU
CONV_BIAS = r"/(conv|res)\d+_\d+/bias$"


def _scan_ctc_counts():
    from openseq2seq_tpu_torch.ops import ctc_cuda, lstm_scan
    return (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES, ctc_cuda.LAUNCHES,
            ctc_cuda.BWD_LAUNCHES)


def _reset_scan_ctc_counts():
    from openseq2seq_tpu_torch.ops import ctc_cuda, lstm_scan
    lstm_scan.LAUNCHES = lstm_scan.BWD_LAUNCHES = 0
    ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0


def _tiny_params(path, **decoder):
    """A tiny recipe's params, dropout off, the pre-norm conv biases
    frozen, Adam's epsilon 1e-4 (its default 1e-8 turns a gradient's
    rounding difference near zero into a full-size step on one device
    and not the other), batches of 5 (two an epoch of the toy's 10), the
    decoder's params updated with ``decoder``."""
    params = copy.deepcopy(runpy.run_path(path)["base_params"])
    params["freeze_variables_regex"] = CONV_BIAS
    params["optimizer_params"] = dict(params["optimizer_params"],
                                      epsilon=1e-4)
    params["batch_size_per_gpu"] = 5
    if "attn_decoder_params" in params["decoder_params"]:
        params["decoder_params"]["attn_decoder_params"][
            "dropout_keep_prob"] = 1.0
    else:
        params["decoder_params"]["dropout_keep_prob"] = 1.0
    params["decoder_params"].update(decoder)
    return params


def _decoded(model, state):
    """The infer decode of the first batch: ids and lengths, as floats."""
    from openseq2seq_tpu_torch.training import trainer
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    batch.pop("target_tensors", None)
    ids, lengths = trainer.to_host(model.eval_step(state, batch))[
        "outputs"]["decoder_output"]["outputs"]
    return {"infer ids": ids.astype("float64"),
            "infer lengths": lengths.astype("float64")}


def phase_small_las():
    """7zy: the tiny LAS (``las_tiny.py`` at H 64 in fp32, where kernel
    B3's fp32 path takes the listener's LSTM on the card) and the tiny JCA
    (``jca_tiny.py``: its CTC half on B1a and B1b on the card) on the card
    and on the CPU from one seed: eval logits (and LAS's alignments), two
    training steps' losses and weights, the beam decode's ids, each within
    rtol 1e-4, atol 1e-5; B3 and the CTC kernels launch on the card."""
    from openseq2seq_tpu_torch.models import Speech2Text
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["OS2S_TOY_DATA_DIR"] = os.path.join(tmp, "toy_speech")
        las = _tiny_params(LAS_TINY)
        las["encoder_params"]["recurrent_layers"] = [
            {"type": "lstm", "num_units": 64, "pool": 2}]
        _reset_scan_ctc_counts()
        _model_card_vs_cpu("tiny LAS (B3 fp32 at H 64)", Speech2Text, las,
                           ("logits", "alignments"), train_steps=2,
                           infer=_decoded)
        las_counts = _scan_ctc_counts()
        _reset_scan_ctc_counts()
        _model_card_vs_cpu("tiny JCA", Speech2Text, _tiny_params(JCA_TINY),
                           ("logits",), train_steps=2, infer=_decoded)
        jca_counts = _scan_ctc_counts()
    print("[las] launches on the card (B3 fwd, B3 bwd, B1a, B1b): tiny LAS "
          "{}, tiny JCA {}".format(las_counts, jca_counts), flush=True)
    # eval 2 (fw, bw), two steps 2 + 2 each way, infer 2
    check(las_counts == (8, 4, 0, 0) and jca_counts[2:] == (3, 2),
          "tiny LAS / JCA launches {} {}".format(las_counts, jca_counts))


def _las_corpus(root):
    """256 utterances of 16.0 s (under the recipes' ``max_duration`` of
    16.7) with 240-character transcripts (about LibriSpeech's 15
    characters a second), the dev list (the first 64) copied as the test
    list, and one symbol that no transcript holds appended to the 28
    characters of ``vocab.txt``: the reference's speech layer keeps id 28
    for the CTC blank and gives <S> and </S> the ids 29 and 30, which the
    recipes' ``GO_SYMBOL`` and ``END_SYMBOL`` name; the port's layer, the
    JAX package's copy, gives them the next two ids after the vocabulary's,
    so the extra symbol puts them where the recipes expect them."""
    from openseq2seq_tpu_torch.test_utils import fake_librispeech
    data = os.path.join(root, "librispeech")
    t0 = time.time()
    fake_librispeech.generate(data, n_utts=256, duration=16.0,
                              transcript_chars=240)
    shutil.copy(os.path.join(data, "librivox-dev-clean.csv"),
                os.path.join(data, "librivox-test-clean.csv"))
    with open(os.path.join(data, "vocab.txt"), "a") as f:
        f.write("_\n")
    print("[las] a LibriSpeech-shaped corpus of 256 utterances of 16.0 s "
          "(240-character transcripts, 29 symbols) written in {:.1f} s"
          .format(time.time() - t0), flush=True)
    return data


def _cached_recipe(path, logdir, steps, cache, **base):
    """``_recipe_config`` with the train list's features cached (the first
    epoch featurizes into ``cache``, the later ones read it: LAS and JCA
    share one cache, their features being the same) and infer reading the
    test list (the recipes, as the JAX package's, set no infer list, so
    infer would read the train lists)."""
    dlp = dict(runpy.run_path(path)["base_params"]["data_layer_params"],
               cache_features=True, cache_format=cache)
    cut = _recipe_config(path, logdir, steps, data_layer_params=dlp, **base)
    with open(cut, "a") as f:
        f.write("infer_params = {{'data_layer_params': {{'dataset_files': "
                "[{!r}], 'cache_features': False}}}}\n".format(os.path.join(
                    os.environ["LIBRISPEECH_DIR"],
                    "librivox-test-clean.csv")))
    return cut


@contextlib.contextmanager
def _traced_last_steps(steps, window):
    """Inside, a training run of ``steps`` steps (``Model.train_step``
    wrapped, a synchronize after each) traces the device activity of its
    last ``window`` steps alone, the profiler on for those steps only;
    yields a dict whose "trace" then holds (busy ms, span ms) over them,
    from the window's first device activity to its last, and whose
    "ends" the host clock at the end of each step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from openseq2seq_tpu_torch.models.model import Model
    out = {"trace": [], "ends": []}
    prof = []
    orig = Model.train_step

    def stepped(self, *args, **kwargs):
        result = orig(self, *args, **kwargs)
        torch.cuda.synchronize()
        out["ends"].append(time.perf_counter())
        done = len(out["ends"])
        if done == steps - window:
            prof.append(profile(activities=[ProfilerActivity.CUDA]))
            prof[0].__enter__()
        elif done == steps:
            prof[0].__exit__(None, None, None)
            out["trace"].append(_device_activity(prof[0])[1:])
        return result

    Model.train_step = stepped
    try:
        yield out
    finally:
        Model.train_step = orig
        if prof and len(out["ends"]) < steps:
            prof[0].__exit__(None, None, None)


def _train_full_width(name, path, tmp, per_step, card):
    """``path`` at full width through ``run.main --mode=train``: 20
    training steps of 64 utterances (``per_step``: B3 fwd, B3 bwd, B1a,
    B1b launches a step), the last 3 traced (the card's idle share; the
    steps' host reads of the loss, one a step as the config prints it,
    and a synchronize a step while the profiler is on); the loss finite
    and falling, utt/s, the peak memory. Returns its argv (for eval and
    infer from its checkpoint) and the launches."""
    import torch
    logdir = os.path.join(tmp, name + "_logs")
    os.makedirs(logdir)
    steps, window = 20, 3
    cut = _cached_recipe(path, logdir, steps,
                         os.path.join(tmp, "feature_cache"),
                         print_loss_steps=1, bench_start=6)
    argv = ["--config_file=" + cut, "--logdir=" + logdir]
    _reset_scan_ctc_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _traced_last_steps(steps, window) as traced:
        result, lines = _run_quiet(argv + ["--mode=train"])
    wall = time.perf_counter() - t0
    got = _scan_ctc_counts()
    losses = _losses(lines)
    frames = 1 + 16 * 16000 // 160
    ends = traced["ends"]
    print("[las] {} at full width, {} steps of 64 utterances: losses {}; "
          "{:.2f} utt/s over steps 7-{} (warm feature cache; the last {} "
          "traced); {:.1f} s in all, to the end of step 1 {:.1f} s (the "
          "build, the cold featurization, cuDNN's autotuning), steps 2-6 "
          "{:.1f} s; peak {:.2f} GiB; launches (B3 fwd, B3 bwd, B1a, B1b) "
          "{} ({})".format(name, result["steps"], losses,
                           result["objects_per_sec"] / frames, steps,
                           window, wall, ends[0] - t0, ends[5] - ends[0],
                           _peak_gib(), got, card), flush=True)
    check(result["steps"] == steps and len(losses) == steps and
          all(math.isfinite(x) for x in losses) and
          sum(losses[-3:]) < sum(losses[:3]),
          "{} losses {}".format(name, losses))
    check(got == tuple(steps * n for n in per_step),
          "{}: launches {} in {} steps, want {} a step".format(
              name, got, steps, per_step))
    check(len(traced["trace"]) == 1, "{}: the window was not traced"
          .format(name))
    busy, span = traced["trace"][0]
    print("[las] {}: steps {}-{} traced: the card busy {:.3f} ms of a "
          "{:.3f} ms span, idle share {:.2%} ({})".format(
              name, steps - window + 1, steps, busy, span, 1 - busy / span,
              card), flush=True)
    return argv, list(got)


def _eval_infer_full_width(name, argv, data, tmp, per_step):
    """Eval from the checkpoint of ``argv`` over the 64 dev utterances
    ("Validation WER", one batch), and a beam-4 infer batch of the 64
    test utterances, whose CSV names each of their wavs once. Returns the
    launches."""
    total = [0, 0, 0, 0]
    _reset_scan_ctc_counts()
    t0 = time.time()
    metrics, lines = _run_quiet(argv + ["--mode=eval"])
    got = _scan_ctc_counts()
    total = [a + b for a, b in zip(total, got)]
    wer = [x.strip() for x in lines if "Validation WER" in x]
    print("[las] {}: eval over the 64 dev utterances in {:.1f} s (one "
          "batch: the teacher-forced loss and the beam-4 decode): {}, loss "
          "{:.4f}; launches {}".format(name, time.time() - t0, wer,
                                       metrics["eval_loss"], got),
          flush=True)
    want = (per_step[0], 0, 1 if per_step[2] else 0, 0)
    check(bool(wer) and math.isfinite(metrics["eval_loss"]) and got == want,
          "{} eval: launches {}, want {}".format(name, got, want))

    out = os.path.join(tmp, name + "_infer.csv")
    _reset_scan_ctc_counts()
    t0 = time.time()
    _run_quiet(argv + ["--mode=infer", "--infer_output_file=" + out])
    got = _scan_ctc_counts()
    total = [a + b for a, b in zip(total, got)]
    rows = _infer_rows(out)
    with open(os.path.join(data, "librivox-test-clean.csv")) as f:
        wavs = [r["wav_filename"] for r in csv.DictReader(f)]
    print("[las] {}: beam-4 infer of the 64 test utterances in {:.1f} s: "
          "{} rows, each wav once in order: {}; the first {!r}; launches {}"
          .format(name, time.time() - t0, len(rows),
                  [r[0] for r in rows] == wavs, rows[0][1][:60], got),
          flush=True)
    check([r[0] for r in rows] == wavs and got == (per_step[0], 0, 0, 0),
          "{} infer: rows or launches {}".format(name, got))
    return total


def phase_las_jca(card, start_toy):
    """7zz, 7zza: ``las_large_librispeech.py`` (the LAS recipe, "mixed",
    ``fused_rnn``: the listener's three BiLSTMs on B3, two tiles of 32
    rows at H 512, T 400 and 200: 6 forward launches a batch and 6
    backward a step) and ``jca_large_8gpus.py`` (fp32, 16 convs up to 768
    channels, then CTC on B1a and B1b at B 64, T' 401, L 241, V 30: one
    B1a and one B1b launch a step, one B1a an eval batch) at batches of
    64 from wav files. ``ctc_cuda.check_fits`` at JCA's shape first. Both
    train, then ``start_toy()`` starts the LAS toy's process (7zzb), which
    trains on its own while both models evaluate and infer. Returns the
    launches and the toy's process."""
    import torch
    from openseq2seq_tpu_torch.ops import ctc_cuda
    dev = torch.device("cuda")
    for L in (240, 241):
        ctc_cuda.check_fits(L, 30, dev, backward=False)
        ctc_cuda.check_fits(L, 30, dev, backward=True)
        print("[las] ctc_cuda.check_fits({}, 30): fits, forward and "
              "backward; resources {}".format(L, ctc_cuda.ctc_resources(
                  L, 30)), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        data = _las_corpus(tmp)
        os.environ["LIBRISPEECH_DIR"] = data
        models = (("LAS", LAS_LIBRI, (6, 6, 0, 0)),
                  ("JCA", JCA_LIBRI, (0, 0, 1, 1)))
        trained = [_train_full_width(name, path, tmp, per_step, card)
                   for name, path, per_step in models]
        toy = start_toy()
        total = [0, 0, 0, 0]
        for (name, _, per_step), (argv, got) in zip(models, trained):
            got = [a + b for a, b in zip(got, _eval_infer_full_width(
                name, argv, data, tmp, per_step))]
            total = [a + b for a, b in zip(total, got)]
    return total, toy


def start_las_toy(tmp):
    """The LAS toy (``las_toy.py``) through ``run.main --mode=train`` in a
    process of its own, its toy wavs and logs under ``tmp``; returns the
    process, its output piped."""
    env = dict(os.environ, PYTHONPATH=REPO,
               OS2S_TOY_DATA_DIR=os.path.join(tmp, "toy_speech"),
               OS2S_TOY_LOGDIR=os.path.join(tmp, "logs"))
    return subprocess.Popen(
        [sys.executable, "-m", "openseq2seq_tpu_torch.run",
         "--config_file=" + LAS_TOY, "--print_loss_steps=1", "--mode=train"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def phase_las_toy(card, proc, started):
    """7zzb: ``las_toy.py`` (the oracle's ``_las_config`` at 150 epochs
    of the 10 toy utterances; like the oracle's config it saves no
    checkpoint), run by ``proc`` (started at ``started`` on the host's
    clock, beside 7zz's evals and 7zzc): its last loss below 0.5, the bar
    of ``tests/test_las_jca.py::test_las_toy_convergence``."""
    out, _ = proc.communicate(timeout=600)
    losses = _losses(out.splitlines())
    print("[las] las_toy (its own process, beside the evals and 7zzc): rc "
          "{}, {} steps, {:.1f} s from its start; losses at steps 1, 50, "
          "100, 120, 140 and the last five: {} ({})".format(
              proc.returncode, len(losses), time.time() - started,
              [losses[i] for i in (0, 49, 99, 119, 139)
               if i < len(losses)] + losses[-5:], card), flush=True)
    check(proc.returncode == 0 and len(losses) == 150 and losses[-1] < 0.5,
          "the LAS toy: rc {}, last loss {}; {}".format(
              proc.returncode, losses[-1:], out[-2000:]))


def phase_ctc_beam(card, native_build):
    """7zzc: Jasper-10x5 (``jasper10x5_beam_librispeech.py``: "mixed",
    the on-device prefix beam 16 with the character 3-gram LM fused at
    alpha 0.5) from seeded weights in infer on 32 utterances of 10 s (B
    32, T' 504, the 1,001 frames padded to 1,008 and halved): its top
    beam's ids and lengths equal those of the CPU's beam on the same
    logits, scores within 1e-3; the beam's seconds on the card. Then the
    same model's ``infer_logits_to_pickle`` (its infer hooks), and
    ``scripts_torch/decode.py`` on the pickle with the native decoder
    (``native/ctc_decoder``, built here by its Makefile) and a word
    2-gram ARPA that ``scripts_torch/build_lm.py`` writes from the
    corpus's transcripts: a WER line and a CSV row a wav. ``native_build``
    is the future of the decoder's build."""
    import torch
    from openseq2seq_tpu_torch.models import Speech2Text
    from openseq2seq_tpu_torch.ops import ctc_beam_device, ctc_beam_native
    from openseq2seq_tpu_torch.ops.ngram_fusion import build_label_lm
    from openseq2seq_tpu_torch.test_utils import fake_librispeech
    from openseq2seq_tpu_torch.training import trainer
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "librispeech")
        fake_librispeech.generate(data, n_utts=32, duration=10.0)
        shutil.copy(os.path.join(data, "librivox-dev-clean.csv"),
                    os.path.join(data, "librivox-test-clean.csv"))
        with open(os.path.join(data, "librivox-test-clean.csv")) as f:
            texts = [r["transcript"] for r in csv.DictReader(f)]
        os.environ["LIBRISPEECH_DIR"] = data
        os.environ["CHAR_LM"] = build_label_lm(
            texts, os.path.join(tmp, "char.arpa"), order=3)
        cfg = runpy.run_path(JASPER_BEAM)
        params = copy.deepcopy(cfg["base_params"])
        from openseq2seq_tpu_torch.utils.params import nested_update
        nested_update(params, copy.deepcopy(cfg["infer_params"]))
        params["decoder_params"].update(use_language_model=True,
                                        infer_logits_to_pickle=True)
        model = Speech2Text(params, mode="infer", device="cuda")
        state = trainer.restore_state(model)
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        _reset_scan_ctc_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out = model.eval_step(state, batch)["outputs"]["decoder_output"]
        torch.cuda.synchronize()
        step_s = time.time() - t0
        logits, lengths = out["logits"], out["src_length"]
        dec = state.module.dec
        fusion = dec.fusion._replace(table=dec.fusion_table)
        torch.cuda.synchronize()
        t0 = time.time()
        ctc_beam_device.ctc_beam_search_device(logits, lengths, 16,
                                               fusion=fusion)
        torch.cuda.synchronize()
        beam_s = time.time() - t0
        t0 = time.time()
        cpu = ctc_beam_device.ctc_beam_search_device(
            logits.cpu(), lengths.cpu(), 16,
            fusion=fusion._replace(table=fusion.table.cpu()))
        cpu_s = time.time() - t0
        ids, lens = out["outputs"]
        same = bool(torch.equal(ids.cpu(), cpu[0][:, 0]) and
                    torch.equal(lens.cpu(), cpu[1][:, 0]))
        err = float((out["beam_scores"].cpu() - cpu[2]).abs().max())
        print("[beam] Jasper-10x5 infer, B {} x T' {}, on-device beam 16 "
              "with the character 3-gram fused: the step {:.3f} s, the "
              "beam alone {:.3f} s on the card, {:.3f} s on the CPU (the "
              "same logits); top beams' ids and lengths equal: {}; beam "
              "scores max abs diff {:.3e}; the first {!r}; launches {} "
              "({})".format(logits.shape[0], logits.shape[1], step_s,
                            beam_s, cpu_s, same, err,
                            model.get_data_layer().decode_ids(
                                ids[0, :int(lens[0])].cpu()),
                            _scan_ctc_counts(), card), flush=True)
        check(logits.shape[0] == 32 and 500 <= logits.shape[1] <= 504 and
              same and err <= 1e-3, "the card's beam differs from the CPU's")

        pkl = os.path.join(tmp, "logits.pkl")
        model.finalize_inference([model.infer(batch, trainer.to_host(
            {"outputs": {"decoder_output": out}}))], pkl)
        import pickle
        with open(pkl, "rb") as f:
            dumped = pickle.load(f)
        corpus = os.path.join(tmp, "corpus.txt")
        with open(corpus, "w") as f:
            f.write("\n".join(texts) + "\n")
        arpa = os.path.join(tmp, "lm.arpa")
        scripts = os.path.join(REPO, "scripts_torch")
        built = subprocess.run(
            [sys.executable, os.path.join(scripts, "build_lm.py"),
             "--corpus", corpus, "--out", arpa, "--order", "2"],
            capture_output=True, text=True)
        check(built.returncode == 0, "build_lm.py: " + built.stderr[-500:])
        check(native_build.result() and ctc_beam_native.available(),
              "the native decoder did not build")
        result = os.path.join(tmp, "decoded.csv")
        t0 = time.time()
        decoded = subprocess.run(
            [sys.executable, os.path.join(scripts, "decode.py"),
             "--logits", pkl, "--labels",
             os.path.join(data, "librivox-test-clean.csv"), "--vocab",
             os.path.join(data, "vocab.txt"), "--lm", arpa,
             "--beam_width", "64", "--infer_output_file", result],
            capture_output=True, text=True)
        rows = _infer_rows(result) if os.path.exists(result) else []
        print("[beam] infer_logits_to_pickle: {} wavs, logits {}; "
              "build_lm.py: {}; decode.py (native decoder, beam 64) in "
              "{:.1f} s: {}; {} CSV rows".format(
                  len(dumped), next(iter(dumped.values())).shape,
                  built.stdout.strip(), time.time() - t0,
                  decoded.stdout.strip().splitlines()[-1:], len(rows)),
              flush=True)
        check(decoded.returncode == 0 and len(rows) == 32 and
              len(dumped) == 32, "decode.py: " + decoded.stderr[-500:])


def group_las(card, launches):
    """Phases 7zy to 7zzc: LAS and JCA, the LAS toy, the CTC beams. The
    native CTC decoder (``native/ctc_decoder``, a C++ build of about 15 s)
    builds on the host meanwhile, for 7zzc; the LAS toy trains in a
    process of its own while LAS and JCA evaluate and infer and 7zzc
    runs (the card's and the host's time shared)."""
    from openseq2seq_tpu_torch.ops import ctc_beam_native
    toy = []

    def start_toy():
        toy.append((start_las_toy(tmp), time.time()))
        return toy[0][0]
    with ThreadPoolExecutor(1) as pool, \
            tempfile.TemporaryDirectory() as tmp:
        native = pool.submit(ctc_beam_native.build)
        try:
            timed(phase_small_las)
            got, _ = timed(phase_las_jca, card, start_toy)
            timed(phase_ctc_beam, card, native)
            timed(phase_las_toy, card, *toy[0])
        finally:
            for proc, _ in toy:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for name, n in zip(("lstm_scan_fwd", "lstm_scan_bwd", "ctc_alpha_fwd",
                        "ctc_beta_bwd"), got):
        launches[name] += n


QUARTZNET_LIBRI = _s2t("quartznet15x5_librispeech.py")
QUARTZNET_SYN = _s2t("quartznet15x5_synthetic.py")
QUARTZNET_TINY = _s2t("quartznet_tiny_synthetic.py")
JASPER_MINI = _s2t("jasper_mini.py")
W2L_TOY_ONDEVICE = _s2t("w2lplus_toy_ondevice.py")
GATEDCONV_TOY = _s2t("gatedconv_toy.py")
QUARTZNET_PARAMS = 19257757
# the full-width QuartzNet and Jasper runs' steps, the last 3 traced and
# utt/s read over steps 7 to QN_STEPS - 3
QN_STEPS = 14
# the recipe's cosine decay with its 1,000-step warmup cut to 20 steps,
# so that a few steps train
QUARTZNET_LR = {"learning_rate": 0.01, "min_lr": 0.0, "warmup_steps": 20,
                "decay_steps": 400 * 2200}


def _ctc_counts():
    from openseq2seq_tpu_torch.ops import ctc_cuda
    return ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES


def _reset_ctc_counts():
    from openseq2seq_tpu_torch.ops import ctc_cuda
    ctc_cuda.LAUNCHES = ctc_cuda.BWD_LAUNCHES = 0


def _asr_corpus(root):
    """128 utterances of 16.0 s (under QuartzNet's ``max_duration`` of
    16.7) with 240-character transcripts (LibriSpeech's about 15
    characters a second), the dev list copied as the test list."""
    from openseq2seq_tpu_torch.test_utils import fake_librispeech
    data = os.path.join(root, "librispeech")
    t0 = time.time()
    fake_librispeech.generate(data, n_utts=128, duration=16.0,
                              transcript_chars=240)
    shutil.copy(os.path.join(data, "librivox-dev-clean.csv"),
                os.path.join(data, "librivox-test-clean.csv"))
    print("[asr] a LibriSpeech-shaped corpus of 128 utterances of 16.0 s "
          "(240-character transcripts) written in {:.1f} s".format(
              time.time() - t0), flush=True)
    return data


def _train_traced(tag, cut, logdir, steps, window, per_step, frames, card,
                  batch=32):
    """``cut`` through ``run.main --mode=train`` for ``steps`` steps of
    ``batch`` utterances, the last ``window`` traced: the loss finite and
    falling, ``per_step`` (B1a, B1b) launches a step, utt/s from the
    host's clock over the steps after the sixth and before the traced
    ones (the profiler's start, which sets up its tracing, is not a
    step's time), the card's idle share over the window, the peak of
    allocated memory. Returns (argv, utt/s, idle share)."""
    import torch
    argv = ["--config_file=" + cut, "--logdir=" + logdir]
    _reset_ctc_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _traced_last_steps(steps, window) as traced:
        result, lines = _run_quiet(argv + ["--mode=train"])
    got = _ctc_counts()
    losses = _losses(lines)
    ends = traced["ends"]
    untraced = steps - window
    utt_s = batch * (untraced - 6) / (ends[untraced - 1] - ends[5])
    busy, span = traced["trace"][0] if traced["trace"] else (0.0, 1.0)
    print("[asr] {}: {} steps of {} utterances ({} frames a row): losses "
          "{}; {:.2f} utt/s over steps 7-{} (host clock, a synchronize a "
          "step); {:.1f} s in all, to the end of step 1 {:.1f} s; the last "
          "{} steps traced: the card busy {:.3f} ms of a {:.3f} ms span, "
          "idle share {:.2%}; peak {:.2f} GiB; B1a, B1b launches {} ({} a "
          "step) ({})".format(
              tag, result["steps"], batch, frames,
              [round(x, 3) for x in losses], utt_s, untraced,
              time.perf_counter() - t0, ends[0] - t0, window, busy, span,
              1 - busy / span, _peak_gib(), got,
              tuple(n / steps for n in got), card), flush=True)
    check(result["steps"] == steps and len(losses) == steps and
          all(math.isfinite(x) for x in losses) and
          sum(losses[-3:]) < sum(losses[:3]),
          "{}: losses {}".format(tag, losses))
    check(got == tuple(steps * n for n in per_step),
          "{}: launches {} in {} steps, want {} a step".format(
              tag, got, steps, per_step))
    check(len(traced["trace"]) == 1, "{}: the window was not traced"
          .format(tag))
    return argv, utt_s, 1 - busy / span


def phase_small_quartznet():
    """7zzd: the tiny QuartzNet twin (``quartznet_tiny_synthetic.py``:
    separable blocks, NovoGrad and cosine decay, ``use_pallas``) on the
    card against the CPU, fp32: eval logits and loss, two train steps'
    losses and weights (B1a/B1b on the card, their plain versions on the
    CPU), the conv biases before a batch norm frozen."""
    from openseq2seq_tpu_torch.models import Speech2Text
    # the biases of the convs before a batch norm are frozen, as in the
    # CPU tests (tests/test_torch_quartznet.py): the norm removes them,
    # so their gradient is rounding noise that NovoGrad's per-tensor
    # normalization scales to a full update
    params = dict(runpy.run_path(QUARTZNET_TINY)["base_params"],
                  freeze_variables_regex=r"/(conv|res)\d+_\d+(_dw|_pw)?"
                                         r"/bias$")
    _model_card_vs_cpu("quartznet_tiny_synthetic", Speech2Text, params,
                       ("logits",), train_steps=2)


def phase_quartznet(card, data):
    """7zze: QuartzNet-15x5 at full width ("mixed", NovoGrad, cosine
    decay with the warmup cut to 20 steps, ``use_pallas``):
    ``ctc_cuda.check_fits`` at its L 240; the
    synthetic config (``quartznet15x5_synthetic.py``: B 32, 1,670 frames,
    T' 835, L 240) for QN_STEPS (14) steps (one B1a and one B1b launch
    a step, the last 3 traced) and an eval of its 4 batches (one B1a
    each); then the
    LibriSpeech recipe (``quartznet15x5_librispeech.py``) from the 16 s
    wavs of ``data``: QN_STEPS steps of 32 utterances, the train list's
    features cached (the first epoch cold, the later ones warm; the
    recipe's dither is drawn once, SpecAugment's masks each epoch), and
    an eval over the 64 dev utterances from its checkpoint. Returns the
    launches."""
    import torch
    from openseq2seq_tpu_torch.models import Speech2Text
    from openseq2seq_tpu_torch.ops import ctc_cuda
    dev = torch.device("cuda")
    for backward in (False, True):
        ctc_cuda.check_fits(240, 29, dev, backward=backward)
    total = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        logdir = os.path.join(tmp, "synthetic")
        os.makedirs(logdir)
        cut = _recipe_config(QUARTZNET_SYN, logdir, QN_STEPS,
                             print_loss_steps=1,
                             save_checkpoint_steps=QN_STEPS,
                             lr_policy_params=QUARTZNET_LR)
        argv, syn_utt_s, _ = _train_traced(
            "QuartzNet-15x5 synthetic", cut, logdir, QN_STEPS, 3, (1, 1),
            1670, card)
        total = [a + b for a, b in zip(total, _ctc_counts())]
        model = Speech2Text(runpy.run_path(QUARTZNET_SYN)["base_params"],
                            mode="eval", device="cpu")
        n_params = sum(p.numel() for p in model.init_state(
            next(iter(model.get_data_layer().iterate_one_epoch())))
            .module.parameters())
        _reset_ctc_counts()
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        got = _ctc_counts()
        total = [a + b for a, b in zip(total, got)]
        print("[asr] QuartzNet-15x5 synthetic: {:,} parameters; eval of its "
              "4 batches from the step-{} checkpoint: loss {:.4f}, {}; "
              "launches {}".format(n_params, QN_STEPS, metrics["eval_loss"],
                                   [x.strip() for x in lines
                                    if "Validation WER" in x], got),
              flush=True)
        check(n_params == QUARTZNET_PARAMS and
              math.isfinite(metrics["eval_loss"]) and got == (4, 0),
              "QuartzNet eval: {} parameters, launches {}".format(
                  n_params, got))

        logdir = os.path.join(tmp, "wavs")
        os.makedirs(logdir)
        cut = _cached_recipe(QUARTZNET_LIBRI, logdir, QN_STEPS,
                             os.path.join(tmp, "feature_cache"),
                             print_loss_steps=1,
                             save_checkpoint_steps=QN_STEPS,
                             lr_policy_params=QUARTZNET_LR)
        argv, wav_utt_s, _ = _train_traced(
            "QuartzNet-15x5 from 16 s wavs", cut, logdir, QN_STEPS, 3,
            (1, 1), 1601, card)
        total = [a + b for a, b in zip(total, _ctc_counts())]
        _reset_ctc_counts()
        metrics, lines = _run_quiet(argv + ["--mode=eval"])
        got = _ctc_counts()
        total = [a + b for a, b in zip(total, got)]
        wer = [x.strip() for x in lines if "Validation WER" in x]
        print("[asr] QuartzNet-15x5 from wavs: {:.2f} utt/s against {:.2f} "
              "synthetic at 16.7 s; eval over the 64 dev utterances from "
              "the step-{} checkpoint: {}, loss {:.4f}; launches {} ({})"
              .format(wav_utt_s, syn_utt_s, QN_STEPS, wer,
                      metrics["eval_loss"], got, card), flush=True)
        check(wer and math.isfinite(metrics["eval_loss"]) and got == (2, 0),
              "QuartzNet eval from wavs: launches {}".format(got))
    return total


def phase_jasper_mini(card, data):
    """7zzf: ``jasper_mini.py`` (12 separable blocks up to 512 channels,
    "mixed", dropout on; its CTC loss without ``use_pallas``, so the plain
    CTC and no kernel) for 5 steps from the wavs of ``data``: the loss
    finite, no CTC kernel launched."""
    with tempfile.TemporaryDirectory() as tmp:
        cut = _recipe_config(JASPER_MINI, tmp, 5, print_loss_steps=1)
        _reset_ctc_counts()
        t0 = time.time()
        result, lines = _run_quiet(["--config_file=" + cut,
                                    "--logdir=" + tmp, "--mode=train"])
        got = _ctc_counts()
        losses = _losses(lines)
        print("[asr] jasper_mini: {} steps of 32 utterances in {:.1f} s "
              "(with the build and the cold featurization): losses {}; CTC "
              "kernel launches {} (its loss sets no use_pallas) ({})".format(
                  result["steps"], time.time() - t0,
                  [round(x, 3) for x in losses], got, card), flush=True)
        check(result["steps"] == 5 and len(losses) == 5 and
              all(math.isfinite(x) for x in losses) and got == (0, 0),
              "jasper_mini: losses {}, launches {}".format(losses, got))


def phase_ondevice_jasper(card, data):
    """7zzg: Jasper-10x5's LibriSpeech recipe from the 16 s wavs of
    ``data``, QN_STEPS (14) steps of 32 utterances, the features computed
    on the card inside the forward (``featurize_on_device``: raw audio shipped,
    ``ops/features_device.logmel_features``), then the same recipe
    featurized on the host, in the same process. The recipe's SpecAugment
    masks are dropped in both runs, since the JAX layer refuses them with
    ``featurize_on_device``, and the feature cache is off in both, so
    that each step featurizes its batch. utt/s over steps 7-11 and the
    idle share of the last 3: information only. Returns the launches."""
    total = [0, 0]
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, on_device in (("on the card", True), ("on the host",
                                                        False)):
            logdir = os.path.join(tmp, "dev" if on_device else "host")
            os.makedirs(logdir)
            dlp = dict(runpy.run_path(LIBRI_CONFIG)["base_params"][
                "data_layer_params"], augmentation={}, cache_features=False,
                featurize_on_device=on_device)
            cut = _recipe_config(LIBRI_CONFIG, logdir, QN_STEPS,
                                 print_loss_steps=1, data_layer_params=dlp)
            _, rates[name], idle = _train_traced(
                "Jasper-10x5 from wavs, features " + name, cut, logdir,
                QN_STEPS, 3, (1, 1), 1601, card)
            rates[name] = (rates[name], idle)
            total = [a + b for a, b in zip(total, _ctc_counts())]
    print("[asr] Jasper-10x5 from 16 s wavs without SpecAugment, feature "
          "cache off: features on the card {:.2f} utt/s, idle {:.2%}; on "
          "the host {:.2f} utt/s, idle {:.2%} (information only; {} CPU "
          "cores; {})".format(*rates["on the card"], *rates["on the host"],
                              os.cpu_count(), card), flush=True)
    return total


def phase_ondevice_toy(card):
    """7zzh: ``w2lplus_toy_ondevice.py`` (the w2lplus toy from raw-audio
    batches, featurized on the card) through ``run.main
    --mode=train_eval`` for 75 of its 150 epochs, as 7s cuts the w2lplus
    toy (its validation at step 75 read 0.0000 in the full runs too):
    its last validation reads WER 0.0000."""
    with tempfile.TemporaryDirectory() as tmp:
        _toy_env(tmp)
        t0 = time.time()
        result, lines = _run_quiet(["--config_file=" + W2L_TOY_ONDEVICE,
                                    "--mode=train_eval", "--num_epochs=75"])
        wer = [x.strip() for x in lines if "Validation WER" in x]
        print("[asr] w2lplus_toy_ondevice --mode=train_eval: {} steps in "
              "{:.1f} s, losses at the printed steps {}; validations {} ({})"
              .format(result["steps"], time.time() - t0,
                      [round(x, 4) for x in _losses(lines)], wer, card),
              flush=True)
        check(wer and wer[-1].endswith("Validation WER: 0.0000"),
              "the on-device toy did not reach WER 0")


def _stream_wav(asr, path, beam):
    """``path`` streamed through ``asr`` frame by frame, comfort noise
    after its end; the transcript as the demo collects it."""
    from scipy.io import wavfile
    import numpy as np
    _, signal = wavfile.read(path)
    signal = signal.astype(np.float32) / 32767.0
    n = asr.n_frame_len
    pad = (-len(signal)) % n
    signal = np.concatenate([signal, (np.random.RandomState(7).randn(pad)
                                      * 1e-3).astype(np.float32)])
    text = ""
    for i in range(0, len(signal), n):
        piece = asr.transcribe(signal[i:i + n])
        text = (piece or text) if beam else text + piece
    tail = asr.flush()
    return (tail or text) if beam else text + tail


# the streaming toy's seeds: the JAX test's recipe passes its bar (each
# decoder within 3 edits of "abc bca") at some seeds only, in the JAX
# package (5 of seeds 0-7 on the CPU) and in the port (4 of seeds 0-9 on
# the CPU; PERF.md, PR 24), so one seed would fail this check about half
# the time: the phase trains the recipe at each of these seeds, in
# STREAM_TOY_WORKERS processes at a time (each run is host-bound)
STREAM_TOY_SEEDS = tuple(range(6))
STREAM_TOY_WORKERS = 3
STREAM_TOY_DECODERS = (
    ("greedy", {}), ("host beam 8", {"beam_width": 8}),
    ("device beam 8", {"beam_width": 8, "on_device_beam": True,
                       "max_transcript_len": 64}))


def _stream_toy_seed(seed, csv_path, vocab, mean, std, tmp):
    """The streaming toy at ``seed``: the recipe trained on the card, then
    each of ``STREAM_TOY_DECODERS`` over toy_0.wav. Returns (seconds to
    train, steps, last loss, [(text, edits, word timestamps)])."""
    from openseq2seq_tpu_torch.apps.frame_asr import FrameASR
    from openseq2seq_tpu_torch.models import Speech2Text
    from openseq2seq_tpu_torch.test_utils.test_speech_configs import \
        w2l_test_config
    from openseq2seq_tpu_torch.training import trainer
    from openseq2seq_tpu_torch.utils.metrics import levenshtein
    logdir = os.path.join(tmp, "logs{}".format(seed))

    def params():
        p, _ = w2l_test_config(csv_path, vocab, logdir=logdir,
                               num_epochs=150)
        p["data_layer_params"].update(
            features_mean=mean, features_std_dev=std, cache_features=True,
            cache_format=os.path.join(tmp, "cache{}".format(seed)))
        p.update(save_checkpoint_steps=150, print_loss_steps=150,
                 random_seed=seed)
        return p
    t0 = time.time()
    result, lines = _run_quiet_fn(
        lambda: trainer.train(Speech2Text(params(), mode="train")))
    seconds = time.time() - t0
    ckpt = os.path.join(logdir, "checkpoints", "150")
    check(os.path.isdir(ckpt), "no checkpoint at step 150")
    texts = []
    for _, kw in STREAM_TOY_DECODERS:
        asr = FrameASR(Speech2Text(params(), mode="interactive_infer"),
                       checkpoint=ckpt, frame_len=0.2, frame_overlap=0.4,
                       timestep_duration=0.01, **kw)
        text = _stream_wav(asr, os.path.join(os.path.dirname(csv_path),
                                             "toy_0.wav"), bool(kw))
        texts.append((text, levenshtein(list("abc bca"),
                                        list(text.strip())),
                      asr.get_word_timestamps()))
    return seconds, result["steps"], _losses(lines)[-1:], texts


def phase_streaming_toy(card):
    """7zzi: the recipe of ``tests/test_asr_inference_stack.py``: the w2l
    test config with feature statistics of the toy corpus, 150 epochs on
    the card (the features cached, which leaves them as they are: the
    recipe draws no dither and no augmentation), then ``FrameASR`` (0.2
    s frames, 0.4 s of overlap) over toy_0.wav with the greedy merge, the
    host beam 8 and the device beam 8 carried across chunks, at each of
    ``STREAM_TOY_SEEDS``, a process a seed: each decoder within 3 edits
    of "abc bca" at one seed at least, and the two beams' transcripts
    equal at every seed (both prefix beams, no LM, over the same logits;
    their word timestamps differ by design, as in the JAX package)."""
    import multiprocessing as mp
    import numpy as np
    from openseq2seq_tpu_torch.ops.features import \
        get_speech_features_from_file
    from openseq2seq_tpu_torch.test_utils import toy_speech
    from openseq2seq_tpu_torch.test_utils.test_speech_configs import \
        w2l_test_config
    passed = {name: 0 for name, _ in STREAM_TOY_DECODERS}
    with tempfile.TemporaryDirectory() as tmp:
        csv_path, vocab = toy_speech.generate(os.path.join(tmp, "data"))
        stats = w2l_test_config(csv_path, vocab)[0]["data_layer_params"]
        feats = np.concatenate([get_speech_features_from_file(
            os.path.join(tmp, "data", "toy_{}.wav".format(i)),
            dict(stats, features_mean=0.0, features_std_dev=1.0))[0]
            for i in range(10)])
        mean, std = feats.mean(axis=0), feats.std(axis=0) + 1e-6
        t0 = time.time()
        with ProcessPoolExecutor(STREAM_TOY_WORKERS,
                                 mp_context=mp.get_context("spawn")) as pool:
            runs = [pool.submit(_stream_toy_seed, seed, csv_path, vocab,
                                mean, std, tmp)
                    for seed in STREAM_TOY_SEEDS]
            for seed, run in zip(STREAM_TOY_SEEDS, runs):
                seconds, steps, loss, texts = run.result()
                print("[asr] streaming toy, seed {}: {} steps in {:.1f} s, "
                      "last loss {}; FrameASR over toy_0.wav (\"abc "
                      "bca\"): {} ({})".format(
                          seed, steps, seconds, loss, "; ".join(
                              "{} {!r} {} edits, words {}".format(name, *t)
                              for (name, _), t in zip(STREAM_TOY_DECODERS,
                                                      texts)), card),
                      flush=True)
                for (name, _), t in zip(STREAM_TOY_DECODERS, texts):
                    passed[name] += t[1] <= 3
                check(texts[1][0] == texts[2][0], "seed {}: the host and "
                      "device beams differ".format(seed))
    print("[asr] streaming toy: within 3 edits at {} of seeds {}, {} "
          "processes at a time, in {:.1f} s".format(
              passed, list(STREAM_TOY_SEEDS), STREAM_TOY_WORKERS,
              time.time() - t0), flush=True)
    check(all(passed.values()), "a streaming decoder missed the bar at "
          "every seed: {}".format(passed))


def phase_streaming_full(card, data):
    """7zzj: streaming at full width on random weights, the recipes'
    models built in ``interactive_infer`` (SpecAugment off): ``FrameASR``
    over Jasper-10x5 (0.2 s frames, 2.4 s of overlap: a 5.0 s buffer,
    0.02 s a logit frame) with the greedy merge and with the device beam
    16, and ``TransducerFrameASR`` over the Conformer-Transducer
    LibriSpeech recipe (flash and fused on: B5 and B6 forward 16 times a
    window at B 1, T' 128 with 126 valid, the kernel group's
    ``STREAMING_SHAPE``; 0.04 s a frame), each over 8 s of a 16 s wav of
    ``data`` with the energy gate off: ms a 0.2 s frame after 5 warm
    ones (the host's clock; each call reads its result on the host), the
    real-time factor (ms / 200), the encoder's output shape, the launches
    a window. Returns the B5 and B6 forward launches."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    from openseq2seq_tpu_torch.apps.frame_asr import (FrameASR,
                                                      TransducerFrameASR)
    with open(os.path.join(data, "librivox-dev-clean.csv")) as f:
        wav = next(csv.DictReader(f))["wav_filename"]
    _, signal = wavfile.read(wav)
    signal = signal.astype(np.float32) / 32767.0
    n = int(0.2 * 16000)
    frames = [signal[i:i + n] for i in range(0, 8 * 16000, n)]
    warm = 5
    launches = [0, 0]
    for name, path, cls, kw in (
            ("Jasper-10x5 greedy", LIBRI_CONFIG, FrameASR,
             {"timestep_duration": 0.02}),
            ("Jasper-10x5 device beam 16", LIBRI_CONFIG, FrameASR,
             {"timestep_duration": 0.02, "beam_width": 16,
              "on_device_beam": True}),
            ("Conformer-Transducer", TRANSDUCER_LIBRI, TransducerFrameASR,
             {"timestep_duration": 0.04})):
        c = runpy.run_path(path)
        params = dict(c["base_params"])
        params["data_layer_params"] = dict(params["data_layer_params"],
                                           augmentation={})
        model = c["base_model"](params, mode="interactive_infer")
        asr = cls(model, silence_threshold=0.0, **kw)
        shapes = []
        hook = asr.state.module.enc.register_forward_hook(
            lambda mod, args, out: shapes.append(
                (tuple(out["outputs"].shape), out["src_length"].tolist())))
        for f in frames[:warm]:
            asr.transcribe(f)
        hook.remove()
        _reset_conformer_counts()
        _reset_ctc_counts()
        ms = _time_stream(asr, frames, 0)
        counts, ctc_counts = _conformer_counts(), _ctc_counts()
        windows = len(frames)
        print("[asr] {} streaming at full width: {:.2f} ms a 0.2 s frame "
              "(real-time factor {:.4f}) over {} frames after {} warm; the "
              "encoder's output {} (valid {}), {} central frames a window; "
              "launches a window: B5 fwd {}, B6 fwd {}, B1a {}; transcript "
              "so far {!r} ({})".format(
                  name, ms, ms / 200.0, windows, warm, shapes[0][0],
                  shapes[0][1], asr.n_timesteps_frame,
                  counts[0] / windows, counts[3] / windows,
                  ctc_counts[0] / windows, asr.text[:40], card), flush=True)
        if cls is TransducerFrameASR:
            check(shapes[0] == ((1, 128, 256), [126]),
                  "the streaming window is not the kernel group's shape")
            check(counts == (16 * windows, 0, 0, 16 * windows, 0),
                  "transducer streaming launches {} in {} windows".format(
                      counts, windows))
            launches = [counts[0], counts[3]]
        else:
            check(counts == (0, 0, 0, 0, 0) and ctc_counts == (0, 0),
                  "Jasper streaming launched a kernel")
        del asr, model
        torch.cuda.empty_cache()
    return launches


def _time_stream(asr, frames, warm):
    """ms a ``transcribe`` call over ``frames[warm:]``."""
    t0 = time.perf_counter()
    for f in frames[warm:]:
        asr.transcribe(f)
    return 1e3 * (time.perf_counter() - t0) / (len(frames) - warm)


def phase_gatedconv_toy(card):
    """7zzk: ``gatedconv_toy.py`` (the walkthrough's GatedConvEncoder on
    the toy corpus, 60 epochs) through ``run.main --mode=train_eval``,
    then eval from its checkpoint: an eval loss below 1.0, the bar of
    ``tests/test_extending_tutorial.py``."""
    with tempfile.TemporaryDirectory() as tmp:
        _toy_env(tmp)
        t0 = time.time()
        result, lines = _run_quiet(["--config_file=" + GATEDCONV_TOY,
                                    "--mode=train_eval"])
        metrics, _ = _run_quiet(["--config_file=" + GATEDCONV_TOY,
                                 "--mode=eval"])
        print("[asr] gatedconv_toy: {} steps in {:.1f} s, losses at the "
              "printed steps {}; eval from the checkpoint: loss {:.4f}, WER "
              "{:.4f} ({})".format(result["steps"], time.time() - t0,
                                   [round(x, 4) for x in _losses(lines)],
                                   metrics["eval_loss"], metrics["Eval WER"],
                                   card), flush=True)
        check(metrics["eval_loss"] < 1.0, "the GatedConv toy's eval loss {}"
              .format(metrics["eval_loss"]))


def group_asr_stack(card, launches):
    """Phases 7zzd to 7zzk: the ASR inference stack. QuartzNet-15x5 and
    Jasper-Mini (separable TDNN blocks), features on the card, the
    on-device toy, streaming over a trained toy and at full width, the
    GatedConv toy."""
    timed(phase_small_quartznet)
    with tempfile.TemporaryDirectory() as tmp:
        data = _asr_corpus(tmp)
        os.environ["LIBRISPEECH_DIR"] = data
        qn = timed(phase_quartznet, card, data)
        timed(phase_jasper_mini, card, data)
        jasper = timed(phase_ondevice_jasper, card, data)
        timed(phase_ondevice_toy, card)
        timed(phase_streaming_toy, card)
        relpos, conv = timed(phase_streaming_full, card, data)
        timed(phase_gatedconv_toy, card)
    launches["ctc_alpha_fwd"] += qn[0] + jasper[0]
    launches["ctc_beta_bwd"] += qn[1] + jasper[1]
    launches["flash_relpos_fwd"] += relpos
    launches["conformer_conv_fwd"] += conv


SERVING = os.path.join(REPO, "example_configs_torch", "text2text",
                       "transformer_base_serving_synthetic.py")
# the JAX model's count by jax.eval_shape of its init
# (tests/test_torch_serving.py::test_serving_config_parameter_count)
SERVING_PARAMS = 60917760
SERVING_LAYERS = 72
SERVING_STEPS = 20
# the JAX tests' bars (tests/test_serving_export.py:63-69, :125-127): an
# int8 weight-only forward within 0.15 of fp and agreeing on over 98% of
# the argmaxes; int8 activations within 0.35 std and over 97%
INT8_W_MAX, INT8_W_AGREE = 0.15, 0.98
INT8_ACT_STD, INT8_ACT_AGREE = 0.35, 0.97
# the beam artifact's frames after the encoder's stride 2: its export
# unrolls the beam over them, about 200 nodes a frame (on the host of an
# H100 80GB HBM3: 52.1 s to export and 31.3 s to load at 64 frames, 330.8
# s and 199.3 s at the full 500)
SERVING_BEAM_FRAMES = 32
# int8 products against bf16 torch.mm at the scoring step's shapes:
# (M, K, N) of qkv, out/q/k/v, the FFN's filter and output layers
INT8_MM_SHAPES = ((4096, 512, 1536), (4096, 512, 512), (4096, 512, 2048),
                  (4096, 2048, 512))
INT8_TOP_PER_S = 1979e12

def _bench_serving():
    """``scripts_torch/bench_serving.py``, whose helpers phase 7zzl
    measures with (the calibration slice, the rate, the artifacts' export
    and their fresh interpreter)."""
    scripts = os.path.join(REPO, "scripts_torch")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import bench_serving
    return bench_serving


def _agreement(got, want):
    """(argmax agreement, max |got - want|) of two logits arrays."""
    import numpy as np
    return (float(np.mean(got.argmax(-1) == want.argmax(-1))),
            float(np.max(np.abs(got - want))))


def phase_int8_products(card):
    """The int8 products (``serving/int8_exec.int_mm``: ``torch._int_mm``)
    against bf16 ``torch.mm`` at the scoring step's shapes, CUDA events
    back to back, each against its bound (operands read once, the product
    written once; 2 M K N operations at the int8 or bf16 peak); the int8
    sums bit for bit the float64 ones. Returns the times by shape."""
    import torch
    from openseq2seq_tpu_torch.serving import int8_exec
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    times = {}
    for M, K, N in INT8_MM_SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        exact = torch.equal(int8_exec.int_mm(a, b).double(),
                            a.double() @ b.double().t())
        check(exact, "int8 product at {} differs from its exact sums".format(
            (M, K, N)))
        ab, bb = a.bfloat16(), b.bfloat16().t()
        t = {"int8_ms": cuda_ms(lambda: int8_exec.int_mm(a, b), 50),
             "bf16_ms": cuda_ms(lambda: torch.mm(ab, bb), 50)}
        t["int8_bound_ms"] = 1e3 * max((M * K + K * N + 4 * M * N) /
                                       HBM_BYTES_PER_S,
                                       2.0 * M * K * N / INT8_TOP_PER_S)
        t["bf16_bound_ms"] = bound_ms(2 * (M * K + K * N + M * N),
                                      2.0 * M * K * N, torch.bfloat16)[0]
        times["{}x{}x{}".format(M, K, N)] = t
        print("[serving] int8 product M={} K={} N={}: {:.4f} ms (bound "
              "{:.4f}), bf16 torch.mm {:.4f} ms (bound {:.4f}); the int8 "
              "sums exact (CUDA events, back to back; {})".format(
                  M, K, N, t["int8_ms"], t["int8_bound_ms"], t["bf16_ms"],
                  t["bf16_bound_ms"], card), flush=True)
    return times


def phase_serving_transformer(card):
    """7zzl: transformer-base scoring at bench_serving.py's width
    (``transformer_base_serving_synthetic.py``, B 64, T 64, V 32768,
    "mixed", teacher-forced with ``train=True`` and every dropout rate 0),
    served four ways, measured with ``scripts_torch/bench_serving.py``'s
    helpers: eagerly (exactly 18 B7 forward launches a batch, tokens/s as
    the JAX bench counts them, B x 2 x T), from the fp artifact reloaded
    in a fresh interpreter that imports only ``openseq2seq_tpu_torch.
    serving`` (18 launches a batch and no ``_int_mm`` node; logits within
    1e-5 of eager, relative to their largest), from the int8 weight-only
    artifact (its size against the fp one's; the JAX test's bars against
    fp, within 1e-4 of the dequantized weights' eager forward; no
    ``_int_mm`` node) and with int8 activations, live and from an artifact
    (72 calibrated layers on 2 sentences, as the JAX bench calibrates; 72
    int8 products a live batch and 72 ``_int_mm`` nodes in the artifact;
    the artifact within 1e-5 of the live int8 path on the dequantized
    weights; argmax agreement >= 0.97 and max |d| < 0.35 std of the fp
    logits, which they must not equal; every layer's int8 output bit for
    bit its float64 plain version on its own input, and a planted fault,
    one layer's x_scale doubled, refused). Also the scoring step's idle
    share. Returns the B7 launches."""
    from types import SimpleNamespace

    import numpy as np
    import torch
    from openseq2seq_tpu_torch import serving
    from openseq2seq_tpu_torch.convert import state_dict_from_flax
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    from openseq2seq_tpu_torch.serving import int8_exec
    from openseq2seq_tpu_torch.serving.export import serving_batch
    bench = _bench_serving()
    config = runpy.run_path(SERVING)
    model = config["base_model"](copy.deepcopy(config["base_params"]),
                                 mode="eval", device="cuda")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    n_params = sum(p.numel() for p in state.module.parameters())
    check(n_params == SERVING_PARAMS, "{} parameters".format(n_params))
    x = batch["source_tensors"][0]
    tokens = 2 * x.size
    device_batch = serving_batch(batch, "cuda")

    def score(b):
        with torch.no_grad():
            return state.module(b, train=True)["decoder_output"]["logits"]

    fa.LAUNCHES = 0
    fp = score(device_batch)
    torch.cuda.synchronize()
    check(fa.LAUNCHES == 18, "eager scoring launched B7 {} times".format(
        fa.LAUNCHES))
    fp_np = fp.float().cpu().numpy()
    check(np.isfinite(fp_np).all() and fp_np.shape == (
        x.shape[0], x.shape[1] - 1, 32768), "fp logits {}".format(
            fp_np.shape))
    fp_rate = bench.rate(score, device_batch, tokens, SERVING_STEPS)
    kernels, busy, span = _device_profile(lambda: [
        score(device_batch) for _ in range(3)])
    print("[serving] transformer-base scoring, {} parameters, B {} x T {}, "
          "bf16: eager {:.0f} tokens/s; B7 {} launches a batch; 3 batches "
          "traced: {} kernels, busy {:.2f} of {:.2f} ms ({:.2f}% idle) ({})"
          .format(n_params, x.shape[0], x.shape[1], fp_rate, 18, kernels,
                  busy, span, 100 * (1 - busy / span), card), flush=True)

    # int8 activations, live: calibrated on 2 sentences, as the JAX bench
    ranges = serving.calibrate_dense_inputs(
        model, state, [bench.calibration_batch(batch)], train=True)
    check(len(ranges) == SERVING_LAYERS, "{} calibrated layers".format(
        len(ranges)))
    live = serving.int8_apply_fn(model, state, ranges, train=True)
    before, calls = fa.LAUNCHES, int8_exec.CALLS
    i8 = live(device_batch)["decoder_output"]["logits"].float().cpu(
        ).numpy()
    calls = int8_exec.CALLS - calls
    check(fa.LAUNCHES - before == 18, "int8 scoring launched B7 {} "
          "times".format(fa.LAUNCHES - before))
    check(calls == SERVING_LAYERS, "int8 scoring ran {} int8 products"
          .format(calls))
    check(not np.allclose(i8, fp_np, atol=1e-6), "the int8 logits are the "
          "fp ones")
    i8_rate = bench.rate(live, device_batch, tokens, SERVING_STEPS)
    agree, diff = _agreement(i8, fp_np)
    std = float(np.std(fp_np))
    print("[serving] int8 activations live: {} calibrated layers, {} int8 "
          "products a batch, {:.0f} tokens/s ({:.3f}x bf16); argmax "
          "agreement {:.4f}, max |d| {:.4f} = {:.3f} std ({})".format(
              len(ranges), calls, i8_rate, i8_rate / fp_rate, agree, diff,
              diff / std, card), flush=True)
    check(agree >= INT8_ACT_AGREE and diff < INT8_ACT_STD * std,
          "int8 activations: agreement {}, max |d| {} of std {}".format(
              agree, diff, std))

    # each layer's int8 output against its plain version on its own input
    layers = int8_exec.int8_layers(state.module)
    inputs = {}

    def keep(name):
        def hook(_, args):
            inputs.setdefault(name, args[0])
        return hook
    hooks = [m.register_forward_pre_hook(keep(n)) for n, m in layers.items()]
    live(device_batch)
    for h in hooks:
        h.remove()
    differ = 0
    with torch.no_grad():
        for name, layer in layers.items():
            got = int8_exec.int8_dense(layer, inputs[name], ranges[name])
            want = int8_exec.int8_dense_plain(layer, inputs[name],
                                              ranges[name])
            differ += int(not torch.equal(got, want))
        name = sorted(layers)[0]
        fault = int8_exec.int8_dense(layers[name], inputs[name],
                                     2 * ranges[name])
        want = int8_exec.int8_dense_plain(layers[name], inputs[name],
                                          ranges[name])
        planted = float((fault.float() - want.float()).abs().max())
    del inputs
    print("[serving] int8 layers against their float64 plain versions on "
          "their own inputs: {} of {} differ; a planted fault ({}'s x_scale "
          "doubled) moves its output by {:.4f}".format(
              differ, len(layers), name, planted), flush=True)
    check(differ == 0, "{} int8 layers differ from their plain "
          "versions".format(differ))
    check(planted > 0, "the planted int8 fault went unseen")

    with tempfile.TemporaryDirectory() as tmp:
        seconds, sizes, report = bench.export_artifacts(model, state, batch,
                                                        ranges, tmp)
        print("[serving] exported in {:.1f}, {:.1f} and {:.1f} s: fp {} "
              "bytes, int8 weights {} bytes ({:.3f} of fp; {} tensors "
              "quantized), int8 activations {} bytes".format(
                  seconds["fp"], seconds["int8w"], seconds["int8act"],
                  sizes["fp"], sizes["int8w"], sizes["int8w"] / sizes["fp"],
                  len(report), sizes["int8act"]), flush=True)
        check(sizes["int8w"] < 0.5 * sizes["fp"], "the int8 artifact is "
              "not smaller")
        fresh = bench.serve_fresh(tmp, SERVING_STEPS)
        logits = {n: np.load(os.path.join(tmp, n + ".npy"))
                  for n in bench.ARTIFACTS}
    reading = float(np.max(np.abs(logits["fp"] - fp_np)) /
                    np.max(np.abs(fp_np)))
    nodes = {n: fresh[n]["int_mm_nodes"] for n in bench.ARTIFACTS}
    print("[serving] reloaded in a fresh interpreter (model modules "
          "imported: {}): fp artifact {:.0f} tokens/s, its logits within "
          "{:.3e} of eager (relative to the largest), bit-identical: {}; "
          "B7 launches a batch: fp {}, int8 weights {}, int8 activations "
          "{}; _int_mm nodes {} ({})".format(
              fresh["model_modules"], fresh["fp"]["tokens_per_s"], reading,
              bool(np.array_equal(logits["fp"], fp_np)),
              fresh["fp"]["launches"], fresh["int8w"]["launches"],
              fresh["int8act"]["launches"], nodes, card), flush=True)
    check(fresh["model_modules"] == [], "loading imported model code")
    check(reading <= 1e-5, "fp artifact logits {} from eager".format(
        reading))
    check(all(fresh[n]["launches"] == 18 for n in bench.ARTIFACTS),
          "artifact B7 launches {}".format(fresh))
    check(nodes == {"fp": 0, "int8w": 0, "int8act": SERVING_LAYERS},
          "artifact _int_mm nodes {}".format(nodes))

    # the artifacts against the eager forward of the dequantized weights:
    # fp layers for int8 weights, the live int8 path for int8 activations
    qparams, _ = serving.quantize_params_int8(state.module)
    deq = copy.deepcopy(state.module)
    deq.load_state_dict(state_dict_from_flax(
        {"params": serving.dequantize_params(qparams)}), strict=False)
    with torch.no_grad():
        l_deq = deq(device_batch, train=True)["decoder_output"][
            "logits"].float().cpu().numpy()
    l_deq_i8 = serving.int8_apply_fn(
        model, SimpleNamespace(module=deq), ranges, train=True)(
            device_batch)["decoder_output"]["logits"].float().cpu().numpy()
    del deq
    w_agree, w_diff = _agreement(logits["int8w"], fp_np)
    w_self = float(np.max(np.abs(logits["int8w"] - l_deq)))
    a_agree, a_diff = _agreement(logits["int8act"], fp_np)
    a_self = float(np.max(np.abs(logits["int8act"] - l_deq_i8)) /
                   np.max(np.abs(l_deq_i8)))
    print("[serving] int8 weights artifact: {:.0f} tokens/s, argmax "
          "agreement {:.4f}, max |d| {:.4f} against fp, {:.3e} against the "
          "dequantized weights' eager forward; int8 activations artifact: "
          "{:.0f} tokens/s ({:.3f}x the fp artifact), within {:.3e} of the "
          "live int8 path on the dequantized weights (relative to the "
          "largest), agreement {:.4f}, max |d| {:.4f} = {:.3f} std against "
          "fp ({})".format(
              fresh["int8w"]["tokens_per_s"], w_agree, w_diff, w_self,
              fresh["int8act"]["tokens_per_s"],
              fresh["int8act"]["tokens_per_s"] / fresh["fp"]["tokens_per_s"],
              a_self, a_agree, a_diff, a_diff / std, card), flush=True)
    check(w_agree > INT8_W_AGREE and w_diff < INT8_W_MAX and w_self <= 1e-4,
          "int8 weights: agreement {}, max |d| {}, {} from the dequantized "
          "forward".format(w_agree, w_diff, w_self))
    check(a_self <= 1e-5, "int8 activations artifact {} from the live "
          "int8 path".format(a_self))
    check(a_agree >= INT8_ACT_AGREE and a_diff < INT8_ACT_STD * std,
          "int8 activations artifact: agreement {}, max |d| {}".format(
              a_agree, a_diff))
    # every launch of this phase, the fresh interpreter's among them
    return fa.LAUNCHES + fresh["launches"]


def phase_serving_jasper(card):
    """7zzm: Jasper-10x5's eval forward (``jasper10x5_synthetic.py``, B 32
    x 1,000 frames, "mixed") exported at full width and reloaded: logits
    equal to eager, greedy ids equal; then with the on-device prefix beam
    of width 4 (``on_device_beam_width``), which the export unrolls over
    the frames: at SERVING_BEAM_FRAMES frames after the stride (B 32), its
    ids and lengths equal to eager and its scores within 1e-5, with the
    export's seconds. No kernel: the forward has no loss."""
    import torch
    from openseq2seq_tpu_torch import serving
    from openseq2seq_tpu_torch.serving.export import serving_batch
    config = runpy.run_path(CONFIG)
    for beam in (0, 4):
        params = copy.deepcopy(config["base_params"])
        if beam:
            params["decoder_params"]["on_device_beam_width"] = beam
            params["data_layer_params"]["time_steps"] = \
                2 * SERVING_BEAM_FRAMES
        model = config["base_model"](params, mode="eval", device="cuda")
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        state = model.init_state(batch)
        with torch.no_grad():
            eager = state.module(serving_batch(batch, "cuda"),
                                 train=False)["decoder_output"]
        t0 = time.time()
        blob = serving.export_inference_fn(model, state, batch)
        t_export = time.time() - t0
        t0 = time.time()
        serve = serving.load_exported(blob)
        t_load = time.time() - t0
        out = serve(batch)["decoder_output"]
        torch.cuda.synchronize()
        diff = float((out["logits"] - eager["logits"]).abs().max())
        same = [torch.equal(a, b) for a, b in zip(out["outputs"][:2],
                                                  eager["outputs"][:2])]
        what = "beam {}".format(beam) if beam else "greedy"
        extra = ""
        if beam:
            score_diff = float((out["beam_scores"] -
                                eager["beam_scores"]).abs().max())
            extra = ", beam scores within {:.3e}".format(score_diff)
            check(score_diff <= 1e-5, "beam scores {}".format(score_diff))
        print("[serving] Jasper-10x5 {} at B {} x T' {}: exported in {:.1f} s "
              "({} bytes), reloaded in {:.1f} s: logits max |d| {:.3e} "
              "against eager, ids and lengths equal: {}{} ({})".format(
                  what, batch["source_tensors"][0].shape[0],
                  eager["logits"].shape[1], t_export, len(blob), t_load,
                  diff, same, extra, card), flush=True)
        check(diff <= 1e-5 * float(eager["logits"].abs().max()) and
              all(same), "Jasper {} artifact: logits {}, ids {}".format(
                  what, diff, same))
        del model, state, eager, out, serve


def group_serving(card, launches):
    """Phases 7zzl and 7zzm: serving from torch.export artifacts, fp, int8
    weights and int8 activations, at the transformer-base scoring bench's
    width, and Jasper-10x5's eval forward greedy and with the on-device
    beam; the int8 products against bf16."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    timed(phase_int8_products, card)
    launches["flash_attn_fwd"] += timed(phase_serving_transformer, card)
    timed(phase_serving_jasper, card)
    print("[serving] group peak {:.2f} GiB allocated".format(_peak_gib()),
          flush=True)


def timed(phase, *args, **kwargs):
    """``phase(*args, **kwargs)``, its seconds printed on a line of their
    own."""
    import gc
    import torch
    t0 = time.time()
    result = phase(*args, **kwargs)
    print("[time] phase {}: {:.1f} s".format(phase.__name__,
                                             time.time() - t0), flush=True)
    # what the phase held goes back to the card, for the groups that run
    # beside this one
    gc.collect()
    torch.cuda.empty_cache()
    return result


GROUPS = ("kernels", "speech", "nmt", "rnn", "conformer", "lm", "tts",
          "transducer", "image", "las", "asr_stack", "serving")


def group_kernels(card):
    """Phases 3 to 4j: every kernel against its plain version, and the
    library calls; returns what the kernels line reports of each."""
    k = {}
    k["fwd_err"], (k["fwd_ms"], k["fwd_plain_ms"]) = timed(phase_kernel,
                                                            card)
    k["bwd_err"], (k["bwd_ms"], k["bwd_plain_ms"], _, _) = \
        timed(phase_backward, card)
    k["ctc_lib_fwd_ms"], k["ctc_lib_fwd_bwd_ms"] = timed(phase_ctc_library,
                                                         card)
    k["flash_err"], k["flash_times"] = timed(phase_flash, card)
    k["dq_err"], k["dkv_err"], k["flash_bwd_times"] = timed(
        phase_flash_bwd, card)
    k["drop"] = timed(phase_dropout, card)
    k["scan_err"], k["scan_times"] = timed(phase_scan, card)
    k["scan_bwd_err"], k["scan_bwd_times"] = timed(phase_scan_bwd, card)
    k["relpos_err"], k["relpos_times"] = timed(phase_relpos, card)
    k["conv_err"], k["conv_times"] = timed(phase_conformer_conv, card)
    (k["relpos_dq_err"], k["relpos_dkv_err"],
     k["relpos_bwd_times"]) = timed(phase_relpos_bwd, card)
    k["conv_bwd_err"], k["conv_bwd_times"] = timed(
        phase_conformer_conv_bwd, card)
    return k


def group_speech(card, launches):
    """Phases 5 to 7 and 7r, 7s: Jasper-10x5 eval, infer and training on
    synthetic batches, then from wav files, and the w2lplus toy."""
    config = runpy.run_path(CONFIG)
    timed(phase_small_reference, config)
    launches["ctc_alpha_fwd"] += timed(phase_slice, config, card)
    train_fwd, train_bwd, synthetic_utt_s = timed(phase_train, card)
    wav_fwd, wav_bwd = timed(phase_librispeech, card, synthetic_utt_s)
    launches["ctc_alpha_fwd"] += train_fwd + wav_fwd
    launches["ctc_beta_bwd"] += train_bwd + wav_bwd
    timed(phase_w2lplus_toy, card)


def group_nmt(card, launches):
    """Phases 7a to 7e, 7u to 7x and 7zu to 7zx: transformer-big eval,
    infer and training, the reversal toys and the WMT-shaped recipes from
    text, ConvS2S among them."""
    timed(phase_small_transformer)
    launches["flash_attn_fwd"] += timed(phase_transformer, card)
    timed(phase_small_transformer_train)
    fwd, dq, dkv, drop = timed(phase_transformer_train, card)
    wmt_flash, gnmt_scan = timed(phase_nmt_text, card)
    launches["flash_attn_fwd"] += fwd + wmt_flash[0]
    launches["flash_attn_bwd_dq"] += dq + wmt_flash[1]
    launches["flash_attn_bwd_dkv"] += dkv + wmt_flash[2]
    launches["dropout_mask"] += drop
    launches["lstm_scan_fwd"] += gnmt_scan[0]
    launches["lstm_scan_bwd"] += gnmt_scan[1]


def group_rnn(card, launches):
    """Phases 7f to 7k and the DS2 toy (7t): DeepSpeech2-medium and
    lstm_small eval, infer and training."""
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    timed(phase_small_ds2)
    gru, ds2_ctc = timed(phase_rnn_model, DS2_MEDIUM, "ds2", gru_scan, 6,
                         card)
    lstm, lstm_ctc = timed(phase_rnn_model, LSTM_SMALL, "lstm_small",
                           lstm_scan, 8, card)
    timed(phase_small_ds2_train)
    ds2 = timed(phase_rnn_train, DS2_MEDIUM, "ds2 train", gru_scan, 6, card)
    small = timed(phase_rnn_train, LSTM_SMALL, "lstm_small train",
                  lstm_scan, 8, card)
    toy = timed(phase_toy, DS2_TOY, "ds2_toy_config", gru_scan, 2, card)
    launches["gru_scan_fwd"] += gru + ds2[0] + toy[0]
    launches["gru_scan_bwd"] += ds2[1] + toy[1]
    launches["lstm_scan_fwd"] += lstm + small[0]
    launches["lstm_scan_bwd"] += small[1]
    launches["ctc_alpha_fwd"] += ds2_ctc + lstm_ctc + ds2[2] + small[2]
    launches["ctc_beta_bwd"] += ds2[3] + small[3]


def group_conformer(card, launches):
    """Phases 7l to 7n and the Conformer toy (7t): Conformer-M eval,
    infer and training."""
    timed(phase_small_conformer)
    relpos, conv = timed(phase_conformer, card)
    timed(phase_small_conformer_train)
    c = timed(phase_conformer_train, card)
    timed(phase_toy, CONFORMER_TOY, "conformer_toy", None, 0, card)
    launches["flash_relpos_fwd"] += relpos + c[0]
    launches["flash_relpos_bwd_dq"] += c[1]
    launches["flash_relpos_bwd_dkv"] += c[2]
    launches["conformer_conv_fwd"] += conv + c[3]
    launches["conformer_conv_bwd"] += c[4]
    launches["ctc_alpha_fwd"] += c[5]
    launches["ctc_beta_bwd"] += c[6]


def group_lm(card, launches):
    """Phases 7o to 7q and 7zf to 7zi: the LSTM LM on synthetic tracks,
    then the language-model family from text."""
    timed(phase_small_lm)
    lm = timed(phase_lm, card)
    lm_train = timed(phase_lm_train, card)
    lm_fwd, lm_bwd = timed(phase_lm_family, card)
    launches["lstm_scan_fwd"] += lm + lm_train[0] + lm_fwd
    launches["lstm_scan_bwd"] += lm_train[1] + lm_bwd


def group_tts(card, launches):
    """Phases 7y to 7za and 7zp to 7zt: Tacotron-2, its GST variant and
    the TTS toy; Centaur and WaveNet."""
    (lstm_fwd, lstm_bwd), (gru_fwd, gru_bwd) = timed(phase_tts, card)
    launches["lstm_scan_fwd"] += lstm_fwd
    launches["lstm_scan_bwd"] += lstm_bwd
    launches["gru_scan_fwd"] += gru_fwd
    launches["gru_scan_bwd"] += gru_bwd


def group_transducer(card, launches):
    """Phases 7zb to 7ze: the Conformer-Transducer."""
    r = timed(phase_transducers, card)
    for i, name in enumerate(("flash_relpos_fwd", "flash_relpos_bwd_dq",
                              "flash_relpos_bwd_dkv", "conformer_conv_fwd",
                              "conformer_conv_bwd")):
        launches[name] += r[i]


def group_image(card, launches):
    """Phases 7zj to 7zo: image classification and speech commands (no
    kernel: the JAX family reaches no ``pallas_call``)."""
    timed(phase_image_family, card)


# the groups that run in processes of their own, at most LANES at a time,
# each started in this order as soon as a lane is free and its memory
# budget fits beside the running groups' within MEMORY_GIB of the card's
# 79 GiB. A budget is the group's largest peak of allocated device memory
# on an H100 (its phases' own "peak" lines: lm 33.8 GiB, nmt 15.1,
# asr_stack 14.6, transducer 12.5, las 11.4, image 10.4, tts 9.4,
# serving 2.8) and about a third more
# for the caching allocator's free blocks; the groups that print no peak
# (speech, rnn, conformer) get 18 to 20. Three groups at once ran lm,
# nmt and the transducer out of memory (79.15 GiB in use).
LANE_ORDER = ("lm", "las", "serving", "asr_stack", "speech", "tts", "nmt",
              "transducer", "image", "rnn", "conformer")
GROUP_GIB = {"lm": 44, "nmt": 24, "speech": 20, "transducer": 18,
             "las": 18, "rnn": 18, "conformer": 18, "tts": 14, "image": 14,
             "asr_stack": 20, "serving": 4}
MEMORY_GIB = 76
LANES = 3


def _stop(proc):
    """Kill ``proc``'s process group (the group's process and whatever it
    started), if any of it is left."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def group_processes(groups, launches):
    """Run ``chip_smoke.py --group=NAME`` for each of ``groups``, each in a
    process group of its own, as ``LANES`` and ``MEMORY_GIB`` allow;
    relay each one's output when it ends (less its environment and build
    lines, which repeat the parent's), add its launch counts to
    ``launches`` and return each group's seconds. The first group to fail
    stops the others, and the run fails with it. The output goes to
    files, not pipes: a process that a group left behind could hold a
    pipe open past the group's end."""
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or LANES) // LANES)))
    pending, running, failed, seconds = list(groups), {}, [], {}

    def start(group):
        out = tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--group=" + group],
            cwd=REPO, env=env, stdout=out, text=True, start_new_session=True)
        running[group] = (proc, out, time.time())
        print("[lanes] {} started beside {} ({} of {} GiB budgeted)".format(
            group, sorted(g for g in running if g != group),
            sum(GROUP_GIB[g] for g in running), MEMORY_GIB), flush=True)

    def finish(group):
        proc, out, t0 = running.pop(group)
        _stop(proc)
        seconds[group] = time.time() - t0
        out.seek(0)
        lines = out.read().splitlines()
        out.close()
        for line in lines:
            if not line.startswith(("[env] ", "[build] ")):
                print(line)
        print("[time] group {} (its own process): {:.1f} s, rc {}".format(
            group, seconds[group], proc.returncode), flush=True)
        result = [json.loads(line) for line in lines
                  if line.startswith('{"group": ')]
        if proc.returncode != 0 or len(result) != 1:
            failed.append(group)
            return
        for name, n in result[0]["launches"].items():
            launches[name] += n

    try:
        while (pending or running) and not failed:
            for group in list(pending):
                gib = sum(GROUP_GIB[g] for g in running) + GROUP_GIB[group]
                if len(running) < LANES and gib <= MEMORY_GIB:
                    pending.remove(group)
                    start(group)
            time.sleep(0.5)
            for group in [g for g, (proc, _, _) in running.items()
                          if proc.poll() is not None]:
                finish(group)
    finally:
        for group, (proc, _, _) in list(running.items()):
            _stop(proc)
            proc.wait()
            finish(group)
    check(not failed and not pending, "every group ran to its end (not: "
          "{})".format(", ".join(failed + pending)))
    return seconds


KERNEL_NAMES = ("ctc_alpha_fwd", "ctc_beta_bwd", "flash_attn_fwd",
                "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "dropout_mask",
                "lstm_scan_fwd", "gru_scan_fwd", "lstm_scan_bwd",
                "gru_scan_bwd", "flash_relpos_fwd", "conformer_conv_fwd",
                "flash_relpos_bwd_dq", "flash_relpos_bwd_dkv",
                "conformer_conv_bwd")


def main():
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--group", choices=GROUPS, default=None,
                        help="run one phase group (default: all of them)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "a GPU only")
    sys.path.insert(0, REPO)
    from openseq2seq_tpu_torch.kernels import build
    t_start = time.time()

    # 1. environment
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("[env] python {}, torch {}, CUDA {}, {} device(s)".format(
        sys.version.split()[0], torch.__version__, torch.version.cuda,
        torch.cuda.device_count()), flush=True)
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build, one nvcc per source, all started together
    names = ("ctc_alpha_fwd", "ctc_beta_bwd", "flash_attn_fwd",
             "flash_attn_bwd", "dropout_mask", "gru_scan_fwd",
             "lstm_scan_fwd", "gru_scan_bwd", "lstm_scan_bwd",
             "flash_relpos_fwd", "conformer_conv_fwd", "flash_relpos_bwd",
             "conformer_conv_bwd")
    t0 = time.time()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    print("[build] {} (nvcc, sm_90a) in {:.2f} s".format(
        ", ".join(os.path.relpath(lib, REPO) for lib in libs),
        time.time() - t0), flush=True)
    for name, lib in zip(names, libs):
        print_ptxas(name, lib.with_suffix(".log").read_text())
    check_relpos_spills([lib.with_suffix(".log").read_text()
                         for name, lib in zip(names, libs)
                         if name.startswith("flash_relpos")])
    seconds = {"build": time.time() - t0}

    # 3-7. the groups; each path with its launch counts set to 0 just
    # before it and read just after. With no --group, the kernel group
    # runs first and alone on the card, so that its times are clean; the
    # others then run in processes of their own, LANES at a time.
    launches = {name: 0 for name in KERNEL_NAMES}
    k = None
    first = "kernels" if args.group is None else args.group
    t0 = time.time()
    if first == "kernels":
        k = group_kernels(card)
    else:
        globals()["group_" + first](card, launches)
    seconds[first] = time.time() - t0
    print("[time] group {}: {:.1f} s".format(first, seconds[first]),
          flush=True)
    if args.group is None:
        torch.cuda.empty_cache()
        seconds.update(group_processes(LANE_ORDER, launches))
    seconds["total"] = time.time() - t_start
    print("[time] {} in {:.1f} s (build {:.1f} s)".format(
        "every group" if args.group is None else "group " + args.group,
        seconds["total"], seconds["build"]), flush=True)
    if args.group is not None:
        print(json.dumps({"group": args.group, "launches": launches,
                          "seconds": seconds}), flush=True)
    else:
        print_kernels_line(k, launches)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
