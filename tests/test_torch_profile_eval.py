"""The profiler's own arithmetic, on the CPU: its FLOP count against
torch's FlopCounterMode on a small Jasper, for the eval step and for the
train step (``--train``: forward and backward of every conv and dense
layer), the tiny transformer's train step (``--train-nmt`` on the tiny
twin of its config), the tiny DeepSpeech2's eval and train steps (2-D
convs and the recurrent products apart), its busy-time union, its kernel
grouping and its arguments. And the GPU scripts import nothing of JAX or
of the JAX package themselves."""
import ast
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from openseq2seq_tpu.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.training import trainer
from openseq2seq_tpu_torch.zoo import jasper_model_params
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts_torch"))
import profile_eval  # noqa: E402


def _small_model(mode):
    return Speech2Text(jasper_model_params(
        SyntheticSpeechDataLayer,
        {"num_audio_features": 16, "tgt_vocab_size": 29, "time_steps": 41,
         "label_length": 6, "num_batches": 1},
        num_blocks=2, block_repeat=2, width_scale=0.125,
        batch_size_per_gpu=2, dtype="float32", max_steps=3),
            mode=mode, device="cpu")


def test_flop_count_matches_torch_flop_counter():
    model = _small_model("eval")
    state = trainer.restore_state(model)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    got = profile_eval.count_flops(
        state.module, lambda: model.eval_step(state, batch))
    with FlopCounterMode(display=False) as counter:
        model.eval_step(state, batch)
    assert got > 0 and got == counter.get_total_flops()


def test_train_step_flop_count_matches_torch_flop_counter():
    """Two train steps through the script's own step: the count of the
    first is FlopCounterMode's over the second, less its one ``bmm`` (the
    vocabulary scatter of the plain CTC backward, which on the card is
    the ``ctc_beta_bwd`` kernel and no conv or dense layer)."""
    model = _small_model("train")
    module, step = profile_eval.make_step(model, train=True)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    before = [p.detach().clone() for p in module.parameters()]
    got = profile_eval.count_flops(module, lambda: step(batch), train=True)
    with FlopCounterMode(display=False) as counter:
        metrics = step(batch)
    counts = {str(op): n for op, n in
              counter.get_flop_counts()["Global"].items()}
    assert set(counts) == {"aten.convolution", "aten.convolution_backward",
                           "aten.addmm", "aten.mm", "aten.bmm"}, counts
    assert got > 0 and got == counter.get_total_flops() - counts["aten.bmm"]
    assert bool(torch.isfinite(metrics["loss"]))
    assert any(not torch.equal(p, q) for p, q in
               zip(before, module.parameters()))


def test_train_nmt_arguments():
    args = profile_eval.parse_args(["--train-nmt"])
    assert args.train and args.config_file == profile_eval.NMT_TRAIN_CONFIG
    args = profile_eval.parse_args(["--train"])
    assert args.train and args.config_file == profile_eval.CONFIG
    assert not profile_eval.parse_args([]).train
    with pytest.raises(SystemExit):
        profile_eval.parse_args(["--train-nmt", "--infer"])


def test_transformer_train_step_flop_count():
    """The tiny twin of the transformer-big training config through the
    script's own train step: the dense layers' FLOP (forward, weight and
    input gradients) equal FlopCounterMode's ``addmm``/``mm`` count less
    the logits products (the shared table against the decoder output,
    forward and its two gradients: 3 x 2 x tokens x d x V), which are no
    dense layer; the step updates the weights with a finite loss."""
    import runpy
    cfg = runpy.run_path(os.path.join(
        REPO, "example_configs_torch", "text2text",
        "transformer_tiny_train_synthetic.py"))
    model = cfg["base_model"](cfg["base_params"], mode="train", device="cpu")
    module, step = profile_eval.make_step(model, train=True)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    got = profile_eval.count_flops(module, lambda: step(batch), train=True)
    with FlopCounterMode(display=False) as counter:
        metrics = step(batch)
    counts = {str(op): n for op, n in
              counter.get_flop_counts()["Global"].items()}
    B, T = batch["target_tensors"][0].shape
    logits = 3 * 2 * B * (T - 1) * 128 * 61
    assert got > 0 and got == counts["aten.addmm"] + counts["aten.mm"] - \
        logits, counts
    assert bool(torch.isfinite(metrics["loss"]))


def test_ds2_flop_counts():
    """The tiny DeepSpeech2 config's eval step through the script's own
    step: the 2-D convs' and dense layers' FLOP equal FlopCounterMode's
    ``convolution`` and ``addmm``/``mm`` count less the recurrent
    products h W_h, which the recurrent count holds: 2 G H^2 per row and
    step, every row and step (the fused recurrence's plain version runs
    them as ``mm`` on the CPU, the scan kernels on the card)."""
    import runpy
    cfg = runpy.run_path(os.path.join(
        REPO, "example_configs_torch", "speech2text",
        "ds2_tiny_synthetic.py"))
    model = cfg["base_model"](cfg["base_params"], mode="eval", device="cpu")
    module, step = profile_eval.make_step(model, train=False)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    got = profile_eval.count_flops(module, lambda: step(batch))
    rnn = profile_eval.count_recurrent_flops(module, lambda: step(batch))
    with FlopCounterMode(display=False) as counter:
        step(batch)
    counts = {str(op): n for op, n in
              counter.get_flop_counts()["Global"].items()}
    B, T = 8, 20                      # 40 frames after the time stride 2
    assert rnn == 2 * 2 * B * T * 2 * 128 * 3 * 128
    assert got > 0 and got + rnn == counter.get_total_flops(), counts
    assert got == counts["aten.convolution"] + counts["aten.addmm"] + \
        counts.get("aten.mm", 0) - rnn


def test_ds2_train_step_flop_counts():
    """The tiny DeepSpeech2 config's train step: FlopCounterMode's total,
    less the plain CTC backward's ``bmm``, is the convs' and dense
    layers' forward and backward plus three times the recurrent products
    (the forward's h W_h, the backward's dg W_h^T and the dW_h products,
    all ``mm`` in the plain versions on the CPU)."""
    import runpy
    cfg = runpy.run_path(os.path.join(
        REPO, "example_configs_torch", "speech2text",
        "ds2_tiny_synthetic.py"))
    model = cfg["base_model"](cfg["base_params"], mode="train", device="cpu")
    module, step = profile_eval.make_step(model, train=True)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    got = profile_eval.count_flops(module, lambda: step(batch), train=True)
    rnn = profile_eval.count_recurrent_flops(module, lambda: step(batch),
                                             train=True)
    with FlopCounterMode(display=False) as counter:
        metrics = step(batch)
    counts = {str(op): n for op, n in
              counter.get_flop_counts()["Global"].items()}
    B, T = 8, 20                      # 40 frames after the time stride 2
    assert rnn == 3 * 2 * 2 * B * T * 2 * 128 * 3 * 128
    assert got > 0 and got + rnn == counter.get_total_flops() - \
        counts["aten.bmm"], counts
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.parametrize("train", [False, True])
def test_lm_flop_counts(train):
    """The tiny LSTM LM's eval step (the full softmax: 2 E V a token) and
    train step (64 sampled candidates: 3 x 2 E S a token) through the
    script's own step: the dense layers' and vocabulary products' FLOP
    plus the recurrent count equal FlopCounterMode's total; the arguments
    pick the full-width LM config."""
    import runpy
    cfg = runpy.run_path(os.path.join(REPO, "example_configs_torch", "lm",
                                      "lstm_lm_tiny_synthetic.py"))
    model = cfg["base_model"](cfg["base_params"],
                              mode="train" if train else "eval",
                              device="cpu")
    module, step = profile_eval.make_step(model, train=train)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    got = profile_eval.count_flops(module, lambda: step(batch), train)
    rnn = profile_eval.count_recurrent_flops(module, lambda: step(batch),
                                             train)
    with FlopCounterMode(display=False) as counter:
        step(batch)
    tokens = 8 * 16
    head = 3 * 2 * tokens * 128 * 64 if train else 2 * tokens * 128 * 1000
    assert rnn == (3 if train else 1) * 2 * 2 * tokens * 128 * 4 * 128
    assert got > head and got + rnn == counter.get_total_flops()
    for flag in ("--train-lm", "--eval-lm"):
        args = profile_eval.parse_args([flag])
        assert args.config_file == profile_eval.LM_CONFIG
        assert args.train == (flag == "--train-lm")


def test_busy_time_is_the_union_of_intervals():
    intervals = [(0, 10, "a"), (5, 12, "b"), (20, 25, "c"), (21, 22, "d")]
    assert profile_eval.busy_us(intervals) == 17


@pytest.mark.parametrize("name,group", [
    ("(anonymous namespace)::ctc_alpha_fwd_kernel(float const*)",
     "ctc kernel"),
    ("void (anonymous namespace)::ctc_alpha_fwd_kernel<1, false>(float "
     "const*, int const*, int const*, int const*, float*, float*, int, int, "
     "int, int, int, int)", "ctc kernel"),
    ("void (anonymous namespace)::ctc_beta_bwd_kernel<2>(float const*, int "
     "const*)", "ctc kernel"),
    ("(anonymous namespace)::ctc_beta_bwd_scatter_kernel(float const*, int "
     "const*, float*, int, int, int, int)", "ctc kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convs (implicit GEMM, k > 1)"),
    ("void convolve_common_engine_float_NHWC<__nv_bfloat16, __nv_bfloat16, "
     "128, 5, 5, 3, 3, 3, true, false, false>", "convs (implicit GEMM, k > 1)"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16>",
     "GEMMs (1x1 residual convs, dense)"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT",
     "GEMMs (1x1 residual convs, dense)"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>",
     "batch norm"),
    ("Memcpy HtoD (Pageable -> Device)", "H2D copies"),
    ("void at::native::vectorized_elementwise_kernel<8, "
     "at::native::bfloat16_copy_kernel_cuda>", "dtype casts and copies"),
    ("void at::native::vectorized_elementwise_kernel<8, "
     "at::native::CUDAFunctor_add<c10::BFloat16>>", "elementwise"),
    ("void (anonymous namespace)::flash_attn_fwd_kernel<__nv_bfloat16, 64, "
     "64>(__nv_bfloat16 const*)", "flash attention kernel"),
    ("void (anonymous namespace)::flash_attn_bwd_dq_kernel<__nv_bfloat16, "
     "64, 64, 64, 4>(__nv_bfloat16 const*)", "flash attention kernel"),
    ("void (anonymous namespace)::flash_attn_bwd_dkv_kernel<float, 256, 256, "
     "32, 8>(float const*)", "flash attention kernel"),
    ("void (anonymous namespace)::flash_attn_fwd_mma_kernel<64>"
     "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "unsigned char const*, __nv_bfloat16*, float*, int, int, int, int, "
     "float, int)", "flash attention kernel"),
    ("void (anonymous namespace)::flash_attn_bwd_dq_mma_kernel<64>"
     "(__nv_bfloat16 const*)", "flash attention kernel"),
    ("void (anonymous namespace)::flash_attn_bwd_dkv_mma_kernel<256>"
     "(__nv_bfloat16 const*)", "flash attention kernel"),
    ("void (anonymous namespace)::dropout_mask_kernel<__nv_bfloat16, false>"
     "(__nv_bfloat16 const*)", "fused dropout kernel"),
    ("void rnn_scan::scan_fwd_kernel<__nv_bfloat16, 3, 8, (anonymous "
     "namespace)::GruCell>(rnn_scan::Params)", "rnn scan kernels"),
    ("void rnn_scan::scan_fwd_kernel<float, 4, 4, (anonymous "
     "namespace)::LstmCell>(rnn_scan::Params)", "rnn scan kernels"),
    ("void rnn_scan::scan_bwd_kernel<__nv_bfloat16, 3, 8, (anonymous "
     "namespace)::GruBwdCell>(rnn_scan::BwdParams)",
     "rnn scan backward kernels"),
    ("void rnn_scan::scan_fwd_mma_kernel<3, 8, (anonymous "
     "namespace)::GruCell>(rnn_scan::Params)", "rnn scan kernels"),
    ("void rnn_scan::scan_bwd_mma_kernel<4, 4, (anonymous "
     "namespace)::LstmBwdCell>(rnn_scan::BwdParams)",
     "rnn scan backward kernels"),
    ("void (anonymous namespace)::flash_relpos_fwd_kernel<__nv_bfloat16, "
     "64>(__nv_bfloat16 const*)", "rel-pos flash kernel"),
    ("void (anonymous namespace)::conformer_conv_pw1_kernel<__nv_bfloat16>"
     "(__nv_bfloat16 const*)", "conformer conv kernel"),
    ("void (anonymous namespace)::conformer_conv_dw_pw2_kernel<float>"
     "(float const*)", "conformer conv kernel"),
    ("void (anonymous namespace)::flash_relpos_bwd_dq_kernel<__nv_bfloat16, "
     "64>(__nv_bfloat16 const*)", "rel-pos flash backward kernels"),
    ("void (anonymous namespace)::flash_relpos_bwd_dkv_kernel<float, 32>"
     "(float const*)", "rel-pos flash backward kernels"),
    ("void conformer_conv_backward::product_kernel<__nv_bfloat16, float, "
     "float>(float const*, long long)", "conformer conv backward kernels"),
    ("conformer_conv_backward::reduce_kernel(float const*, int, int)",
     "conformer conv backward kernels"),
    ("void (anonymous namespace)::conformer_conv_fused_kernel<64>"
     "(__nv_bfloat16 const*, int const*)", "conformer conv kernel"),
    ("(anonymous namespace)::conformer_conv_round_weights_kernel(float "
     "const*, float const*, __nv_bfloat16*, int)", "conformer conv kernel"),
    ("conformer_conv_backward::round_weights_kernel(float const*, float "
     "const*, __nv_bfloat16*, int)", "conformer conv backward kernels"),
    ("void conformer_conv_backward::front_kernel<64>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*)", "conformer conv backward kernels"),
    ("void conformer_conv_backward::glu_bwd_kernel<32>(__nv_bfloat16 "
     "const*, float const*)", "conformer conv backward kernels"),
    ("void conformer_conv_backward::dh0_kernel<2, 8>(__nv_bfloat16 "
     "const*)", "conformer conv backward kernels"),
    ("conformer_conv_backward::weight_grads_kernel(__nv_bfloat16 const*)",
     "conformer conv backward kernels"),
    ("conformer_conv_backward::reduce_all_kernel(conformer_conv_backward::"
     "Pieces, int)", "conformer conv backward kernels"),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::"
     "gpu_index_kernel<...>>(long, ...)", "sampled softmax gathers and "
     "scatters"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*, char*, "
     "long*, int, long, long, long, long, bool)",
     "sampled softmax gathers and scatters"),
    ("void at::native::(anonymous namespace)::indexing_backward_kernel<"
     "float, 4>(long const*, long const*, float const*, float*, long, "
     "long, long, long, bool)", "sampled softmax gathers and scatters"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>(...)",
     "gathers and scatters (embedding, beam reorder)"),
])
def test_kernel_groups(name, group):
    assert profile_eval.group_of(name) == group


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "scripts_torch/profile_eval.py",
                                    "scripts_torch/bench_scan.py",
                                    "scripts_torch/bench_relpos.py",
                                    "scripts_torch/bench_conv.py",
                                    "scripts_torch/bench_ctc.py"])
def test_gpu_scripts_import_no_jax_package(script):
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    roots = {name.split(".")[0] for name in names}
    assert not roots & {"jax", "flax", "optax", "openseq2seq_tpu"}, roots


def test_conformer_flop_count():
    """The tiny Conformer config's eval step through the script's own
    step, both kernel flags off: the convs' and dense layers' FLOP (the
    front end, the FFNs, the attention's DenseGeneral projections with the
    position table's) equal FlopCounterMode's ``convolution`` and
    ``addmm``/``mm`` count. The attention's score and context products,
    the relative-shift einsums, the conv module's pointwise products and
    its depthwise conv are no dense layer or front-end conv (on the card,
    with the flags on, the last two and the attention are the
    kernels')."""
    import runpy
    cfg = runpy.run_path(os.path.join(
        REPO, "example_configs_torch", "speech2text",
        "conformer_tiny_synthetic.py"))
    params = dict(cfg["base_params"])
    params["encoder_params"] = dict(params["encoder_params"],
                                    flash_attention=False,
                                    fused_conv_module=False)
    model = cfg["base_model"](params, mode="eval", device="cpu")
    module, step = profile_eval.make_step(model, train=False)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    got = profile_eval.count_flops(module, lambda: step(batch))
    with FlopCounterMode(display=False) as counter:
        step(batch)
    counts = {str(op): n for op, n in
              counter.get_flop_counts()["Global"].items()}
    B, T, D, k = 4, 10, 128, 7
    # five DenseGeneral projections a block, r over the 2T - 1 table rows
    attn = 2 * (4 * B * T + (2 * T - 1)) * D * D
    # the conv module a block: its pointwise products (D -> 2D, D -> D)
    # and its depthwise taps
    conv_module = 2 * B * T * D * (3 * D + k)
    assert got > 0 and attn < got
    assert got == counts["aten.convolution"] + counts["aten.addmm"] + \
        counts["aten.mm"] - 2 * conv_module, counts


def test_txl_flop_count_and_arguments():
    """``--train-txl``/``--eval-txl`` pick the Transformer-XL recipe; the
    tiny twin's eval step through the script's own step: its dense and
    DenseGeneral layers and the tied logits (2 D V a token) equal
    FlopCounterMode's ``addmm``/``mm`` count (the attention's score and
    context products, ``bmm``, are left out, as for the Conformer)."""
    import runpy
    args = profile_eval.parse_args(["--train-txl"])
    assert args.train and args.wikitext and \
        args.config_file == profile_eval.TXL_CONFIG
    args = profile_eval.parse_args(["--eval-txl"])
    assert not args.train and args.config_file == profile_eval.TXL_CONFIG
    assert profile_eval.parse_args(["--train-lm-wkt"]).config_file == \
        profile_eval.LM_WKT_CONFIG
    cfg = runpy.run_path(os.path.join(REPO, "example_configs_torch", "lm",
                                      "txl_tiny.py"))
    model = cfg["base_model"](cfg["base_params"], mode="eval", device="cpu")
    module, step = profile_eval.make_step(model, train=False)
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    got = profile_eval.count_flops(module, lambda: step(batch))
    with FlopCounterMode(display=False) as counter:
        step(batch)
    counts = {str(op): n for op, n in
              counter.get_flop_counts()["Global"].items()}
    assert got > 0 and got == counts["aten.addmm"] + counts["aten.mm"], \
        (got, counts)
