"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``; each test skips where no CUDA device is
present. This file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerance: fp32 on both sides, rtol 1e-5 on the per-row negative log
likelihood of feasible rows; infeasible rows are exactly 0 on both. The
backward kernel against ``ctc_nll_grad`` on the card: max abs error 1e-5
on d log-probs, exact zeros on infeasible rows and past each length, the
posteriors of a live frame summing to 1 within 1e-4, and two calls
bit-identical; the first launch's posteriors element by element against
``ctc_posteriors`` within 1e-5, lengths on either side of the chunk
edges, planted faults refused through ``ctc_cuda.readings``, and a label
length whose CTA does not fit refused before any launch. The flash
attention kernel against
``flash_attention_plain``: fp32, max abs error 2e-5 (sums in another
order), and what it refuses. The flash backward kernels against
``flash_attention_bwd_plain`` from the kernel forward's own output and
lse: fp32, max abs error 1e-4, two calls bit-identical, and autograd
through the kernels. The bf16 flash kernels (tensor cores) against the
rounding plain versions, forward and backward, at the encoder shape, the
decoder's causal shape and at D = 128 and 256 (tolerances in the test),
repeats bit-identical, and the refusal of a misaligned bf16 input. The fused dropout kernel against its plain version:
bit-identical, forward and backward, with and without the residual. The
GRU and LSTM scan kernels against their plain versions, forward and
reverse, residuals included: fp32 (TF32 off) max abs error 1e-5, bf16
within 3 bf16 ulps of max(1, |value|), two calls bit-identical; and what
they refuse. Their backward kernels the same way, on the forward
kernel's residuals, and autograd through both kernels against the CPU's
plain versions (fp32, rtol 1e-4, atol 1e-5: dW_h sums over B x T). The
Conformer's rel-pos flash kernel and conv module kernel against their
plain versions, forward and backward, fp32 and bf16 (tolerances in each
test), repeats bit-identical, what the rel-pos kernels refuse, and
autograd through both modules' kernels against the CPU's plain
versions. The bf16 scan kernels and conv module kernels are also held
element by element within the bounds of ``ops/scan_bounds.py`` and
``ops/conformer_conv.py``, each step or stage from the kernel's own
state, and must refuse planted faults. The flash forward's custom op
(``torch.library.opcheck``, one launch a call) and serving's int8
products (the exact integer sums; an int8 layer bit for bit its float64
plain version)."""
import numpy as np
import pytest
import torch

from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
from test_torch_text_data import one_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(device, B, T, L, V=29, seed=0):
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(B, T, V).astype(np.float32))
    logit_lens = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    labels = rng.randint(0, V - 1, size=(B, L)).astype(np.int32)
    label_lens = rng.randint(0, L + 1, size=B).astype(np.int32)
    label_lens[0] = 0
    logit_lens[-1], label_lens[-1] = 1, L        # infeasible
    return [t.to(device) for t in (logits, torch.from_numpy(logit_lens),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(label_lens))]


@pytest.mark.parametrize("B,T,L", [(8, 37, 12), (4, 1300, 600),
                                   (64, 250, 160)])
def test_kernel_matches_plain(device, B, T, L):
    case = _case(device, B, T, L)
    before = ctc_cuda.LAUNCHES
    got = ctc_cuda.ctc_loss_cuda(*case, average_across_batch=False)
    assert ctc_cuda.LAUNCHES == before + 1
    want = ctc.ctc_loss(*case, average_across_batch=False)
    feasible = ctc.feasible_rows(case[1], case[2], case[3])
    assert not feasible[-1] and got[-1] == 0 and want[-1] == 0
    torch.testing.assert_close(got[feasible], want[feasible],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("B,T,L", [(8, 37, 12), (32, 500, 160),
                                   (4, 1300, 600), (64, 250, 160)])
def test_backward_kernel_matches_plain(device, B, T, L):
    logits, lens, labels, label_lens = _case(device, B, T, L)
    lp = ctc.log_probs(logits).contiguous()
    fwd, bwd = ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES
    nll, lattice = ctc_cuda.alpha_fwd(lp, lens, labels, label_lens, 28, True)
    got = ctc_cuda.beta_bwd(lp, lens, labels, label_lens, 28, nll, lattice)
    again = ctc_cuda.beta_bwd(lp, lens, labels, label_lens, 28, nll, lattice)
    assert ctc_cuda.LAUNCHES == fwd + 1 and ctc_cuda.BWD_LAUNCHES == bwd + 2
    want_nll, want = ctc.ctc_nll_grad(lp, lens, labels, label_lens, 28)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(nll, want_nll, rtol=1e-5, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    feasible = ctc.feasible_rows(lens, labels, label_lens)
    live = torch.arange(T, device=device)[None, :] < lens[:, None]
    assert torch.all(got[~feasible] == 0)
    assert torch.all(got[~live] == 0)
    sums = got.sum(dim=2)[feasible[:, None] & live]
    torch.testing.assert_close(sums, -torch.ones_like(sums), rtol=0,
                               atol=1e-4)


def test_autograd_through_the_kernels(device):
    logits, lens, labels, label_lens = _case(device, 8, 37, 12)
    x = logits.clone().requires_grad_()
    ctc_cuda.ctc_loss_cuda(x, lens, labels, label_lens).backward()
    y = logits.clone().requires_grad_()
    ctc.ctc_loss(y, lens, labels, label_lens).backward()
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-6)


def test_backward_twice_with_retain_graph(device):
    """The backward's posterior buffer is its own allocation: the saved
    lattice is left as it was, so a second backward through a retained
    graph gives the first one's gradient bit for bit."""
    logits, lens, labels, label_lens = _case(device, 8, 80, 12)
    x = logits.clone().requires_grad_()
    loss = ctc_cuda.ctc_loss_cuda(x, lens, labels, label_lens)
    first, = torch.autograd.grad(loss, x, retain_graph=True)
    second, = torch.autograd.grad(loss, x)
    assert torch.equal(first, second) and first.abs().max() > 0


def test_kernel_refuses_what_it_does_not_take(device):
    lp = ctc.log_probs(_case(device, 2, 9, 3)[0])
    lengths = torch.full((2,), 9, dtype=torch.int32, device=device)
    labels = torch.ones((2, 3), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_nll_cuda(lp.double(), lengths, labels, lengths, 28)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_nll_cuda(lp.transpose(0, 1), lengths, labels,
                              lengths, 28)
    with pytest.raises(ValueError):
        ctc_cuda.ctc_nll_cuda(lp, lengths.long(), labels, lengths, 28)


def _chunk_case(device, seed=41):
    """Lengths that end on either side of the CTC kernels' chunk edges
    (the forward's chunks of ``ctc_cuda.CHUNK`` = 32 frames start at
    frames 1, 33, the backward's at len - 1, len - 33, ...), an empty
    label (row 1) and a repeated symbol (row 2)."""
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


@pytest.mark.parametrize("shape", ["chunk", (8, 80, 12), (64, 250, 160)])
def test_backward_posteriors_and_planted_faults(device, shape):
    """Both launches of the backward against the plain versions through
    ``ctc_cuda.readings`` (the first launch's posteriors against
    ``ctc_posteriors`` on the kernel forward's own NLL and lattice, within
    1e-5), every reading at most 1; each planted fault of
    ``ctc_cuda.planted_faults`` reads above 1."""
    logits, lens, labels, label_lens = _chunk_case(device) \
        if shape == "chunk" else _case(device, *shape)
    args = (ctc.log_probs(logits).contiguous(), lens, labels, label_lens, 28)
    nll, lattice = ctc_cuda.alpha_fwd(*args, True)
    dlp, post = ctc_cuda.beta_bwd(*args, nll, lattice, posteriors=True)
    plain = ctc_cuda.plain_results(*args)
    want = {"nll": plain["nll"], "dlp": plain["dlp"],
            "post": ctc.ctc_posteriors(*args, nll, lattice)}
    reads = ctc_cuda.readings({"nll": nll, "dlp": dlp, "post": post}, want,
                              lens, labels, label_lens)
    assert all(v <= 1 for v in reads.values()), reads
    faults = ctc_cuda.planted_faults(*args, plain)
    assert len(faults) == 4
    for name, got in faults.items():
        worst = max(ctc_cuda.readings(got, plain, lens, labels,
                                      label_lens).values())
        assert worst > 1, name


def test_ctc_resources_and_refusals(device):
    """The kernels' own resource entries: one state a thread and chunks of
    ``ctc_cuda.CHUNK`` frames at L = 160, two states at L = 600, and a
    label length whose CTA does not fit (L = 3000) refused with ValueError
    before any launch, nothing counted."""
    res = ctc_cuda.ctc_resources(160, 29)
    assert res["fwd"][:3] == (352, 1, ctc_cuda.CHUNK)
    assert res["bwd"][:3] == (352, 1, ctc_cuda.CHUNK)
    assert res["fwd"][4] > 0 and res["bwd"][4] > 0 and res["scatter"][4] > 0
    assert ctc_cuda.ctc_resources(600, 29)["fwd"][1] == 2
    big = ctc_cuda.ctc_resources(3000, 29)
    assert big["fwd"][4] == 0 and big["bwd"][4] == 0
    lp = ctc.log_probs(_case(device, 2, 9, 3)[0])
    n = torch.full((2,), 9, dtype=torch.int32, device=device)
    labels = torch.ones((2, 3000), dtype=torch.int32, device=device)
    before = (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES)
    with pytest.raises(ValueError):
        ctc_cuda.alpha_fwd(lp, n, labels, n, 28, True)
    with pytest.raises(ValueError):
        ctc_cuda.beta_bwd(lp, n, labels, n, 28, torch.zeros(2, device=device),
                          torch.zeros((2, 9, 6001), device=device))
    assert (ctc_cuda.LAUNCHES, ctc_cuda.BWD_LAUNCHES) == before


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", [
    (4, 64, 64, 16, 64, False), (2, 113, 113, 4, 64, True),
    (2, 63, 64, 4, 128, False), (1, 70, 200, 2, 256, False)])
def test_flash_kernel_matches_plain(device, B, Tq, Tk, H, D, causal):
    """fp32 (TF32 plays no part: the kernel and the plain version's
    einsums run in full fp32 by default), max abs error 2e-5 on unit-scale
    inputs; one launch."""
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(Tq + D)
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=device)
               for T in (Tq, Tk, Tk))
    valid = None
    if not causal:
        lengths = torch.randint(1, Tk + 1, (B,), generator=g, device=device)
        valid = torch.arange(Tk, device=device)[None] < lengths[:, None]
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, valid, causal)
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, valid, causal)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_flash_kernel_refuses_what_it_does_not_take(device):
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    q = torch.randn((2, 8, 2, 64), device=device)
    for bad in ((q.half(), q.half(), q.half()), (q[..., :32].contiguous(),) * 3,
                (q.transpose(1, 2), q, q), (q, q.bfloat16(), q)):
        with pytest.raises(ValueError):
            fa.flash_attention(*bad)


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", [
    (4, 64, 64, 16, 64, False), (2, 113, 113, 4, 64, True),
    (2, 63, 64, 4, 128, False), (1, 70, 200, 2, 256, False)])
def test_flash_backward_kernels_match_plain(device, B, Tq, Tk, H, D, causal):
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(Tq + D + 1)
    q, do = (torch.randn((B, Tq, H, D), generator=g, device=device)
             for _ in range(2))
    k, v = (torch.randn((B, Tk, H, D), generator=g, device=device)
            for _ in range(2))
    valid = None
    if not causal:
        lengths = torch.randint(1, Tk + 1, (B,), generator=g, device=device)
        valid = torch.arange(Tk, device=device)[None] < lengths[:, None]
    out, lse = fa.flash_attention_cuda(q, k, v, valid, causal, D ** -0.5,
                                      return_lse=True)
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, valid, causal)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, valid, causal)
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == (before[0] + 2,
                                                         before[1] + 2)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, valid, causal)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, rtol=0, atol=1e-4)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, valid, causal).backward(do)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", [
    (64, 64, 64, 16, 64, False), (64, 63, 63, 16, 64, True),
    (2, 100, 130, 4, 128, False), (1, 70, 200, 2, 256, False)])
def test_bf16_flash_kernels_match_rounding_plain(device, B, Tq, Tk, H, D,
                                                 causal):
    """The bf16 kernels (tensor cores) against the rounding plain versions
    (``round_weights=True``) on the same inputs, the backward from the
    kernel forward's own output and lse: each element of the output and
    of the gradients within ``flash_attention_bound`` and
    ``flash_attention_bwd_bound``, bounds built from that element's own
    terms (one bf16 ulp of each rounded weight or ds, the fp32 sums in
    another order, one ulp of the element); two calls bit-identical; each
    call one launch of each kernel."""
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(Tq + D + 2)
    q, do = (torch.randn((B, Tq, H, D), generator=g, device=device)
             for _ in range(2))
    k = torch.randn((B, Tk, H, D), generator=g, device=device)
    v = 2 * torch.rand((B, Tk, H, D), generator=g, device=device) - 1
    q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
    valid = None
    if not causal:
        lengths = torch.randint(1, Tk + 1, (B,), generator=g, device=device)
        lengths[0] = Tk
        valid = torch.arange(Tk, device=device)[None] < lengths[:, None]
    before = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    out, lse = fa.flash_attention_cuda(q, k, v, valid, causal, D ** -0.5,
                                      return_lse=True)
    again = fa.flash_attention_cuda(q, k, v, valid, causal, D ** -0.5)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, valid, causal)
    got_again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, valid,
                                            causal)
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    want = fa.flash_attention_plain(q, k, v, valid, causal,
                                    round_weights=True)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, valid,
                                              causal, round_weights=True)
    bound = fa.flash_attention_bound(q, k, v, valid, causal)
    bounds = fa.flash_attention_bwd_bound(q, k, v, out, lse, do, valid,
                                          causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    assert torch.all((out.float() - want.float()).abs() <= bound)
    for a, b, w, wb in zip(got, got_again, want_grads, bounds):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert torch.all((a.float() - w.float()).abs() <= wb)


def test_flash_kernels_refuse_misaligned_bf16(device):
    """The bf16 kernels copy 16 bytes at a time: a contiguous bf16 view
    that does not start on a 16-byte boundary is refused."""
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    n = 2 * 8 * 2 * 64
    q = torch.randn(n + 1, device=device).bfloat16()[1:].view(2, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dropout_kernel_matches_plain(device, dtype):
    from openseq2seq_tpu_torch.ops import fused_dropout as fd
    g = torch.Generator(device=device).manual_seed(0)
    x, y, cot = (torch.randn((600, 256), generator=g, device=device)
                 .to(dtype) for _ in range(3))
    seed = fd.draw_seed(g, device)
    leaves = [t.clone().requires_grad_() for t in (x, y)]
    before = fd.LAUNCHES
    out = fd.fused_dropout_add(leaves[0], leaves[1], 0.3, seed)
    out.backward(cot)
    assert fd.LAUNCHES == before + 2
    assert torch.equal(out, fd.fused_dropout_add_plain(x, y, 0.3, seed))
    assert torch.equal(leaves[1].grad, fd.fused_dropout_plain(cot, 0.3, seed))
    assert torch.equal(leaves[0].grad, cot)
    with pytest.raises(ValueError):
        fd.fused_dropout_cuda(y[:, :100].contiguous(), None, 0.3, seed)


def _scan_inputs(device, cell, B, T, H, seed):
    G = 4 if cell == "lstm" else 3
    g = torch.Generator(device=device).manual_seed(seed)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    lengths[0], lengths[1] = T, 1
    return (torch.randn((B, T, G * H), generator=g, device=device),
            torch.randn((H, G * H), generator=g, device=device) / H ** 0.5,
            0.3 * torch.randn((G * H,), generator=g, device=device),
            0.5 * torch.randn((B, H), generator=g, device=device),
            torch.randn((B, H), generator=g, device=device), lengths.int())


def _scan(cell, x, wh, bh, h0, c0, lengths, reverse, plain=False):
    """The flat outputs of the GRU or LSTM scan (kernel or plain), with
    the residuals."""
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    if cell == "gru":
        fn = gru_scan.gru_scan_plain if plain else gru_scan.gru_scan
        ys, h, res = fn(x, wh, bh, h0, lengths, reverse, True)
        return [ys, h, *res]
    fn = lstm_scan.lstm_scan_plain if plain else lstm_scan.lstm_scan
    ys, (h, c), res = fn(x, wh, h0, c0, lengths, 1.0, reverse, True)
    return [ys, h, c, *res]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell,B,T,H", [
    ("gru", 8, 37, 128), ("gru", 4, 120, 1024), ("lstm", 8, 37, 128),
    ("lstm", 4, 120, 512), ("lstm", 40, 9, 256)])
def test_scan_kernels_match_plain(device, cell, B, T, H, reverse):
    """fp32 with TF32 off, max abs error 1e-5 (sums in another order);
    bf16 within 3 bf16 ulps of max(1, |value|), mean 1e-3 (a flipped
    rounding of the carried h is carried on); ys zero past each length;
    one launch per call; two calls bit-identical."""
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    kernel = gru_scan if cell == "gru" else lstm_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    x, wh, bh, h0, c0, lengths = _scan_inputs(device, cell, B, T, H, T + H)
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), wh, bh, h0.to(dtype), c0, lengths, reverse)
        before = kernel.LAUNCHES
        got = _scan(cell, *args)
        assert kernel.LAUNCHES == before + 1
        again = _scan(cell, *args)
        want = _scan(cell, *args, plain=True)
        torch.cuda.synchronize()
        live = torch.arange(T, device=device)[None] < lengths[:, None]
        assert not got[0][~live].any()
        for a, b, w in zip(got, again, want):
            assert torch.equal(a, b) and a.dtype == w.dtype
            err = (a.float() - w.float()).abs()
            if dtype == torch.float32:
                assert float(err.max()) <= 1e-5
            else:
                rel = err / w.float().abs().clamp(min=1.0)
                assert float(rel.max()) <= 3 * 2.0 ** -7
                assert float(rel.mean()) <= 1e-3


def test_scan_kernels_refuse_what_they_do_not_take(device):
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    x, wh, bh, h0, c0, lengths = _scan_inputs(device, "gru", 8, 9, 128, 0)
    for bad in ((x.half(), wh, bh, h0, lengths),
                (x[..., :288].contiguous(), wh[:96, :288].contiguous(),
                 bh[:288].contiguous(), h0[:, :96].contiguous(), lengths),
                (x, wh, bh, h0, lengths.cpu()), (x, wh, bh, h0[:4], lengths),
                (x, wh, bh[:10], h0, lengths)):
        with pytest.raises(ValueError):
            gru_scan.gru_scan(*bad)
    x, wh, _, h0, c0, lengths = _scan_inputs(device, "lstm", 8, 9, 128, 0)
    with pytest.raises(ValueError):
        lstm_scan.lstm_scan(x, wh, h0, c0[:4], lengths)
    # the fp32 LSTM at H = 1280, whose fp32 copy of W_h passes a CTA's
    # shared memory, forward and backward: refused before any launch
    x, wh, _, h0, c0, lengths = _scan_inputs(device, "lstm", 4, 3, 1280, 0)
    before = (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="1280"):
        lstm_scan.lstm_scan(x, wh, h0, c0, lengths)
    with pytest.raises(ValueError, match="1280"):
        lstm_scan._bwd_cuda(wh, c0, lengths, x, x[..., :1280].contiguous(),
                            x[..., :1280].contiguous(), h0, c0, False)
    torch.cuda.synchronize()
    assert (lstm_scan.LAUNCHES, lstm_scan.BWD_LAUNCHES) == before


def _scan_bwd(cell, x, wh, bh, h0, c0, lengths, dys, dh, dc, reverse,
              plain=False):
    """The forward kernel with its residuals, then the backward kernel
    (or its plain version) on them: the flat (dx_proj, dh0[, dc0])."""
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    if cell == "gru":
        ys, _, (acts, hn) = gru_scan.gru_scan(x, wh, bh, h0, lengths,
                                              reverse, True)
        fn = gru_scan.gru_scan_bwd_plain if plain else gru_scan._bwd_cuda
        return list(fn(wh, h0, lengths, ys, acts, hn, dys, dh, reverse))
    _, _, (acts, cs) = lstm_scan.lstm_scan(x, wh, h0, c0, lengths, 1.0,
                                           reverse, True)
    fn = lstm_scan.lstm_scan_bwd_plain if plain else lstm_scan._bwd_cuda
    return list(fn(wh, c0, lengths, acts, cs, dys, dh, dc, reverse))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell,B,T,H", [
    ("gru", 8, 37, 128), ("gru", 4, 120, 1024), ("lstm", 8, 37, 128),
    ("lstm", 4, 120, 512), ("lstm", 40, 9, 256)])
def test_scan_backward_kernels_match_plain(device, cell, B, T, H, reverse):
    """The backward kernels on the forward kernel's residuals against
    their plain versions, h0 and c0 non-zero, the cotangent of ys
    non-zero past each length: fp32 (TF32 off) max abs error 1e-5, bf16
    within 3 bf16 ulps of max(1, |value|), mean 1e-3; dx_proj zero past
    each length; one launch per call; two calls bit-identical. Then
    autograd through both kernels on the card against the CPU's plain
    versions, fp32."""
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
    kernel = gru_scan if cell == "gru" else lstm_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    x, wh, bh, h0, c0, lengths = _scan_inputs(device, cell, B, T, H,
                                              T + H + 1)
    g = torch.Generator(device=device).manual_seed(T)
    dys, dh, dc = (torch.randn(shape, generator=g, device=device)
                   for shape in ((B, T, H), (B, H), (B, H)))
    live = torch.arange(T, device=device)[None] < lengths[:, None]
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), wh, bh, h0.to(dtype), c0, lengths,
                dys.to(dtype), dh.to(dtype), dc, reverse)
        before = kernel.BWD_LAUNCHES
        got = _scan_bwd(cell, *args)
        assert kernel.BWD_LAUNCHES == before + 1
        again = _scan_bwd(cell, *args)
        want = _scan_bwd(cell, *args, plain=True)
        torch.cuda.synchronize()
        assert not got[0][~live].any()
        for a, b, w in zip(got, again, want):
            assert torch.equal(a, b) and a.dtype == w.dtype
            err = (a.float() - w.float()).abs()
            if dtype == torch.float32:
                assert float(err.max()) <= 1e-5
            else:
                rel = err / w.float().abs().clamp(min=1.0)
                assert float(rel.max()) <= 3 * 2.0 ** -7
                assert float(rel.mean()) <= 1e-3
    grads = {}
    for dev in (device, torch.device("cpu")):
        leaves = [t.to(dev).clone().requires_grad_()
                  for t in ((x, wh, bh, h0) if cell == "gru"
                            else (x, wh, h0, c0))]
        if cell == "gru":
            ys, _ = gru_scan.gru_scan(*leaves, lengths.to(dev), reverse)
        else:
            ys, _ = lstm_scan.lstm_scan(*leaves, lengths.to(dev), 1.0,
                                        reverse)
        grads[dev.type] = torch.autograd.grad(ys, leaves, dys.to(dev))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell,B,T,H", [
    ("gru", 8, 37, 128), ("gru", 32, 60, 1024), ("lstm", 8, 37, 128),
    ("lstm", 32, 60, 512), ("lstm", 40, 9, 256), ("lstm", 4, 20, 1024),
    ("lstm", 40, 9, 1152), ("gru", 8, 20, 1280), ("lstm", 8, 20, 1280)])
def test_bf16_scan_kernels_within_one_step_bounds(device, cell, B, T, H,
                                                  reverse):
    """The bf16 scan kernels, forward and backward (both on the tensor
    cores in clusters of two; for the LSTM from H = 1024 each warp's slice
    of dg in two windows, at 1152 and 1280 in three parts each; at H =
    1280 the widest the kernels take), each step held from the kernel's
    own state within ``ops/scan_bounds``'s per-element bounds; the planted
    faults and controls refused (the output zeroed on all rows but row 1;
    one step without the recurrent product for one CTA's units: the
    forward's ys, the backward's carry with dx from it; the forward's h
    carried unrounded and the LSTM's c carried in bf16,
    ``scan_bounds.fwd_faults``; every backward carry rounded to bf16, at
    every width); two forward calls bit-identical; two
    backward calls bit-identical, carries and all, and their dx, dh0 (and
    dc0) bit-identical to the launch's without carries."""
    from openseq2seq_tpu_torch.ops import bounds as eb
    from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan, rnn_scan
    from openseq2seq_tpu_torch.ops import scan_bounds as sb
    x, wh, bh, h0, c0, lengths = _scan_inputs(device, cell, B, T, H, B + H)
    g = torch.Generator(device=device).manual_seed(H)
    dys, dh, dc = (torch.randn(shape, generator=g, device=device)
                   for shape in ((B, T, H), (B, H), (B, H)))
    bf = torch.bfloat16
    x, h0, dys, dh = x.to(bf), h0.to(bf), dys.to(bf), dh.to(bf)
    U = rnn_scan.units_per_cta(H)
    units = slice(U, 2 * U)
    if cell == "gru":
        ys, h_last, (acts, hn) = gru_scan.gru_scan(x, wh, bh, h0, lengths,
                                                   reverse, True)
        fwd = sb.gru_fwd_bounds(x, wh, bh, h0, lengths, ys, reverse)
        outs = {"ys": ys, "h_last": h_last, "acts": acts, "hn": hn}
        kw = dict(x_proj=x, wh=wh, bh=bh, h0=h0, lengths=lengths, ys=ys,
                  reverse=reverse)

        def bwd(carries=True):
            return gru_scan._bwd_cuda(wh, h0, lengths, ys, acts, hn, dys, dh,
                                      reverse, carries=carries)
        got = bwd()
        bwd_outs = dict(zip(("dx", "dh0", "carry"), got))
        bwd_kw = dict(wh=wh, h0=h0, lengths=lengths, ys=ys, acts=acts, hn=hn,
                      dys=dys, dh_last=dh, carries=got[2], reverse=reverse)
    else:
        ys, (h_last, c_last), (acts, cs) = lstm_scan.lstm_scan(
            x, wh, h0, c0, lengths, 1.0, reverse, True)
        fwd = sb.lstm_fwd_bounds(x, wh, h0, c0, lengths, ys, cs, 1.0,
                                 reverse)
        outs = {"ys": ys, "h_last": h_last, "c_last": c_last, "acts": acts,
                "cs": cs}
        kw = dict(x_proj=x, wh=wh, h0=h0, c0=c0, cs=cs, lengths=lengths,
                  ys=ys, reverse=reverse)

        def bwd(carries=True):
            return lstm_scan._bwd_cuda(wh, c0, lengths, acts, cs, dys, dh,
                                       dc, reverse, carries=carries)
        got = bwd()
        bwd_outs = dict(zip(("dx", "dh0", "dc0", "carry", "ccarry"), got))
        bwd_kw = dict(wh=wh, c0=c0, lengths=lengths, acts=acts, cs=cs,
                      dys=dys, dh_last=dh, dc_last=dc, carries=got[3],
                      ccarries=got[4], reverse=reverse)
    again, plain = bwd(), bwd(carries=False)
    fwd_again = _scan(cell, x, wh, bh, h0, c0, lengths, reverse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(fwd_again,
                                                 outs.values()))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert len(plain) == len(got) - (1 if cell == "gru" else 2)
    assert all(torch.equal(a, b) for a, b in zip(plain, got))
    bwd_kw["depth"] = sb.sum_depth(acts.shape[2] // H, H, bf)
    bounds = sb.bwd_bounds(cell, **bwd_kw)
    for readings in (eb.readings(outs, fwd), eb.readings(bwd_outs, bounds)):
        assert max(readings.values()) <= 1.0, readings
    faults = sb.fwd_faults(cell, T // 2, units, **kw)
    assert min(faults.values()) > 1.0, faults
    faults = sb.bwd_faults(cell, T // 2, units, got[0], **bwd_kw)
    assert min(faults.values()) > 1.0, faults


@pytest.mark.parametrize("cell,H", [("gru", 1024), ("lstm", 512),
                                    ("lstm", 1152), ("lstm", 1280)])
def test_bf16_scan_backward_resources(device, cell, H):
    """The bf16 backward's C entry reports the shared memory the launcher
    asks for and one CTA an SM, and the grid of H / U = 128 CTAs resident
    at once in clusters of two on an H100's 132 SMs; the fp32 backward's
    copy of W_h's rows fits but for the LSTM from H = 1152, which the
    wrapper then refuses; nothing is launched."""
    from openseq2seq_tpu_torch.ops import rnn_scan
    smem, ctas, resident = rnn_scan.resources(cell + "_scan_bwd", H)
    assert 200_000 < smem <= 227 * 1024 and ctas == 1
    assert resident >= 128
    _, ctas32, _ = rnn_scan.resources(cell + "_scan_bwd", H, bf16=False)
    assert (ctas32 == 0) == (cell == "lstm" and H >= 1152)


@pytest.mark.parametrize("cell,H", [("gru", 512), ("gru", 1024),
                                    ("gru", 1280), ("lstm", 512),
                                    ("lstm", 1024), ("lstm", 1280)])
def test_bf16_scan_forward_resources(device, cell, H):
    """The bf16 forward's C entry: its dynamic shared memory (its rooms
    for h and its partial sums) is less than the fp32 forward's, which
    holds an fp32 copy of W_h's columns (4 G H U bytes), and the grid of
    H / U = 128 CTAs is resident at once in clusters of two; the fp32
    forward at H = 1280 fits for the GRU and not for the LSTM, which the
    wrapper then refuses; nothing is launched."""
    from openseq2seq_tpu_torch.ops import rnn_scan
    G, U = (3 if cell == "gru" else 4), rnn_scan.units_per_cta(H)
    smem, ctas, resident = rnn_scan.resources(cell + "_scan_fwd", H)
    smem32, ctas32, _ = rnn_scan.resources(cell + "_scan_fwd", H,
                                           bf16=False)
    assert 0 < smem < smem32 and smem32 > 4 * G * H * U
    assert ctas >= 1 and resident >= 128
    assert (ctas32 == 0) == (cell == "lstm" and H == 1280)


def _relpos_inputs(device, B, H, T, Dh, D, seed):
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    g = torch.Generator(device=device).manual_seed(seed)
    q_u, q_w, k = (torch.randn((B, T, H, Dh), generator=g, device=device)
                   for _ in range(3))
    v = 2 * torch.rand((B, T, H, Dh), generator=g, device=device) - 1
    r_kernel = torch.randn((D, H, Dh), generator=g, device=device) / D ** 0.5
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    lengths[0], lengths[-1] = T, 0
    return fr._operands(q_u, q_w, k, r_kernel) + (v, lengths.int())


def _reading(got, want, bound):
    """The largest |got - want| / bound; an element whose bound is 0 must
    match exactly."""
    err = (got.float() - want.float()).abs()
    return float(torch.where(err > 0, err / bound, 0.0).max())


def _zero_but_row_1(x):
    bad = x.clone()
    bad[:1] = 0
    bad[2:] = 0
    return bad


RELPOS_SHAPES = [(4, 4, 250, 64, 256), (2, 8, 130, 64, 512),
                 (3, 4, 37, 32, 128)]


@pytest.mark.parametrize("B,H,T,Dh,D", RELPOS_SHAPES)
def test_relpos_kernel_matches_plain(device, B, H, T, Dh, D):
    """The rel-pos flash kernel (B5) against its plain version on the same
    folded inputs, lengths from 0 (clamped to 1) to T: fp32 context max
    abs error 2e-5, lse 1e-5 (sums in another order); bf16 each element
    within ``relpos_attention_bound`` of the plain version, which rounds
    the weights as the kernel does (against the running maximum of
    128-key blocks), lse within 1e-5 of max(1, |lse|); one launch a call;
    two calls bit-identical."""
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    case = _relpos_inputs(device, B, H, T, Dh, D, T + D)
    for dtype in (torch.float32, torch.bfloat16):
        args = tuple(x.to(dtype) for x in case[:5]) + (case[5], Dh ** -0.5)
        before = fr.LAUNCHES
        got, lse = fr.relpos_attention(*args, return_lse=True)
        again = fr.relpos_attention(*args)
        assert fr.LAUNCHES == before + 2
        want, want_lse = fr.relpos_attention_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
            torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
            continue
        bound = fr.relpos_attention_bound(*args)
        assert _reading(got, want, bound) <= 1.0
        assert float(((lse - want_lse).abs() /
                      want_lse.abs().clamp(min=1.0)).max()) <= 1e-5


def test_relpos_kernel_refuses_what_it_does_not_take(device):
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    qu, qp, k, kp, v, lengths = _relpos_inputs(device, 2, 2, 8, 32, 128, 0)
    for bad in ((qu.half(), qp.half(), k.half(), kp.half(), v.half(),
                 lengths),
                (qu[..., :16].contiguous(), qp, k[..., :16].contiguous(), kp,
                 v[..., :16].contiguous(), lengths),
                (qu.transpose(1, 2), qp, k, kp, v, lengths),
                (qu, qp, k, kp, v, lengths.long())):
        with pytest.raises(ValueError):
            fr.relpos_attention_cuda(*bad, 0.25)
    # the backward is ported: an input that needs a gradient launches
    before = fr.LAUNCHES
    fr.relpos_attention_cuda(qu.requires_grad_(), qp, k, kp, v, lengths,
                             0.25)
    assert fr.LAUNCHES == before + 1
    o, lse = fr.relpos_attention_cuda(qu.detach(), qp, k, kp, v, lengths,
                                      0.25, return_lse=True)
    for bad in ((o.bfloat16(), lse, o), (o, lse.double(), o),
                (o, lse, o.transpose(1, 2))):
        with pytest.raises(ValueError):
            fr.relpos_attention_bwd_cuda(qu.detach(), qp, k, kp, v, lengths,
                                         *bad, 0.25)


@pytest.mark.parametrize("B,T,D,k", [
    (4, 250, 256, 31), (2, 130, 512, 31), (5, 37, 128, 7)])
def test_conformer_conv_kernel_matches_plain(device, B, T, D, k):
    """The conv module kernel (B6) against its plain version, a
    zero-length row: fp32 (TF32 off) max abs error 1e-4; bf16 its u and
    y element by element within ``conformer_conv_module_bounds`` (y from
    the kernel's own u), and the planted faults of ``fwd_faults`` (y
    zeroed on all rows but row 1, a tile's y from u without its halo)
    refused; one launch a call; two calls bit-identical, and in bf16 y
    bit-identical with u written out and with every other tile of frames
    that fits (other tile edges: a halo frame's u is its owner's)."""
    from openseq2seq_tpu_torch.ops import conformer_conv as cc
    from openseq2seq_tpu_torch.ops import bounds as eb
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(T + k)

    def randn(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(shape, generator=g,
                                            device=device)

    x = randn(B, T, D)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    lengths[0], lengths[-1] = T, 0
    weights = (randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1),
               randn(D, 2 * D, scale=D ** -0.5), randn(2 * D, scale=0.1),
               randn(k, D, scale=k ** -0.5), randn(D, scale=0.1),
               randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1),
               randn(D, D, scale=D ** -0.5), randn(D, scale=0.1))
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), lengths.int()) + weights
        before = cc.LAUNCHES
        got = cc.conformer_conv_module(*args)
        again = cc.conformer_conv_module(*args)
        assert cc.LAUNCHES == before + 2
        want = cc.conformer_conv_module_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and got.dtype == dtype
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-4
        else:
            y, inter = cc.conformer_conv_module_cuda(*args,
                                                     intermediates=True)
            bounds = cc.conformer_conv_module_bounds(args[0], lengths.int(),
                                                     inter["u"], *weights)
            assert torch.equal(y, got)
            readings = eb.readings(dict(inter, y=y), bounds)
            assert max(readings.values()) <= 1.0, readings
            tile = cc.fwd_resources(D, k)[0]
            faults = cc.fwd_faults(bounds, inter["u"], y, weights, tile)
            assert min(faults.values()) > 1.0, faults
            for t in (64, 32, 16):
                if t != tile and cc.fwd_resources(D, k, t)[2] > 0:
                    yt, it = cc.conformer_conv_module_cuda(
                        *args, intermediates=True, tile=t)
                    assert torch.equal(yt, y) and \
                        torch.equal(it["u"], inter["u"]), t


def test_conformer_conv_resources_and_refusals(device):
    """The bf16 conv module kernels' resources, from their C entries,
    nothing launched: every launch fits an SM at the widths and tap
    counts the kernels take, with 64 frames a CTA at Conformer-M's shape;
    a tile that does not fit is refused with ValueError before any
    launch, forward and backward."""
    from openseq2seq_tpu_torch.ops import conformer_conv as cc
    assert cc.fwd_resources(256, 31)[0] == 64
    assert [r[0] for r in cc.bwd_resources(256, 31)] == [64, 64, 64, 128]
    for D, k in ((64, 1), (256, 63), (512, 31), (512, 63)):
        assert cc.fwd_resources(D, k)[2] >= 1, (D, k)
        assert all(r[2] >= 1 for r in cc.bwd_resources(D, k)), (D, k)
    x, lengths, weights, dy = _conv_inputs(device, 2, 40, 512, 63, 0)
    args = (x.bfloat16(), lengths) + weights
    before = cc.LAUNCHES, cc.BWD_LAUNCHES
    with pytest.raises(ValueError):
        cc.conformer_conv_module_cuda(*args, tile=64)
    with pytest.raises(ValueError):
        cc.conformer_conv_module_cuda_bwd(*args, dy.bfloat16(), tile=64)
    assert (cc.LAUNCHES, cc.BWD_LAUNCHES) == before


@pytest.mark.parametrize("B,H,T,Dh,D", RELPOS_SHAPES)
def test_relpos_backward_kernels_match_plain(device, B, H, T, Dh, D):
    """The rel-pos backward kernels (B5 dq and dkv) against their plain
    version on the same inputs, from the forward kernel's own output and
    lse, lengths from 0 (clamped to 1) to T: fp32 (TF32 off) max abs
    error 1e-4; bf16 each element within ``relpos_attention_bwd_bound``
    (both round p and ds to bf16, from fp32 sums in another order); one
    launch of each a call; two calls bit-identical."""
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    torch.backends.cuda.matmul.allow_tf32 = False
    case = _relpos_inputs(device, B, H, T, Dh, D, T + D + 1)
    g = torch.Generator(device=device).manual_seed(T)
    do = torch.randn((B, T, H, Dh), generator=g, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        args = tuple(x.to(dtype) for x in case[:5]) + (case[5],)
        o, lse = fr.relpos_attention_cuda(*args, Dh ** -0.5, return_lse=True)
        bwd = args + (o, lse, do.to(dtype), Dh ** -0.5)
        before = fr.BWD_DQ_LAUNCHES, fr.BWD_DKV_LAUNCHES
        got = fr.relpos_attention_bwd_cuda(*bwd)
        again = fr.relpos_attention_bwd_cuda(*bwd)
        assert (fr.BWD_DQ_LAUNCHES, fr.BWD_DKV_LAUNCHES) == \
            (before[0] + 2, before[1] + 2)
        want = fr.relpos_attention_bwd_plain(*bwd)
        bounds = fr.relpos_attention_bwd_bound(*bwd) \
            if dtype == torch.bfloat16 else [None] * 4
        torch.cuda.synchronize()
        for a, b, w, bound in zip(got, again, want, bounds):
            assert torch.equal(a, b) and a.dtype == dtype
            if bound is None:
                assert float((a - w).abs().max()) <= 1e-4
            else:
                assert _reading(a, w, bound) <= 1.0


def test_bf16_relpos_bounds_refuse_planted_faults(device):
    """The element-wise bounds the bf16 kernels are held to refuse a
    wrong kernel: the context, or dv, zeroed on every batch row but row 1
    (one valid key) reads far above 1 at Conformer-M's width."""
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    B, H, T, Dh, D = 4, 4, 250, 64, 256
    case = _relpos_inputs(device, B, H, T, Dh, D, 3)
    args = tuple(x.bfloat16() for x in case[:5]) + (case[5],)
    o, lse = fr.relpos_attention_cuda(*args, Dh ** -0.5, return_lse=True)
    do = torch.randn((B, T, H, Dh), device=device).bfloat16()
    bwd = args + (o, lse, do, Dh ** -0.5)
    dv = fr.relpos_attention_bwd_cuda(*bwd)[3]
    torch.cuda.synchronize()
    assert _reading(_zero_but_row_1(o), o,
                    fr.relpos_attention_bound(*args, Dh ** -0.5)) > 10
    assert _reading(_zero_but_row_1(dv), dv,
                    fr.relpos_attention_bwd_bound(*bwd)[3]) > 10


def test_relpos_autograd_through_the_kernels(device):
    """``rel_flash_attention`` under autograd on the card (the forward and
    backward kernels, then the fold's backward) against the CPU's plain
    versions, fp32 (TF32 off): the five gradients within rtol 1e-4, atol
    1e-5 (dK_r sums over B x T)."""
    from openseq2seq_tpu_torch.ops import flash_relpos as fr
    torch.backends.cuda.matmul.allow_tf32 = False
    B, T, H, Dh, D = 3, 70, 4, 32, 128
    rng = np.random.RandomState(5)
    host = [torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in [(B, T, H, Dh)] * 4 + [(D, H, Dh)]]
    host[4] /= D ** 0.5
    lengths = torch.tensor([T, 1, 33], dtype=torch.int32)
    do = torch.from_numpy(rng.randn(B, T, H, Dh).astype(np.float32))
    grads = {}
    for dev in (device, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_() for x in host]
        before = fr.BWD_DQ_LAUNCHES
        fr.rel_flash_attention(*leaves, lengths.to(dev), Dh ** -0.5) \
            .backward(do.to(dev))
        assert fr.BWD_DQ_LAUNCHES == before + (dev.type == "cuda")
        grads[dev.type] = [x.grad for x in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def _conv_inputs(device, B, T, D, k, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(shape, generator=g,
                                            device=device)

    x = randn(B, T, D)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=device)
    lengths[0], lengths[-1] = T, 0
    weights = (randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1),
               randn(D, 2 * D, scale=D ** -0.5), randn(2 * D, scale=0.1),
               randn(k, D, scale=k ** -0.5), randn(D, scale=0.1),
               randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1),
               randn(D, D, scale=D ** -0.5), randn(D, scale=0.1))
    return x, lengths.int(), weights, randn(B, T, D)


@pytest.mark.parametrize("B,T,D,k", [
    (4, 250, 256, 31), (2, 130, 512, 31), (5, 37, 128, 7)])
def test_conformer_conv_backward_kernels_match_plain(device, B, T, D, k):
    """The conv module's backward kernels (B6) against their plain version
    on the same inputs, a zero-length row: dx and the ten weight gradients
    within 1e-5 of max(1, |gradient|) in fp32 (TF32 off; sums over B x T
    rows in another order); in bf16 the kernels' intermediates, dx and the
    ten weight gradients element by element within
    ``conformer_conv_module_bwd_bounds`` (each from the kernels' own
    intermediates, db1 and dwd at the kernels' summation depth), and the
    planted faults of ``bwd_faults`` refused; one call counted; two calls
    bit-identical; in bf16 the gradients bit-identical with the
    intermediates written out, the second launch's recompute of a the
    first's bits, and with every other tile of frames that fits the
    intermediates, dx, dw1 and dw2 bit-identical (the sums over frames
    take another order)."""
    from openseq2seq_tpu_torch.ops import conformer_conv as cc
    from openseq2seq_tpu_torch.ops import bounds as eb
    torch.backends.cuda.matmul.allow_tf32 = False
    x, lengths, weights, dy = _conv_inputs(device, B, T, D, k, T + k + 1)
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), lengths) + weights + (dy.to(dtype),)
        before = cc.BWD_LAUNCHES
        got = cc.conformer_conv_module_cuda_bwd(*args)
        again = cc.conformer_conv_module_cuda_bwd(*args)
        assert cc.BWD_LAUNCHES == before + 2
        want = cc.conformer_conv_module_bwd_plain(*args)
        torch.cuda.synchronize()
        for i, (a, b, w) in enumerate(zip(got, again, want)):
            assert torch.equal(a, b) and a.dtype == w.dtype
            rel = float((a.float() - w.float()).abs().max()) / \
                max(1.0, float(w.float().abs().max()))
            if dtype == torch.float32:
                assert rel <= 1e-5, (i, rel)
        if dtype == torch.bfloat16:
            grads, inter = cc.conformer_conv_module_cuda_bwd(
                *args, intermediates=True)
            assert all(torch.equal(a, b) for a, b in zip(grads, got))
            assert torch.equal(inter["a again"], inter["a"])
            tile = cc.bwd_resources(D, k)[1][0]
            bounds = cc.conformer_conv_module_bwd_bounds(
                args[0], lengths, inter, *weights, args[-1],
                depth=cc.sum_depth(B, T, tile))
            readings = eb.readings(dict(inter, **dict(zip(cc.GRADS, grads))),
                                   bounds)
            assert max(readings.values()) <= 1.0, readings
            faults = cc.bwd_faults(bounds, lengths, inter, grads, weights[4],
                                   tile)
            assert min(faults.values()) > 1.0, faults
            for t in (64, 32, 16):
                if all(r[0] == t or j > 1 for j, r in enumerate(
                        cc.bwd_resources(D, k))) or not all(
                            r[2] > 0 for r in cc.bwd_resources(D, k, t)):
                    continue
                gt, it = cc.conformer_conv_module_cuda_bwd(
                    *args, intermediates=True, tile=t)
                assert all(torch.equal(it[n], inter[n]) for n in inter), t
                assert all(torch.equal(gt[i], grads[i]) for i in (0, 3, 9))


def test_conformer_conv_autograd_through_the_kernels(device):
    """``conformer_conv_module`` under autograd on the card (the forward
    and backward kernels) against the CPU's plain versions, fp32 (TF32
    off): dx and the ten weight gradients within rtol 1e-4, atol 1e-5."""
    from openseq2seq_tpu_torch.ops import conformer_conv as cc
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = torch.device("cpu")
    x, lengths, weights, dy = _conv_inputs(cpu, 3, 45, 128, 7, 9)
    grads = {}
    for dev in (device, cpu):
        leaves = [t.to(dev).requires_grad_() for t in (x,) + weights]
        before = cc.BWD_LAUNCHES
        cc.conformer_conv_module(leaves[0], lengths.to(dev),
                                 *leaves[1:]).backward(dy.to(dev))
        assert cc.BWD_LAUNCHES == before + (dev.type == "cuda")
        grads[dev.type] = [t.grad for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_flash_custom_op_launches_the_kernel(device):
    """The flash forward's custom op on the card: ``torch.library.opcheck``,
    one launch a call, the kernel's bits (bf16, padded keys)."""
    from openseq2seq_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((4, 33, 2, 64), generator=g, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    valid = torch.arange(33, device=device)[None] < torch.tensor(
        [[33], [20], [1], [7]], device=device)
    result = torch.library.opcheck(fa.flash_attn_fwd,
                                   (q, k, v, valid, False, 0.125))
    assert set(result.values()) == {"SUCCESS"}, result
    before = fa.LAUNCHES
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, valid, False, 0.125)
    assert fa.LAUNCHES == before + 1
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, valid, False,
                                                    0.125))


@pytest.mark.parametrize("M,K,N", [(3, 40, 29), (4096, 512, 1536)])
def test_int8_product_exact(device, M, K, N):
    """``int8_exec.int_mm`` (``torch._int_mm``, the operands padded to its
    shapes) gives the exact integer sums, and an int8 layer equals its
    float64 plain version bit for bit."""
    from types import SimpleNamespace

    from openseq2seq_tpu_torch.serving import int8_exec
    g = torch.Generator(device=device).manual_seed(M)
    a, b = (torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8) for shape in ((M, K), (N, K)))
    assert torch.equal(int8_exec.int_mm(a, b).double(),
                       a.double() @ b.double().t())
    layer = SimpleNamespace(
        weight=torch.randn((N, K), generator=g, device=device),
        bias=torch.randn((N,), generator=g, device=device))
    x = torch.randn((M, K), generator=g, device=device).bfloat16()
    absmax = 0.8 * float(x.float().abs().max())
    got = int8_exec.int8_dense(layer, x, absmax)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, int8_exec.int8_dense_plain(layer, x, absmax))
