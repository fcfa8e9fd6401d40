"""The bf16 scan backward's carry check at the widths of the LSTM language
model, on the kernels' plain versions on the CPU.

Given a kernel's summation depth (``depth``), ``ops/scan_bounds.bwd_bounds``
holds each dh carry within a bound whose summation term counts the
additions a term of dg W_h^T passes through in the backward kernel's own
order (``scan_bounds.sum_depth``), not G H of them. So at G H 4096 (the
LSTM at H 1024) a backward that carried its dh rounded to bf16 ("bf16
carry") is refused as it is at the narrower widths. The plain version,
which sums in another order (the BLAS's), is held to the bound of any
order (G H additions) and reads at most 1 there; every other planted
fault of ``bwd_faults`` reads above 1 at G H 2048, 3072 and 4096.

Inputs from numpy with fixed seeds, B 8, T 16 to 24."""
import numpy as np
import pytest
import torch

from openseq2seq_tpu_torch.ops import bounds as eb
from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan, rnn_scan
from openseq2seq_tpu_torch.ops import scan_bounds as sb

BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The fp64 recomputes on one thread: the suite runs several workers
    on the machine's cores, and torch's threads in each would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _backward(cell, H, B, T, seed, reverse=False):
    """The bf16 plain forward (residuals) and backward (carries) on seeded
    inputs: the backward's outputs and the bound function's keyword
    arguments."""
    G = 3 if cell == "gru" else 4
    rng = np.random.RandomState(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32))
    lengths = rng.randint(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[1] = T, 1
    lengths = torch.from_numpy(lengths)
    x, wh = randn(B, T, G * H).to(BF), randn(H, G * H) / H ** 0.5
    h0, dys, dh = (randn(B, H, scale=0.5).to(BF), randn(B, T, H).to(BF),
                   randn(B, H).to(BF))
    if cell == "gru":
        bh = randn(G * H, scale=0.3)
        ys, _, (acts, hn) = gru_scan.gru_scan_plain(x, wh, bh, h0, lengths,
                                                    reverse, True)
        dx, dh0, carries = gru_scan.gru_scan_bwd_plain(
            wh, h0, lengths, ys, acts, hn, dys, dh, reverse, carries=True)
        return (dict(dx=dx, dh0=dh0, carry=carries),
                dict(wh=wh, h0=h0, lengths=lengths, ys=ys, acts=acts, hn=hn,
                     dys=dys, dh_last=dh, carries=carries, reverse=reverse))
    c0, dc = randn(B, H), randn(B, H)
    _, _, (acts, cs) = lstm_scan.lstm_scan_plain(x, wh, h0, c0, lengths, 1.0,
                                                 reverse, True)
    dx, dh0, dc0, carries, ccarries = lstm_scan.lstm_scan_bwd_plain(
        wh, c0, lengths, acts, cs, dys, dh, dc, reverse, carries=True)
    return (dict(dx=dx, dh0=dh0, dc0=dc0, carry=carries, ccarry=ccarries),
            dict(wh=wh, c0=c0, lengths=lengths, acts=acts, cs=cs, dys=dys,
                 dh_last=dh, dc_last=dc, carries=carries, ccarries=ccarries,
                 reverse=reverse))


def test_sum_depth_is_the_kernels():
    """The bf16 kernel's depth: 32 for a term's own k16 step of mma, 17
    for each of the warp's G U - 1 others (U = H / 128), 8 warps; the
    fp32 kernel's: G H / 8 FMAs a warp, 8 warps. Both below G H at the
    LM's width."""
    assert sb.sum_depth(4, 1024, BF) == 32 + 17 * (4 * 8 - 1) + 8
    assert sb.sum_depth(3, 1024, BF) == 32 + 17 * (3 * 8 - 1) + 8
    assert sb.sum_depth(4, 128, BF) == 32 + 17 * 3 + 8
    assert sb.sum_depth(4, 1024, torch.float32) == 4 * 1024 // 8 + 8
    assert sb.sum_depth(4, 1024, BF) < 4 * 1024 // 7


@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_carry_refused_at_the_lm_width(reverse):
    """At G H 4096 (LSTM, H 1024, B 8, T 16): the plain version's
    backward within every bound of any order (reading at most 1), and,
    at the kernel's depth, every dh carry rounded to bf16 read above 1,
    with the other planted faults."""
    outs, kw = _backward("lstm", 1024, 8, 16, 5 + reverse, reverse)
    readings = eb.readings(outs, sb.bwd_bounds("lstm", **kw))
    assert max(readings.values()) <= 1.0, readings
    U = rnn_scan.units_per_cta(1024)
    faults = sb.bwd_faults("lstm", 8, slice(U, 2 * U), outs["dx"],
                           depth=sb.sum_depth(4, 1024, BF), **kw)
    assert set(faults) == {"rows zeroed", "product left out", "bf16 carry"}
    assert min(faults.values()) > 1.0, faults


@pytest.mark.parametrize("cell,H", [("lstm", 512), ("gru", 1024),
                                    ("lstm", 1024)])
def test_every_backward_fault_refused(cell, H):
    """At G H 2048 (LSTM, H 512), 3072 (GRU, H 1024) and 4096 (LSTM,
    H 1024): the plain version within the bounds, and every planted fault
    of ``bwd_faults`` above 1 at the kernel's depth, "bf16 carry" among
    them."""
    outs, kw = _backward(cell, H, 8, 24, 23)
    readings = eb.readings(outs, sb.bwd_bounds(cell, **kw))
    assert max(readings.values()) <= 1.0, readings
    U = rnn_scan.units_per_cta(H)
    G = 3 if cell == "gru" else 4
    faults = sb.bwd_faults(cell, 12, slice(2 * U, 3 * U), outs["dx"],
                           depth=sb.sum_depth(G, H, BF), **kw)
    assert "bf16 carry" in faults
    assert min(faults.values()) > 1.0, faults
