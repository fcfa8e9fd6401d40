"""The per-element bounds that hold the bf16 scan kernels (B3, B4) and the
conv module kernels (B6) on the card, checked here on the CPU against the
kernels' plain versions, which compute the same function in fp32 with
the same roundings to bf16.

- ``ops/scan_bounds``: each step of the bf16 ``gru_scan_plain``,
  ``lstm_scan_plain`` and their backward versions, recomputed in fp64
  from the state the plain version carried into it (its ys and cs; its
  fp32 carries), lies within the step's bounds (reading at most 1), and
  the planted faults read above 1: the output zeroed on every batch row
  but row 1; one step without the recurrent product for one CTA's block
  of units (the forward's ys; the backward's carry into the step, with
  dx recomputed from it, which dx's bound alone cannot see); the forward
  run with h carried unrounded, and the LSTM's with c carried in bf16
  (the rounded outputs are held exactly: each a rounding of a value
  within the recompute's error); every backward carry rounded to bf16;
  at B 64, two tiles of 32 rows a step, a step whose second tile takes
  the first tile's h (forward) or dh carry (backward).
- ``conformer_conv_module_bounds`` and ``conformer_conv_module_bwd_bounds``:
  each stage of the bf16 ``conformer_conv_module_plain`` and its backward,
  from the plain version's own intermediates (those the kernels keep),
  within its bounds; y or dx zeroed on every batch row but row 1 reads
  above 1, and so does each fault a tiled design could commit
  (``fwd_faults``, ``bwd_faults``): a tile's y from u without its halo,
  a CTA's partial left out of dw1 or of dwd, db1 summed from bf16 da.

Inputs from numpy with fixed seeds, B <= 8 (64 for the tiles), T <= 40,
H = 128 (the conv
module's D 128 and 256)."""
import numpy as np
import pytest
import torch

from openseq2seq_tpu_torch.ops import bounds as eb
from openseq2seq_tpu_torch.ops import conformer_conv as cc
from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan, rnn_scan
from openseq2seq_tpu_torch.ops import scan_bounds as sb
from test_torch_text_data import one_thread  # noqa: F401

BF = torch.bfloat16


def _scan_case(cell, seed, B=8, T=37, H=128):
    G = 3 if cell == "gru" else 4
    rng = np.random.RandomState(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32))
    lengths = rng.randint(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[1] = T, 1
    return {"x": randn(B, T, G * H).to(BF), "wh": randn(H, G * H) / H ** 0.5,
            "bh": randn(G * H, scale=0.3), "h0": randn(B, H, scale=0.5).to(BF),
            "c0": randn(B, H), "lengths": torch.from_numpy(lengths),
            "dys": randn(B, T, H).to(BF), "dh": randn(B, H).to(BF),
            "dc": randn(B, H)}


def _scan_run(cell, c, reverse):
    """The plain versions forward and backward (with their carries): the
    outputs and bounds of each, and the planted faults' keyword
    arguments (the backward's: the bound function's)."""
    if cell == "gru":
        ys, h_last, (acts, hn) = gru_scan.gru_scan_plain(
            c["x"], c["wh"], c["bh"], c["h0"], c["lengths"], reverse, True)
        fwd = (dict(ys=ys, h_last=h_last, acts=acts, hn=hn),
               sb.gru_fwd_bounds(c["x"], c["wh"], c["bh"], c["h0"],
                                 c["lengths"], ys, reverse),
               dict(x_proj=c["x"], wh=c["wh"], bh=c["bh"], h0=c["h0"],
                    lengths=c["lengths"], ys=ys, reverse=reverse))
        dx, dh0, carries = gru_scan.gru_scan_bwd_plain(
            c["wh"], c["h0"], c["lengths"], ys, acts, hn, c["dys"], c["dh"],
            reverse, carries=True)
        kw = dict(wh=c["wh"], h0=c["h0"], lengths=c["lengths"], ys=ys,
                  acts=acts, hn=hn, dys=c["dys"], dh_last=c["dh"],
                  carries=carries, reverse=reverse)
        bwd = (dict(dx=dx, dh0=dh0, carry=carries),
               sb.gru_bwd_bounds(c["wh"], c["h0"], c["lengths"], ys, acts,
                                 hn, c["dys"], c["dh"], carries, reverse), kw)
        return fwd, bwd
    ys, (h_last, c_last), (acts, cs) = lstm_scan.lstm_scan_plain(
        c["x"], c["wh"], c["h0"], c["c0"], c["lengths"], 1.0, reverse, True)
    fwd = (dict(ys=ys, h_last=h_last, c_last=c_last, acts=acts, cs=cs),
           sb.lstm_fwd_bounds(c["x"], c["wh"], c["h0"], c["c0"],
                              c["lengths"], ys, cs, 1.0, reverse),
           dict(x_proj=c["x"], wh=c["wh"], h0=c["h0"], c0=c["c0"], cs=cs,
                lengths=c["lengths"], ys=ys, reverse=reverse))
    dx, dh0, dc0, carries, ccarries = lstm_scan.lstm_scan_bwd_plain(
        c["wh"], c["c0"], c["lengths"], acts, cs, c["dys"], c["dh"], c["dc"],
        reverse, carries=True)
    kw = dict(wh=c["wh"], c0=c["c0"], lengths=c["lengths"], acts=acts, cs=cs,
              dys=c["dys"], dh_last=c["dh"], dc_last=c["dc"],
              carries=carries, ccarries=ccarries, reverse=reverse)
    bwd = (dict(dx=dx, dh0=dh0, dc0=dc0, carry=carries, ccarry=ccarries),
           sb.bwd_bounds("lstm", **kw), kw)
    return fwd, bwd


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_bounds_hold_the_plain_versions(cell, reverse):
    """Every output element of every step of the bf16 plain versions,
    forward and backward, within its one-step bound of the fp64
    recompute; the last states exactly the last live step's."""
    (outs, bounds, _), (bouts, bbounds, _) = _scan_run(
        cell, _scan_case(cell, 3 + reverse), reverse)
    readings = eb.readings(outs, bounds)
    assert max(readings.values()) <= 1.0, readings
    assert readings["h_last"] == 0.0
    readings = eb.readings(bouts, bbounds)
    assert max(readings.values()) <= 1.0, readings


@pytest.mark.parametrize("way", ["fwd", "bwd"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_bounds_refuse_planted_faults(cell, way):
    """The output (ys, or dx) zeroed on every batch row but row 1 and one
    step without the recurrent product for the second CTA's units read
    far above 1; so does every backward carry rounded to bf16. The
    backward's product fault is a consistent kernel: its dx at that step
    follows from its carry and passes dx's bound, so that the carry's
    bound alone refuses it."""
    c = _scan_case(cell, 11)
    fwd, bwd = _scan_run(cell, c, False)
    U = rnn_scan.units_per_cta(128)
    units = slice(U, 2 * U)
    if way == "fwd":
        outs, bounds, kw = fwd
        bad = sb.drop_product(cell, 18, units, **kw)
        assert not torch.equal(bad, outs["ys"])
        assert eb.reading(eb.zero_but_row_1(outs["ys"]), *bounds["ys"]) > 10
        assert eb.reading(bad, *bounds["ys"]) > 10
        return
    outs, bounds, kw = bwd
    faults = sb.bwd_faults(cell, 18, units, outs["dx"], **kw)
    assert faults["rows zeroed"] > 10, faults
    assert faults["product left out"] > 10, faults
    assert faults["bf16 carry"] > 1, faults
    bad_dx, carries = sb.drop_product_bwd(cell, 18, units, outs["dx"], **kw)
    assert not torch.equal(carries, kw["carries"])
    assert not torch.equal(bad_dx, outs["dx"])
    bad = sb.bwd_bounds(cell, **dict(kw, carries=carries))
    assert eb.reading(bad_dx, *bad["dx"]) <= 1.0
    want, bound = bad["carry"]
    assert eb.reading(carries[:, 18], want[:, 18], bound[:, 18]) > 10


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_bounds_refuse_rows_from_another_tile(cell, reverse):
    """At B = 64, two tiles of 32 rows a step: the forward's step whose
    second tile of rows starts from the first tile's h, and the
    backward's whose second tile carries the first's dh into the step
    (dx recomputed from it), read above 1 among the faults of
    ``fwd_faults`` and ``bwd_faults``; at one tile (B = 8) neither fault
    is asked for. The plain versions themselves read at most 1."""
    c = _scan_case(cell, 17 + reverse, B=64, T=12)
    fwd, bwd = _scan_run(cell, c, reverse)
    (outs, bounds, kw), (bouts, bbounds, bkw) = fwd, bwd
    assert max(eb.readings(outs, bounds).values()) <= 1.0
    assert max(eb.readings(bouts, bbounds).values()) <= 1.0
    U = rnn_scan.units_per_cta(128)
    units = slice(U, 2 * U)
    rows, src = slice(32, 64), slice(0, 32)
    bad = sb.cross_tile(cell, 6, rows, src, **kw)
    changed = (bad != outs["ys"]).any(-1)
    assert changed[32:, 6].any() and not changed[:32].any() and \
        not changed[:, [5, 7]].any()
    faults = sb.fwd_faults(cell, 6, units, **kw)
    assert faults["rows from another tile"] > 10, faults
    bfaults = sb.bwd_faults(cell, 6, units, bouts["dx"], **bkw)
    assert bfaults["rows from another tile"] > 10, bfaults
    bad_dx, carries = sb.cross_tile_bwd(cell, 6, rows, src, bouts["dx"],
                                        **bkw)
    assert not torch.equal(carries[32:, 6], bkw["carries"][32:, 6])
    assert torch.equal(carries[:32], bkw["carries"][:32])
    bad = sb.bwd_bounds(cell, **dict(bkw, carries=carries))
    assert eb.reading(bad_dx, *bad["dx"]) <= 1.0
    one = _scan_case(cell, 19)
    (_, _, kw1), (bouts1, _, bkw1) = _scan_run(cell, one, reverse)
    assert "rows from another tile" not in sb.fwd_faults(cell, 6, units,
                                                          **kw1)
    assert "rows from another tile" not in sb.bwd_faults(
        cell, 6, units, bouts1["dx"], **bkw1)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_bounds_refuse_forward_controls(cell, reverse):
    """``scan_bounds.fwd_faults`` on the bf16 plain forward: besides ys
    zeroed but in row 1 and a step without the recurrent product, the
    forward run with h carried unrounded (fp32) while ys is written in
    bf16, and for the LSTM with c carried in bf16, read above 1 against
    the bounds from their own ys (and cs); the same run with the right
    carries (h in bf16, c in fp32) reads at most 1."""
    c = _scan_case(cell, 13 + reverse)
    (_, _, kw), _ = _scan_run(cell, c, reverse)
    U = rnn_scan.units_per_cta(128)
    faults = sb.fwd_faults(cell, 18, slice(U, 2 * U), **kw)
    names = {"rows zeroed", "product left out", "fp32 h carry"}
    assert set(faults) == names | ({"bf16 c carry"} if cell == "lstm"
                                   else set())
    assert min(faults.values()) > 1.0, faults
    ys, cs = sb.carried_run(cell, BF, **kw)
    right = dict(kw, ys=ys, **({"cs": cs} if cell == "lstm" else {}))
    bounds = sb.fwd_bounds(cell, **right)
    assert eb.reading(ys, *bounds["ys"]) <= 1.0
    if cell == "lstm":
        assert eb.reading(cs, *bounds["cs"]) <= 1.0
    # the rounded outputs are held exactly: ys moved by 2^-7 of itself (a
    # rounding or two) at one live element whose bound is 0 reads inf
    want, bound = bounds["ys"]
    i = tuple(torch.nonzero((bound == 0) & (want != 0))[0].tolist())
    bad = ys.clone()
    bad[i] = (ys[i].float() * (1 + 2.0 ** -7)).to(BF)
    assert bad[i] != ys[i]
    assert eb.reading(bad, *bounds["ys"]) == float("inf")


def test_plain_backward_carries():
    """The plain backward's carries: dh_last into the first step it
    visits, the same dx and dh0 with and without them."""
    c = _scan_case("gru", 5)
    ys, _, (acts, hn) = gru_scan.gru_scan_plain(
        c["x"], c["wh"], c["bh"], c["h0"], c["lengths"], False, True)
    args = (c["wh"], c["h0"], c["lengths"], ys, acts, hn, c["dys"], c["dh"])
    dx, dh0, carries = gru_scan.gru_scan_bwd_plain(*args, carries=True)
    dx2, dh02 = gru_scan.gru_scan_bwd_plain(*args)
    assert torch.equal(dx, dx2) and torch.equal(dh0, dh02)
    assert carries.dtype == torch.float32
    assert torch.equal(carries[:, -1], c["dh"].float())


def _conv_case(B, T, D, k, seed):
    rng = np.random.RandomState(seed)

    def randn(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.randn(*shape)).astype(
            np.float32))
    lengths = rng.randint(1, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = T, 0
    weights = (randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1),
               randn(D, 2 * D, scale=D ** -0.5), randn(2 * D, scale=0.1),
               randn(k, D, scale=k ** -0.5), randn(D, scale=0.1),
               randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1),
               randn(D, D, scale=D ** -0.5), randn(D, scale=0.1))
    return (randn(B, T, D).to(BF), torch.from_numpy(lengths), weights,
            randn(B, T, D).to(BF))


@pytest.mark.parametrize("B,T,D,k", [(5, 37, 128, 7), (3, 40, 256, 31)])
def test_conv_bounds_hold_the_plain_versions(B, T, D, k):
    """The bf16 plain conv module, forward (u, y) and backward (its
    intermediates, dx and the ten weight gradients), each stage within
    its bound of the fp64 recompute from the stage before; y or dx zeroed
    on every batch row but row 1 reads far above 1."""
    x, lengths, weights, dy = _conv_case(B, T, D, k, T + k)
    y, inter = cc.conformer_conv_module_plain(x, lengths, *weights,
                                              intermediates=True)
    assert torch.equal(y, cc.conformer_conv_module_plain(x, lengths,
                                                         *weights))
    bounds = cc.conformer_conv_module_bounds(x, lengths, inter["u"],
                                             *weights)
    readings = eb.readings(dict(inter, y=y), bounds)
    assert max(readings.values()) <= 1.0, readings
    assert eb.reading(eb.zero_but_row_1(y), *bounds["y"]) > 10
    grads, inter = cc.conformer_conv_module_bwd_plain(
        x, lengths, *weights, dy, intermediates=True)
    bounds = cc.conformer_conv_module_bwd_bounds(x, lengths, inter,
                                                 *weights, dy)
    assert set(bounds) == set(inter) | set(cc.GRADS)
    readings = eb.readings(dict(inter, **dict(zip(cc.GRADS, grads))), bounds)
    assert max(readings.values()) <= 1.0, readings
    assert eb.reading(eb.zero_but_row_1(grads[0]), *bounds["dx"]) > 10


@pytest.mark.parametrize("fault", ["halo zeroed", "dw1 partial left out",
                                   "dwd partial left out",
                                   "db1 from bf16 da"])
def test_conv_bounds_refuse_tiled_faults(fault):
    """Each planted fault a tiled design could commit (``fwd_faults``,
    ``bwd_faults``: a tile's y from u without its halo, a CTA's partial
    left out of dw1 or of dwd, db1 summed from da rounded to bf16), built
    from the bf16 plain versions' intermediates with tiles of 16 frames,
    reads above 1 against ``conformer_conv_module_bounds`` /
    ``_bwd_bounds`` (their sums held for any order)."""
    B, T, D, k = 5, 37, 128, 7
    x, lengths, weights, dy = _conv_case(B, T, D, k, T + k)
    if fault == "halo zeroed":
        y, inter = cc.conformer_conv_module_plain(x, lengths, *weights,
                                                  intermediates=True)
        bounds = cc.conformer_conv_module_bounds(x, lengths, inter["u"],
                                                 *weights)
        faults = cc.fwd_faults(bounds, inter["u"], y, weights, 16)
    else:
        grads, inter = cc.conformer_conv_module_bwd_plain(
            x, lengths, *weights, dy, intermediates=True)
        bounds = cc.conformer_conv_module_bwd_bounds(x, lengths, inter,
                                                     *weights, dy)
        faults = cc.bwd_faults(bounds, lengths, inter, grads, weights[4], 16)
    assert faults[fault] > 1.0, faults


def test_conv_dw_bound_follows_the_splits():
    """dw1 and dw2 are held at the backward kernels' own summation depth
    (``sum_depth``'s ``"dw"``: a split's rows by mma.sync, then the
    splits' partials), far below the B T of an any-order sum once the
    rows take several splits, so that "dw1 partial left out" (one CTA's
    partial of one split) reads well above 1 where the any-order bound
    let it shrink toward 1; the plain version stays within the bound.
    At Conformer-M's shape (B 64, T' 250) the depth is a 14th of B T, at
    the transducer's (B 128, T' 250 and 418) a 28th."""
    B, T, D, k = 16, 512, 128, 7
    N = B * T
    splits, rows = cc.dw_splits(N)
    assert (splits, rows) == (8, 1024)
    depth = cc.sum_depth(B, T, 64)
    assert depth["dw"] == 32 + 17 * (rows // 16 - 1) + 3 + 3
    for Bp, Tp, ratio in ((64, 250, 14), (128, 250, 28), (128, 418, 28)):
        assert Bp * Tp >= ratio * cc.sum_depth(Bp, Tp, 64)["dw"]
    x, lengths, weights, dy = _conv_case(B, T, D, k, 17)
    grads, inter = cc.conformer_conv_module_bwd_plain(
        x, lengths, *weights, dy, intermediates=True)
    any_order = cc.conformer_conv_module_bwd_bounds(x, lengths, inter,
                                                    *weights, dy)
    at_depth = cc.conformer_conv_module_bwd_bounds(x, lengths, inter,
                                                   *weights, dy, depth=depth)
    outputs = dict(inter, **dict(zip(cc.GRADS, grads)))
    for name in ("dw1", "dw2"):
        assert eb.reading(outputs[name], *at_depth[name]) <= 1.0
        assert float(at_depth[name][1].max()) * 7 < \
            float(any_order[name][1].max())
    loose = cc.bwd_faults(any_order, lengths, inter, grads, weights[4], 64)
    tight = cc.bwd_faults(at_depth, lengths, inter, grads, weights[4], 64)
    fault = "dw1 partial left out"
    assert tight[fault] > 7 * loose[fault] and tight[fault] > 10, \
        (loose, tight)
