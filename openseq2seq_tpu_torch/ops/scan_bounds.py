"""Element-by-element bounds for the bf16 scan kernels (``ops/gru_scan.py``,
``ops/lstm_scan.py``), one step at a time from the kernel's own state.

A bound propagated with absolute values through hundreds of steps of
|W_h| grows without limit (|W_h|'s row sums are about 0.8 sqrt(H)), so
every step is held on its own: from the state a kernel carried into step
t (the forward's ``ys[t_prev]`` and cell state, the backward's fp32
carries, which ``_bwd_cuda(..., carries=True)`` returns), the step is
recomputed in fp64 with the plain versions' arithmetic, and each output
element of the step is held within a bound built from that element's own
terms, as ``flash_attention._sum_bound`` builds them:

- for the forward's outputs rounded to the compute type, none beyond the
  rounding itself: each must be a rounding of a value within the
  recompute's error (:func:`_rounding`, exact), so that a right kernel
  reads 0 or 1 there; for the backward's, one ulp of each rounding, and
  for each rounded dg whose error straddles a rounding point, so that it
  may round the other way (``bounds.flips``), the gap times |W_h| in the
  next carry;
- the fp32 sums of the recurrent product in another order: 2 n 2^-24 of
  the sum of the terms' sizes, n = H in the forward; in the backward
  n = G H for a sum in any order (the plain version's), or, given
  ``depth``, the most additions a term passes through in the backward
  kernel's own order (:func:`sum_depth`), so that a kernel whose carry is
  rounded to bf16 is refused at every width;
- the fp32 cell math: ``CELL`` of the magnitude of each expression (the
  same expression on absolute values, each difference a sum), which
  covers 32 roundings, transcendentals at 2 ulps each;
- a sigmoid's or tanh's input error times its slope (plus the slope's
  change over that error).

The functions return ``{name: (want, bound)}`` in fp64, the outputs'
shapes; an element whose bound is 0 must match exactly (a step past a
row's length), one whose bound is inf is not held (a residual of such a
step, which the backward never reads). ``bounds.reading`` is the largest
|got - want| / bound, at most 1 for a right kernel. The planted faults a
check must refuse: ``bounds.zero_but_row_1``; :func:`drop_product`, the
forward's ys at one step recomputed with the recurrent product left out
for one CTA's block of units; the forward's controls (h carried
unrounded, the LSTM's c carried in bf16), all four in :func:`fwd_faults`;
and the backward's, :func:`bwd_faults`; at more than one tile of rows a
step (``TILE_ROWS``), both also refuse a step whose tiles take one
another's rows (:func:`cross_tile`, :func:`cross_tile_bwd`) and an
output zeroed on the second tile's rows alone (:func:`zero_rows`), the
ragged second tile of B 33 to 63 included.
"""
from __future__ import annotations

import math

import torch

from . import rnn_scan
from .bounds import (BF16_ULP, CELL, F32_U, flips, reading, roundings,
                     sigmoid, zero_but_row_1)


def _ulp(dtype) -> float:
    return BF16_ULP if dtype == torch.bfloat16 else 2.0 ** -23


def _rounded(want, err, dtype):
    """The bound of an output rounded to ``dtype`` from a value within
    ``err`` of ``want``: one ulp, plus the error."""
    u = _ulp(dtype)
    return u * want.abs() + (1 + u) * err


def _rounding(want, err, dtype):
    """(want, bound) of an output rounded to ``dtype`` from a value within
    ``err`` of ``want`` (fp64), exactly: the output must be one of the
    roundings of the values within err of want, from the least to the
    greatest (``bounds.roundings``), so the pair is their midpoint and half
    their gap. Where they all round alike the bound is 0 and the output
    must be that rounding; a right kernel reads 0 or 1 (the other rounding
    of a value whose error straddles a rounding point), a kernel off by a
    rounding elsewhere reads inf."""
    lo, hi = roundings(want, err, dtype)
    return (lo + hi) / 2, (hi - lo) / 2


def _tanh(x, err):
    y = torch.tanh(x)
    return y, (1 - y * y + 0.8 * err) * err + CELL * y.abs()


def _live(lengths, T):
    return (torch.arange(T, device=lengths.device)[None, :] <
            lengths.long()[:, None])[..., None]


def _last_state(seq, init, lengths, reverse):
    """The state a scan carries out: ``seq`` at each row's last live step
    in the scan's order (t = length - 1, or 0 for a reverse cell), or
    ``init`` for a row of length 0."""
    T = seq.shape[1]
    t = torch.zeros_like(lengths.long()) if reverse else \
        (lengths.long() - 1).clamp(min=0)
    got = seq[torch.arange(seq.shape[0], device=seq.device),
              t.clamp(max=max(T - 1, 0))]
    return torch.where((lengths > 0)[:, None], got, init.to(seq.dtype))


def _unit_columns(G, H, units):
    """The columns of each gate block of (B, T, G H) owned by ``units``."""
    return torch.cat([torch.arange(g * H + units.start, g * H + units.stop)
                      for g in range(G)])


# the forward: gates from the kernel's own h_prev (and c_prev)

def _gru_fwd(x, w, b, h_prev):
    """One GRU step in fp64 from pre-activations x (.., 3H), W_h, b_h and
    h_prev: {r, z, n, hn, h} and their errors e_*."""
    H = h_prev.shape[-1]
    hp = h_prev @ w + b
    e_hp = 2 * (H + 1) * F32_U * (h_prev.abs() @ w.abs() + b.abs())
    pre = x + hp
    e_pre = e_hp + 2 * F32_U * (x.abs() + hp.abs())
    r, e_r = sigmoid(pre[..., :H], e_pre[..., :H])
    z, e_z = sigmoid(pre[..., H:2 * H], e_pre[..., H:2 * H])
    hn, e_hn = hp[..., 2 * H:], e_hp[..., 2 * H:]
    xn = x[..., 2 * H:]
    n, e_n = _tanh(xn + r * hn, hn.abs() * e_r + r * e_hn +
                   2 * F32_U * (xn.abs() + (r * hn).abs()))
    h = (1 - z) * n + z * h_prev
    e_h = (n - h_prev).abs() * e_z + (1 - z) * e_n + CELL * (
        (1 + z) * n.abs() + z * h_prev.abs())
    return {"r": r, "z": z, "n": n, "hn": hn, "h": h, "e_r": e_r,
            "e_z": e_z, "e_n": e_n, "e_hn": e_hn, "e_h": e_h}


def _lstm_fwd(x, w, h_prev, c_prev, forget_bias):
    """One LSTM step in fp64: {i, f, g, o, c, h} (g = tanh(g_g), c the
    unmasked c') and their errors."""
    H = h_prev.shape[-1]
    pre = x + h_prev @ w
    e_pre = 2 * (H + 1) * F32_U * (x.abs() + h_prev.abs() @ w.abs())
    si, e_si = sigmoid(pre[..., :H], e_pre[..., :H])
    gf = pre[..., H:2 * H] + forget_bias
    sf, e_sf = sigmoid(gf, e_pre[..., H:2 * H] + F32_U * gf.abs())
    tg, e_tg = _tanh(pre[..., 2 * H:3 * H], e_pre[..., 2 * H:3 * H])
    so, e_so = sigmoid(pre[..., 3 * H:], e_pre[..., 3 * H:])
    c = sf * c_prev + si * tg
    e_c = c_prev.abs() * e_sf + tg.abs() * e_si + si * e_tg + CELL * (
        (sf * c_prev).abs() + (si * tg).abs())
    tc, e_tc = _tanh(c, e_c)
    h = so * tc
    e_h = tc.abs() * e_so + so * e_tc + CELL * h.abs()
    return {"i": si, "f": sf, "g": tg, "o": so, "c": c, "h": h,
            "e_i": e_si, "e_f": e_sf, "e_g": e_tg, "e_o": e_so, "e_c": e_c,
            "e_h": e_h}


def _fwd_out(step, live, dt, acts, extra):
    """(want, bound) of ys and the residuals from one step's values, the
    rounded ones by :func:`_rounding`: ys 0 past the length, residuals
    there not held."""
    inf = torch.full_like(step["h"], math.inf)
    h, e_h = _rounding(step["h"], step["e_h"], dt)
    ys = (torch.where(live, h, 0.0), torch.where(live, e_h, 0.0))
    rounded = [_rounding(step[k], step["e_" + k], dt) for k in acts]
    a_want = torch.cat([want for want, _ in rounded], dim=-1)
    a_bound = torch.cat([torch.where(live, bound, inf)
                         for _, bound in rounded], dim=-1)
    out = {"ys": ys, "acts": (a_want, a_bound)}
    for name, (want, bound) in extra.items():
        out[name] = (want, torch.where(live, bound, inf))
    return out


def gru_fwd_bounds(x_proj, wh, bh, h0, lengths, ys,
                   reverse=False) -> dict:
    """Bounds of the GRU forward kernel's ys, acts and hn from its own ys
    (the state before each step, ``rnn_scan.prev_states``), and of h_last
    (exactly ys at the last live step)."""
    d, dt, T = torch.float64, x_proj.dtype, x_proj.shape[1]
    h_prev = rnn_scan.prev_states(ys, h0, lengths, reverse).to(d)
    step = _gru_fwd(x_proj.to(d), wh.to(dt).to(d), bh.to(d), h_prev)
    out = _fwd_out(step, _live(lengths, T), dt, ("r", "z", "n"),
                   {"hn": _rounding(step["hn"], step["e_hn"], dt)})
    last = _last_state(ys, h0, lengths, reverse).to(d)
    out["h_last"] = (last, torch.zeros_like(last))
    return out


def lstm_fwd_bounds(x_proj, wh, h0, c0, lengths, ys, cs,
                    forget_bias=1.0, reverse=False) -> dict:
    """Bounds of the LSTM forward kernel's ys, acts and cs (fp32: its
    error alone) from its own ys and cs, and of h_last and c_last
    (exactly ys and cs at the last live step)."""
    d, dt, T = torch.float64, x_proj.dtype, x_proj.shape[1]
    h_prev = rnn_scan.prev_states(ys, h0, lengths, reverse).to(d)
    c_prev = rnn_scan.prev_states(cs, c0.float(), lengths, reverse).to(d)
    step = _lstm_fwd(x_proj.to(d), wh.to(dt).to(d), h_prev, c_prev,
                     forget_bias)
    out = _fwd_out(step, _live(lengths, T), dt, ("i", "f", "g", "o"),
                   {"cs": (step["c"], step["e_c"])})
    for name, seq, init in (("h_last", ys, h0), ("c_last", cs, c0.float())):
        last = _last_state(seq, init, lengths, reverse).to(d)
        out[name] = (last, torch.zeros_like(last))
    return out


# the backward: one step from the kernel's own carries

def _gru_bwd(c, dys, live, acts, hn, h_prev):
    """The GRU backward cell from the carry c (fp64): dx, dg (dhp) and the
    next carry without the product, each with its fp32 error."""
    H = hn.shape[-1]
    r, z, n = acts[..., :H], acts[..., H:2 * H], acts[..., 2 * H:]
    dyl = torch.where(live, dys, 0.0)
    dh, m_dh = c + dyl, c.abs() + dyl.abs()
    dhn, m_dhn = torch.where(live, dh, 0.0), torch.where(live, m_dh, 0.0)
    dz, m_dz = dhn * (h_prev - n), m_dhn * (h_prev.abs() + n.abs())
    dn = dhn * (1 - z) * (1 - n * n)
    m_dn = m_dhn * (1 + z) * (1 + n * n)
    dr, m_dr = dn * hn * r * (1 - r), m_dn * hn.abs() * r * (1 + r)
    dzp, m_dzp = dz * z * (1 - z), m_dz * z * (1 + z)
    return {"dx": torch.cat([dr, dzp, dn], dim=-1),
            "e_dx": CELL * torch.cat([m_dr, m_dzp, m_dn], dim=-1),
            "dg": torch.cat([dr, dzp, dn * r], dim=-1),
            "e_dg": CELL * torch.cat([m_dr, m_dzp, m_dn * r], dim=-1),
            "next": torch.where(live, 0.0, dh) + dhn * z,
            "e_next": CELL * (torch.where(live, 0.0, m_dh) + m_dhn * z)}


def _lstm_bwd(c, cc, dys, live, acts, cs, c_prev):
    """The LSTM backward cell from the carries c, cc (fp64): dx = dg, the
    next dh carry without the product and the next dc carry, each with
    its fp32 error."""
    H = cs.shape[-1]
    si, sf, tg, so = (acts[..., g * H:(g + 1) * H] for g in range(4))
    dyl = torch.where(live, dys, 0.0)
    dh, m_dh = c + dyl, c.abs() + dyl.abs()
    dhn, m_dhn = torch.where(live, dh, 0.0), torch.where(live, m_dh, 0.0)
    tc = torch.tanh(cs)
    dcn = torch.where(live, cc, 0.0) + dhn * so * (1 - tc * tc)
    m_dcn = torch.where(live, cc.abs(), 0.0) + m_dhn * so * (1 + tc * tc)
    dg = torch.cat([dcn * tg * si * (1 - si), dcn * c_prev * sf * (1 - sf),
                    dcn * si * (1 - tg * tg), dhn * tc * so * (1 - so)],
                   dim=-1)
    m_dg = torch.cat([m_dcn * tg.abs() * si * (1 + si),
                      m_dcn * c_prev.abs() * sf * (1 + sf),
                      m_dcn * si * (1 + tg * tg),
                      m_dhn * tc.abs() * so * (1 + so)], dim=-1)
    return {"dx": dg, "e_dx": CELL * m_dg, "dg": dg, "e_dg": CELL * m_dg,
            "next": torch.where(live, 0.0, dh),
            "e_next": CELL * torch.where(live, 0.0, m_dh),
            "next_c": torch.where(live, 0.0, cc) + dcn * sf,
            "e_next_c": CELL * (torch.where(live, 0.0, cc.abs()) +
                                m_dcn * sf)}


# the warps of a CTA of the backward kernels, each summing its own slice
# of the product's G H columns (``kWarps`` in csrc/rnn_scan.cuh)
WARPS = 8


def sum_depth(G: int, H: int, dtype) -> int:
    """The most fp32 additions a term of the backward's product dg W_h^T
    passes through in the kernel's order (``csrc/rnn_scan_bwd.cuh``), at
    G gates of width H: warp w of a CTA sums the G H / 8 columns of its
    slice, then the eight warps' partial sums are added in a fixed order.

    bf16 (``scan_bwd_mma_kernel``): a warp's slice is G U k16 steps of
    mma.sync m16n8k16, U = H / 128 units a CTA; a term passes through its
    own k16 step, whose 16 products and accumulator the tensor core adds
    in an order PTX does not state (counted as 32 additions, twice its
    terms, so that a truncating adder is covered too), then each later
    k16 step of the slice, whose adder aligns the running sum with its 16
    new products and truncates it with them (counted as 17 additions, one
    for each of the step's terms). fp32 (``scan_bwd_kernel``): one FMA
    for each of the slice's G H / 8 columns. Then the eight partials."""
    if dtype == torch.bfloat16:
        return 32 + 17 * (G * rnn_scan.units_per_cta(H) - 1) + WARPS
    return G * H // WARPS + WARPS


def _product(step, w, dt, depth=None):
    """The next dh carry with dg rounded to ``dt`` times W_h^T, and its
    error: where dg's error may move its rounding (``flips``), the gap,
    times |W_h| (unrounded, dg's error); the fp32 sum, ``depth``
    additions at most for each term (None: G H, any order); the add to
    the carry."""
    dg_r = step["dg"].to(dt).to(torch.float64)
    e_dg = flips(step["dg"], step["e_dg"]).abs() \
        if dt == torch.bfloat16 else step["e_dg"]
    nxt = step["next"] + dg_r @ w.t()
    n = w.shape[1] if depth is None else depth
    terms = (2 * n * F32_U * dg_r.abs() + e_dg) @ w.abs().t()
    return nxt, step["e_next"] + terms + 2 * F32_U * nxt.abs()


def _carried(nxt, e_nxt, first, reverse):
    """(want, bound) of the carries into each step: the first step's is
    ``first`` exactly, each later one the step visited before's ``nxt``."""
    want, bound = torch.empty_like(nxt), torch.empty_like(nxt)
    first = first.double()
    if reverse:        # visits t = 0, 1, ...
        want[:, 1:], bound[:, 1:] = nxt[:, :-1], e_nxt[:, :-1]
        want[:, 0], bound[:, 0] = first, 0.0
    else:              # visits t = T - 1, T - 2, ...
        want[:, :-1], bound[:, :-1] = nxt[:, 1:], e_nxt[:, 1:]
        want[:, -1], bound[:, -1] = first, 0.0
    return want, bound


def _final(x, reverse):
    """The value after the last step the backward visits."""
    return x[:, -1] if reverse else x[:, 0]


def gru_bwd_bounds(wh, h0, lengths, ys, acts, hn, dys, dh_last, carries,
                   reverse=False, depth=None) -> dict:
    """Bounds of the GRU backward kernel's dx, its carries (``carry``)
    and dh0, each step recomputed from the kernel's own carry; ``depth``
    as :func:`_product` takes it (a kernel's: :func:`sum_depth`)."""
    d, dt, T = torch.float64, acts.dtype, acts.shape[1]
    live = _live(lengths, T)
    h_prev = rnn_scan.prev_states(ys, h0, lengths, reverse).to(d)
    step = _gru_bwd(carries.to(d), dys.to(d), live, acts.to(d), hn.to(d),
                    h_prev)
    nxt, e_nxt = _product(step, wh.to(dt).to(d), dt, depth)
    last, e_last = _final(nxt, reverse), _final(e_nxt, reverse)
    return {"dx": (step["dx"], _rounded(step["dx"], step["e_dx"], dt)),
            "carry": _carried(nxt, e_nxt, dh_last, reverse),
            "dh0": (last, _rounded(last, e_last, dt))}


def lstm_bwd_bounds(wh, c0, lengths, acts, cs, dys, dh_last, dc_last,
                    carries, ccarries, reverse=False, depth=None) -> dict:
    """Bounds of the LSTM backward kernel's dx (dgates), its dh and dc
    carries (``carry``, ``ccarry``), dh0 and dc0 (fp32: its error
    alone), each step recomputed from the kernel's own carries;
    ``depth`` as :func:`_product` takes it."""
    d, dt, T = torch.float64, acts.dtype, acts.shape[1]
    live = _live(lengths, T)
    c_prev = rnn_scan.prev_states(cs, c0.float(), lengths, reverse).to(d)
    step = _lstm_bwd(carries.to(d), ccarries.to(d), dys.to(d), live,
                     acts.to(d), cs.to(d), c_prev)
    nxt, e_nxt = _product(step, wh.to(dt).to(d), dt, depth)
    last, e_last = _final(nxt, reverse), _final(e_nxt, reverse)
    last_c = _final(step["next_c"], reverse)
    return {"dx": (step["dx"], _rounded(step["dx"], step["e_dx"], dt)),
            "carry": _carried(nxt, e_nxt, dh_last, reverse),
            "ccarry": _carried(step["next_c"], step["e_next_c"], dc_last,
                               reverse),
            "dh0": (last, _rounded(last, e_last, dt)),
            "dc0": (last_c, _final(step["e_next_c"], reverse))}


def bwd_bounds(cell, **kw) -> dict:
    """:func:`gru_bwd_bounds` (``cell`` "gru") or :func:`lstm_bwd_bounds`
    ("lstm") on their keyword arguments."""
    return (gru_bwd_bounds if cell == "gru" else lstm_bwd_bounds)(**kw)


# the planted faults: one step without the recurrent product for one CTA,
# or one whose tiles of rows take one another's state

def _fwd_step_at(cell, t, w, h_prev, **kw):
    """Step t of the forward in fp64 with W_h ``w`` (fp64) from ``h_prev``
    (B, H) and, for the LSTM, the c each row carried into step t, from
    the bound function's arguments."""
    d = torch.float64
    lengths, reverse = kw["lengths"], kw.get("reverse", False)
    x = kw["x_proj"][:, t].to(d)
    if cell == "gru":
        return _gru_fwd(x, w, kw["bh"].to(d), h_prev.to(d))
    c_prev = rnn_scan.prev_states(kw["cs"], kw["c0"].float(), lengths,
                                  reverse)[:, t]
    return _lstm_fwd(x, w, h_prev.to(d), c_prev.to(d),
                     kw.get("forget_bias", 1.0))


def _h_prev_at(t, **kw):
    return rnn_scan.prev_states(kw["ys"], kw["h0"], kw["lengths"],
                                kw.get("reverse", False))[:, t]


def drop_product(cell, t, units, **kw):
    """The forward kernel's ys with step t's values for the hidden units
    ``units`` (a slice: one CTA's block) recomputed with the recurrent
    product left out, from the bound function's arguments (``cell`` "gru"
    or "lstm"): a wrong kernel a bound must refuse."""
    ys = kw["ys"]
    live = _live(kw["lengths"], ys.shape[1])[:, t]
    dt, H = ys.dtype, ys.shape[2]
    w = kw["wh"].to(dt).to(torch.float64).clone()
    w[:, _unit_columns(w.shape[1] // H, H, units)] = 0
    step = _fwd_step_at(cell, t, w, _h_prev_at(t, **kw), **kw)
    bad = ys.clone()
    bad[:, t, units] = torch.where(live, step["h"], 0.0)[:, units].to(dt)
    return bad


# The batch rows a CTA of the bf16 scan kernels walks at once (``kRows`` in
# csrc/rnn_scan.cuh and csrc/rnn_scan_bwd.cuh): at B > 32 each step runs
# ceil(B / 32) tiles, one after the other, reusing the CTA's reduction
# buffer and multicast rooms after a cluster barrier, so that a hand-off out
# of order shows only in rows past the first tile.
TILE_ROWS = 32


def _tiles(B):
    """(rows, src): the second tile of rows (ragged where B < 64: the
    rows past the first tile), and as many rows of the first, whose state
    a wrong hand-off between tiles gives it; None at one tile a step."""
    if B <= TILE_ROWS:
        return None
    end = min(B, 2 * TILE_ROWS)
    return slice(TILE_ROWS, end), slice(0, end - TILE_ROWS)


def zero_rows(x, rows):
    """``x`` with the batch rows ``rows`` zeroed: a fault a bound must
    refuse."""
    bad = x.clone()
    bad[rows] = 0
    return bad


def cross_tile(cell, t, rows, src, **kw):
    """The forward kernel's ys with step t's values for the batch rows
    ``rows`` (one tile, a slice) recomputed from the h that the rows
    ``src`` (another tile) carried into step t, each row with its own
    x_proj (and c): a kernel whose tiles of a step take one another's
    rows of h, a wrong kernel a bound must refuse."""
    ys = kw["ys"]
    live = _live(kw["lengths"], ys.shape[1])[:, t]
    dt = ys.dtype
    h_prev = _h_prev_at(t, **kw).clone()
    h_prev[rows] = h_prev[src]
    step = _fwd_step_at(cell, t, kw["wh"].to(dt).to(torch.float64), h_prev,
                        **kw)
    bad = ys.clone()
    bad[rows, t] = torch.where(live, step["h"], 0.0)[rows].to(dt)
    return bad


def fwd_bounds(cell, **kw) -> dict:
    """:func:`gru_fwd_bounds` (``cell`` "gru") or :func:`lstm_fwd_bounds`
    ("lstm") on their keyword arguments."""
    return (gru_fwd_bounds if cell == "gru" else lstm_fwd_bounds)(**kw)


def carried_run(cell, h_carry, c_carry=torch.float32, **kw):
    """(ys, cs) of a forward kernel that carries h rounded to ``h_carry``
    and the LSTM's c rounded to ``c_carry`` from step to step, each step
    in fp64 (:func:`_gru_fwd`, :func:`_lstm_fwd`) from the bound
    function's inputs (``cell`` "gru" or "lstm"), ys rounded to x_proj's
    dtype, cs (the LSTM's unmasked c', fp32; None for the GRU) as the
    kernel writes it. ``h_carry`` x_proj's dtype and ``c_carry`` fp32 is
    the right kernel's carry; the others are wrong kernels a bound must
    refuse."""
    d, dt = torch.float64, kw["x_proj"].dtype
    lengths, reverse = kw["lengths"], kw.get("reverse", False)
    x = kw["x_proj"].to(d)
    B, T = x.shape[:2]
    w = kw["wh"].to(dt).to(d)
    H = w.shape[0]
    h = kw["h0"].to(dt).to(d)
    ys = torch.zeros((B, T, H), dtype=dt, device=x.device)
    cs = None
    if cell == "lstm":
        c = kw["c0"].float().to(d)
        cs = torch.zeros((B, T, H), device=x.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        live = (t < lengths)[:, None]
        if cell == "gru":
            step = _gru_fwd(x[:, t], w, kw["bh"].to(d), h)
        else:
            step = _lstm_fwd(x[:, t], w, h, c, kw.get("forget_bias", 1.0))
            cs[:, t] = step["c"].float()
            c = torch.where(live, step["c"].to(c_carry).to(d), c)
        ys[:, t] = torch.where(live, step["h"], 0.0).to(dt)
        h = torch.where(live, step["h"].to(h_carry).to(d), h)
    return ys, cs


def fwd_faults(cell, t, units, **kw) -> dict:
    """The readings of wrong forward kernels against the bounds, from the
    bound function's keyword arguments (the right kernel's ys, and cs for
    the LSTM), by name:

    - "rows zeroed": ys zeroed on every batch row but row 1;
    - "product left out": :func:`drop_product` at step t for ``units``;
    - "fp32 h carry": :func:`carried_run` with h carried unrounded (fp32)
      while ys is written rounded, each step's ys against the bounds from
      its own ys (the state a kernel keeping h on chip in fp32 would
      carry);
    - "bf16 c carry" (the LSTM): c carried rounded to bf16, its cs and ys
      against the bounds from its own cs and ys;
    - "rows from another tile" (B > ``TILE_ROWS``): :func:`cross_tile`
      at step t, the second tile of rows (ragged below 64 rows) from the
      first's h;
    - "second tile zeroed" (B > ``TILE_ROWS``): ys zeroed on the rows of
      the second tile alone.

    A check must read all of them above 1. Both controls move a step by
    less than a rounding of h or c, so the bounds tell them only because
    each rounded output must be a rounding of the recompute's value within
    its error (:func:`_rounding`) and the fp32 cs is held to its fp32
    error alone. h carried unrounded moves the LSTM's step only through
    h W_h, by about 2^-9 of its terms, against the sum's term 2 H 2^-24 of
    their sizes: the share of ys it puts outside falls as H grows, but
    stays above none at every width the kernels take (the card tests and
    ``chip_smoke.py`` 4e hold it up to H 1280); the GRU's z h_prev shows
    it at every element whose rounding it moves."""
    bounds = fwd_bounds(cell, **kw)
    ys = kw["ys"]
    out = {"rows zeroed": reading(zero_but_row_1(ys), *bounds["ys"]),
           "product left out": reading(drop_product(cell, t, units, **kw),
                                       *bounds["ys"])}
    tiles = _tiles(ys.shape[0])
    if tiles:
        out["rows from another tile"] = reading(
            cross_tile(cell, t, *tiles, **kw), *bounds["ys"])
        out["second tile zeroed"] = reading(zero_rows(ys, tiles[0]),
                                            *bounds["ys"])
    controls = {"fp32 h carry": (torch.float32, torch.float32)}
    if cell == "lstm":
        controls["bf16 c carry"] = (ys.dtype, torch.bfloat16)
    for name, (h_carry, c_carry) in controls.items():
        bad_ys, bad_cs = carried_run(cell, h_carry, c_carry, **kw)
        bad = dict(kw, ys=bad_ys)
        got = {"ys": bad_ys}
        if cell == "lstm":
            bad["cs"] = got["cs"] = bad_cs
        bad_bounds = fwd_bounds(cell, **bad)
        out[name] = max(reading(got[k], *bad_bounds[k]) for k in got)
    return out


def _bwd_step(cell, carries, kw):
    """The backward cell of every step from ``carries`` (fp64 values)."""
    d = torch.float64
    lengths, reverse = kw["lengths"], kw.get("reverse", False)
    acts = kw["acts"].to(d)
    live = _live(lengths, acts.shape[1])
    if cell == "gru":
        h_prev = rnn_scan.prev_states(kw["ys"], kw["h0"], lengths,
                                      reverse).to(d)
        return _gru_bwd(carries.to(d), kw["dys"].to(d), live, acts,
                        kw["hn"].to(d), h_prev)
    c_prev = rnn_scan.prev_states(kw["cs"], kw["c0"].float(), lengths,
                                  reverse).to(d)
    return _lstm_bwd(carries.to(d), kw["ccarries"].to(d), kw["dys"].to(d),
                     live, acts, kw["cs"].to(d), c_prev)


def _carry_fault(cell, t, bad_carries, dx, units, **kw):
    """(dx, carries) of a backward kernel whose dh carries are
    ``bad_carries``, wrong into step t, its dx at step t recomputed from
    them for the columns of the hidden units ``units`` (all units: every
    column), so that the two agree and only the carry's bound can refuse
    them."""
    dt, H = kw["acts"].dtype, kw["dys"].shape[2]
    G = kw["acts"].shape[2] // H
    cols = _unit_columns(G, H, units)
    bad = dx.clone()
    bad[:, t, cols] = _bwd_step(cell, bad_carries, kw)["dx"][
        :, t, cols].to(dt)
    return bad, bad_carries


def _t_before(t, kw):
    """The step the backward visits before step t."""
    return t - 1 if kw.get("reverse", False) else t + 1


def drop_product_bwd(cell, t, units, dx, **kw):
    """(dx, carries) of a backward kernel that left the recurrent product
    out of the dh carry into step t for the hidden units ``units`` (one
    CTA's block), from the bound function's arguments and the kernel's
    dx: that carry as the step visited before left it, and step t's dx
    recomputed from it, so that the two agree and only the carry's bound
    can refuse them."""
    carries = kw["carries"].clone()
    carries[:, t, units] = _bwd_step(cell, carries, kw)["next"][
        :, _t_before(t, kw), units].float()
    return _carry_fault(cell, t, carries, dx, units, **kw)


def cross_tile_bwd(cell, t, rows, src, dx, **kw):
    """(dx, carries) of a backward kernel whose tiles of a step take one
    another's rows: the dh carry into step t of the batch rows ``rows``
    (one tile) is the one the step visited before left for the rows
    ``src`` (another tile), product and all, and step t's dx of those
    rows is recomputed from it."""
    dt = kw["acts"].dtype
    nxt, _ = _product(_bwd_step(cell, kw["carries"], kw),
                      kw["wh"].to(dt).to(torch.float64), dt,
                      kw.get("depth"))
    carries = kw["carries"].clone()
    carries[rows, t] = nxt[src, _t_before(t, kw)].float()
    H = kw["dys"].shape[2]
    return _carry_fault(cell, t, carries, dx, slice(0, H), **kw)


def bwd_faults(cell, t, units, dx, **kw) -> dict:
    """The readings of wrong backward kernels, each against the
    bounds recomputed from its own carries, by name:

    - "rows zeroed": dx zeroed on every batch row but row 1 (dx's bound);
    - "product left out": :func:`drop_product_bwd` at step t (the carry
      into step t: the steps after it would follow from it in such a
      kernel, so they are not read);
    - "bf16 carry": every dh carry rounded to bf16, as in a kernel that
      kept its carries in bf16 (the carries at the live steps, where the
      product moves them);
    - "rows from another tile" (B > ``TILE_ROWS``):
      :func:`cross_tile_bwd` at step t, the second tile of rows (ragged
      below 64 rows) carrying the first's dh into it (the carry into step
      t);
    - "second tile zeroed" (B > ``TILE_ROWS``): dx zeroed on the rows of
      the second tile alone (dx's bound).

    A check must read all of them above 1, at every width, given the
    kernel's own summation depth (``depth``, :func:`sum_depth`), so that
    the carry's sum term stays below a bf16 rounding of the carry (at G H
    4096, the LSTM at H 1024, "bf16 carry" read 0.88 to 1.08 against a
    bound of any order, G H additions, short of refusing it)."""
    bounds = bwd_bounds(cell, **kw)
    out = {"rows zeroed": reading(zero_but_row_1(dx), *bounds["dx"])}
    faults = {"product left out": drop_product_bwd(cell, t, units, dx, **kw)}
    tiles = _tiles(dx.shape[0])
    if tiles:
        faults["rows from another tile"] = cross_tile_bwd(cell, t, *tiles,
                                                          dx, **kw)
        out["second tile zeroed"] = reading(zero_rows(dx, tiles[0]),
                                            *bounds["dx"])
    for name, (_, carries) in faults.items():
        want, bound = bwd_bounds(cell, **dict(kw, carries=carries))["carry"]
        out[name] = reading(carries[:, t], want[:, t], bound[:, t])
    carries = kw["carries"].to(torch.bfloat16).float()
    want, bound = bwd_bounds(cell, **dict(kw, carries=carries))["carry"]
    live = _live(kw["lengths"], carries.shape[1]).expand_as(carries)
    out["bf16 carry"] = reading(carries[live], want[live], bound[live])
    return out
