"""CTC prefix beam search on the device, with optional n-gram shallow
fusion (port of ``openseq2seq_tpu/ops/ctc_beam_tpu.py``, which is plain
jnp and no Pallas kernel; here it is plain torch operations on the card).

The JAX module restates Hannun et al.'s prefix beam search with static
shapes: a beam is K rows of a fixed-width token matrix plus per-row
scalars (length, last label, two rolling prefix hashes, log p_blank and
log p_nonblank, the LM context, the frame each label entered). Each frame
expands the K x V candidates at once (column ``blank`` is "stay": its
p_b takes the blank extension and its p_nb the repeated last label; the
other columns extend the prefix), then merges equal prefixes by sorting
on (hash 1, hash 2, length), summing each run of equal keys in the log
domain, and keeps the top K. The port keeps every number of it:

  * the hashes are uint32 with wraparound there; here int64 masked to
    32 bits after every product (h < 2^32 and the primes below 2^25, so
    no int64 product overflows), which sorts as the unsigned values do;
  * ``jnp.lexsort((len, h2, h1))`` is two stable sorts, on h2 * 2^20 +
    len and then on h1, which give the same order, ties included;
  * ``jax.ops.segment_max`` / ``segment_sum`` / ``segment_min`` are
    ``scatter_reduce`` with the same identities for empty segments;
  * ``lax.top_k`` breaks ties by the lower index: a stable descending
    sort does the same, where ``torch.topk`` on CUDA promises no order;
  * the batch is one more leading axis instead of ``vmap``, and the frame
    loop is a Python loop of about 70 small operations a frame.

:class:`FusionLM` takes ``ops/ngram_fusion.dense_label_lm``'s table: an
extension by label c from LM context ``ctx`` adds ``alpha * table[ctx,
c] + beta``. :func:`ctc_beam_init` and :func:`ctc_beam_update` carry the
beam over chunks; feeding an utterance chunk by chunk gives the beams of
one pass, with utterance-absolute emission frames.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1.0e30
_P1 = 1000003
_P2 = 16777619
_MASK32 = 0xFFFFFFFF
_LEN_BITS = 20           # the lengths' share of the second sort key


class FusionLM(NamedTuple):
    """Dense label-level LM for shallow fusion (``dense_label_lm``)."""
    table: torch.Tensor   # (C**m, V-1) natural-log P(label | ctx)
    C: int                # context base (V: the labels and a BOS pad)
    m: int                # context length (order - 1)
    init_ctx: int         # the all-BOS context
    alpha: float          # LM weight
    beta: float           # per-label insertion bonus


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.logaddexp(a, b), min=NEG_INF)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, ties to the lower
    index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along axis 1 by idx (B, M)."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(shape))


def _segment(x: torch.Tensor, seg: torch.Tensor, reduce: str,
             init: float) -> torch.Tensor:
    """Per row of (B, N), the ``reduce`` of x over each segment id of seg
    (B, N) in [0, N); ``init`` where a segment is empty."""
    out = torch.full_like(x, init)
    return out.scatter_reduce_(1, seg, x, reduce, include_self=True)


def _seg_lse(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    mx = torch.clamp(_segment(x, seg, "amax", float("-inf")), min=NEG_INF)
    s = torch.zeros_like(x).scatter_add_(1, seg,
                                         torch.exp(x - mx.gather(1, seg)))
    return torch.clamp(mx + torch.log(s + 1e-37), min=NEG_INF)


def _beam_step(state, logp: torch.Tensor, active: torch.Tensor,
               t: torch.Tensor, K: int, V: int, U: int,
               fusion: Optional[FusionLM]):
    """One frame: ``logp`` (B, V), ``active`` (B,) bool, ``t`` (B,) the
    frame's index in its utterance."""
    toks, lens, last, h1, h2, ctx, p_b, p_nb, frames = state
    dev = logp.device
    B = logp.shape[0]
    blank = V - 1
    N = K * V
    c = torch.arange(V, device=dev)
    is_stay = (c == blank)[None, None, :]                    # (1, 1, V)
    tot = _lse(p_b, p_nb)                                    # (B, K)
    stay_b = tot + logp[:, blank, None]
    stay_nb = torch.where(lens > 0, p_nb + torch.gather(
        logp, 1, last.clamp(0, V - 1)), torch.full_like(p_nb, NEG_INF))
    base = torch.where(c[None, None, :] == last[:, :, None],
                       p_b[:, :, None], tot[:, :, None])     # (B, K, V)
    ext_score = base + logp[:, None, :]
    if fusion is not None:
        lm_row = fusion.table[ctx]                           # (B, K, V-1)
        bonus = fusion.alpha * lm_row + fusion.beta
        ext_score = ext_score + torch.cat(
            [bonus, torch.zeros_like(bonus[..., :1])], dim=-1)
    neg = torch.full_like(ext_score, NEG_INF)
    cand_b = torch.where(is_stay, stay_b[:, :, None], neg).reshape(B, N)
    cand_nb = torch.where(is_stay, stay_nb[:, :, None],
                          torch.clamp(ext_score, min=NEG_INF)).reshape(B, N)
    step = torch.where(is_stay, 0, c + 1)                    # (1, 1, V)
    cand_h1 = torch.where(is_stay, h1[:, :, None],
                          (h1[:, :, None] * _P1 + step) & _MASK32)
    cand_h2 = torch.where(is_stay, h2[:, :, None],
                          (h2[:, :, None] * _P2 + step) & _MASK32)
    cand_len = lens[:, :, None] + (~is_stay).to(lens.dtype)
    cand_h1, cand_h2 = cand_h1.reshape(B, N), cand_h2.reshape(B, N)
    cand_len = cand_len.reshape(B, N)
    parent = torch.arange(K, device=dev).repeat_interleave(V)  # (N,)
    char = c.repeat(K)

    # merge equal prefixes: the lexsort on (h1, h2, length), then a
    # log-sum-exp over each run of equal keys
    order = torch.sort((cand_h2 << _LEN_BITS) + cand_len, dim=1,
                       stable=True)[1]
    order = order.gather(1, torch.sort(cand_h1.gather(1, order), dim=1,
                                       stable=True)[1])
    h1s, h2s = cand_h1.gather(1, order), cand_h2.gather(1, order)
    lns = cand_len.gather(1, order)
    bs, nbs = cand_b.gather(1, order), cand_nb.gather(1, order)
    first = torch.ones_like(h1s, dtype=torch.bool)
    first[:, 1:] = (h1s[:, 1:] != h1s[:, :-1]) | \
        (h2s[:, 1:] != h2s[:, :-1]) | (lns[:, 1:] != lns[:, :-1])
    seg = torch.cumsum(first.long(), dim=1) - 1              # (B, N)
    m_b, m_nb = _seg_lse(bs, seg), _seg_lse(nbs, seg)
    idx = torch.arange(N, device=dev).expand(B, N)
    rep = _segment(idx, seg, "amin", N).clamp(0, N - 1)
    top_score, top = _top_k(_lse(m_b, m_nb), K)              # (B, K)

    pick = order.gather(1, rep.gather(1, top))              # (B, K)
    par, ch = parent[pick], char[pick]
    ext = ch != blank
    plen = lens.gather(1, par)
    wpos = plen.clamp(0, U - 1)
    upd = ext[:, :, None] & (torch.arange(U, device=dev)[None, None, :] ==
                             wpos[:, :, None])
    new_toks = torch.where(upd, ch[:, :, None].to(toks.dtype),
                           _take(toks, par))
    new_frames = torch.where(upd, t[:, None, None].to(frames.dtype),
                             _take(frames, par))
    new_lens = (plen + ext.to(plen.dtype)).clamp(0, U)
    new_last = torch.where(ext, ch.to(last.dtype), last.gather(1, par))
    ctx_par = ctx.gather(1, par)
    if fusion is not None:
        rolled = ctx_par // fusion.C + ch.to(ctx.dtype) * \
            fusion.C ** (fusion.m - 1)
        new_ctx = torch.where(ext, rolled, ctx_par)
    else:
        new_ctx = ctx_par
    rep_top = rep.gather(1, top)
    new_h1, new_h2 = h1s.gather(1, rep_top), h2s.gather(1, rep_top)
    new_b = torch.clamp(m_b.gather(1, top), min=NEG_INF)
    new_nb = torch.clamp(m_nb.gather(1, top), min=NEG_INF)

    # a lane whose top-K slot fell on an empty segment is dead: unique
    # junk hashes and -1 tokens, so that it neither merges with a live
    # prefix nor shows as a duplicate transcript
    dead = top_score <= NEG_INF * 0.5
    lane = torch.arange(K, device=dev)[None, :]
    new_h1 = torch.where(dead, 0x60000000 + lane, new_h1)
    new_h2 = torch.where(dead, 0x70000000 + lane, new_h2)
    new_toks = torch.where(dead[:, :, None], -1, new_toks)
    new_frames = torch.where(dead[:, :, None], -1, new_frames)
    new_lens = torch.where(dead, 0, new_lens)
    new_last = torch.where(dead, -1, new_last)

    new = (new_toks, new_lens, new_last, new_h1, new_h2, new_ctx, new_b,
           new_nb, new_frames)
    # frames past the utterance's length leave its beam as it was
    return tuple(torch.where(active.reshape((B,) + (1,) * (n.dim() - 1)),
                             n, o) for n, o in zip(new, state))


def _init(B: int, K: int, U: int, fusion: Optional[FusionLM], device):
    """Lane 0 the empty prefix; the other lanes dead, with junk hashes
    that can never merge with a real prefix."""
    k = torch.arange(K, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    one = (torch.full((K, U), -1, **i32),
           torch.zeros((K,), **i32),
           torch.full((K,), -1, **i32),
           torch.where(k == 0, 1, 0x40000000 + k),
           torch.where(k == 0, 2, 0x50000000 + k),
           torch.full((K,), fusion.init_ctx if fusion is not None else 0,
                      dtype=torch.int64, device=device),
           torch.where(k == 0, 0.0, NEG_INF).float(),
           torch.full((K,), NEG_INF, dtype=torch.float32, device=device),
           torch.full((K, U), -1, **i32))
    return tuple(x[None].expand((B,) + x.shape).clone() for x in one)


def _scan(state, logp: torch.Tensor, n_valid: torch.Tensor,
          t0: torch.Tensor, fusion: Optional[FusionLM]):
    """The beam over the frames of ``logp`` (B, T, V), the first
    ``n_valid`` (B,) of each row live, frame indices from ``t0`` (B,)."""
    B, T, V = logp.shape
    K, U = state[0].shape[1], state[0].shape[2]
    n_valid = n_valid.to(logp.device)
    for j in range(T):
        state = _beam_step(state, logp[:, j], j < n_valid, t0 + j, K, V, U,
                           fusion)
    return state


def _rank(state):
    toks, lens, frames = state[0], state[1], state[8]
    top_scores, order = _top_k(_lse(state[6], state[7]), state[6].shape[1])
    return (_take(toks, order), lens.gather(1, order), top_scores,
            _take(frames, order))


def ctc_beam_search_device(logits: torch.Tensor,
                           logit_lengths: torch.Tensor,
                           beam_width: int = 16,
                           max_label_len: Optional[int] = None,
                           fusion: Optional[FusionLM] = None,
                           return_frames: bool = False
                           ) -> Tuple[torch.Tensor, ...]:
    """Batched CTC prefix beam search on ``logits``' device.

    logits (B, T, V) raw, blank the last class; logit_lengths (B,) valid
    frames; ``max_label_len`` U (default T): a prefix that reaches U stops
    growing (its last slot is overwritten). Returns ``(ids, lengths,
    scores)``: (B, K, U) int32 label ids padded with -1, (B, K) int32
    lengths, (B, K) fp32 total log probabilities (LM-fused with
    ``fusion``), the best beam first; with ``return_frames`` also the
    (B, K, U) int32 frame at which each label entered its prefix."""
    B, T, V = logits.shape
    U = int(max_label_len or T)
    logp = torch.log_softmax(logits.float(), dim=-1)
    state = _init(B, int(beam_width), U, fusion, logits.device)
    zero = torch.zeros((B,), dtype=torch.int64, device=logits.device)
    ids, lens, scores, frames = _rank(_scan(state, logp, logit_lengths,
                                            zero, fusion))
    if return_frames:
        return ids, lens, scores, frames
    return ids, lens, scores


def ctc_beam_init(batch_size: int, beam_width: int, max_label_len: int,
                  fusion: Optional[FusionLM] = None, device=None):
    """A fresh batched beam: the empty prefix in lane 0; the last element
    counts each utterance's frames so far, so that streamed emission
    frames are utterance-absolute."""
    core = _init(batch_size, int(beam_width), int(max_label_len), fusion,
                 device)
    return core + (torch.zeros((batch_size,), dtype=torch.int64,
                               device=device),)


def ctc_beam_update(state, logits: torch.Tensor, chunk_lengths: torch.Tensor,
                    fusion: Optional[FusionLM] = None):
    """Advance the beam by one (B, Tc, V) chunk, ``chunk_lengths`` (B,)
    of its frames live. Returns ``(new_state, (ids, lens, scores,
    frames))``, the current beams ranked best first."""
    core, t_done = state[:-1], state[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    core = _scan(core, logp, chunk_lengths, t_done, fusion)
    return core + (t_done + chunk_lengths.to(t_done),), _rank(core)
