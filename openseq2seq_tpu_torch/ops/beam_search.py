"""Batched beam search (port of ``openseq2seq_tpu/ops/beam_search.py``).

The same alive/finished state machine: sequence buffers (B, K, T_max+1)
with ``bos_id`` at position 0, only beam 0 alive at step 0, the GNMT
length penalty ((5 + len) / 6)^alpha, early termination once the best
alive score cannot beat the worst finished one, and a fall-back to the
alive beams for rows where nothing finished. ``beam_size=1`` is greedy.

``symbols_to_logits_fn(ids, i) -> logits`` runs one decoder step on the
flattened (B*K, 1) ids at position ``i`` and returns (B*K, V) logits. The
step function owns its cache; after each step ``reorder_cache(parents,
i)`` is called with the (B*K,) flattened row of each surviving beam's
parent, so that the cache rows written up to position ``i`` follow their
beams (the JAX package gathers its cache pytree with the same composed
indices, once per step).

Where ties decide, the order is ``lax.top_k``'s, lower index first: the
small top-k's over the 2K, K*kb and 3K candidates use a stable
descending sort and a slice (the finished set starts as K copies of
NEG_INF, so those ties decide the ``beams`` output). The per-beam top-2K
over the vocabulary is ``torch.topk``; the JAX package's
``_topk_grouped`` is a TPU rewrite of the same exact top-k.

The JAX package runs the loop condition on the device inside a
``while_loop``. Here it is one host read per step; the loop stops where
JAX's stops, so the results are the same. ``segment_bounds`` and the
lazy cache of the JAX package only shape the TPU's cache traffic and
give identical beams; the port has no such argument (the decoder bounds
its cache reads by position instead). A tracer cannot hold the host read:
under ``torch.export`` the search raises ValueError (:func:`refuse_trace`).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

NEG_INF = -1.0e7


def refuse_trace(what: str) -> None:
    """Raise ValueError under a tracer (``torch.export``): ``what`` reads
    the host, which a traced program cannot hold."""
    if torch.compiler.is_compiling():
        raise ValueError(
            "{} reads the host once a step: torch.export cannot trace it. "
            "Export a forward without it (for Text2Text the teacher-forced "
            "scoring forward, train=True with every dropout rate 0) and "
            "decode outside the artifact".format(what))


def _length_penalty(alpha: float, length: int) -> float:
    """((5 + length) / 6)^alpha computed in fp32, as the JAX package
    computes it; a host number, so dividing by it moves nothing."""
    length = torch.tensor(length, dtype=torch.float32)
    return float(torch.pow((5.0 + length) / 6.0, alpha))


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, and on ties the
    lower index first."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gather_beams(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x (B, K_old, ...), indices (B, K_new) -> (B, K_new, ...)."""
    idx = indices.reshape(indices.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(indices.shape + x.shape[2:]))


def beam_search(symbols_to_logits_fn: Callable[[torch.Tensor, int],
                                               torch.Tensor],
                reorder_cache: Callable[[torch.Tensor, int], None],
                batch_size: int, beam_size: int, vocab_size: int,
                max_decode_length: int, eos_id: int, alpha: float = 0.6,
                bos_id: int = 0, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (decoded ids (B, K, T_max+1) int32, scores (B, K) fp32),
    best first; position 0 holds ``bos_id``."""
    refuse_trace("the beam decode (ops/beam_search.py)")
    B, K, V, T = batch_size, beam_size, vocab_size, max_decode_length
    f32 = dict(dtype=torch.float32, device=device)
    seq = torch.full((B, K, T + 1), bos_id, dtype=torch.int32,
                     device=device)
    alive_lp = torch.tensor([[0.0] + [NEG_INF] * (K - 1)], **f32).repeat(
        B, 1)
    fin_seq = torch.zeros((B, K, T + 1), dtype=torch.int32, device=device)
    fin_scores = torch.full((B, K), NEG_INF, **f32)
    fin_flags = torch.zeros((B, K), dtype=torch.bool, device=device)
    row_base = torch.arange(B, device=device)[:, None] * K
    max_lp = _length_penalty(alpha, T)
    neg_inf = torch.tensor(NEG_INF, **f32)

    def still_improving() -> bool:
        best_alive = alive_lp[:, 0] / max_lp
        worst_finished = torch.where(fin_flags, fin_scores, neg_inf).amin(1)
        worst_finished = torch.where(fin_flags.any(1), worst_finished,
                                     neg_inf)
        # one host read per step: the loop condition
        return bool((best_alive > worst_finished).any())

    i = 0
    while i < T and still_improving():
        logits = symbols_to_logits_fn(seq[:, :, i].reshape(B * K, 1), i)
        raw = logits.float().reshape(B, K, V)

        # grow alive: per-beam top-kb over V on the raw logits (the
        # log-softmax and the alive log-prob shift a whole row), then the
        # top-2K of the K*kb survivors with their exact log-probs
        kb = min(2 * K, V)
        lp_raw, idx_pb = torch.topk(raw, kb, dim=-1)
        lse = torch.logsumexp(raw, dim=-1)
        lp_pb = lp_raw + (alive_lp - lse)[:, :, None]
        top_lp, sel = _top_k(lp_pb.reshape(B, K * kb), min(2 * K, K * kb))
        beam_idx = torch.div(sel, kb, rounding_mode="floor")
        token_idx = torch.gather(idx_pb.reshape(B, K * kb), 1, sel).to(
            torch.int32)
        top_seq = _gather_beams(seq, beam_idx)
        top_seq[:, :, i + 1] = token_idx
        is_eos = token_idx == eos_id

        # alive: the best K continuations that are not EOS
        alive_cand = torch.where(is_eos, neg_inf, top_lp)
        alive_lp, alive_sel = _top_k(alive_cand, K)
        seq = _gather_beams(top_seq, alive_sel)
        parents = torch.gather(beam_idx, 1, alive_sel) + row_base
        reorder_cache(parents.reshape(B * K), i)

        # finished: merge the EOS candidates into the finished set
        cand_scores = torch.where(
            is_eos, top_lp / _length_penalty(alpha, i + 1), neg_inf)
        all_scores = torch.cat([fin_scores, cand_scores], dim=1)
        fin_scores, fin_sel = _top_k(all_scores, K)
        fin_seq = _gather_beams(torch.cat([fin_seq, top_seq], dim=1),
                                fin_sel)
        fin_flags = _gather_beams(torch.cat([fin_flags, is_eos], dim=1),
                                  fin_sel)
        i += 1

    any_finished = fin_flags.any(1)
    out_seq = torch.where(any_finished[:, None, None], fin_seq, seq)
    out_scores = torch.where(any_finished[:, None], fin_scores,
                             alive_lp / max_lp)
    return out_seq, out_scores


def sequence_lengths_from_ids(ids: torch.Tensor, eos_id: int
                              ) -> torch.Tensor:
    """Length up to and including the first EOS (ids without BOS)."""
    is_eos = ids == eos_id
    seen = torch.cumsum(is_eos.int(), dim=-1)
    return ((seen == 0).int().sum(-1) + is_eos.any(-1).int()).to(
        torch.int32)
