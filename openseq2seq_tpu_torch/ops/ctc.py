"""CTC loss and greedy decoding in plain PyTorch.

Port of ``openseq2seq_tpu/ops/ctc.py``:

  * :func:`ctc_loss` — fp32 log-space alpha (forward) recursion, a
    Python loop over time vectorized over batch and extended label
    positions. :func:`ctc_nll` is that recursion on log-probs; it is also
    the plain version that ``ops/ctc_cuda.py`` holds its kernel against.
  * :func:`ctc_greedy_decode` — argmax, collapse repeats, drop blanks,
    compacted into a dense (B, T) id matrix padded with -1, plus lengths.

Semantics kept from the JAX package: infeasible rows (labels that cannot
fit in the logit length) get exactly 0 loss under
``ignore_longer_outputs_than_inputs``; the blank id is the last class.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30  # large-negative stand-in for -inf, as in the JAX package


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.clamp(torch.maximum(a, b), min=NEG)
    return mx + torch.log1p(torch.exp(torch.minimum(a, b) - mx))


def resolve_blank(blank_id: int, vocab: int) -> int:
    return vocab + blank_id if blank_id < 0 else blank_id


def log_probs(logits: torch.Tensor) -> torch.Tensor:
    """fp32 log-softmax over the vocabulary, whatever the logits' dtype."""
    return F.log_softmax(logits.float(), dim=-1)


def ctc_nll(logprobs: torch.Tensor, logit_lengths: torch.Tensor,
            labels: torch.Tensor, label_lengths: torch.Tensor,
            blank_id: int) -> torch.Tensor:
    """(B,) negative log likelihood from (B, T, V) fp32 log-probs.

    The alpha recursion of the JAX package's ``ctc_loss``, before the
    infeasible-row mask. ``blank_id`` is a class index (not negative)."""
    B, T, _ = logprobs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logprobs.device
    labels = labels.long()
    label_lengths = label_lengths.long()
    logit_lengths = logit_lengths.long()

    # extended label sequence: blank, l1, blank, l2, ..., blank
    s_idx = torch.arange(S, device=dev)
    is_label = (s_idx % 2) == 1
    label_idx = torch.clamp((s_idx - 1) // 2, 0, L - 1)
    ext = torch.where(is_label[None, :], labels[:, label_idx], blank_id)
    ext_m2 = torch.cat([torch.full((B, 2), blank_id, dtype=ext.dtype,
                                   device=dev), ext[:, :-2]], dim=1)
    # skip transition into s allowed when s is a label differing from s-2
    can_skip = is_label[None, :] & (ext != ext_m2) & (s_idx >= 2)[None, :]
    ext_len = 2 * label_lengths + 1
    valid_s = s_idx[None, :] < ext_len[:, None]

    emit = torch.gather(logprobs, 2, ext[:, None, :].expand(B, T, S))

    neg = torch.full((B, S), NEG, dtype=torch.float32, device=dev)
    alpha = neg.clone()
    alpha[:, 0] = emit[:, 0, 0]
    has_label = label_lengths > 0
    alpha[:, 1] = torch.where(has_label, emit[:, 0, 1], NEG)
    alpha = torch.where(valid_s, alpha, neg)

    neg1 = neg[:, :1]
    neg2 = neg[:, :2]
    for t in range(1, T):
        shift1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
        cand = _logaddexp(alpha, shift1)
        cand = torch.where(can_skip, _logaddexp(cand, shift2), cand)
        new = torch.where(valid_s, cand + emit[:, t], neg)
        # frozen past the row's logit length
        alpha = torch.where((t < logit_lengths)[:, None], new, alpha)

    end = torch.clamp(ext_len - 1, 0, S - 1)
    end_m1 = torch.clamp(ext_len - 2, 0, S - 1)
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_end_m1 = torch.gather(alpha, 1, end_m1[:, None])[:, 0]
    a_end_m1 = torch.where(has_label, a_end_m1, NEG)
    return -_logaddexp(a_end, a_end_m1)


def feasible_rows(logit_lengths: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the labels fit in the logits (one frame per label plus
    one per adjacent repeat)."""
    B, L = labels.shape
    prev = torch.cat([torch.full((B, 1), -1, dtype=labels.dtype,
                                 device=labels.device), labels[:, :-1]], dim=1)
    in_range = (torch.arange(L, device=labels.device)[None, :] <
                label_lengths[:, None])
    repeats = torch.sum((labels == prev) & in_range, dim=1)
    return logit_lengths >= (label_lengths + repeats)


def reduce_nll(nll: torch.Tensor, logit_lengths: torch.Tensor,
               labels: torch.Tensor, label_lengths: torch.Tensor,
               ignore_longer_outputs_than_inputs: bool,
               average_across_batch: bool) -> torch.Tensor:
    if ignore_longer_outputs_than_inputs:
        nll = torch.where(feasible_rows(logit_lengths, labels, label_lengths),
                          nll, torch.zeros_like(nll))
    return nll.mean() if average_across_batch else nll


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = -1,
             ignore_longer_outputs_than_inputs: bool = True,
             average_across_batch: bool = True) -> torch.Tensor:
    """CTC negative log likelihood of (B, T, V) logits (any float dtype;
    the recursion runs in fp32). Returns the batch mean, or (B,)."""
    blank = resolve_blank(blank_id, logits.shape[2])
    nll = ctc_nll(log_probs(logits), logit_lengths, labels, label_lengths,
                  blank)
    return reduce_nll(nll, logit_lengths, labels, label_lengths,
                      ignore_longer_outputs_than_inputs, average_across_batch)


def ctc_greedy_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                      blank_id: int = -1, merge_repeated: bool = True):
    """Greedy (best-path) CTC decoding: ``(ids, lengths)`` with ids (B, T)
    int32, left-compacted and padded with -1."""
    B, T, V = logits.shape
    blank = resolve_blank(blank_id, V)
    best = torch.argmax(logits, dim=-1)                        # (B, T)
    t_idx = torch.arange(T, device=logits.device)[None, :]
    in_time = t_idx < logit_lengths[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=best.dtype,
                                 device=best.device), best[:, :-1]], dim=1)
    keep = (best != blank) & in_time
    if merge_repeated:
        keep &= best != prev
    pos = torch.cumsum(keep.long(), dim=1) - 1                 # target slot
    lengths = torch.clamp(pos[:, -1] + 1, min=0)
    # dropped frames scatter into a dummy slot T that is sliced away
    out = torch.full((B, T + 1), -1, dtype=best.dtype, device=best.device)
    out.scatter_(1, torch.where(keep, pos, T), best)
    out = out[:, :T]
    out = torch.where(t_idx < lengths[:, None], out, -1)
    return out.int(), lengths.int()
