"""CTC loss and greedy decoding in plain PyTorch.

Port of ``openseq2seq_tpu/ops/ctc.py``:

  * :func:`ctc_loss` — fp32 log-space alpha (forward) recursion, a
    Python loop over time vectorized over batch and extended label
    positions. :func:`ctc_nll` is that recursion on log-probs; it is also
    the plain version that ``ops/ctc_cuda.py`` holds its kernel against,
    as :func:`ctc_nll_grad` (:func:`ctc_nll_lattice`, then
    :func:`ctc_posteriors` and :func:`ctc_scatter`) is of its backward.
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


def _extended(labels: torch.Tensor, label_lengths: torch.Tensor,
              blank_id: int):
    """The blank-interleaved extended label sequence of each row: ids
    ``ext`` (B, S = 2L+1), the skip flags (a label differing from the one
    two states back), the states each row can reach (s < 2 len + 1), and
    whether the row has a label. A state past the row's length takes the
    blank's id, so that padding labels outside the vocabulary (the joint
    CTC-attention loss passes its end symbol there) are never read, as
    the JAX package's clamped gathers never use them."""
    B, L = labels.shape
    S = 2 * L + 1
    dev = labels.device
    s_idx = torch.arange(S, device=dev)
    is_label = (s_idx % 2) == 1
    label_idx = torch.clamp((s_idx - 1) // 2, 0, L - 1)
    ext_len = 2 * label_lengths + 1
    valid_s = s_idx[None, :] < ext_len[:, None]
    ext = torch.where(is_label[None, :] & valid_s, labels[:, label_idx],
                      blank_id)
    ext_m2 = torch.cat([torch.full((B, 2), blank_id, dtype=ext.dtype,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = is_label[None, :] & (ext != ext_m2) & (s_idx >= 2)[None, :]
    return ext, can_skip, valid_s, ext_len, label_lengths > 0


def _alpha_lattice(logprobs, logit_lengths, labels, label_lengths,
                   blank_id, keep_lattice: bool):
    """The alpha recursion: nll (B,), and alphas (B, T, S) or None."""
    B, T, _ = logprobs.shape
    labels = labels.long()
    label_lengths = label_lengths.long()
    logit_lengths = logit_lengths.long()
    ext, can_skip, valid_s, ext_len, has_label = _extended(
        labels, label_lengths, blank_id)
    S = ext.shape[1]
    dev = logprobs.device

    emit = torch.gather(logprobs, 2, ext[:, None, :].expand(B, T, S))

    neg = torch.full((B, S), NEG, dtype=logprobs.dtype, device=dev)
    alpha = neg.clone()
    alpha[:, 0] = emit[:, 0, 0]
    alpha[:, 1] = torch.where(has_label, emit[:, 0, 1], NEG)
    alpha = torch.where(valid_s, alpha, neg)
    alphas = [alpha] if keep_lattice else None

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
        if keep_lattice:
            alphas.append(alpha)

    end = torch.clamp(ext_len - 1, 0, S - 1)
    end_m1 = torch.clamp(ext_len - 2, 0, S - 1)
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_end_m1 = torch.gather(alpha, 1, end_m1[:, None])[:, 0]
    a_end_m1 = torch.where(has_label, a_end_m1, NEG)
    nll = -_logaddexp(a_end, a_end_m1)
    lattice = torch.stack(alphas, dim=1) if keep_lattice else None
    return nll, lattice


def ctc_nll(logprobs: torch.Tensor, logit_lengths: torch.Tensor,
            labels: torch.Tensor, label_lengths: torch.Tensor,
            blank_id: int) -> torch.Tensor:
    """(B,) negative log likelihood from (B, T, V) fp32 log-probs.

    The alpha recursion of the JAX package's ``ctc_loss``, before the
    infeasible-row mask. ``blank_id`` is a class index (not negative)."""
    return _alpha_lattice(logprobs, logit_lengths, labels, label_lengths,
                          blank_id, keep_lattice=False)[0]


def ctc_nll_lattice(logprobs: torch.Tensor, logit_lengths: torch.Tensor,
                    labels: torch.Tensor, label_lengths: torch.Tensor,
                    blank_id: int):
    """``(nll, lattice)``: the NLL of :func:`ctc_nll` and its (B, T, 2L+1)
    alpha lattice, frozen past each row's length. The plain twin of the
    CUDA kernel ``ctc_alpha_fwd`` with its lattice (which writes only the
    frames t < length and states s < 2 len + 1)."""
    return _alpha_lattice(logprobs, logit_lengths, labels, label_lengths,
                          blank_id, keep_lattice=True)


def ctc_posteriors(logprobs: torch.Tensor, logit_lengths: torch.Tensor,
                   labels: torch.Tensor, label_lengths: torch.Tensor,
                   blank_id: int, nll: torch.Tensor,
                   lattice: torch.Tensor) -> torch.Tensor:
    """(B, T, 2L+1) posteriors of the extended states, from the forward's
    NLL and alpha lattice (:func:`ctc_nll_lattice`): the beta recursion.

    The plain twin of the CUDA backward's first launch
    (``ctc_beta_bwd_kernel``) and of the TPU kernel ``_beta_chunk_kernel``'s
    recursion (``openseq2seq_tpu/ops/ctc_pallas.py:140``): beta runs in
    reverse with the same ``NEG``, ``_logaddexp``, skip and freeze rules,
    then ``gamma = alpha + beta - logZ`` and the posterior ``exp(max(gamma,
    -80))`` of each state. Frames ``t >= length``, states ``s >= 2 len +
    1`` and rows that fail :func:`feasible_rows` get exactly 0; the
    lattice is read nowhere else, so its values there may be anything."""
    B, T, _ = logprobs.shape
    ext, can_skip, valid_s, ext_len, _ = _extended(
        labels.long(), label_lengths.long(), blank_id)
    S = ext.shape[1]
    dev = logprobs.device
    emit = torch.gather(logprobs, 2, ext[:, None, :].expand(B, T, S))
    lens = torch.clamp(logit_lengths.long(), max=T)
    logz = -nll
    s_idx = torch.arange(S, device=dev)
    end_mask = (s_idx[None, :] >= ext_len[:, None] - 2) & \
        (s_idx[None, :] <= ext_len[:, None] - 1)
    neg = torch.full((B, S), NEG, dtype=logprobs.dtype, device=dev)
    beta_last = torch.where(end_mask, torch.zeros_like(neg), neg)
    # skip transition out of s into s + 2
    can_skip_fwd = torch.cat([can_skip[:, 2:], torch.zeros(
        (B, 2), dtype=torch.bool, device=dev)], dim=1)

    grads = torch.zeros((B, T, S), dtype=logprobs.dtype, device=dev)
    z = None                     # beta_{t+1} + emit_{t+1}
    for t in range(T - 1, -1, -1):
        if z is None:
            beta = neg
        else:
            shift1 = torch.cat([z[:, 1:], neg[:, :1]], dim=1)
            shift2 = torch.cat([z[:, 2:], neg[:, :2]], dim=1)
            cand = _logaddexp(z, shift1)
            cand = torch.where(can_skip_fwd, _logaddexp(cand, shift2), cand)
            beta = torch.where(valid_s, cand, neg)
        beta = torch.where((t == lens - 1)[:, None], beta_last, beta)
        live = (t < lens)[:, None]
        beta = torch.where(live, beta, neg)
        gamma = lattice[:, t] + beta - logz[:, None]
        post = torch.exp(torch.clamp(gamma, min=-80.0))
        grads[:, t] = torch.where(valid_s & live, post, 0.0)
        z = beta + emit[:, t]

    feasible = feasible_rows(logit_lengths, labels, label_lengths)
    return torch.where(feasible[:, None, None], grads, 0.0)


def ctc_scatter(posteriors: torch.Tensor, labels: torch.Tensor,
                label_lengths: torch.Tensor, blank_id: int,
                vocab: int) -> torch.Tensor:
    """(B, T, V) d NLL / d log-probs from the (B, T, 2L+1) posteriors of
    :func:`ctc_posteriors`: each state's posterior summed onto its
    vocabulary id (a label outside [0, V) has none), and ``dlp[t, v] =
    -that / (its sum over v)``; 0 on frames whose posteriors are all 0.
    The plain twin of the CUDA backward's second launch
    (``ctc_beta_bwd_scatter_kernel``) and of the TPU kernel's one-hot
    matmul."""
    ext = _extended(labels.long(), label_lengths.long(), blank_id)[0]
    dev = posteriors.device
    # vocabulary scatter as a matmul with the exact 0/1 one-hot of the
    # extended labels
    onehot = (ext[:, :, None] == torch.arange(vocab, device=dev)).to(
        posteriors.dtype)
    mass = torch.einsum("bts,bsv->btv", posteriors, onehot)
    total = mass.sum(dim=2, keepdim=True)
    return torch.where(total > 0, -mass / total, 0.0)


def ctc_nll_grad(logprobs: torch.Tensor, logit_lengths: torch.Tensor,
                 labels: torch.Tensor, label_lengths: torch.Tensor,
                 blank_id: int):
    """``(nll, dlogprobs)``: the NLL of :func:`ctc_nll` and its gradient
    with respect to the (B, T, V) fp32 log-probs: :func:`ctc_nll_lattice`,
    :func:`ctc_posteriors` and :func:`ctc_scatter` in turn, the plain
    twins of the CUDA kernels ``ctc_alpha_fwd`` (with its alpha lattice)
    and ``ctc_beta_bwd``'s two launches. Frames ``t >= length`` and rows
    that fail :func:`feasible_rows` get exactly 0 (the infeasible rows'
    loss is masked to 0 by the caller, so their gradient is 0 too).

    Each frame is divided by its posterior mass (1 in exact arithmetic),
    which the TPU kernel does not do. In fp32, gamma subtracts log-values
    of the size of logZ (about 1500 at the Jasper train shape, T=500 and
    L=160), and without it the posteriors of a frame sum to 1 only within
    about 1.6e-3 there; with it, within rounding, and the gradient's
    largest error against an fp64 run falls from about 1.6e-3 to 2e-4."""
    lp = logprobs.detach()
    nll, lattice = ctc_nll_lattice(lp, logit_lengths, labels, label_lengths,
                                   blank_id)
    post = ctc_posteriors(lp, logit_lengths, labels, label_lengths, blank_id,
                          nll, lattice)
    return nll, ctc_scatter(post, labels, label_lengths, blank_id,
                            logprobs.shape[2])


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
