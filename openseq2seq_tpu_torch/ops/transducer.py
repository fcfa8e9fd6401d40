"""RNN-Transducer (RNN-T) loss in plain PyTorch (port of
``openseq2seq_tpu/ops/transducer.py``; Graves 2012).

Conventions are the JAX package's: blank is the last class, lengths are
per example, and the recursion runs in fp32 whatever the model's compute
dtype. Off-lattice cells and labels past a row's length hold -1e30 in
place of -inf, and every log-sum-exp goes through ``ctc._logaddexp``,
which clamps its maximum, so masked branches give zero gradients and
never NaN.

  * :func:`transducer_loss` takes the (B, T, U+1, V) joint lattice. The
    blank and label log-probs are gathered once into diagonal coordinates
    ``diag[d, u] = M[d - u, u]``; one Python loop runs over the T + U - 1
    anti-diagonals on a (B, U+1) row, every cell of a diagonal depending
    only on the one before.
  * :func:`transducer_loss_fused` evaluates the joint (tanh, then the
    (J, V) product) inside that loop, ``block_size`` diagonals at a time,
    each block under ``torch.utils.checkpoint``: the (B, T, U+1, V)
    lattice is never held, the backward recomputes one block's joint at a
    time, and what is kept is O(B (T + U) (U + 1)) scalars. Its blocks are
    the JAX package's, so the two agree block for block, the trailing
    partial block's padded diagonals included (they are sliced off).
  * FastEmit (Yu et al. 2021): the label log-probs pass through
    :class:`_FastEmitScale`, the identity forward whose backward scales the
    gradient by (1 + lambda).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .ctc import _logaddexp

_NEG_INF = -1e30


class _FastEmitScale(torch.autograd.Function):
    """Identity forward; the gradient scaled by (1 + lam) backward."""

    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * (1.0 + ctx.lam), None


def _fastemit_scale(label_lp: torch.Tensor, lam: float) -> torch.Tensor:
    """FastEmit's emission-gradient scale; ``lam`` 0 is a no-op."""
    if lam == 0.0:
        return label_lp
    return _FastEmitScale.apply(label_lp, float(lam))


def _step(a: torch.Tensor, bd: torch.Tensor, ld: torch.Tensor
          ) -> torch.Tensor:
    """One anti-diagonal: alpha[t, u] = logaddexp(alpha[t-1, u] +
    blank[t-1, u], alpha[t, u-1] + label[t, u-1]), both source terms on
    the previous diagonal ``a`` (B, U+1)."""
    label_term = a + ld
    shifted = F.pad(label_term[:, :-1], (1, 0), value=_NEG_INF)
    return _logaddexp(a + bd, shifted)


def _initial_alpha(B: int, U1: int, device) -> torch.Tensor:
    a0 = torch.full((B, U1), _NEG_INF, device=device)
    a0[:, 0] = 0.0
    return a0


def _final_picks(logit_lengths, label_lengths, T: int, U: int):
    t_last = torch.clamp(logit_lengths.long() - 1, 0, T - 1)
    u_last = torch.clamp(label_lengths.long(), 0, U)
    return t_last, u_last, t_last + u_last


def _reduce(ll, logit_lengths, average_across_batch: bool):
    loss = -torch.where(logit_lengths > 0, ll, torch.zeros_like(ll))
    return loss.mean() if average_across_batch else loss


def transducer_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
                    labels: torch.Tensor, label_lengths: torch.Tensor,
                    blank_id: int = -1, average_across_batch: bool = True,
                    fastemit_lambda: float = 0.0) -> torch.Tensor:
    """Transducer negative log likelihood of the (B, T, U+1, V) joint
    lattice (position u of the third axis conditions on the first u
    labels); ``labels`` (B, U), lengths (B,). Returns the batch mean, or
    the (B,) losses."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    if blank_id < 0:
        blank_id = V + blank_id
    dev = logits.device
    lp = F.log_softmax(logits.float(), dim=-1)
    blank_lp = lp[..., blank_id]                                # (B,T,U1)
    # emitting from u = U (all labels consumed) or u >= label_len is
    # impossible
    neg_col = torch.full((B, T, 1), _NEG_INF, device=dev)
    if U > 0:
        lab = torch.clamp(labels.long(), 0, V - 1)
        label_lp = torch.gather(
            lp[:, :, :U, :], 3,
            lab[:, None, :, None].expand(B, T, U, 1))[..., 0]
        label_lp = torch.cat([label_lp, neg_col], dim=2)
    else:
        label_lp = neg_col
    u_idx = torch.arange(U1, device=dev)
    label_lp = torch.where(
        u_idx[None, None, :] < label_lengths.to(dev)[:, None, None],
        label_lp, _NEG_INF)
    label_lp = _fastemit_scale(label_lp, fastemit_lambda)

    # diag[b, d, u] = M[b, d - u, u]
    D = T + U
    t_of = torch.arange(D, device=dev)[:, None] - u_idx[None, :]   # (D,U1)
    on_lattice = (t_of >= 0) & (t_of <= T - 1)
    gather_t = torch.clamp(t_of, 0, T - 1)[None].expand(B, D, U1)

    def to_diag(m):
        return torch.where(on_lattice[None],
                           torch.gather(m, 1, gather_t), _NEG_INF)

    blank_diag = to_diag(blank_lp)
    label_diag = to_diag(label_lp)

    # diagonals 1..D-1 consume source diagonals 0..D-2
    a = _initial_alpha(B, U1, dev)
    alphas = [a]
    for d in range(D - 1):
        a = _step(a, blank_diag[:, d], label_diag[:, d])
        alphas.append(a)
    alpha = torch.stack(alphas, 0)                               # (D,B,U1)

    # log P(y|x) = alpha[T_b - 1, U_b] + blank_lp[T_b - 1, U_b]
    b_idx = torch.arange(B, device=dev)
    t_last, u_last, d_last = _final_picks(logit_lengths.to(dev),
                                          label_lengths.to(dev), T, U)
    ll = alpha[d_last, b_idx, u_last] + blank_lp[b_idx, t_last, u_last]
    return _reduce(ll, logit_lengths.to(dev), average_across_batch)


def transducer_loss_fused(enc_j: torch.Tensor, pred_j: torch.Tensor,
                          joint_b: torch.Tensor, out_w: torch.Tensor,
                          out_b: torch.Tensor, logit_lengths: torch.Tensor,
                          labels: torch.Tensor, label_lengths: torch.Tensor,
                          blank_id: int = -1,
                          average_across_batch: bool = True,
                          block_size: int = 8,
                          fastemit_lambda: float = 0.0) -> torch.Tensor:
    """The transducer loss with the joint evaluated inside the wavefront,
    ``block_size`` anti-diagonals a block: ``enc_j`` (B, T, J) and
    ``pred_j`` (B, U+1, J) are the activations after the joint's encoder
    and prediction projections, ``joint_b`` (J,), ``out_w`` (J, V) and
    ``out_b`` (V,) the rest of the joint. The joint computes in
    ``enc_j``'s dtype and its logits are cast to fp32 for the
    log-softmax, as in :func:`transducer_loss`'s unfused path."""
    B, T, J = enc_j.shape
    U1 = pred_j.shape[1]
    U = U1 - 1
    V = out_w.shape[1]
    if blank_id < 0:
        blank_id = V + blank_id
    dev = enc_j.device
    dt = enc_j.dtype
    pred_j = pred_j.to(dt)
    joint_b = joint_b.to(dt)
    out_w = out_w.to(dt)
    out_b = out_b.to(dt)
    logit_lengths = logit_lengths.to(dev)
    label_lengths = label_lengths.to(dev)

    u_idx = torch.arange(U1, device=dev)
    lab_u1 = F.pad(torch.clamp(labels.long().to(dev), 0, V - 1), (0, 1))
    # emitting a label from position u needs u < label_len (and u < U)
    label_ok = u_idx[None, :] < torch.clamp(label_lengths, max=U)[:, None]
    W = max(1, int(block_size))
    w_idx = torch.arange(W, device=dev)

    def block_logprobs(d0: int, enc_j, pred_j, joint_b, out_w, out_b):
        """Blank and label log-probs of every lattice cell on the W
        source diagonals d0 .. d0+W-1 (cells (t = d - u, u)); off-lattice
        cells, whole padded diagonals past D - 1 among them, -1e30."""
        t_of = (d0 + w_idx)[:, None] - u_idx[None, :]             # (W,U1)
        on_lat = (t_of >= 0) & (t_of <= T - 1)
        # several cells read one frame: indexing's backward accumulates
        enc_d = enc_j[:, torch.clamp(t_of, 0, T - 1), :]        # (B,W,U1,J)
        h = torch.tanh(enc_d + pred_j[:, None] + joint_b)
        logits = (h @ out_w + out_b).float()                    # (B,W,U1,V)
        lp = F.log_softmax(logits, dim=-1)
        blank_d = torch.where(on_lat[None], lp[..., blank_id], _NEG_INF)
        label_d = torch.gather(
            lp, 3, lab_u1[:, None, :, None].expand(B, W, U1, 1))[..., 0]
        label_d = torch.where(on_lat[None] & label_ok[:, None], label_d,
                              _NEG_INF)
        return blank_d, _fastemit_scale(label_d, fastemit_lambda)

    def block_step(a, d_first: int, *weights):
        bd, ld = block_logprobs(d_first - 1, *weights)
        outs = []
        for w in range(W):
            a = _step(a, bd[:, w], ld[:, w])
            outs.append(a)
        return torch.stack(outs, 0)                              # (W,B,U1)

    weights = (enc_j, pred_j, joint_b, out_w, out_b)
    D = T + U
    nsteps = -(-(D - 1) // W)
    a = _initial_alpha(B, U1, dev)
    alphas = [a[None]]
    for i in range(nsteps):
        outs = checkpoint(block_step, a, 1 + W * i, *weights,
                          use_reentrant=False)
        alphas.append(outs)
        a = outs[-1]
    # trailing padded diagonals (>= D) hold garbage: sliced off
    alpha = torch.cat(alphas, 0)[:D]                             # (D,B,U1)

    b_idx = torch.arange(B, device=dev)
    t_last, u_last, d_last = _final_picks(logit_lengths, label_lengths, T, U)
    # the final blank emission log-prob at (T_b - 1, U_b), pointwise
    h_fin = torch.tanh(enc_j[b_idx, t_last] + pred_j[b_idx, u_last] +
                       joint_b)                                   # (B,J)
    lp_fin = F.log_softmax((h_fin @ out_w + out_b).float(), dim=-1)
    ll = alpha[d_last, b_idx, u_last] + lp_fin[:, blank_id]
    return _reduce(ll, logit_lengths, average_across_batch)
