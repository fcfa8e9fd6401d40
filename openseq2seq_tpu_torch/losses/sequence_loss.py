"""Sequence losses (port of ``openseq2seq_tpu/losses/sequence_loss.py``),
all in fp32:

  * :class:`BasicSequenceLoss` (``:25-59``): the full softmax's NLL of
    each valid position, ``logsumexp(logits) - logits[gold]``, averaged
    over the valid positions (``average_across_timestep``) or summed and
    divided by the batch size; ``offset_target_by_one`` predicts y[t + 1]
    from position t. The logsumexp runs over row blocks of about 2^28
    logits, so that no (B, T, V) one-hot, log-softmax or exp is ever built
    beside the logits (each is another 23 GB at the LSTM LM's size);
  * :class:`BasicSampledSequenceLoss` (``:149-233``): the same, or, when
    the decoder output carries the sampled-softmax bundle (the LM encoder
    emits it in training), the candidate-sampling estimator of
    :func:`sampled_softmax_nll` over ``num_sampled`` candidates drawn by
    :func:`log_uniform_candidates` from the bundle's generator. The JAX
    package draws them with a key folded with the targets' sum; its
    threefry bits cannot be drawn here, so the two agree in law, and
    :func:`sampled_softmax_nll` agrees with the JAX estimator given the
    same candidates;
  * :class:`CrossEntropyWithSmoothing` (``:66-108``): the same
    reductions as :class:`BasicSequenceLoss` over the cross entropy with
    the smoothed targets ``onehot (1 - s) + s / V``, computed as
    ``lse - (1 - s) logits[gold] - (s / V) sum(logits)`` with the blocked
    logsumexp, so that no (B, T, V) one-hot is built;
  * :class:`PaddedCrossEntropyLossWithSmoothing` (``:111-146``): label
    smoothing with confidence 1 - s on the gold class and s / (V - 1) on
    each other class, the exact normalizing constant (the least possible
    loss) subtracted, averaged over non-pad (id != 0) positions.

``offset_target_by_one`` (on by default) shifts the labels by one unless
the input dict says ``"targets_aligned": True``: a Text2Text model shifts
its targets itself, once, and says so (``models/text2text.py``). The JAX
package's Text2Text shifts them and its loss shifts them again, so its
logits at t are scored against y[t + 2] (C22); the language model, whose
targets come unshifted, keeps the loss's single shift.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .loss import Loss

# logits a logsumexp block reads at once (1 GiB of fp32)
_LSE_BLOCK = 1 << 28


def _valid_mask(labels: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T) fp32: 1 where t < length."""
    T = labels.shape[1]
    return (torch.arange(T, device=labels.device)[None, :] <
            lengths[:, None]).float()


def _reduce(nll: torch.Tensor, labels: torch.Tensor, lengths: torch.Tensor,
            average_across_timestep: bool, batch_size: Optional[int],
            do_mask: bool = True) -> torch.Tensor:
    """The masked sum of the (B, T) NLL over the valid positions' count,
    or over ``batch_size``."""
    mask = _valid_mask(labels, lengths) if do_mask else torch.ones_like(nll)
    total = (nll * mask).sum()
    if average_across_timestep:
        return total / mask.sum().clamp(min=1.0)
    return total / batch_size


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis of fp32 ``logits`` (..., V), one block
    of rows at a time."""
    V = logits.shape[-1]
    flat = logits.reshape(-1, V)
    rows = max(1, _LSE_BLOCK // V)
    lse = torch.cat([torch.logsumexp(block, dim=-1)
                     for block in flat.split(rows)])
    return lse.reshape(logits.shape[:-1])


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


class _FullSoftmaxNLL(torch.autograd.Function):
    """The blocked NLL with a blocked backward: the gradient of the logits,
    ``g (softmax(logits) - onehot(labels))``, written one block of rows at
    a time into one tensor the logits' size, so that a step holds the
    logits and their gradient and nothing else that size (autograd's own
    backward of the blocks and the gather holds three more)."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = _logsumexp(logits)
        ctx.save_for_backward(logits, labels, lse)
        return lse - _gold(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        V = logits.shape[-1]
        flat, lse, g = logits.reshape(-1, V), lse.reshape(-1), \
            g.reshape(-1).float()
        grad = torch.empty_like(flat)
        rows = max(1, _LSE_BLOCK // V)
        for i in range(0, flat.shape[0], rows):
            block = slice(i, i + rows)
            torch.exp(flat[block] - lse[block, None], out=grad[block])
            grad[block] *= g[block, None]
        lab = labels.reshape(-1).long()
        grad[torch.arange(grad.shape[0], device=grad.device), lab] -= g
        return grad.reshape(logits.shape), None


def full_softmax_nll(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """(B, T) NLL of ``labels`` under the softmax of fp32 ``logits``
    (B, T, V): the blocked logsumexp less the gold logit."""
    return _FullSoftmaxNLL.apply(logits, labels)


def smoothed_nll(logits: torch.Tensor, labels: torch.Tensor,
                 smoothing: float, vocab_size: int) -> torch.Tensor:
    """(B, T) cross entropy of the softmax of fp32 ``logits`` against the
    smoothed one-hot ``onehot (1 - s) + s / V``: ``lse - (1 - s) gold -
    (s / V) sum(logits)``, as the smoothed weights sum to 1 over V
    classes (the JAX package's ``-sum(smoothed * log_softmax)``)."""
    nll = _logsumexp(logits) - (1.0 - smoothing) * _gold(logits, labels)
    if smoothing:
        nll = nll - (smoothing / vocab_size) * logits.sum(-1)
    return nll


def log_q(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """log of the log-uniform (Zipf) probability of each id,
    log(log1p(1 / (k + 1)) / log1p(V)), fp32. The log1p form is required:
    log((k + 2) / (k + 1)) as a difference of logs cancels at large k,
    where its ~1/k sits under an ulp, and gave log(0) = -inf for
    thousands of the 267,744 ids of WikiText-103 on the TPU (C4)."""
    k = ids.float()
    v = torch.tensor(float(vocab_size), device=ids.device)
    return torch.log(torch.log1p(1.0 / (k + 1.0)) / torch.log1p(v))


def log_uniform_candidates(num_sampled: int, vocab_size: int,
                           generator: torch.Generator,
                           device) -> torch.Tensor:
    """``num_sampled`` int64 ids drawn with replacement from the
    log-uniform law: ``floor(exp(u log(V + 1))) - 1``, clipped to [0, V),
    for u ~ U[0, 1) from ``generator`` (on ``device``), in fp32 as the JAX
    package draws them."""
    u = torch.rand((num_sampled,), generator=generator, device=device)
    v1 = torch.tensor(float(vocab_size) + 1.0, device=device)
    ids = torch.floor(torch.exp(u * torch.log(v1))) - 1.0
    return ids.clamp(0, vocab_size - 1).long()


def sampled_softmax_nll(inputs: torch.Tensor, weights: torch.Tensor,
                        bias: torch.Tensor, labels: torch.Tensor,
                        lengths: torch.Tensor, sampled: torch.Tensor,
                        vocab_size: int,
                        average_across_timestep: bool = True,
                        batch_size: Optional[int] = None,
                        do_mask: bool = True) -> torch.Tensor:
    """The sampled-softmax loss of ``inputs`` (B, T, H) against
    ``labels`` (B, T) with the softmax ``weights`` (V, H) and ``bias``
    (V,), over the candidates ``sampled`` (S,), in fp32: for each
    position the true logit and the S sampled ones, each less the log_q
    of its id (the expected-count correction), a sampled candidate equal
    to the true class (an accidental hit) at -1e9, and the NLL
    ``logsumexp([true | sampled]) - true``; then reduced over the valid
    positions as :class:`BasicSequenceLoss` reduces (``batch_size``
    divides the sum without ``average_across_timestep``)."""
    B, T, H = inputs.shape
    flat_in = inputs.reshape(-1, H).float()
    flat_lab = labels.reshape(-1).long()
    sampled = sampled.long()
    w, b = weights.float(), bias.float()
    true_logit = ((flat_in * w[flat_lab]).sum(-1) + b[flat_lab] -
                  log_q(flat_lab, vocab_size))                   # (N,)
    samp_logits = (flat_in @ w[sampled].t() + b[sampled] -
                   log_q(sampled, vocab_size))                   # (N, S)
    hit = sampled[None, :] == flat_lab[:, None]
    samp_logits = samp_logits.masked_fill(hit, -1e9)
    cat = torch.cat([true_logit[:, None], samp_logits], dim=1)
    nll = (torch.logsumexp(cat, dim=1) - true_logit).reshape(B, T)
    return _reduce(nll, labels, lengths, average_across_timestep,
                   batch_size, do_mask)


class BasicSequenceLoss(Loss):

    @staticmethod
    def get_required_params():
        return dict(Loss.get_required_params(), **{
            "tgt_vocab_size": int,
            "batch_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Loss.get_optional_params(), **{
            "offset_target_by_one": bool,
            "average_across_timestep": bool,
            "do_mask": bool,
        })

    def __init__(self, params, model, name="basic_sequence_loss"):
        super().__init__(params, model, name)
        self._offset = self._params.get("offset_target_by_one", True)
        self._avg_time = self._params.get("average_across_timestep", False)
        self._do_mask = self._params.get("do_mask", True)

    def _targets(self, input_dict):
        """(labels, lengths), shifted by one with ``offset_target_by_one``
        (the first label and the last position dropped) unless the
        caller aligned them already (``targets_aligned``)."""
        labels, lengths = input_dict["target_tensors"]
        if self._offset and not input_dict.get("targets_aligned", False):
            return labels[:, 1:], lengths - 1
        return labels, lengths

    def compute_loss(self, input_dict):
        labels, lengths = self._targets(input_dict)
        logits = input_dict["decoder_output"]["logits"].float()
        nll = full_softmax_nll(logits[:, :labels.shape[1]], labels)
        return _reduce(nll, labels, lengths, self._avg_time,
                       self._params["batch_size"], self._do_mask)


class BasicSampledSequenceLoss(BasicSequenceLoss):
    """The sampled-softmax sequence loss; the full softmax where the
    decoder output has no sampled-softmax bundle (eval, or
    ``num_sampled`` 0). Without a generator in the bundle (a train step
    called without one) the candidates come from a generator seeded with
    ``sample_seed``."""

    @staticmethod
    def get_optional_params():
        return dict(BasicSequenceLoss.get_optional_params(), **{
            "sample_seed": int,
        })

    def compute_loss(self, input_dict):
        dec = input_dict["decoder_output"]
        if "weights" not in dec:
            return super().compute_loss(input_dict)
        labels, lengths = self._targets(input_dict)
        inputs = dec["inputs"][:, :labels.shape[1]]
        generator = dec.get("generator")
        if generator is None:
            generator = torch.Generator(device=inputs.device).manual_seed(
                self._params.get("sample_seed", 0))
        V = self._params["tgt_vocab_size"]
        sampled = log_uniform_candidates(int(dec["num_sampled"]), V,
                                         generator, inputs.device)
        return sampled_softmax_nll(inputs, dec["weights"], dec["bias"],
                                   labels, lengths, sampled, V,
                                   self._avg_time, self._params["batch_size"],
                                   self._do_mask)


class CrossEntropyWithSmoothing(BasicSequenceLoss):
    """Label-smoothed cross entropy with :class:`BasicSequenceLoss`'s
    shift and reductions."""

    @staticmethod
    def get_optional_params():
        return dict(BasicSequenceLoss.get_optional_params(), **{
            "label_smoothing": float,
        })

    def __init__(self, params, model, name="cross_entropy_with_smoothing"):
        super().__init__(params, model, name)
        self._smoothing = self._params.get("label_smoothing", 0.0)

    def compute_loss(self, input_dict):
        labels, lengths = self._targets(input_dict)
        logits = input_dict["decoder_output"]["logits"].float()
        nll = smoothed_nll(logits[:, :labels.shape[1]], labels,
                           self._smoothing, self._params["tgt_vocab_size"])
        return _reduce(nll, labels, lengths, self._avg_time,
                       self._params["batch_size"], self._do_mask)


class PaddedCrossEntropyLossWithSmoothing(Loss):

    @staticmethod
    def get_optional_params():
        return dict(Loss.get_optional_params(), **{
            "batch_size": int,
            "tgt_vocab_size": int,
            "label_smoothing": float,
            "pad_embeddings_2_eight": bool,
        })

    def __init__(self, params, model, name="padded_cross_entropy"):
        super().__init__(params, model, name)
        self._smoothing = self._params.get("label_smoothing", 0.0)

    def compute_loss(self, input_dict):
        labels = input_dict["target_tensors"][0].long()
        logits = input_dict["decoder_output"]["logits"].float()
        logits = logits[:, :labels.shape[1], :]
        V = logits.shape[-1]
        confidence = 1.0 - self._smoothing
        low = self._smoothing / (V - 1) if V > 1 else 0.0
        logp = torch.log_softmax(logits, dim=-1)
        gold = torch.gather(logp, -1, labels[..., None])[..., 0]
        # sum_v soft_v logp_v with soft = low everywhere, confidence at gold
        xent = -(low * logp.sum(-1) + (confidence - low) * gold)
        if self._smoothing > 0 and V > 1:
            xent = xent + (confidence * math.log(confidence) +
                           (V - 1) * low * math.log(low + 1e-20))
        mask = (labels != 0).float()
        return (xent * mask).sum() / mask.sum().clamp(min=1.0)
