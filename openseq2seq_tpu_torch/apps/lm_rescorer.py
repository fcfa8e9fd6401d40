"""Neural LM rescoring of ASR n-best lists (port of
``openseq2seq_tpu/apps/lm_rescorer.py``), with any language model built
on ``LSTMLM``: the LSTM LM (its layers on kernel B3 under ``fused_rnn``
where the batch and width are supported) or Transformer-XL.

Each hypothesis is ``<eos> words <eos>``, its score the sum of the
next-token log-probabilities under the length mask (position t predicts
token t + 1); the final score of a hypothesis is
``am_score + lm_weight * lm_logprob + word_bonus * num_words``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.model import to_device_batch


class NeuralRescorer:

    def __init__(self, lm_model, checkpoint: str):
        """``lm_model`` is an ``LSTMLM`` built in eval mode with its
        WikiText-style data layer (the vocabulary); ``checkpoint`` a
        directory ``training/trainer.restore_state`` restores."""
        from ..training.trainer import restore_state
        self.model = lm_model
        self.state = restore_state(lm_model, checkpoint)
        self.word2idx = lm_model.get_data_layer().corp.word2idx
        self.unk = self.word2idx.get("<unk>", 0)
        self.eos = self.word2idx.get("<eos>", 1)

    def _score(self, x: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        batch = to_device_batch({"source_tensors": [x, lengths]},
                                self.model.device)
        x, lengths = batch["source_tensors"]
        with torch.no_grad():
            out = self.state.module(batch, train=False)
            logp = torch.log_softmax(
                out["decoder_output"]["logits"].float(), dim=-1)
            tgt = x[:, 1:].long()
            tok_lp = torch.gather(logp[:, :-1], -1, tgt[..., None])[..., 0]
            mask = torch.arange(tgt.shape[1], device=x.device)[None, :] < \
                (lengths - 1)[:, None]
            return (tok_lp * mask).sum(1).cpu().numpy()

    def _encode(self, text: str) -> List[int]:
        return ([self.eos] +
                [self.word2idx.get(t, self.unk) for t in text.split()] +
                [self.eos])

    def lm_scores(self, texts: Sequence[str]) -> np.ndarray:
        """The LM log-probability of each text, one batch padded to a
        multiple of 8 tokens."""
        ids = [self._encode(t) for t in texts]
        T = max(max(len(i) for i in ids), 2)
        T = (T + 7) // 8 * 8
        x = np.zeros((len(ids), T), np.int32)
        lengths = np.zeros((len(ids),), np.int32)
        for i, seq in enumerate(ids):
            x[i, :len(seq)] = seq
            lengths[i] = len(seq)
        return self._score(x, lengths)

    def rescore(self, nbest: Sequence[Sequence[Tuple[float, str]]],
                lm_weight: float = 0.5,
                word_bonus: float = 0.0) -> List[str]:
        """nbest: per utterance [(am_score, text), ...]; the best text of
        each utterance after the combination."""
        flat_texts, offsets = [], [0]
        for hyps in nbest:
            flat_texts.extend(t for _, t in hyps)
            offsets.append(len(flat_texts))
        lm = self.lm_scores(flat_texts) if flat_texts else np.zeros(0)
        out = []
        for ui, hyps in enumerate(nbest):
            best_text, best_score = "", -np.inf
            for hi, (am, text) in enumerate(hyps):
                score = (am + lm_weight * lm[offsets[ui] + hi] +
                         word_bonus * len(text.split()))
                if score > best_score:
                    best_score, best_text = score, text
            out.append(best_text)
        return out
