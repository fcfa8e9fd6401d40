"""Listen-Attend-Spell decoder (port of
``openseq2seq_tpu/decoders/las_decoder.py``; reference
`open_seq2seq/decoders/las_decoder.py:22-399`): a character speller with
attention over the listener's outputs.

What the JAX module computes, and so the port:

  * the whole speller in fp32, whatever the compute type: the memory is
    cast to fp32 and every parameter is fp32;
  * ``num_heads`` heads, each with its keys ``att{i}_keys`` (a dense layer
    E -> A over the memory), its query ``att{i}_q`` (H, A), score vector
    ``att{i}_v`` and bias ``att{i}_b``, and its own output layer
    ``att{i}_out_w`` (H + E, H), ``att{i}_out_b``; the scores ``v .
    tanh(h q + keys + b)``, -1e9 past each memory length, softmax;
  * location-sensitive attention (``chorowski``; ``zhaopeng`` is the same)
    adds ``conv(prev) loc_proj`` to the energies: a SAME conv of kernel
    101 with 10 filters (``att{i}_loc_conv``, (101, 1, 10) as flax keeps
    it) over the previous alignment or, with ``use_coverage``, over the
    sum of the alignments so far; ``bahadanu`` is the reference's
    spelling of ``bahdanau``;
  * with ``pos_embedding``, learned 1024-row tables added to the memory
    (``EncoderPositionEmbeddingMatrix``) and to the inputs
    (``DecoderPositionEmbeddingMatrix``), zeros past the table;
  * ``num_layers`` cells on raw leaves ``rnn{i}_wx``, ``rnn{i}_wh``,
    ``rnn{i}_b``: the LSTM's gates i, f, g, o with 1.0 added to the forget
    gate, or the GRU with z and r from one product and the reset gate
    applied to h before the candidate's recurrent product (not the cuDNN
    variant of ``parts/rnns``); layer 1 takes [token embedding, previous
    attention output];
  * in training, dropout after each layer's output and before the
    projection ``fully_connected_w``, ``fully_connected_b``; the JAX
    module folds a key per step and site, the port draws its masks from
    the step's generator through :meth:`LASDecoderModule.keep_mask`
    (site ``i`` for layer i, ``num_layers`` for the projection);
  * teacher forcing over ``y[:, :-1]``; with ``plot_attention`` the
    alignments of head 0, (B, T, S);
  * beam search (``ops/beam_search.py``) with ``alpha`` 0 from
    ``GO_SYMBOL`` over ``min(S + 10, 1024)`` steps, S the padded memory
    length; the best beam without its start token and its length up to
    and including the first ``END_SYMBOL``. A transcript longer than
    ``S + 10`` characters is cut there, as in the JAX package (C28).

The JAX module decodes whenever its model is not a training one; the port
decodes in every call outside training (``train`` False), so that a
training run's evaluations, which reuse the training module, print their
WER. The teacher-forced pass is a Python loop over the positions; the
embedded tokens' share of layer 1's gates and the logits of all steps are
each one product outside the loop. ``use_language_model`` is accepted with
no effect, as in the JAX package (C28).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .decoder import Decoder
from .fc_decoders import Dense
from .rnn_decoders import _orthogonal, _param
from ..ops.beam_search import beam_search, sequence_lengths_from_ids
from ..parts.initializers import resolve_initializer

_NEG = -1e9
_MAX_POS = 1024          # the positional tables' rows
_LOC_FILTERS = 10
_LOC_KERNEL = 101


def _xavier(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``xavier_uniform`` on a flax-layout leaf: (in, out), or
    (k, in, out) with the receptive field k."""
    rf = w.shape[0] if w.dim() == 3 else 1
    limit = math.sqrt(6.0 / (rf * (w.shape[-2] + w.shape[-1])))
    w.uniform_(-limit, limit, generator=generator)


def _normal(std: float):
    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        w.normal_(0.0, std, generator=generator)
    return init


def _positions(table: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` rows of ``table``, zeros past its end."""
    pe = table[:min(n, _MAX_POS)]
    return F.pad(pe, (0, 0, 0, n - pe.shape[0])) if n > _MAX_POS else pe


class LASDecoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], enc_width: int, mode: str,
                 generator: torch.Generator):
        super().__init__()
        ap = p["attention_params"]
        att_type = ap.get("attention_type", "bahdanau")
        self.attention_type = "bahdanau" if att_type == "bahadanu" \
            else att_type
        self.location = self.attention_type in ("chorowski", "zhaopeng")
        self.V, self.D = V, D = p["tgt_vocab_size"], p["tgt_emb_size"]
        self.H = H = p["hidden_dim"]
        self.A = A = ap.get("attention_dim", H)
        self.E = E = enc_width
        self.NH = NH = ap.get("num_heads", 1)
        self.use_coverage = ap.get("use_coverage", False)
        self.plot_attention = ap.get("plot_attention", False)
        self.layers = p["num_layers"]
        self.gru = (p.get("rnn_type", "lstm") or "lstm") == "gru"
        self.pos_embedding = p.get("pos_embedding", False)
        self.keep = p.get("dropout_keep_prob", 1.0)
        self.go_symbol, self.end_symbol = p["GO_SYMBOL"], p["END_SYMBOL"]
        self.beam_width = max(p.get("beam_width", 1), 1)
        self.mode = mode

        self.TargetEmbeddingMatrix = _param((V, D), _normal(D ** -0.5),
                                            generator)
        if self.pos_embedding:
            self.EncoderPositionEmbeddingMatrix = _param(
                (_MAX_POS, E), _normal(0.02), generator)
            self.DecoderPositionEmbeddingMatrix = _param(
                (_MAX_POS, D), _normal(0.02), generator)
        dense_init = resolve_initializer(None)
        for i in range(NH):
            self.add_module("att{}_keys".format(i), Dense(
                E, A, torch.float32, dense_init, generator))
            leaves = [("q", (H, A), _xavier), ("v", (A,), _normal(0.1)),
                      ("b", (A,), None), ("out_w", (H + E, H), _xavier),
                      ("out_b", (H,), None)]
            if self.location:
                leaves += [("loc_conv", (_LOC_KERNEL, 1, _LOC_FILTERS),
                            _xavier),
                           ("loc_proj", (_LOC_FILTERS, A), _xavier)]
            for leaf, shape, init in leaves:
                self.register_parameter(
                    "att{}_{}".format(i, leaf),
                    nn.Parameter(torch.zeros(shape)) if init is None
                    else _param(shape, init, generator))
        gates = 3 if self.gru else 4
        for i in range(self.layers):
            d_in = D + NH * H if i == 0 else H
            self.register_parameter("rnn{}_wx".format(i + 1), _param(
                (d_in, gates * H), _xavier, generator))
            self.register_parameter("rnn{}_wh".format(i + 1), _param(
                (H, gates * H), _orthogonal, generator))
            self.register_parameter("rnn{}_b".format(i + 1),
                                    nn.Parameter(torch.zeros(gates * H)))
        self.fully_connected_w = _param((NH * H, V), _xavier, generator)
        self.fully_connected_b = nn.Parameter(torch.zeros(V))

    # ------------------------------------------------------------------
    def keep_mask(self, shape, site: int, generator: torch.Generator,
                  device) -> torch.Tensor:
        """A dropout mask at ``site`` (layer i, or ``num_layers`` for the
        projection): keep with probability ``dropout_keep_prob``."""
        return torch.rand(shape, generator=generator, device=device) < \
            self.keep

    def _drop(self, x: torch.Tensor, site: int, generator) -> torch.Tensor:
        if generator is None:
            raise ValueError("dropout in training needs a torch.Generator")
        mask = self.keep_mask(x.shape, site, generator, x.device)
        return torch.where(mask, x / self.keep, torch.zeros((), device=x.device))

    def _att(self, i: int, leaf: str) -> torch.Tensor:
        return getattr(self, "att{}_{}".format(i, leaf))

    def _rnn(self, i: int) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, "rnn{}_{}".format(i + 1, leaf))
                     for leaf in ("wx", "wh", "b"))

    def cell(self, i: int, gates_x: torch.Tensor, state
             ) -> Tuple[tuple, torch.Tensor]:
        """Layer ``i``'s cell from its input's share of the gates
        ``gates_x`` (x W_x + b)."""
        _, wh, _ = self._rnn(i)
        if self.gru:
            H = self.H
            h_prev = state[0]
            zr = gates_x[:, :2 * H] + h_prev @ wh[:, :2 * H]
            z, r = torch.chunk(torch.sigmoid(zr), 2, dim=-1)
            hh = torch.tanh(gates_x[:, 2 * H:] + (r * h_prev) @ wh[:, 2 * H:])
            h = (1 - z) * h_prev + z * hh
            return (h,), h
        h_prev, c_prev = state
        i_, f, g, o = torch.chunk(gates_x + h_prev @ wh, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c_prev + \
            torch.sigmoid(i_) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    def attend(self, h: torch.Tensor, aligns_prev: torch.Tensor,
               memory: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(attention output (B, NH H), alignments (B, NH, S))."""
        outs, aligns = [], []
        for i in range(self.NH):
            e = (h @ self._att(i, "q"))[:, None, :] + keys[:, i] + \
                self._att(i, "b")
            if self.location:
                w = self._att(i, "loc_conv").permute(2, 1, 0)  # (10, 1, k)
                f = F.conv1d(aligns_prev[:, i:i + 1], w,
                             padding=_LOC_KERNEL // 2)         # (B, 10, S)
                e = e + f.transpose(1, 2) @ self._att(i, "loc_proj")
            scores = torch.tanh(e) @ self._att(i, "v")
            scores = scores.masked_fill(~mask, _NEG)
            align = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bs,bse->be", align, memory)
            outs.append(torch.cat([h, ctx], dim=-1) @ self._att(i, "out_w")
                        + self._att(i, "out_b"))
            aligns.append(align)
        return torch.cat(outs, dim=-1), torch.stack(aligns, dim=1)

    def emb_gates(self, emb: torch.Tensor) -> torch.Tensor:
        """The token embedding's share of layer 1's gates, bias
        included."""
        wx, _, b = self._rnn(0)
        return emb @ wx[:self.D] + b

    def step(self, states: List[tuple], att: torch.Tensor,
             aligns_state: torch.Tensor, emb_gates: torch.Tensor, memory,
             keys, mask, generator=None):
        """One speller step: (states, attention output, alignments, new
        alignment state). ``generator`` set: dropout after each layer."""
        wx, _, _ = self._rnn(0)
        gates_x = emb_gates + att @ wx[self.D:]
        new_states = []
        for i in range(self.layers):
            if i > 0:
                wx, _, b = self._rnn(i)
                gates_x = h @ wx + b
            state, h = self.cell(i, gates_x, states[i])
            if generator is not None and self.keep < 1.0:
                h = self._drop(h, i, generator)
            new_states.append(state)
        att, aligns = self.attend(h, aligns_state, memory, keys, mask)
        return new_states, att, aligns, \
            aligns_state + aligns if self.use_coverage else aligns

    def project(self, att: torch.Tensor, generator=None) -> torch.Tensor:
        if generator is not None and self.keep < 1.0:
            att = self._drop(att, self.layers, generator)
        return att @ self.fully_connected_w + self.fully_connected_b

    def initial(self, B: int, S: int, device):
        zeros = torch.zeros((B, self.H), device=device)
        state = (zeros,) if self.gru else (zeros, zeros)
        return ([state for _ in range(self.layers)],
                torch.zeros((B, self.NH * self.H), device=device),
                torch.zeros((B, self.NH, S), device=device))

    # ------------------------------------------------------------------
    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        enc = input_dict["encoder_output"]
        memory = enc["outputs"].float()
        mem_len = enc["src_length"]
        B, S, _ = memory.shape
        if self.pos_embedding:
            memory = memory + _positions(
                self.EncoderPositionEmbeddingMatrix, S)[None]
        mask = torch.arange(S, device=memory.device)[None, :] < \
            mem_len[:, None]
        keys = torch.stack([self._modules["att{}_keys".format(i)](memory)
                            for i in range(self.NH)], dim=1)  # (B,NH,S,A)
        out: Dict[str, Any] = {"src_length": mem_len}
        targets = input_dict.get("target_tensors")
        if targets is not None and self.mode != "infer":
            y = targets[0]
            drop_gen = generator if (train and self.keep < 1.0) else None
            logits, aligns = self.teacher_forced(y[:, :-1], memory, keys,
                                                 mask, drop_gen)
            out["logits"] = logits
            out["targets"] = y
            if self.plot_attention:
                out["alignments"] = aligns
        if not train:
            out.update(self.decode(memory, keys, mask))
        return out

    def teacher_forced(self, dec_in, memory, keys, mask, generator):
        """(B, T, V) fp32 logits of the inputs ``dec_in`` (B, T), and head
        0's alignments (B, T, S)."""
        B, T = dec_in.shape
        embs = F.embedding(dec_in.long(), self.TargetEmbeddingMatrix)
        if self.pos_embedding:
            embs = embs + _positions(self.DecoderPositionEmbeddingMatrix,
                                     T)[None]
        gates = self.emb_gates(embs)
        states, att, aligns_state = self.initial(B, memory.shape[1],
                                                 memory.device)
        atts, head0 = [], []
        for t in range(T):
            states, att, aligns, aligns_state = self.step(
                states, att, aligns_state, gates[:, t], memory, keys, mask,
                generator)
            atts.append(att)
            head0.append(aligns[:, 0])
        return (self.project(torch.stack(atts, dim=1), generator),
                torch.stack(head0, dim=1))

    def decode(self, memory, keys, mask) -> Dict[str, Any]:
        """Beam search from the memory, which is tiled over the beams
        once; the states, the attention output and the alignment state
        follow the beams."""
        B, S, _ = memory.shape
        K = self.beam_width
        memory, keys, mask = (t.repeat_interleave(K, 0)
                              for t in (memory, keys, mask))
        states, att, aligns = self.initial(B * K, S, memory.device)
        cache = {"states": states, "att": att, "aligns": aligns}

        def step(ids: torch.Tensor, pos: int) -> torch.Tensor:
            emb = F.embedding(ids[:, 0].long(), self.TargetEmbeddingMatrix)
            if self.pos_embedding:
                emb = emb + self.DecoderPositionEmbeddingMatrix[
                    min(pos, _MAX_POS - 1)]
            cache["states"], cache["att"], _, cache["aligns"] = self.step(
                cache["states"], cache["att"], cache["aligns"],
                self.emb_gates(emb), memory, keys, mask)
            return self.project(cache["att"])

        def reorder(parents: torch.Tensor, pos: int) -> None:
            cache["states"] = [tuple(s.index_select(0, parents) for s in st)
                               for st in cache["states"]]
            for key in ("att", "aligns"):
                cache[key] = cache[key].index_select(0, parents)

        decoded, scores = beam_search(
            step, reorder, batch_size=B, beam_size=K, vocab_size=self.V,
            max_decode_length=min(S + 10, _MAX_POS), eos_id=self.end_symbol,
            alpha=0.0, bos_id=self.go_symbol, device=memory.device)
        top = decoded[:, 0, 1:]
        lengths = sequence_lengths_from_ids(top, self.end_symbol)
        return {"outputs": [top, lengths], "scores": scores[:, 0],
                "tgt_length": lengths}


class ListenAttendSpellDecoder(Decoder):
    """Config wrapper, the JAX package's schema (reference
    `las_decoder.py:77-98`)."""

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "GO_SYMBOL": int,
            "END_SYMBOL": int,
            "tgt_vocab_size": int,
            "tgt_emb_size": int,
            "attention_params": dict,
            "rnn_type": None,
            "hidden_dim": int,
            "num_layers": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Decoder.get_optional_params(), **{
            "dropout_keep_prob": float,
            "pos_embedding": bool,
            "beam_width": int,
            "use_language_model": bool,
        })

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> LASDecoderModule:
        """``in_features`` is the encoder's output width."""
        return LASDecoderModule(self._params, in_features, self._mode,
                                generator)
