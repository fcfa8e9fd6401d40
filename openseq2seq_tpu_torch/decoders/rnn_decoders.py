"""RNN decoders with attention for NMT (port of
``openseq2seq_tpu/decoders/rnn_decoders.py``; reference
`open_seq2seq/decoders/rnn_decoders.py:22-532`).

  * :class:`RNNDecoderWithAttention`: an embedding, attention
    (``bahdanau``, ``luong``, ``gnmt`` or ``gnmt_v2``) and a stack of LSTM
    cells; the teacher-forced pass in training and eval, and in eval and
    infer the beam search of ``ops/beam_search.py`` (beam 1, greedy, by
    default);
  * :class:`BeamSearchRNNDecoderWithAttention`: the same, beam 4 by
    default.

What the JAX module computes, and so the port:

  * the whole decoder in fp32, whatever the compute type: the encoder's
    outputs are cast to fp32 and every parameter is used in fp32;
  * the LSTM cell on raw parameters ``lstm{i}_wx`` (d_in, 4H),
    ``lstm{i}_wh`` (H, 4H) and ``lstm{i}_b`` (4H,), in flax's layout,
    gates in the order i, f, g, o and 1 added to the forget gate;
  * layer 1 takes [token embedding, previous context]; with ``gnmt`` and
    ``gnmt_v2`` the attention is queried with layer 1's output and the
    context goes into layer 2 (``gnmt``) or every later layer
    (``gnmt_v2``); otherwise the top layer's output queries it for the
    next step; with ``decoder_use_skip_connections`` each later layer's
    output is added to its input where the widths agree;
  * the attention's scores past each source length set to -1e9 before
    the softmax; ``luong`` scores are dot products with the keys
    ``luong_keys`` (E -> H, no bias), the others ``att_v . tanh(h att_q
    + keys + att_b)`` with the keys ``bahdanau_keys`` (E -> A);
  * the logits from [top output, context] through ``out_w`` and
    ``out_b`` or, with ``weight_tied``, through ``tied_proj`` (H + E, D)
    and the embedding's transpose;
  * scheduled sampling in training (``sampling_prob``): at each step each
    row takes, with that probability, the embedding of the model's own
    previous argmax in place of the teacher's token; the coins come from
    the step's generator;
  * beam decode in every call outside training (eval and infer, and the
    evaluations of a training run), over ``2 S + 10`` steps (S the padded
    source length) with ``alpha = length_penalty``; the LSTM states and
    the context follow the beams through ``reorder_cache``, while the
    memory, keys and mask are tiled over the beams once; the output is
    the best beam without its start token and its length up to and
    including the first EOS.

The teacher-forced pass is a Python loop over the target positions. The
embedded tokens' share of layer 1's gates, and the logits of all steps,
are each one product over the whole sequence, outside the loop (fp32
sums in another order than the JAX module's per-step products).

Accepted with no effect, as in the JAX package, which reads them into
fields that nothing uses: ``decoder_dp_input_keep_prob`` and
``decoder_dp_output_keep_prob`` (C23). Refused, since they have no effect
there and no recipe sets them: ``core_cell`` "gru" (the JAX module builds
an LSTM decoder whatever the cell; C23), ``bahdanau_normalize``,
``luong_scale``, ``PAD_SYMBOL``, ``time_major``, ``use_swap_memory``,
``proj_size``, ``num_groups``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .decoder import Decoder
from .fc_decoders import Dense
from ..ops.beam_search import beam_search, sequence_lengths_from_ids
from ..parts.initializers import resolve_initializer

_NEG = -1e9
REFUSED = ("bahdanau_normalize", "luong_scale", "PAD_SYMBOL", "time_major",
           "use_swap_memory", "proj_size", "num_groups")

State = List[Tuple[torch.Tensor, torch.Tensor]]


def _param(shape, init, generator) -> nn.Parameter:
    w = torch.empty(shape)
    with torch.no_grad():
        init(w, generator=generator)
    return nn.Parameter(w)


def _xavier(w, generator):
    nn.init.xavier_uniform_(w, generator=generator)


def _orthogonal(w, generator):
    nn.init.orthogonal_(w, generator=generator)


class RNNAttnDecoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], enc_width: int, mode: str,
                 beam_width: int, generator: torch.Generator):
        super().__init__()
        self.V, self.D = V, D = p["tgt_vocab_size"], p["tgt_emb_size"]
        self.H = H = p.get("core_cell_params", {}).get("num_units", D)
        self.A = A = p["attention_layer_size"]
        self.E = E = enc_width
        self.attention_type = p["attention_type"]
        self.layers = p["decoder_layers"]
        self.use_skip_connections = p["decoder_use_skip_connections"]
        self.go_symbol, self.end_symbol = p["GO_SYMBOL"], p["END_SYMBOL"]
        self.beam_width = beam_width
        self.length_penalty = p.get("length_penalty", 0.0)
        self.weight_tied = p.get("weight_tied", False)
        self.sampling_prob = p.get("sampling_prob", 0.0)
        self.mode = mode
        self.gnmt = self.attention_type in ("gnmt", "gnmt_v2")

        self.embedding = nn.Parameter(
            torch.randn((V, D), generator=generator) * D ** -0.5)
        dense_init = resolve_initializer(None)
        if self.attention_type == "luong":
            self.luong_keys = Dense(E, H, torch.float32, dense_init,
                                    generator, use_bias=False)
        else:
            self.bahdanau_keys = Dense(E, A, torch.float32, dense_init,
                                       generator)
            self.att_q = _param((H, A), _xavier, generator)
            self.att_v = nn.Parameter(
                torch.randn((A,), generator=generator) * 0.1)
            self.att_b = nn.Parameter(torch.zeros(A))
        for i in range(self.layers):
            d_in = D + E if i == 0 else \
                H + E if self.takes_context(i) else H
            self.register_parameter("lstm{}_wx".format(i + 1), _param(
                (d_in, 4 * H), _xavier, generator))
            self.register_parameter("lstm{}_wh".format(i + 1), _param(
                (H, 4 * H), _orthogonal, generator))
            self.register_parameter("lstm{}_b".format(i + 1),
                                    nn.Parameter(torch.zeros(4 * H)))
        if self.weight_tied:
            self.tied_proj = _param((H + E, D), _xavier, generator)
        else:
            self.out_w = _param((H + E, V), _xavier, generator)
        self.out_b = nn.Parameter(torch.zeros(V))

    def takes_context(self, i: int) -> bool:
        """Whether layer ``i`` > 0 takes [h, context]."""
        return self.attention_type == "gnmt_v2" or \
            (self.attention_type == "gnmt" and i == 1)

    def lstm(self, i: int) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, "lstm{}_{}".format(i + 1, leaf))
                     for leaf in ("wx", "wh", "b"))

    @staticmethod
    def cell(gates: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def attend(self, query, keys, memory, mask) -> torch.Tensor:
        """The context (B, E) of ``query`` (B, H) over ``memory``."""
        if self.attention_type == "luong":
            scores = torch.einsum("bh,bsh->bs", query, keys)
        else:
            e = torch.tanh((query @ self.att_q)[:, None, :] + keys +
                           self.att_b)
            scores = e @ self.att_v
        scores = scores.masked_fill(~mask, _NEG)
        align = torch.softmax(scores, dim=-1)
        return torch.einsum("bs,bse->be", align, memory)

    def step(self, states: State, ctx: torch.Tensor, emb_gates: torch.Tensor,
             memory, keys, mask) -> Tuple[State, torch.Tensor, torch.Tensor]:
        """One decoder step: ``emb_gates`` is the token embedding's share
        of layer 1's gates (bias included). Returns the new states, the
        top output and the context."""
        wx, wh, _ = self.lstm(0)
        h_prev, c_prev = states[0]
        gates = emb_gates + ctx @ wx[self.D:] + h_prev @ wh
        h = self.cell(gates, c_prev)
        new: State = [h]
        h = h[0]
        if self.gnmt:
            ctx = self.attend(h, keys, memory, mask)
        for i in range(1, self.layers):
            wx, wh, b = self.lstm(i)
            inp = torch.cat([h, ctx], dim=-1) if self.takes_context(i) \
                else h
            h_prev, c_prev = states[i]
            state = self.cell(inp @ wx + h_prev @ wh + b, c_prev)
            new.append(state)
            h = h + state[0] if (self.use_skip_connections and
                                 h.shape == state[0].shape) else state[0]
        if not self.gnmt:
            ctx = self.attend(h, keys, memory, mask)
        return new, h, ctx

    def logits(self, h: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        feat = torch.cat([h, ctx], dim=-1)
        if self.weight_tied:
            return (feat @ self.tied_proj) @ self.embedding.t() + self.out_b
        return feat @ self.out_w + self.out_b

    def emb_gates(self, emb: torch.Tensor) -> torch.Tensor:
        wx, _, b = self.lstm(0)
        return emb @ wx[:self.D] + b

    def initial(self, B: int, device) -> Tuple[State, torch.Tensor]:
        zeros = torch.zeros((B, self.H), device=device)
        return ([(zeros, zeros) for _ in range(self.layers)],
                torch.zeros((B, self.E), device=device))

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        enc = input_dict["encoder_output"]
        memory = enc["outputs"].float()
        mem_len = enc["src_length"]
        B, S, _ = memory.shape
        mask = torch.arange(S, device=memory.device)[None, :] < \
            mem_len[:, None]
        keys = self.luong_keys(memory) if self.attention_type == "luong" \
            else self.bahdanau_keys(memory)
        out: Dict[str, Any] = {"src_length": mem_len}
        targets = input_dict.get("target_tensors")
        if targets is not None and self.mode != "infer":
            y = targets[0]
            out["logits"] = self.teacher_forced(
                y[:, :-1], memory, keys, mask, train, generator)
            out["targets"] = y
        if not train:
            out.update(self.decode(memory, keys, mask))
        return out

    def teacher_forced(self, dec_in, memory, keys, mask, train, generator):
        """(B, T, V) fp32 logits of the inputs ``dec_in`` (B, T)."""
        B, T = dec_in.shape
        embs = F.embedding(dec_in.long(), self.embedding)
        states, ctx = self.initial(B, memory.device)
        if train and self.sampling_prob > 0.0:
            if generator is None:
                raise ValueError("scheduled sampling in training needs a "
                                 "torch.Generator")
            logits = []
            prev = embs[:, 0]
            for t in range(T):
                coin = torch.rand((B, 1), generator=generator,
                                  device=memory.device) < self.sampling_prob
                inp = torch.where(coin, prev, embs[:, t])
                states, h, ctx = self.step(states, ctx, self.emb_gates(inp),
                                           memory, keys, mask)
                logits.append(self.logits(h, ctx))
                prev = F.embedding(logits[-1].argmax(-1), self.embedding)
            return torch.stack(logits, dim=1)
        gates = self.emb_gates(embs)
        tops, ctxs = [], []
        for t in range(T):
            states, h, ctx = self.step(states, ctx, gates[:, t], memory,
                                       keys, mask)
            tops.append(h)
            ctxs.append(ctx)
        return self.logits(torch.stack(tops, 1), torch.stack(ctxs, 1))

    def decode(self, memory, keys, mask) -> Dict[str, Any]:
        """Beam search from the encoder's memory."""
        B, S, _ = memory.shape
        K = self.beam_width
        memory, keys, mask = (t.repeat_interleave(K, 0)
                              for t in (memory, keys, mask))
        states, ctx = self.initial(B * K, memory.device)
        cache = {"states": states, "ctx": ctx}

        def step(ids: torch.Tensor, pos: int) -> torch.Tensor:
            emb = F.embedding(ids[:, 0].long(), self.embedding)
            cache["states"], h, cache["ctx"] = self.step(
                cache["states"], cache["ctx"], self.emb_gates(emb), memory,
                keys, mask)
            return self.logits(h, cache["ctx"])

        def reorder(parents: torch.Tensor, pos: int) -> None:
            cache["states"] = [(h.index_select(0, parents),
                                c.index_select(0, parents))
                               for h, c in cache["states"]]
            cache["ctx"] = cache["ctx"].index_select(0, parents)

        decoded, scores = beam_search(
            step, reorder, batch_size=B, beam_size=K, vocab_size=self.V,
            max_decode_length=2 * S + 10, eos_id=self.end_symbol,
            alpha=self.length_penalty, bos_id=self.go_symbol,
            device=memory.device)
        top = decoded[:, 0, 1:]
        return {"outputs": [top, sequence_lengths_from_ids(
            top, self.end_symbol)], "scores": scores[:, 0]}


class RNNDecoderWithAttention(Decoder):
    """Config wrapper (reference `rnn_decoders.py:26-54`); greedy
    inference, beam width 1, by default."""

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "GO_SYMBOL": int,
            "END_SYMBOL": int,
            "tgt_vocab_size": int,
            "tgt_emb_size": int,
            "attention_layer_size": int,
            "attention_type": ["bahdanau", "luong", "gnmt", "gnmt_v2"],
            "core_cell": None,
            "decoder_layers": int,
            "decoder_use_skip_connections": bool,
            "batch_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Decoder.get_optional_params(), **{
            "core_cell_params": dict,
            "bahdanau_normalize": bool,
            "luong_scale": bool,
            "decoder_dp_input_keep_prob": float,
            "decoder_dp_output_keep_prob": float,
            "time_major": bool,
            "use_swap_memory": bool,
            "proj_size": int,
            "num_groups": int,
            "PAD_SYMBOL": int,
            "weight_tied": bool,
            "beam_width": int,
            "length_penalty": float,
            "sampling_prob": float,
        })

    _default_beam_width = 1

    def __init__(self, params, model, name="decoder", mode="train"):
        super().__init__(params, model, name, mode)
        p = self._params
        refused = [k for k in REFUSED if k in p]
        if refused:
            raise ValueError("{} options {} have no effect in the JAX "
                             "package and are refused".format(
                                 type(self).__name__, refused))
        core = p["core_cell"]
        name = core if isinstance(core, str) \
            else getattr(core, "__name__", "")
        if "gru" in str(name or "").lower():
            raise ValueError("core_cell {!r}: the JAX package builds an LSTM "
                             "decoder whatever the cell (C23); the port "
                             "refuses it".format(core))
        extra = set(p.get("core_cell_params", {})) - {"num_units"}
        if extra:
            raise NotImplementedError("core_cell_params {} are not ported "
                                      "yet".format(sorted(extra)))

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> RNNAttnDecoderModule:
        """``in_features`` is the encoder's output width."""
        return RNNAttnDecoderModule(
            self._params, in_features, self._mode,
            self._params.get("beam_width", self._default_beam_width),
            generator)


class BeamSearchRNNDecoderWithAttention(RNNDecoderWithAttention):
    """Reference `rnn_decoders.py:324-532`."""

    _default_beam_width = 4
