"""Transducer (RNN-T) decoder: an LSTM prediction network, an additive
joint network, greedy decode, and a frame-synchronous beam decode with
optional n-gram shallow fusion (port of
``openseq2seq_tpu/decoders/transducer_decoder.py``; Graves 2012).

What the JAX module computes, and so the port:

  * raw parameters created in every mode, with the JAX names, shapes and
    initializers: ``pred_embedding`` (V, E), per layer ``pred_wx{i}``
    (in, 4H), ``pred_wh{i}`` (H, 4H) and ``pred_b{i}`` (4H,), then
    ``joint_enc_w`` (D, J), ``joint_pred_w`` (H, J), ``joint_b`` (J,),
    ``joint_out_w`` (J, V) and ``joint_out_b`` (V,); they compute in the
    model's compute dtype;
  * the prediction net's LSTM cells, gates in the order i, f, g, o with 1
    added to the forget gate, each layer followed in training by dropout
    drawn from the step's generator with the model's ``dropout_bits``;
    the teacher-forced pass is a Python loop over the U + 1 positions
    (the JAX package runs it in ``lax.scan``, outside any kernel); the
    embedded tokens' share of the gates is one product over the sequence;
  * the joint: ``tanh(enc @ joint_enc_w + pred @ joint_pred_w + joint_b)
    @ joint_out_w + joint_out_b``, with fp32 logits;
  * with targets (training and eval): the (B, T, U+1, V) ``logits``, or
    with ``fused_loss`` the ``joint_fused`` activations for
    ``ops/transducer.transducer_loss_fused``; an infer-mode model, which
    has no loss, skips them;
  * outside training, greedy decode: a loop over frames with
    ``max_symbols_per_frame`` rounds each, emissions written at each
    row's output cursor, ``max_output_length`` labels at most (0: the
    frames), the frame of each emission (``emit_frames``) and the
    streaming contract: ``decode_carry`` (the prediction net's states and
    its projected output) in and out, ``decode_window`` (lo, hi) frames;
  * with ``beam_width`` > 1, the expansion-limited frame-synchronous beam
    (``_beam_decode``): ``outputs`` the best hypothesis, ``nbest`` [ids
    (B, K, L), lengths (B, K), scores (B, K)] sorted by score; with
    ``lm_fusion_arpa`` each label expansion adds ``lm_fusion_weight``
    times a dense label LM's log-prob (``ops/ngram_fusion.py``, the table
    built once on the host and moved to the model's device) plus
    ``lm_fusion_beta``.

The decode loops are Python loops of small launches (about 250 x 3 rounds
for a 10 s utterance), host-bound on the card.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .decoder import Decoder
from ..ops.beam_search import refuse_trace
from ..parts.dropout import dropout

State = List[Tuple[torch.Tensor, torch.Tensor]]
_NEG = -1e30


def _select(keep: torch.Tensor, new: State, old: State) -> State:
    """The states of ``new`` where ``keep``, else ``old``, layer by
    layer."""
    return [(torch.where(keep, nh, oh), torch.where(keep, nc, oc))
            for (nh, nc), (oh, oc) in zip(new, old)]


def _xavier(shape, generator) -> nn.Parameter:
    w = torch.empty(shape)
    with torch.no_grad():
        nn.init.xavier_uniform_(w, generator=generator)
    return nn.Parameter(w)


class TransducerDecoderModule(nn.Module):

    def __init__(self, vocab: int, embed: int, units: int, layers: int,
                 joint: int, enc_width: int, max_symbols_per_frame: int,
                 max_output_length: int, keep_prob: float,
                 dropout_bits: int, fused_loss: bool, beam_width: int,
                 dtype: torch.dtype, mode: str, lm_fusion,
                 generator: torch.Generator):
        super().__init__()
        self.V, self.E, self.H, self.J = vocab, embed, units, joint
        self.layers = layers
        self.blank = vocab - 1
        self.max_symbols_per_frame = max_symbols_per_frame
        self.max_output_length = max_output_length
        self.keep_prob = keep_prob
        self.dropout_bits = dropout_bits
        self.fused_loss = fused_loss
        self.beam_width = beam_width
        self.dtype = dtype
        self.mode = mode
        self.lm_fusion = lm_fusion
        self._fusion_table = None

        self.pred_embedding = nn.Parameter(
            torch.randn((vocab, embed), generator=generator) * embed ** -0.5)
        for i in range(layers):
            d_in = embed if i == 0 else units
            self.register_parameter("pred_wx{}".format(i), _xavier(
                (d_in, 4 * units), generator))
            self.register_parameter("pred_wh{}".format(i), _xavier(
                (units, 4 * units), generator))
            self.register_parameter("pred_b{}".format(i), nn.Parameter(
                torch.zeros(4 * units)))
        self.joint_enc_w = _xavier((enc_width, joint), generator)
        self.joint_pred_w = _xavier((units, joint), generator)
        self.joint_b = nn.Parameter(torch.zeros(joint))
        self.joint_out_w = _xavier((joint, vocab), generator)
        self.joint_out_b = nn.Parameter(torch.zeros(vocab))

    # -- the prediction net and the joint, in the compute dtype ----------
    def weights(self) -> Dict[str, torch.Tensor]:
        """The parameters in the compute dtype, cast once a call."""
        return {n: p.to(self.dtype) for n, p in self.named_parameters()}

    def cell(self, w, i: int, x_gates: torch.Tensor, state
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """LSTM step of layer ``i`` from its input's share of the gates,
        ``x @ wx``; forget bias +1."""
        h_prev, c_prev = state
        gates = x_gates + h_prev @ w["pred_wh{}".format(i)] + \
            w["pred_b{}".format(i)]
        g_i, g_f, g_g, g_o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(g_f + 1.0) * c_prev + \
            torch.sigmoid(g_i) * torch.tanh(g_g)
        return torch.sigmoid(g_o) * torch.tanh(c), c

    def init_states(self, B: int, device) -> State:
        return [(torch.zeros((B, self.H), dtype=self.dtype, device=device),
                 torch.zeros((B, self.H), dtype=self.dtype, device=device))
                for _ in range(self.layers)]

    def pred_step(self, w, states: State, tokens: torch.Tensor
                  ) -> Tuple[State, torch.Tensor]:
        x = w["pred_embedding"][tokens]
        new = []
        for i in range(self.layers):
            h, c = self.cell(w, i, x @ w["pred_wx{}".format(i)], states[i])
            new.append((h, c))
            x = h
        return new, x

    def joint_logits(self, w, enc_j: torch.Tensor, pred_j: torch.Tensor
                     ) -> torch.Tensor:
        h = torch.tanh(enc_j + pred_j + w["joint_b"])
        return (h @ w["joint_out_w"] + w["joint_out_b"]).float()

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: Optional[torch.Generator] = None):
        enc = input_dict["encoder_output"]["outputs"]
        enc_len = input_dict["encoder_output"]["src_length"]
        out: Dict[str, Any] = {"src_length": enc_len}
        w = self.weights()
        targets = input_dict.get("target_tensors")
        if targets is not None and self.mode != "infer":
            out.update(self._lattice(w, enc, targets[0], train, generator))
        if train:
            return out
        if self.beam_width > 1:
            out["outputs"], out["nbest"] = self._beam_decode(w, enc, enc_len)
        else:
            out.update(self._greedy_decode(w, enc, enc_len, input_dict))
        return out

    def _lattice(self, w, enc, labels, train, generator) -> Dict[str, Any]:
        """The training outputs: the joint lattice's ``logits``, or the
        fused loss's ``joint_fused`` activations."""
        B = labels.shape[0]
        tokens = F.pad(labels.long(), (1, 0), value=self.blank)   # (B,U1)
        x = w["pred_embedding"][tokens]                           # (B,U1,E)
        for i in range(self.layers):
            x_gates = x @ w["pred_wx{}".format(i)]
            zeros = torch.zeros((B, self.H), dtype=self.dtype,
                                device=enc.device)
            state = (zeros, zeros)
            hs = []
            for u in range(tokens.shape[1]):
                state = self.cell(w, i, x_gates[:, u], state)
                hs.append(state[0])
            x = torch.stack(hs, 1)                                # (B,U1,H)
            if train:
                x = dropout(x, self.keep_prob, generator, self.dropout_bits)
        enc_j = enc.to(self.dtype) @ w["joint_enc_w"]             # (B,T,J)
        pred_j = x @ w["joint_pred_w"]                            # (B,U1,J)
        if self.fused_loss:
            return {"joint_fused": {
                "enc_j": enc_j, "pred_j": pred_j,
                "joint_b": w["joint_b"], "out_w": w["joint_out_w"],
                "out_b": w["joint_out_b"]}}
        return {"logits": self.joint_logits(w, enc_j[:, :, None, :],
                                            pred_j[:, None, :, :])}

    def _greedy_decode(self, w, enc, enc_len, input_dict
                       ) -> Dict[str, Any]:
        B, T, _ = enc.shape
        dev = enc.device
        Lmax = self.max_output_length or T
        blank = self.blank
        enc_j = enc.to(self.dtype) @ w["joint_enc_w"]             # (B,T,J)
        w_pred = w["joint_pred_w"]
        carry_in = input_dict.get("decode_carry")
        if carry_in is not None:
            states, pred_j = carry_in
            states = [(h.to(self.dtype), c.to(self.dtype))
                      for h, c in states]
            pred_j = pred_j.to(self.dtype)
        else:
            states, h = self.pred_step(
                w, self.init_states(B, dev),
                torch.full((B,), blank, dtype=torch.long, device=dev))
            pred_j = h @ w_pred                                    # (B,J)
        enc_len = enc_len.to(dev)
        window = input_dict.get("decode_window")
        if window is not None:
            t_lo = torch.as_tensor(window[0], device=dev)
            t_hi = torch.minimum(torch.as_tensor(window[1], device=dev),
                                 enc_len)
        else:
            t_lo, t_hi = torch.zeros_like(enc_len), enc_len
        out_ids = torch.full((B, Lmax), -1, dtype=torch.long, device=dev)
        out_frames = torch.full_like(out_ids, -1)
        out_len = torch.zeros((B,), dtype=torch.long, device=dev)
        slot = torch.arange(Lmax, device=dev)[None, :]
        # frames past every row's window change nothing
        refuse_trace("the transducer's greedy decode")
        for t in range(min(T, int(t_hi.max()))):
            active = (t >= t_lo) & (t < t_hi)
            enc_jt = enc_j[:, t]
            for _ in range(self.max_symbols_per_frame):
                k = torch.argmax(self.joint_logits(w, enc_jt, pred_j), dim=-1)
                emit = active & (k != blank) & (out_len < Lmax)
                write = (slot == out_len[:, None]) & emit[:, None]
                out_ids = torch.where(write, k[:, None], out_ids)
                out_frames = torch.where(write, t, out_frames)
                out_len = out_len + emit.long()
                new_states, h = self.pred_step(w, states, k)
                keep = emit[:, None]
                states = _select(keep, new_states, states)
                pred_j = torch.where(keep, h @ w_pred, pred_j)
                active = emit
        return {"outputs": [out_ids.int(), out_len.int()],
                "emit_frames": out_frames.int(),
                "decode_carry": (tuple(states), pred_j)}

    def fusion_table(self, device):
        """(table + bonus (C**m, V) on ``device``, C, m, start context):
        the weighted label LM with a zero blank column, plus the label
        bonus; built once."""
        if self._fusion_table is None:
            from ..ops.ngram_fusion import dense_label_lm
            arpa, labels, w_lm, beta, order = self.lm_fusion
            if len(labels) != self.V - 1:
                raise ValueError("fusion LM labels must be the V-1 non-blank "
                                 "outputs")
            table, C, m, ctx0 = dense_label_lm(arpa, labels, order)
            tab = F.pad(torch.from_numpy(table) * w_lm, (0, 1))
            bonus = torch.where(torch.arange(self.V) == self.blank, 0.0,
                                float(beta))
            self._fusion_table = ((tab + bonus).to(device), C, m, ctx0)
        return self._fusion_table

    def _beam_decode(self, w, enc, enc_len):
        """Frame-synchronous, expansion-limited transducer beam search, as
        the JAX package's: the beam is (B, K) score, length and done lanes
        plus (B K)-row prediction-net states; each frame takes
        ``max_symbols_per_frame`` label rounds and then a round that
        forces blank, each round the top K of the (B, K V) candidates
        (K (V - 1) label extensions and each lane's stay-put blank). A
        lane that takes blank is done for the frame; hypotheses are not
        merged. Returns ``[ids (B, L), lengths (B,)]`` of the best and the
        n-best ``[ids, lengths, scores]`` sorted by score."""
        V, K, J = self.V, self.beam_width, self.J
        msf = self.max_symbols_per_frame
        B, T, _ = enc.shape
        dev = enc.device
        Lmax = self.max_output_length or T
        blank = self.blank
        fusion = self.fusion_table(dev) if self.lm_fusion else None

        enc_j = enc.to(self.dtype) @ w["joint_enc_w"]             # (B,T,J)
        w_pred = w["joint_pred_w"]
        states, h = self.pred_step(
            w, self.init_states(B * K, dev),
            torch.full((B * K,), blank, dtype=torch.long, device=dev))
        pred_j = (h @ w_pred).reshape(B, K, J)
        # only lane 0 is live at t = 0: all lanes share the empty prefix
        scores = torch.full((B, K), _NEG, device=dev)
        scores[:, 0] = 0.0
        out_ids = torch.full((B, K, Lmax), -1, dtype=torch.long, device=dev)
        out_len = torch.zeros((B, K), dtype=torch.long, device=dev)
        lm_ctx = torch.full((B, K), fusion[3] if fusion else 0,
                            dtype=torch.long, device=dev)
        slot = torch.arange(Lmax, device=dev)[None, None, :]
        not_blank = (torch.arange(V, device=dev) != blank)[None, None, :]
        rows = (torch.arange(B, device=dev) * K)[:, None]
        enc_len = enc_len.to(dev)

        def gather_k(x, parent):
            idx = parent.reshape(parent.shape + (1,) * (x.dim() - 2))
            return torch.gather(x, 1, idx.expand((-1, -1) + x.shape[2:]))

        for t in range(T):
            enc_jt = enc_j[:, t]
            # frames past a row's length carry its whole beam unchanged
            done = (t >= enc_len)[:, None].expand(B, K)
            for s in range(msf + 1):
                logp = F.log_softmax(
                    self.joint_logits(w, enc_jt[:, None, :], pred_j), dim=-1)
                cand = scores[:, :, None] + logp                  # (B,K,V)
                if fusion is not None:
                    cand = cand + fusion[0][lm_ctx]
                # the stay-put candidate in the blank slot: done lanes keep
                # their score (this frame's blank already paid)
                stay = torch.where(done, scores, scores + logp[..., blank])
                cand = torch.where(not_blank, cand, stay[:, :, None])
                label_ok = (~done & (out_len < Lmax))[:, :, None]
                if s == msf:  # the frame's label budget is spent
                    label_ok = torch.zeros_like(label_ok)
                cand = torch.where(not_blank & ~label_ok, _NEG, cand)
                scores, top_idx = torch.topk(cand.reshape(B, K * V), K,
                                             dim=1)
                parent = top_idx // V
                tok = top_idx % V
                is_label = tok != blank
                out_ids = gather_k(out_ids, parent)
                out_len = gather_k(out_len, parent)
                pred_j = gather_k(pred_j, parent)
                lm_ctx = gather_k(lm_ctx, parent)
                if fusion is not None:
                    _, C, m, _ = fusion
                    lm_ctx = torch.where(
                        is_label, lm_ctx // C + tok * C ** (m - 1), lm_ctx)
                flat_parent = (parent + rows).reshape(-1)
                states = [(hh[flat_parent], cc[flat_parent])
                          for hh, cc in states]
                write = (slot == out_len[:, :, None]) & is_label[:, :, None]
                out_ids = torch.where(write, tok[:, :, None], out_ids)
                out_len = out_len + is_label.long()
                new_states, h = self.pred_step(w, states, tok.reshape(-1))
                keep = is_label.reshape(-1, 1)
                states = _select(keep, new_states, states)
                pred_j = torch.where(is_label[:, :, None],
                                     (h @ w_pred).reshape(B, K, J), pred_j)
                done = ~is_label
        # lanes sorted by final score, so that nbest[:, 0] is the best
        order = torch.argsort(-scores, dim=1, stable=True)
        scores = torch.gather(scores, 1, order)
        out_len = torch.gather(out_len, 1, order)
        out_ids = gather_k(out_ids, order)
        return ([out_ids[:, 0].int(), out_len[:, 0].int()],
                [out_ids.int(), out_len.int(), scores])


class TransducerDecoder(Decoder):

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "tgt_vocab_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Decoder.get_optional_params(), **{
            "pred_embed_size": int,       # prediction-net embedding width
            "pred_units": int,            # prediction-net LSTM width
            "pred_layers": int,           # prediction-net LSTM depth
            "joint_dim": int,             # joint-network hidden width
            "max_symbols_per_frame": int,  # decode's labels a frame
            "max_output_length": int,     # decode buffer (0: the frames)
            "dropout_keep_prob": float,
            "fused_loss": bool,           # no (B, T, U+1, V) lattice
            "beam_width": int,            # > 1: frame-synchronous beam
            # shallow fusion (beam decode only)
            "lm_fusion_arpa": str,        # label-level ARPA or binary LM
            "lm_fusion_weight": float,    # lambda on LM log-probs (0.5)
            "lm_fusion_beta": float,      # label insertion bonus
            "lm_fusion_order": int,       # densification order cap (3)
            "alphabet_config_path": str,  # the id-ordered label chars
        })

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> TransducerDecoderModule:
        p = self._params
        model = self._model
        dtype = torch.float32 if model is None \
            else model.mp_policy.compute_dtype
        lm_fusion = None
        if p.get("lm_fusion_arpa"):
            from ..data.speech2text.speech2text import (
                load_pre_existing_vocabulary)
            vocab = load_pre_existing_vocabulary(p["alphabet_config_path"],
                                                 read_chars=True)
            labels = tuple(c for c, _ in sorted(vocab.items(),
                                                key=lambda kv: kv[1]))
            lm_fusion = (p["lm_fusion_arpa"], labels,
                         float(p.get("lm_fusion_weight", 0.5)),
                         float(p.get("lm_fusion_beta", 0.0)),
                         int(p.get("lm_fusion_order", 3)))
        return TransducerDecoderModule(
            vocab=p["tgt_vocab_size"],
            embed=p.get("pred_embed_size", 320),
            units=p.get("pred_units", 320),
            layers=p.get("pred_layers", 1),
            joint=p.get("joint_dim", 320),
            enc_width=in_features,
            max_symbols_per_frame=p.get("max_symbols_per_frame", 3),
            max_output_length=p.get("max_output_length", 0),
            keep_prob=p.get("dropout_keep_prob", 1.0),
            dropout_bits=32 if model is None
            else model.params.get("dropout_bits", 32),
            fused_loss=p.get("fused_loss", False),
            beam_width=p.get("beam_width", 1),
            dtype=dtype, mode=self._mode, lm_fusion=lm_fusion,
            generator=generator)
