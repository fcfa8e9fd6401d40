"""Tacotron-2 decoder (port of
``openseq2seq_tpu/decoders/tacotron2_decoder.py``).

An autoregressive frame decoder: a prenet whose dropout stays on in eval
and infer (the Tacotron-2 convention), a stack of zoneout LSTM cells,
location-sensitive (or Bahdanau) attention, the frame and stop-token
projections and a conv postnet added to the frames.

What the JAX module computes, and so the port:

  * the cell math in fp32 whatever the compute type: the encoder's
    outputs are cast to fp32; the attention keys (module ``memory``, a
    dense layer) are computed in the compute type and cast back; every
    other parameter is a raw fp32 leaf in flax's layout: ``prenet_w{i}``
    (in, units) and ``prenet_b{i}``, ``lstm{i}_wx`` (d_in, 4H),
    ``lstm{i}_wh`` (H, 4H) and ``lstm{i}_b`` (gates i, f, g, o; 1 added to
    the forget gate; layer 1 takes [prenet output, previous context]),
    ``att_query`` (H, A), ``att_v``, ``att_b``, ``loc_conv_kernel`` (31,
    1, 32), flax's ``WIO`` layout of the location conv, and ``loc_proj``
    (32, A), ``frame_w`` (H + E, r F), ``frame_b``, ``stop_w`` (H + E, r)
    and ``stop_b``;
  * the prenet: relu, then dropout at 0.5 in every mode, its masks drawn
    from the ``torch.Generator`` passed to ``forward`` (the model seeds
    one in eval and infer, as the JAX model passes a fixed key);
  * zoneout (``zoneout_prob`` p): in training each unit of c and h keeps
    its previous value with probability p; outside training the blend
    ``p prev + (1 - p) new``;
  * location-sensitive attention: ``att_v . tanh(h att_query + keys +
    att_b + conv(cum_align) loc_proj)``, the conv of width 31 with 15
    frames of zeros on either side over the cumulative alignment, a
    cross-correlation as in XLA; scores past each source length -1e9
    before the softmax; ``bahdanau`` leaves out the location term;
  * ``outputs_per_step`` r: each step projects r frames and r stop
    logits; its input is the last ground-truth frame of the previous
    group (zeros first) under teacher forcing, the last predicted frame
    when running free; the frames are cut back to T and the alignments
    repeated r times;
  * teacher forcing in training and eval (targets given, mode not
    infer); otherwise ``infer_max_steps`` free-running frames, all of
    them (no read on the host), the lengths from the first stop logit
    above 0 (the cumulative-sum rule), plus one;
  * ``mask_decoder_sequence``: frames zeroed and stop logits 1e3 past
    each length, the postnet's sum zeroed there too;
  * the postnet: SAME convs (``-1`` channels: F) in the compute type,
    each with batch norm (flax's momentum 0.1 and epsilon 1e-5 by
    default) and tanh (a config's ``activation_fn`` callable in its
    place; any other name, none), added to the frames in fp32.

Under teacher forcing the prenet over every step, its share of layer 1's
gates and the frame and stop projections of every step are each one
product outside the step loop. Within a step each cell's gates are one
product of [input, h] with its two weights stacked, the forget gate's 1
in the bias, and the location conv is one conv with ``loc_proj`` folded
into it (fp32 sums in another order than the JAX module's). The loop is
Python: one step's launches each, which the host issues.

Accepted with no effect, as in the JAX package, which reads them into
fields nothing uses: ``decoder_cell_type`` (an LSTM whatever it names;
a GRU is refused) and ``dropout_prob``. Refused, since they have no
effect there and no recipe sets them: ``bahdanau_normalize``,
``time_major``, ``use_swap_memory``, ``prenet_activation``,
``postnet_data_format``, ``postnet_keep_dropout_prob``,
``attention_bias``, ``parallel_iterations``.
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
from ..parts.initializers import resolve_initializer

_NEG = -1e9
LOCATION_FILTERS, LOCATION_KERNEL = 32, 31
REFUSED = ("bahdanau_normalize", "time_major", "use_swap_memory",
           "prenet_activation", "postnet_data_format",
           "postnet_keep_dropout_prob", "attention_bias",
           "parallel_iterations")
DEFAULT_POSTNET = [{"kernel_size": [5], "stride": [1], "num_channels": 512,
                    "padding": "SAME"}] * 4 + [
    {"kernel_size": [5], "stride": [1], "num_channels": -1,
     "padding": "SAME"}]

State = List[Tuple[torch.Tensor, torch.Tensor]]


def _flax_xavier(w, generator):
    """flax's ``xavier_uniform`` in flax's layout: the last axis is the
    fan out, the one before it the fan in, the others the receptive field
    (torch's takes the first two axes the other way round)."""
    receptive = math.prod(w.shape[:-2])
    limit = math.sqrt(6.0 / ((w.shape[-2] + w.shape[-1]) * receptive))
    w.uniform_(-limit, limit, generator=generator)


def _xavier(shape, generator) -> nn.Parameter:
    return _param(shape, _flax_xavier, generator)


class Tacotron2DecoderModule(nn.Module):

    def __init__(self, p: Dict[str, Any], enc_width: int, mode: str,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        # here, not at the top: the encoders' package imports the
        # recurrent layers, which import this package's dense layer
        from ..encoders.tdnn_encoder import BatchNorm, SameConv1d
        self.F = F_ = p["num_audio_features"]
        self.H = H = p["decoder_cell_units"]
        self.A = A = p["attention_layer_size"]
        self.E = E = enc_width
        self.layers = p["decoder_layers"]
        self.r = max(int(p.get("outputs_per_step", 1)), 1)
        self.location = (p["attention_type"] or "bahdanau") == "location"
        self.enable_prenet = p.get("enable_prenet", True)
        self.prenet_layers = p.get("prenet_layers", 2) \
            if self.enable_prenet else 0
        self.P = P = p.get("prenet_units", 256) if self.enable_prenet \
            else F_
        self.zoneout = p.get("zoneout_prob", 0.0)
        self.mask_decoder_sequence = p.get("mask_decoder_sequence", True)
        self.infer_max_steps = p.get("infer_max_steps", 1000)
        self.mode, self.dtype = mode, dtype

        self.memory = Dense(E, A, dtype, resolve_initializer(None),
                            generator)
        d_in = F_
        for i in range(1, self.prenet_layers + 1):
            self.register_parameter("prenet_w{}".format(i), _xavier(
                (d_in, P), generator))
            self.register_parameter("prenet_b{}".format(i),
                                    nn.Parameter(torch.zeros(P)))
            d_in = P
        for i in range(1, self.layers + 1):
            d_in = P + E if i == 1 else H
            self.register_parameter("lstm{}_wx".format(i), _xavier(
                (d_in, 4 * H), generator))
            self.register_parameter("lstm{}_wh".format(i), _param(
                (H, 4 * H), _orthogonal, generator))
            self.register_parameter("lstm{}_b".format(i),
                                    nn.Parameter(torch.zeros(4 * H)))
        self.att_query = _xavier((H, A), generator)
        self.att_v = nn.Parameter(torch.randn((A,), generator=generator)
                                  * 0.1)
        self.att_b = nn.Parameter(torch.zeros(A))
        if self.location:
            self.loc_conv_kernel = _xavier(
                (LOCATION_KERNEL, 1, LOCATION_FILTERS), generator)
            self.loc_proj = _xavier((LOCATION_FILTERS, A), generator)
        r = self.r
        self.frame_w = _xavier((H + E, F_ * r), generator)
        self.frame_b = nn.Parameter(torch.zeros(F_ * r))
        self.stop_w = _xavier((H + E, r), generator)
        self.stop_b = nn.Parameter(torch.zeros(r))

        self.postnet_acts = []
        if p.get("enable_postnet", True):
            width = F_
            for i, spec in enumerate(p.get("postnet_conv_layers",
                                           DEFAULT_POSTNET), start=1):
                if spec.get("padding", "SAME") != "SAME":
                    raise NotImplementedError(
                        "only SAME postnet convs are ported; got {}".format(
                            spec["padding"]))
                ch = F_ if spec["num_channels"] == -1 \
                    else spec["num_channels"]
                self.add_module("postnet_conv{}".format(i), SameConv1d(
                    width, ch, spec["kernel_size"][0], 1, 1, dtype,
                    resolve_initializer(None), generator))
                # flax momentum is the decay of the running average
                self.add_module("postnet_bn{}".format(i), BatchNorm(
                    ch, 1.0 - p.get("postnet_bn_momentum", 0.1),
                    p.get("postnet_bn_epsilon", 1e-5), dtype))
                act = spec.get("activation_fn", "tanh")
                self.postnet_acts.append(
                    torch.tanh if act in ("tanh", None)
                    else act if callable(act) else None)
                width = ch

    # ------------------------------------------------------------------
    def keep_mask(self, shape, generator: torch.Generator, device
                  ) -> torch.Tensor:
        """The prenet's dropout mask: keep with probability 0.5."""
        return torch.rand(shape, generator=generator, device=device) < 0.5

    def prenet(self, x: torch.Tensor, generator: torch.Generator
               ) -> torch.Tensor:
        for i in range(1, self.prenet_layers + 1):
            x = torch.relu(F.linear(x, getattr(self, "prenet_w{}".format(
                i)).t(), getattr(self, "prenet_b{}".format(i))))
            keep = self.keep_mask(x.shape, generator, x.device)
            x = torch.where(keep, x / 0.5, 0.0)
        return x

    def step_weights(self):
        """What every step reads, prepared once a pass: per layer the
        weight of [context, h] (layer 1) or [input, h] (the others), (d +
        H, 4H), and the bias with the forget gate's 1 added (layer 1's
        goes with its input part, outside the loop); the location conv
        folded with ``loc_proj`` into one conv to the A attention units,
        (A, 1, 31)."""
        forget = torch.zeros(4 * self.H, device=self.frame_w.device)
        forget[self.H:2 * self.H] = 1.0
        weights, biases = [], []
        for i in range(1, self.layers + 1):
            wx, wh, b = (getattr(self, "lstm{}_{}".format(i, leaf))
                         for leaf in ("wx", "wh", "b"))
            weights.append(torch.cat([wx[self.P:] if i == 1 else wx, wh]))
            biases.append(b + forget)
        loc = torch.einsum("kif,fa->aik", self.loc_conv_kernel,
                           self.loc_proj) if self.location else None
        return weights, biases, loc

    def cells(self, states: State, x_gates: torch.Tensor, ctx, weights,
              biases, zone, train: bool) -> Tuple[State, torch.Tensor]:
        """The LSTM stack at one step; ``x_gates`` is layer 1's input
        part of the gates, bias included; ``zone`` the step's zoneout
        keep-previous masks by layer (c, h) in training."""
        new: State = []
        inp = ctx
        for i in range(self.layers):
            h_prev, c_prev = states[i]
            gates = torch.addmm(x_gates if i == 0 else biases[i],
                                torch.cat([inp, h_prev], dim=1), weights[i])
            # the forget gate's 1 is in the bias
            sig = torch.sigmoid(gates)
            ig, fg, _, og = torch.chunk(sig, 4, dim=-1)
            c = torch.addcmul(fg * c_prev, ig,
                              torch.tanh(gates[:, 2 * self.H:3 * self.H]))
            h = og * torch.tanh(c)
            if self.zoneout > 0:
                if train:
                    c = torch.where(zone[i][0], c_prev, c)
                    h = torch.where(zone[i][1], h_prev, h)
                else:
                    # p prev + (1 - p) new
                    c = torch.lerp(c, c_prev, self.zoneout)
                    h = torch.lerp(h, h_prev, self.zoneout)
            new.append((h, c))
            inp = h
        return new, inp

    def attend(self, query, keys_b, memory, mask, cum_align, loc_weight
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context (B, E), alignment (B, S)) of ``query`` (B, H);
        ``keys_b`` is the keys plus ``att_b``, ``loc_weight`` the folded
        location conv (None for Bahdanau attention)."""
        e = (query @ self.att_query)[:, None, :] + keys_b
        if loc_weight is not None:
            loc = F.conv1d(cum_align[:, None, :], loc_weight,
                           padding=LOCATION_KERNEL // 2)     # (B, A, S)
            e = e + loc.transpose(1, 2)
        scores = torch.tanh(e) @ self.att_v
        scores = scores.masked_fill(~mask, _NEG)
        align = torch.softmax(scores, dim=-1)
        return torch.bmm(align[:, None, :], memory)[:, 0], align

    def zoneout_masks(self, G: int, B: int, train: bool,
                      generator: torch.Generator, device):
        """Per step, per layer, the (c, h) keep-previous masks of training
        zoneout; None outside training or without zoneout."""
        if not (train and self.zoneout > 0):
            return [None] * G
        if generator is None:
            raise ValueError("zoneout in training needs a torch.Generator")
        draws = torch.rand((G, self.layers, 2, B, self.H),
                           generator=generator, device=device) < \
            self.zoneout
        return [[(d[i, 0], d[i, 1]) for i in range(self.layers)]
                for d in draws.unbind(0)]

    # ------------------------------------------------------------------
    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        enc = input_dict["encoder_output"]
        memory = enc["outputs"].float()
        mem_len = enc["src_length"]
        B, S, _ = memory.shape
        dev = memory.device
        H, F_, r = self.H, self.F, self.r
        mask = torch.arange(S, device=dev)[None, :] < mem_len[:, None]
        keys_b = self.memory(memory).float() + self.att_b
        if self.prenet_layers and generator is None:
            raise ValueError("the prenet's dropout, on in every mode, needs "
                             "a torch.Generator")

        targets = input_dict.get("target_tensors")
        teacher = targets is not None and self.mode != "infer"
        if teacher:
            spec = targets[0].float()
            spec_len = targets[2]
            T = spec.shape[1]
            G = -(-T // r)
            spec_p = F.pad(spec, (0, 0, 0, G * r - T))
            # the last ground-truth frame of the previous group (zeros
            # first): the previous frame at r = 1
            dec_in = torch.cat([spec.new_zeros((B, 1, F_)),
                                spec_p[:, r - 1::r][:, :G - 1]], dim=1)
        else:
            T = self.infer_max_steps
            G = -(-T // r)

        weights, biases, loc_weight = self.step_weights()
        w_in = self.lstm1_wx[:self.P]
        zeros = torch.zeros((B, H), device=dev)
        states: State = [(zeros, zeros) for _ in range(self.layers)]
        ctx = torch.zeros((B, self.E), device=dev)
        cum = torch.zeros((B, S), device=dev)
        zone = self.zoneout_masks(G, B, train, generator, dev)
        tops, ctxs, aligns, groups, stops = [], [], [], [], []
        if teacher:
            # one tensor a step: indexing the whole one would make each
            # step's backward write a gradient of its full size
            pre_gates = torch.addmm(
                biases[0], self.prenet(dec_in, generator).reshape(B * G, -1),
                w_in).reshape(B, G, -1).unbind(1)
        else:
            prev = torch.zeros((B, F_), device=dev)
        for g in range(G):
            if teacher:
                x_gates = pre_gates[g]
            else:
                x_gates = torch.addmm(biases[0], self.prenet(prev, generator),
                                      w_in)
            states, h_top = self.cells(states, x_gates, ctx, weights,
                                       biases, zone[g], train)
            ctx, align = self.attend(h_top, keys_b, memory, mask, cum,
                                     loc_weight)
            cum = cum + align
            aligns.append(align)
            if teacher:
                tops.append(h_top)
                ctxs.append(ctx)
            else:
                proj_in = torch.cat([h_top, ctx], dim=-1)
                group = torch.addmm(self.frame_b, proj_in, self.frame_w)
                groups.append(group)
                stops.append(torch.addmm(self.stop_b, proj_in, self.stop_w))
                prev = group[:, -F_:]
        if teacher:
            proj_in = torch.cat([torch.stack(tops, 1), torch.stack(ctxs, 1)],
                                dim=-1)                     # (B, G, H + E)
            frames = proj_in @ self.frame_w + self.frame_b
            stop_logits = proj_in @ self.stop_w + self.stop_b
        else:
            frames = torch.stack(groups, 1)
            stop_logits = torch.stack(stops, 1)
        frames = frames.reshape(B, G * r, F_)[:, :T]
        stop_logits = stop_logits.reshape(B, G * r)[:, :T]
        alignments = torch.stack(aligns, 1).repeat_interleave(r, 1)[:, :T]

        if teacher:
            out_len = spec_len
        else:
            stopped = torch.sigmoid(stop_logits) > 0.5
            seen = torch.cumsum(stopped.int(), dim=1)
            out_len = torch.clamp((seen == 0).int().sum(1) + 1, max=T)
        if self.mask_decoder_sequence:
            tmask = torch.arange(T, device=dev)[None, :] < out_len[:, None]
            frames = frames * tmask[:, :, None]
            stop_logits = torch.where(tmask, stop_logits, 1e3)

        post = frames
        if self.postnet_acts:
            m = self._modules
            y = frames.to(self.dtype)
            for i, act in enumerate(self.postnet_acts, start=1):
                y = m["postnet_conv{}".format(i)](y)
                y = m["postnet_bn{}".format(i)](y, train)
                if act is not None:
                    y = act(y)
            post = frames + y.float()
            if self.mask_decoder_sequence:
                post = post * tmask[:, :, None]
        return {"decoder_spec": frames, "post_net_spec": post,
                "stop_token_logits": stop_logits, "alignments": alignments,
                "lengths": out_len, "outputs": [post, out_len]}


class Tacotron2Decoder(Decoder):
    """Config wrapper, the JAX package's schema."""

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "attention_layer_size": int,
            "attention_type": ["bahdanau", "location", None],
            "decoder_cell_units": int,
            "decoder_cell_type": None,
            "decoder_layers": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Decoder.get_optional_params(), **{
            "bahdanau_normalize": bool,
            "time_major": bool,
            "use_swap_memory": bool,
            "enable_prenet": bool,
            "prenet_layers": int,
            "prenet_units": int,
            "prenet_activation": None,
            "enable_postnet": bool,
            "postnet_conv_layers": list,
            "postnet_bn_momentum": float,
            "postnet_bn_epsilon": float,
            "postnet_data_format": ["channels_first", "channels_last"],
            "postnet_keep_dropout_prob": float,
            "mask_decoder_sequence": bool,
            "attention_bias": bool,
            "zoneout_prob": float,
            "dropout_prob": float,
            "parallel_iterations": int,
            "num_audio_features": int,
            "infer_max_steps": int,
            "outputs_per_step": int,
        })

    def __init__(self, params, model, name="decoder", mode="train"):
        super().__init__(params, model, name, mode)
        p = self._params
        refused = [k for k in REFUSED if k in p]
        if refused:
            raise ValueError("{} options {} have no effect in the JAX "
                             "package and are refused".format(
                                 type(self).__name__, refused))
        cell = p["decoder_cell_type"]
        name = cell if isinstance(cell, str) or cell is None \
            else getattr(cell, "__name__", "")
        if "gru" in str(name or "").lower():
            raise ValueError("decoder_cell_type {!r}: the JAX package builds "
                             "an LSTM decoder whatever the cell; the port "
                             "refuses it".format(cell))

    def make_module(self, in_features: int, generator: torch.Generator
                    ) -> Tacotron2DecoderModule:
        """``in_features`` is the encoder's output width."""
        dtype = torch.float32 if self._model is None \
            else self._model.mp_policy.compute_dtype
        return Tacotron2DecoderModule(self._params, in_features, self._mode,
                                      dtype, generator)
