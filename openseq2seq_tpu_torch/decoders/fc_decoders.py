"""Fully-connected decoders (port of
``openseq2seq_tpu/decoders/fc_decoders.py``).

  * :class:`FullyConnectedDecoder` — one dense layer for classification
    over the flattened encoder outputs; :class:`FullyConnectedSCDecoder`,
    the speech-commands variant, first averages a (B, T, C) output over
    its valid frames;
  * :class:`FullyConnectedTimeDecoder` — per-frame dense projection to
    vocabulary logits, batch-major (B, T, V).
  * :class:`FullyConnectedCTCDecoder` — adds CTC decoding outside
    training: greedy, or with ``on_device_beam_width`` > 1 the prefix
    beam search of ``ops/ctc_beam_device.py`` on the logits' device,
    optionally with ``on_device_fusion`` (a dense character n-gram LM of
    ``ops/ngram_fusion.dense_label_lm``: ``lm_path``, and optionally
    ``labels``, ``alpha`` 0.5, ``beta`` 0.0, ``order`` 3); the beams'
    scores come back as ``beam_scores``. ``use_language_model`` sets
    ``infer_logits_to_pickle``'s default, so that infer pickles the
    logits for the host beam search with a word LM
    (``scripts_torch/decode.py``), and the in-step decode stays greedy;
    its host-side keys (``beam_width``, ``alpha``, ``beta``, ``lm_path``,
    ``alphabet_config_path``) are read by that script's caller, not here,
    and ``decoder_library_path``, ``trie_path`` and ``trie_weight`` print
    a note that they have no effect, as in the JAX package.

The dense layer computes in the model's compute dtype from fp32 params;
logits are cast to fp32 before the loss and the decode, as in the JAX
package.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .decoder import Decoder
from ..ops.ctc import ctc_greedy_decode
from ..ops.ctc_beam_device import FusionLM, ctc_beam_search_device
from ..parts.initializers import resolve_initializer
from ..parts.transformer.common import dense
from ..utils.logging import deco_print


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x W + b in ``dtype``, rounded as flax
    rounds it (``parts/transformer/common.dense``), W stored (out, in);
    no b with ``use_bias`` False."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, kernel_init,
                 generator: torch.Generator, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias \
            else None
        kernel_init(self.weight, generator)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x.to(self.dtype), self.weight.to(self.dtype),
                     None if self.bias is None
                     else self.bias.to(self.dtype))


class FCTimeDecoderModule(nn.Module):
    """With ``greedy_ctc``, decodes outside training: greedily, or with
    ``beam_width`` > 1 by the on-device prefix beam, fused with the LM
    ``fusion`` (its table a buffer that follows the module's device and is
    kept out of the state dict)."""

    def __init__(self, fully_connected: Dense, greedy_ctc: bool,
                 beam_width: int = 0, fusion: FusionLM = None):
        super().__init__()
        self.fully_connected = fully_connected
        self.greedy_ctc = greedy_ctc
        self.beam_width = beam_width
        self.fusion = fusion
        if fusion is not None:
            self.register_buffer("fusion_table", fusion.table,
                                 persistent=False)

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        """``generator`` is unused: the layer has no dropout."""
        x = input_dict["encoder_output"]["outputs"]
        src_length = input_dict["encoder_output"]["src_length"]
        # logits feed fp32 losses and decoders
        logits = self.fully_connected(x).float()
        out: Dict[str, Any] = {"logits": logits, "src_length": src_length}
        if self.greedy_ctc and not train:
            if self.beam_width > 1:
                fusion = None if self.fusion is None else \
                    self.fusion._replace(table=self.fusion_table)
                ids, lengths, scores = ctc_beam_search_device(
                    logits, src_length, beam_width=self.beam_width,
                    fusion=fusion)
                out["outputs"] = [ids[:, 0], lengths[:, 0]]
                out["beam_scores"] = scores
            else:
                out["outputs"] = list(ctc_greedy_decode(logits, src_length))
        return out


class FullyConnectedTimeDecoder(Decoder):

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "tgt_vocab_size": int,
        })

    @staticmethod
    def get_optional_params():
        return dict(Decoder.get_optional_params(), **{
            "infer_logits_to_pickle": bool,
        })

    def _dense(self, in_features: int, generator: torch.Generator) -> Dense:
        dtype = torch.float32 if self._model is None \
            else self._model.mp_policy.compute_dtype
        kinit = resolve_initializer(self._params.get("initializer"),
                                    self._params.get("initializer_params"))
        return Dense(in_features, self._params["tgt_vocab_size"], dtype,
                     kinit, generator)

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> FCTimeDecoderModule:
        return FCTimeDecoderModule(self._dense(in_features, generator),
                                   greedy_ctc=False)


class FullyConnectedCTCDecoder(FullyConnectedTimeDecoder):
    """FC time decoder plus CTC decoding outside training: greedy, or the
    on-device prefix beam (``on_device_beam_width``) with optional shallow
    fusion (``on_device_fusion``)."""

    @staticmethod
    def get_required_params():
        return dict(FullyConnectedTimeDecoder.get_required_params(), **{
            "use_language_model": bool,
        })

    @staticmethod
    def get_optional_params():
        return dict(FullyConnectedTimeDecoder.get_optional_params(), **{
            "decoder_library_path": str,
            "beam_width": int,
            "alpha": float,
            "beta": float,
            "trie_weight": float,
            "lm_path": str,
            "trie_path": str,
            "alphabet_config_path": str,
            "on_device_beam_width": int,
            "on_device_fusion": dict,
        })

    def __init__(self, params, model, name="fully_connected_ctc_decoder",
                 mode="train"):
        super().__init__(params, model, name, mode)
        if self._params["use_language_model"]:
            # the host-side beam with a word LM reads pickled logits; the
            # in-step decode stays greedy
            self._params.setdefault("infer_logits_to_pickle", False)
        for legacy in ("decoder_library_path", "trie_path", "trie_weight"):
            if legacy in self._params:
                deco_print(
                    "NOTE: decoder_params['{}'] is accepted for "
                    "reference-config compatibility but has no effect "
                    "(see docs/migrating.md)".format(legacy))

    def _make_fusion(self) -> FusionLM:
        """The dense label LM of ``on_device_fusion``, or None; its labels
        default to the data layer's characters in id order."""
        fus = self._params.get("on_device_fusion")
        if not fus:
            return None
        from ..ops.ngram_fusion import dense_label_lm
        labels = fus.get("labels")
        if labels is None:
            c2i = self._model.get_data_layer().params["char2idx"]
            labels = tuple(sorted(c2i, key=c2i.get))
        table, C, m, init_ctx = dense_label_lm(
            fus["lm_path"], tuple(labels), order=fus.get("order", 3))
        return FusionLM(torch.as_tensor(table, dtype=torch.float32), C, m,
                        init_ctx, float(fus.get("alpha", 0.5)),
                        float(fus.get("beta", 0.0)))

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> FCTimeDecoderModule:
        beam = int(self._params.get("on_device_beam_width", 0))
        return FCTimeDecoderModule(
            self._dense(in_features, generator), greedy_ctc=True,
            beam_width=beam, fusion=self._make_fusion() if beam > 1
            else None)


class FCDecoderModule(nn.Module):
    """One dense layer, ``fully_connected``, over the encoder's outputs
    flattened past the batch axis; with ``masked_mean`` a (B, T, C) output
    with ``src_length`` is first averaged over its valid frames. Logits in
    the compute dtype (``fp32_logits`` False, as ``FullyConnectedDecoder``)
    or fp32, and their argmax as ``outputs``."""

    def __init__(self, fully_connected: Dense, masked_mean: bool,
                 fp32_logits: bool):
        super().__init__()
        self.fully_connected = fully_connected
        self.masked_mean, self.fp32_logits = masked_mean, fp32_logits

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None):
        """``generator`` is unused: the layer has no dropout."""
        x = input_dict["encoder_output"]["outputs"]
        lengths = input_dict["encoder_output"].get("src_length")
        if self.masked_mean and x.dim() == 3 and lengths is not None:
            mask = (torch.arange(x.shape[1], device=x.device)[None, :] <
                    lengths[:, None]).to(x.dtype)
            x = (x * mask[:, :, None]).sum(1) / \
                mask.sum(1).clamp_min(1.0)[:, None]
        elif x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        logits = self.fully_connected(x)
        if self.fp32_logits:
            logits = logits.float()
        return {"logits": logits, "outputs": [logits.argmax(-1)]}


class FullyConnectedDecoder(Decoder):
    """One dense layer for classification
    (``openseq2seq_tpu/decoders/fc_decoders.py:31-57``): the encoder's
    outputs flattened to (B, -1), logits in the compute dtype."""

    masked_mean, fp32_logits = False, False

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "output_dim": int,
        })

    def input_width(self, out_shape, has_lengths: bool) -> int:
        """The dense layer's input width for encoder outputs of
        ``out_shape`` an example (the batch axis left out)."""
        if self.masked_mean and len(out_shape) == 2 and has_lengths:
            return int(out_shape[-1])
        width = 1
        for n in out_shape:
            width *= int(n)
        return width

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> FCDecoderModule:
        dtype = torch.float32 if self._model is None \
            else self._model.mp_policy.compute_dtype
        kinit = resolve_initializer(self._params.get("initializer"),
                                    self._params.get("initializer_params"))
        return FCDecoderModule(
            Dense(in_features, self._params["output_dim"], dtype, kinit,
                  generator), self.masked_mean, self.fp32_logits)


class FullyConnectedSCDecoder(FullyConnectedDecoder):
    """Speech-commands decoder (``fc_decoders.py:211-249``): a (B, T, C)
    output with lengths is averaged over its valid frames, any other is
    flattened; fp32 logits."""

    masked_mean, fp32_logits = True, True
