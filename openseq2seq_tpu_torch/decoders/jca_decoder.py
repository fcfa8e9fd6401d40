"""Joint CTC-attention decoder (port of
``openseq2seq_tpu/decoders/jca_decoder.py``; reference
`open_seq2seq/decoders/jca_decoder.py:10-105`): a CTC head and an
attention decoder over the same encoder output, trained together by
``MultiTaskCTCEntropyLoss``; the attention head's decode is the
transcript.

As in the JAX package, the CTC head (``ctc_decoder``, module ``ctc``)
gets ``tgt_vocab_size - 1`` classes, so that its blank, the last class,
takes the id of ``GO_SYMBOL``; the attention head (``attn_decoder``,
module ``attn``) keeps the whole vocabulary and takes ``GO_SYMBOL``,
``END_SYMBOL``, and the keys of ``beam_search_params`` and
``language_model_params`` merged into its params. The module returns
``seq_outputs`` and ``ctc_outputs`` (each head's output dict), the
memory's ``src_length``, and the attention head's ``outputs`` and
``logits`` where it has them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from .decoder import Decoder


class JCADecoderModule(nn.Module):

    def __init__(self, ctc: nn.Module, attn: nn.Module):
        super().__init__()
        self.ctc = ctc
        self.attn = attn

    def forward(self, input_dict: Dict[str, Any], train: bool,
                generator: torch.Generator = None) -> Dict[str, Any]:
        seq_out = self.attn(input_dict, train, generator)
        ctc_out = self.ctc(input_dict, train, generator)
        out = {"seq_outputs": seq_out, "ctc_outputs": ctc_out,
               "src_length": seq_out.get(
                   "src_length", input_dict["encoder_output"]["src_length"])}
        for key in ("outputs", "logits"):
            if key in seq_out:
                out[key] = seq_out[key]
        return out


class JointCTCAttentionDecoder(Decoder):

    @staticmethod
    def get_required_params():
        return dict(Decoder.get_required_params(), **{
            "ctc_decoder": None,
            "attn_decoder": None,
            "attn_decoder_params": dict,
            "ctc_decoder_params": dict,
            "beam_search_params": dict,
            "language_model_params": dict,
            "GO_SYMBOL": int,
            "END_SYMBOL": int,
            "tgt_vocab_size": int,
        })

    def __init__(self, params, model, name="jca_decoder", mode="train"):
        super().__init__(params, model, name, mode)
        p = self._params
        ctc_params = dict(p["ctc_decoder_params"])
        attn_params = dict(p["attn_decoder_params"])
        attn_params.update(p.get("beam_search_params", {}))
        attn_params.update(p.get("language_model_params", {}))
        ctc_params["tgt_vocab_size"] = p["tgt_vocab_size"] - 1
        attn_params["tgt_vocab_size"] = p["tgt_vocab_size"]
        attn_params["GO_SYMBOL"] = p["GO_SYMBOL"]
        attn_params["END_SYMBOL"] = p["END_SYMBOL"]
        self.ctc_decoder = p["ctc_decoder"](params=ctc_params, model=model,
                                            mode=mode)
        self.attn_decoder = p["attn_decoder"](params=attn_params,
                                              model=model, mode=mode)

    def make_module(self, in_features: int,
                    generator: torch.Generator) -> JCADecoderModule:
        """``in_features`` is the encoder's output width; the attention
        head's weights are drawn first, as the JAX module calls it
        first."""
        attn = self.attn_decoder.make_module(in_features, generator)
        ctc = self.ctc_decoder.make_module(in_features, generator)
        return JCADecoderModule(ctc, attn)
