"""Carry state between the JAX package and the port, both ways.

:func:`state_dict_from_flax` takes the flax variables as nested dicts of
numpy arrays, ``{"params": ..., "batch_stats": ...}``, of any module
whose torch twin keeps the flax names (the whole forward pass, or a part
such as the TDNN encoder), and returns the ``state_dict`` for
``load_state_dict(strict=True)``:

  * conv kernel (k, in, out)   -> weight (out, in, k)
  * 2-D conv kernel (kt, kf, in, out) -> weight (out, in, kt, kf)
  * dense kernel (in, out)     -> weight (out, in)
  * recurrent_kernel (H, G·H), recurrent_bias (3H,) of the recurrent
    layers                     -> kept as they are, under the same names
  * bias                       -> bias (flax convs carry one by default)
  * batch norm scale / bias    -> weight / bias
  * batch_stats mean / var     -> running_mean / running_var, plus a zero
                                  ``num_batches_tracked``

  * embedding table            -> ``embedding`` (V, d), as it is (the
                                  LM's ``embedding``, its untied
                                  ``softmax/kernel`` (E, V) a dense kernel
                                  -> weight (V, E), its tied
                                  ``softmax_bias`` kept)
  * layer norm scale / bias    -> weight / bias
  * the NMT attention decoder's raw leaves (``lstm{i}_wx``, ``lstm{i}_wh``,
    ``lstm{i}_b``, ``att_q``, ``att_v``, ``att_b``, ``out_w``, ``out_b``,
    ``tied_proj``; its ``bahdanau_keys`` and ``luong_keys`` are dense
    layers, the latter without a bias), the transducer decoder's
    (``pred_embedding``, ``pred_wx{i}``, ``pred_wh{i}``, ``pred_b{i}``,
    ``joint_enc_w``, ``joint_pred_w``, ``joint_b``, ``joint_out_w``,
    ``joint_out_b``), the Tacotron decoder's
    (``prenet_w{i}``, ``prenet_b{i}``, its ``lstm{i}_*``, ``att_query``,
    ``att_v``, ``att_b``, ``loc_conv_kernel`` (31, 1, 32), a raw 3-D leaf
    and not a conv ``kernel``, ``loc_proj``, ``frame_w``, ``frame_b``,
    ``stop_w``, ``stop_b``; its ``memory`` is a dense layer), the GST
    encoder's ``style_tokens``, the Conformer's explicit leaves
    (``u_bias``, ``w_bias`` and the conv
    module's ``ln1_scale`` ... ``pw2_bias``) and the kernels of the
    ``DenseGeneral`` layers under a module named ``attn`` (``q``, ``k``,
    ``v``, ``r`` (D, H, Dh) and ``out`` (H, Dh, D)), as are
    Transformer-XL's under ``layer{i}_attn``, and the LM cells' raw
    leaves (the factorized LSTM's ``first_gemm_h``, ``second_gemm``,
    ``second_gemm_bias``, ``projection``; the layer-norm LSTM's
    ``ln_scale``, ``ln_bias`` (4, H)), and ConvS2S's learned positions
    ``pos_embedding`` (max length, E), and the LAS speller's
    (``TargetEmbeddingMatrix``, ``EncoderPositionEmbeddingMatrix``,
    ``DecoderPositionEmbeddingMatrix``, each head's ``att{i}_q``,
    ``att{i}_v``, ``att{i}_b``, ``att{i}_out_w``, ``att{i}_out_b``,
    ``att{i}_loc_conv`` (101, 1, 10), a raw 3-D leaf and not a conv
    ``kernel``, and ``att{i}_loc_proj``; the cells' ``rnn{i}_wx``,
    ``rnn{i}_wh``, ``rnn{i}_b``; ``fully_connected_w``,
    ``fully_connected_b``; its ``att{i}_keys`` are dense layers)
                               -> kept as they are, under the same names

The causal-convolution families need no other rule: Centaur's encoder
(``embedding``, ``conv{i}``, ``bn{i}``, ``proj``) and decoder
(``prenet{i}``, ``pre_proj``, ``conv{i}``, ``bn{i}``, ``att_q{i}``,
``att_kv{i}``, ``att_o{i}``, ``frame``, ``stop``), WaveNet's net
(``net/entry``, ``net/b{b}_l{l}_dilated``, ``_cond``, ``_res``,
``_skip``, ``net/post1``, ``net/post2``: conv kernels (k, in, out)) and
ConvS2S's encoder and decoder (``embedding``, ``conv{i}``,
``conv{i}_res_proj``, ``emb_proj``, ``att_q{i}``, ``att_out{i}``,
``pre_out``, ``out``) are embeddings, conv and dense kernels and bare
batch norms.

These rules go by module and leaf name, never by a kernel's rank: a
``DenseGeneral`` kernel is 3-D like a conv kernel, and the layouts differ.

The image models need no rule of their own: the ResNet's convs
(``init_conv``, ``block{i}_{j}/proj``, ``conv1`` to ``conv3``, no bias),
the CNN encoder's ``conv2d_{i}`` and ``dense_{i}`` and the classification
decoder's ``fully_connected`` are conv and dense kernels (flax (kh, kw,
in, out) -> torch (out, in, kh, kw); (in, out) -> (out, in)), and their
batch norms are bare flax ``BatchNorm`` modules (below).

The flax ``_Norm`` wrapper's inner ``BatchNorm_0`` folds into the torch
norm module, so ``enc/net/norm1_1/BatchNorm_0/scale`` becomes
``enc.net.norm1_1.weight``; so does its inner ``LayerNorm_0`` (the TDNN's
``layer_norm``; ``instance_norm`` and None hold no parameters), and the
transformer's ``TransformerNorm``
with its inner ``LayerNorm_0`` (``enc/sa_norms_0/LayerNorm_0/scale`` ->
``enc.sa_norms_0.weight``), and the Conformer FFN's (``ffn1/LayerNorm_0``
-> ``ffn1.weight``). The DeepSpeech2 encoder's batch norms
(``conv1_bn``, named ``*_bn``) are flax's ``BatchNorm`` itself, with no
inner module, and so are the Tacotron-2 encoder's, GST's and postnet's
(``bn{i}``, ``ref_bn{i}``, ``postnet_bn{i}``), the ResNet's (``init_bn``,
``preact_bn``, ``proj_bn``, ``bn{i}``, ``final_bn``), the CNN encoder's
(``batch_norm_{i}``) and the Conformer block's
layer norms (``attn_ln``, ``final_ln``, named ``*_ln``) and
Transformer-XL's (``layer{i}_ln1``, ``layer{i}_ln2``), and the GatedConv
tutorial encoder's ``LayerNorm_{i}`` directly under its ``net`` (beside
its ``front`` and ``conv{i}`` convs), which keep their flax names.
A separable TDNN block's depthwise kernel ``conv{l}_{r}_dw`` (k, 1, C)
becomes a grouped conv's weight (C, 1, k) by the conv rule; its
pointwise ``conv{l}_{r}_pw`` is a 1x1 conv.

:func:`flax_from_state_dict` is the inverse (a module with running
statistics is a batch norm, whose flax leaves sit under ``BatchNorm_0``
unless it is named ``*_bn`` or ``bn{i}``; the modules of
:func:`layer_norm_modules`
hold a folded ``LayerNorm_0``),
so tests can compare the port's updated weights leaf by leaf with the
JAX package's. :func:`flax_path` names a port parameter as the JAX
package does (``enc/net/conv1_1/kernel``), which is what
``freeze_variables_regex`` and the regularizer match against.
:func:`optimizer_state_from_optax` carries a NovoGrad (+ LARC, + clip),
Adam or AdamW (+ clip) optax state into the port's optimizer state.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

_BN_INNER = "BatchNorm_0"
_LN_INNER = "LayerNorm_0"
_STATS = {"mean": "running_mean", "var": "running_var"}
# kept under their flax names and in the flax layout
_RECURRENT = ("recurrent_kernel", "recurrent_bias")
_LM = ("softmax_bias",)
# ConvS2S's learned positions (encoder and decoder), (max length, E)
_CONVS2S = ("pos_embedding",)
_CONFORMER = ("u_bias", "w_bias", "ln1_scale", "ln1_bias", "pw1_kernel",
              "pw1_bias", "dw_kernel", "dw_bias", "ln2_scale", "ln2_bias",
              "pw2_kernel", "pw2_bias")
# the NMT attention decoder's raw leaves (``lstm{i}_wx``, ``lstm{i}_wh``,
# ``lstm{i}_b`` match by pattern)
_RNN_DECODER = ("att_q", "att_v", "att_b", "out_w", "out_b", "tied_proj")
_RNN_DECODER_CELL = re.compile(r"lstm[0-9]+_(wx|wh|b)")
# the Tacotron-2 decoder's raw leaves (``prenet_w{i}``, ``prenet_b{i}``
# match by pattern; its cells' by ``_RNN_DECODER_CELL``) and GST's tokens
_TACOTRON = ("att_query", "loc_conv_kernel", "loc_proj", "frame_w",
             "frame_b", "stop_w", "stop_b", "style_tokens")
_PRENET = re.compile(r"prenet_[wb][0-9]+")
# the transducer decoder's raw leaves (its cells' ``pred_wx{i}``,
# ``pred_wh{i}``, ``pred_b{i}`` match by pattern)
_TRANSDUCER = ("pred_embedding", "joint_enc_w", "joint_pred_w", "joint_b",
               "joint_out_w", "joint_out_b")
_TRANSDUCER_CELL = re.compile(r"pred_(wx|wh|b)[0-9]+")
# the LM cells' raw leaves: the factorized LSTM's and the layer-norm
# LSTM's (its ``recurrent_kernel`` is among ``_RECURRENT``)
_LM_CELLS = ("first_gemm_h", "second_gemm", "second_gemm_bias", "projection",
             "ln_scale", "ln_bias")
# the LAS speller's raw leaves (its heads' and cells' match by pattern)
_LAS = ("TargetEmbeddingMatrix", "EncoderPositionEmbeddingMatrix",
        "DecoderPositionEmbeddingMatrix", "fully_connected_w",
        "fully_connected_b")
_LAS_LEAF = re.compile(
    r"att[0-9]+_(q|v|b|out_w|out_b|loc_conv|loc_proj)|rnn[0-9]+_(wx|wh|b)")
_KEPT = _RECURRENT + _CONFORMER + _LM + _RNN_DECODER + _TACOTRON + \
    _TRANSDUCER + _LM_CELLS + _CONVS2S + _LAS
# the parent module of flax DenseGeneral layers, whose kernels are kept:
# the Conformer block's ``attn``, Transformer-XL's ``layer{i}_attn``, and
# the layers' names (the joint CTC-attention decoder's ``attn`` head holds
# dense layers)
_DENSE_GENERAL_PARENT = re.compile(r"(layer[0-9]+_)?attn")
_DENSE_GENERAL = ("q", "k", "v", "r", "out")
# bare flax LayerNorm modules: the Conformer's ``attn_ln``, ``final_ln``,
# Transformer-XL's ``layer{i}_ln1``, ``layer{i}_ln2``, the GatedConv net's
# ``LayerNorm_{i}``
_BARE_LN = re.compile(r".*_ln[0-9]*|LayerNorm_[0-9]+")


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _kept(leaf: str) -> bool:
    """Whether the flax leaf ``leaf`` is kept under its name and layout."""
    return leaf in _KEPT or bool(_RNN_DECODER_CELL.fullmatch(leaf) or
                                 _PRENET.fullmatch(leaf) or
                                 _TRANSDUCER_CELL.fullmatch(leaf) or
                                 _LAS_LEAF.fullmatch(leaf))


# flax BatchNorm modules with no inner ``BatchNorm_0``: the DS2 encoder's
# ``conv{i}_bn``, the Tacotron encoder's ``bn{i}``, GST's ``ref_bn{i}``, the
# postnet's ``postnet_bn{i}``, the ResNet's ``init_bn``, ``preact_bn``,
# ``proj_bn``, ``bn{i}``, ``final_bn`` and the CNN encoder's
# ``batch_norm_{i}`` (``bn_{i}``)
_BARE_BN = re.compile(
    r".*_bn|(ref_|postnet_)?bn[0-9]+|(batch_norm|bn)_[0-9]+")


def _module_key(path: Tuple[str, ...]) -> str:
    # a layer norm directly under ``net`` is the GatedConv net's own bare
    # ``LayerNorm_{i}``, a module of the port too; elsewhere an inner
    # ``LayerNorm_0`` or ``BatchNorm_0`` folds into its wrapper
    return ".".join(p for i, p in enumerate(path)
                    if p not in (_BN_INNER, _LN_INNER) or
                    (p == _LN_INNER and i > 0 and path[i - 1] == "net"))


def _param_to_torch(path: Tuple[str, ...], value) -> Tuple[str, np.ndarray]:
    """(torch name, array in torch layout) of the flax param at ``path``."""
    value = np.array(value, dtype=np.float32)
    module, leaf = _module_key(path[:-1]), path[-1]
    if _kept(leaf) or (leaf == "kernel" and len(path) >= 3 and
                         path[-2] in _DENSE_GENERAL and
                         _DENSE_GENERAL_PARENT.fullmatch(path[-3])):
        name = leaf
    elif leaf == "kernel" and value.ndim == 4:
        name, value = "weight", value.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and value.ndim == 3:
        name, value = "weight", value.transpose(2, 1, 0)
    elif leaf == "kernel" and value.ndim == 2:
        name, value = "weight", value.T
    elif leaf in ("kernel", "scale"):
        name = "weight"
    elif leaf in ("bias", "embedding"):
        name = leaf
    else:
        raise ValueError("no torch name for flax param {}".format(
            "/".join(path)))
    return _join(module, name), np.ascontiguousarray(value)


def _join(module: str, name: str) -> str:
    """``module.name``, or ``name`` for the top module."""
    return module + "." + name if module else name


def state_dict_from_flax(variables: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables.get("params", {})):
        name, value = _param_to_torch(path, value)
        out[name] = torch.from_numpy(value)
    for path, value in _flatten(variables.get("batch_stats", {})):
        module, leaf = _module_key(path[:-1]), path[-1]
        name = _STATS.get(leaf)
        if name is None:
            raise ValueError("no torch name for flax batch stat {}".format(
                "/".join(path)))
        out[_join(module, name)] = torch.from_numpy(
            np.array(value, dtype=np.float32))
        out[_join(module, "num_batches_tracked")] = torch.tensor(0)
    return out


def _norm_modules(names: Sequence[str]) -> set:
    return {n.rsplit(".", 1)[0] for n in names
            if n.endswith(".running_mean")}


def layer_norm_modules(module: torch.nn.Module) -> set:
    """The names of ``module``'s submodules that hold a folded flax
    ``LayerNorm_0`` (their ``flax_inner``)."""
    return {n for n, m in module.named_modules()
            if getattr(m, "flax_inner", None) == _LN_INNER}


def flax_path(name: str, norms: set, layer_norms: set = frozenset()
              ) -> Tuple[str, ...]:
    """The flax path of the port's parameter or statistic ``name``;
    ``norms`` holds the names of the batch-norm modules, ``layer_norms``
    those of the modules with a folded layer norm."""
    module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    parts = tuple(module.split(".")) if module else ()
    if module in norms:
        inner = () if _BARE_BN.fullmatch(parts[-1]) else (_BN_INNER,)
        return parts + inner + ({"weight": "scale", "bias": "bias",
                                 "running_mean": "mean",
                                 "running_var": "var"}[leaf],)
    if module in layer_norms and leaf in ("weight", "bias"):
        return parts + (_LN_INNER, {"weight": "scale", "bias": "bias"}[leaf])
    if parts and _BARE_LN.fullmatch(parts[-1]):
        return parts + ({"weight": "scale", "bias": "bias"}[leaf],)
    if _kept(leaf) or leaf == "kernel":
        return parts + (leaf,)
    return parts + ({"weight": "kernel", "bias": "bias",
                     "embedding": "embedding"}[leaf],)


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor],
                         layer_norms: set = frozenset()) -> Dict[str, Any]:
    """The port's ``state_dict`` as flax variables of numpy arrays,
    ``{"params": ..., "batch_stats": ...}``; ``layer_norms`` names the
    modules with a folded layer norm (:func:`layer_norm_modules`)."""
    norms = _norm_modules(state_dict)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, value in state_dict.items():
        if name.endswith(".num_batches_tracked"):
            continue
        path = flax_path(name, norms, layer_norms)
        value = value.detach().float().cpu().numpy()
        # a torch "weight" that flax names "kernel" is transposed back;
        # kept leaves ("kernel" of a DenseGeneral among them) are not
        torch_layout = path[-1] == "kernel" and name.endswith("weight")
        if torch_layout and value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)
        elif torch_layout and value.ndim == 3:
            value = value.transpose(2, 1, 0)
        elif torch_layout and value.ndim == 2:
            value = value.T
        tree = out["batch_stats" if path[-1] in _STATS else "params"]
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = np.ascontiguousarray(value)
    return out


def _params_list(tree: Dict[str, Any], names: List[str]
                 ) -> List[torch.Tensor]:
    """A flax param-shaped tree as tensors in the port's order ``names``."""
    converted = dict(_param_to_torch(p, v) for p, v in _flatten(tree))
    return [torch.from_numpy(converted[n]) for n in names]


def optimizer_state_from_optax(opt_state: Any, param_names: List[str]
                               ) -> Any:
    """An optax state of the JAX package's NovoGrad chain (optionally
    behind LARC and global-norm clipping) or Adam or AdamW chain
    (optionally behind global-norm clipping; AdamW's weight decay keeps
    no state) as the port's optimizer state,
    for parameters named ``param_names`` in the port's order. Moments are
    transposed into the torch layout; the per-tensor ``grads_ema`` become
    one (n,) tensor."""
    kind = type(opt_state).__name__
    if kind == "EmptyState":
        return None
    if kind in ("LARCState", "ScaleByScheduleState"):
        return {"count": int(opt_state.count)}
    if kind == "ScaleByAdamState":
        return {"count": int(opt_state.count),
                "mu": _params_list(opt_state.mu, param_names),
                "nu": _params_list(opt_state.nu, param_names)}
    if kind == "ScaleByNovoGradState":
        ema = [t.reshape(()) for t in _params_list(
            opt_state.grads_ema, param_names)]
        return {"count": int(opt_state.count),
                "moments": _params_list(opt_state.moments, param_names),
                "grads_ema": torch.stack(ema)}
    if isinstance(opt_state, (tuple, list)) and not hasattr(opt_state,
                                                            "_fields"):
        return [optimizer_state_from_optax(s, param_names)
                for s in opt_state]
    raise NotImplementedError("no port state for optax {}".format(kind))
