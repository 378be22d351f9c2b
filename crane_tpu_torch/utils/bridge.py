"""Hand ``crane_tpu`` parameters and caches to the port.

:func:`params_from_jax` turns a ``crane_tpu`` params pytree (nested dicts,
tuples and lists whose leaves are numpy arrays or ``jax.Array``s) into the
same tree of torch tensors, so both packages can run on the same weights;
:func:`audio_params_from_jax` does the same for the audio models' trees,
whose 1-D convs the port keeps in PyTorch's layout (the speech recognizers'
and the VAD's by default; ECAPA's and Mimi's with :data:`ECAPA_CONV_KEYS`
and :data:`MIMI_CONV_KEYS`). The trees whose layout the two packages share
come across through :func:`params_from_jax` as they are: Qwen3-TTS's talker
and code predictor, the speech tokenizer's decoder and encoder (convs
``[Cout, Cin, k]`` in both), CSM's backbone, depth decoder and tables.
:func:`voxtral_params_from_jax`, :func:`kokoro_params_from_jax` and
:func:`ocr_params_from_jax` carry the Voxtral TTS, Kokoro and OCR nets'
trees, whose convs the port keeps in PyTorch's layouts.
:func:`cache_from_jax` turns a ``crane_tpu`` ``KVCache`` (fp, int8/int4, GDN
and short-conv layers) into the port's, so a decode step or a continuation can start
from JAX's own state. Nothing here imports jax: a ``jax.Array`` leaf is read
through ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from crane_tpu_torch.ops.kv_cache import (
    ConvLayerCache,
    GdnLayerCache,
    KVCache,
    LayerKVCache,
    QuantLayerKVCache,
)
from crane_tpu_torch.ops.linear import QuantizedWeight


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array (numpy, ``jax.Array`` or anything ``np.asarray`` takes) ->
    a torch tensor. ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16``, so
    bf16 goes through a ``uint16`` view of the same bytes."""
    arr = np.array(a)  # a writable copy: jax hands out read-only buffers
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree, device=None, dtype: torch.dtype | None = None):
    """A ``crane_tpu`` params pytree -> the port's tree of tensors.

    Floating leaves are cast to ``dtype`` when it is given; integer leaves
    keep their type. A ``crane_tpu`` ``QuantizedWeight`` becomes the port's
    :class:`~crane_tpu_torch.ops.linear.QuantizedWeight` with the same int8
    codes, float32 scales, ``block`` and ``bits``: ``dtype`` never touches
    codes or scales. A fused tree (``wqkv``, ``bqkv``, ``gate_up``, fused
    ``QuantizedWeight`` leaves) comes across as it is, equal to the port's
    ``fuse_params`` of the bridged unfused tree."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    if hasattr(tree, "codes") and hasattr(tree, "scales"):
        return QuantizedWeight(codes=tensor_from_numpy(tree.codes, device),
                               scales=tensor_from_numpy(tree.scales, device),
                               block=tree.block, bits=tree.bits)
    t = tensor_from_numpy(tree, device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def cache_from_jax(cache, device=None) -> KVCache:
    """A ``crane_tpu`` ``KVCache`` -> the port's, layer by layer, with the
    same values and dtypes: ``GdnLayerCache`` (conv window and recurrent
    state), ``ConvLayerCache`` (conv window alone), ``QuantLayerKVCache``
    (codes, scales, bits) or ``LayerKVCache``."""
    def t(a):
        return tensor_from_numpy(a, device)

    layers = []
    for layer in cache.layers:
        if hasattr(layer, "recurrent_state"):
            layers.append(GdnLayerCache(conv_state=t(layer.conv_state),
                                        recurrent_state=t(layer.recurrent_state)))
        elif hasattr(layer, "conv_state"):
            layers.append(ConvLayerCache(conv_state=t(layer.conv_state)))
        elif hasattr(layer, "k_scale"):
            layers.append(QuantLayerKVCache(k=t(layer.k), v=t(layer.v), k_scale=t(layer.k_scale),
                                            v_scale=t(layer.v_scale), bits=layer.bits,
                                            n_kv_heads=layer.k_scale.shape[1]))
        else:
            layers.append(LayerKVCache(k=t(layer.k), v=t(layer.v)))
    return KVCache(layers=tuple(layers), lengths=t(cache.lengths))


# 1-D conv weights crane_tpu stores WIO ``[k, Cin, Cout]``: Qwen2-Audio's and
# Whisper's ``conv1_w``/``conv2_w``, Moonshine's frontend ``conv1_w``..
# ``conv3_w``, and the VAD net's ``convs[i]["w"]``
_CONV_KEYS = ("conv1_w", "conv2_w", "conv3_w", "w")
# ECAPA's: the TDNN convs ``w``, the SE convs ``w1``/``w2``, the attentive
# pool's ``conv_w`` and the output ``fc_w``
ECAPA_CONV_KEYS = ("w", "w1", "w2", "conv_w", "fc_w")
# Mimi's SEANet and frame-rate convs (its transposed convs ``up_w`` and
# ``upsample_w`` are torch's ``[Cin, Cout / groups, k]`` in both packages)
MIMI_CONV_KEYS = ("init_w", "conv1_w", "conv2_w", "down_w", "final_w", "downsample_w")


def audio_params_from_jax(tree, device=None, dtype: torch.dtype | None = None,
                          conv_keys=_CONV_KEYS):
    """A ``crane_tpu`` audio params tree (Qwen3-ASR's AuT tower and
    projector, Qwen2-Audio's encoder and projector, Whisper, Moonshine, the
    VAD net, with or without a text model beside them; ECAPA and Mimi with
    their ``conv_keys``) -> the port's tree, as :func:`params_from_jax`,
    except that each 1-D conv weight named in ``conv_keys`` becomes
    PyTorch's ``[Cout, Cin, k]`` and Moonshine's GroupNorm affine (``gn_w``,
    ``gn_b``, ``[1, 1, C]``) becomes ``[C]``. AuT's 2-D convs are OIHW in
    both packages and come across as they are."""
    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, key) for v in node)
        if node is None:  # Mimi's acoustic branch when it has none
            return None
        t = params_from_jax(node, device, dtype)
        if key in conv_keys and t.ndim == 3:
            return t.permute(2, 1, 0).contiguous()
        if key in ("gn_w", "gn_b"):
            return t.reshape(-1)
        return t

    return walk(tree, "")


def _convs_from_jax(tree, key, device, dtype, perms: dict):
    """:func:`params_from_jax` over ``tree``, each leaf under a key in
    ``perms`` whose rank has a permutation there permuted to it."""
    if isinstance(tree, dict):
        return {k: _convs_from_jax(v, k, device, dtype, perms) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convs_from_jax(v, key, device, dtype, perms) for v in tree)
    if tree is None:
        return None
    t = params_from_jax(tree, device, dtype)
    perm = perms.get(key, {}).get(t.ndim)
    return t.permute(*perm).contiguous() if perm else t


def kokoro_params_from_jax(tree, device=None, dtype: torch.dtype | None = None):
    """crane_tpu's Kokoro net tree -> the port's: its 1-D convs (the
    encoder's ``convs[i]["w"]``, the duration head's ``w1``, the decoder
    blocks' ``w1``/``w2``), WIO ``[k, Cin, Cout]`` there, become PyTorch's
    ``[Cout, Cin, k]``; the 2-D ``w2`` of the duration head (a linear) and
    every other leaf come across as they are."""
    perm = {3: (2, 1, 0)}
    return _convs_from_jax(tree, "", device, dtype, {"w": perm, "w1": perm, "w2": perm})


def ocr_params_from_jax(tree, device=None, dtype: torch.dtype | None = None):
    """crane_tpu's OCR detector or recognizer tree -> the port's: each conv
    weight ``w``, HWIO ``[kh, kw, Cin, Cout]`` there, becomes PyTorch's
    ``[Cout, Cin, kh, kw]``."""
    return _convs_from_jax(tree, "", device, dtype, {"w": {4: (3, 2, 0, 1)}})


def voxtral_params_from_jax(tree, device=None, dtype: torch.dtype | None = None):
    """crane_tpu's Voxtral TTS tree -> the port's. The backbone, the
    acoustic transformer and the tables share their layout. The codec's
    convs (``input_conv``, ``output_conv``), WIO ``[k, Cin, Cout]`` there,
    become PyTorch's ``[Cout, Cin, k]``; its transposed convs (each
    stage's ``upsample``), which crane_tpu keeps flipped along k as
    ``[k, Cin, Cout]`` for its lhs-dilated convolution, become PyTorch's
    unflipped ``[Cin, Cout, k]``, the checkpoint's own layout."""
    out = params_from_jax({k: v for k, v in tree.items() if k != "codec"}, device, dtype)
    codec = tree["codec"]

    def conv(c, flipped=False):
        if c is None:
            return None
        w = params_from_jax(c["w"], device, dtype)
        w = w.flip(0).permute(1, 2, 0) if flipped else w.permute(2, 1, 0)
        b = None if c["b"] is None else params_from_jax(c["b"], device, dtype)
        return {"w": w.contiguous(), "b": b}

    out["codec"] = {
        "semantic_codebook": params_from_jax(codec["semantic_codebook"], device, dtype),
        "input_conv": conv(codec["input_conv"]),
        "stages": tuple({"layers": params_from_jax(s["layers"], device, dtype),
                         "upsample": conv(s.get("upsample"), flipped=True)}
                        for s in codec["stages"]),
        "output_conv": conv(codec["output_conv"]),
    }
    return out
