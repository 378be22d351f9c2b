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
    codes or scales."""
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
