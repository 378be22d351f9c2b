"""Tensor and data parallelism: the dp x tp mesh and the Megatron split of
the parameters.

Port of ``crane_tpu/parallel/sharding.py``. crane_tpu annotates its arrays
with ``PartitionSpec``s and lets GSPMD place the collectives; PyTorch has no
single-process counterpart, so the port writes the split out. Each tp shard
holds its own slice of every weight whose spec names ``tp``, on its own
device:

- wq/wk/wv, bq/bk/bv, gate and up split their out columns (whole heads:
  Qwen3-Next's ``[query | gate]`` columns are head-major); wo and down
  split their in rows, so a shard's product is a partial sum;
- embed splits its vocab rows, lm_head its vocab columns;
- the stacked MoE experts split the expert axis, the shared expert like a
  dense MLP; the router, ``shared_gate`` and LFM2-MoE's ``expert_bias``
  replicate;
- a GDN layer splits in_proj_qkvz / in_proj_ba by whole k-head groups,
  A_log and dt_bias by v-head, out_proj on its in rows; its conv weight
  replicates in crane_tpu's spec, and each shard keeps the channels its
  parts convolve (its q, k and v slices, ``gdn_layer.py``);
- norms, q_norm/k_norm and anything else with no tp spec (LFM2's short
  conv) replicate, and those layers are computed once per dp group.

dp replicates the whole split once per group: shard ``(g, t)`` lives on
``mesh.devices[g][t]``, and every position owns its copy, so on a repeated
device the copies add up, as they would on separate cards. Where tp does
not divide the kv heads, crane_tpu's kernels replicate the attention
(``ops/pallas/partitioning.py``); the port keeps such a layer's attention
whole, on each group's first device.

crane_tpu cannot shard weights quantized in situ (its ``shard_params`` maps
a spec leaf onto a ``QuantizedWeight`` node and raises); the port refuses
them likewise (:data:`ISQ_UNDER_MESH`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from crane_tpu_torch.ops.linear import QuantizedWeight
from crane_tpu_torch.utils.device import default_device

# the refusal of quantized weights under a mesh, the reference's own limit
ISQ_UNDER_MESH = (
    "weights quantized in situ (QuantizedWeight) cannot be sharded over a mesh: crane_tpu's "
    "shard_params maps a PartitionSpec leaf onto the QuantizedWeight node and raises "
    "'Custom dataclass node type mismatch', so serve --quant with --tp/--dp fails there too")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A dp x tp grid of devices: ``devices[g][t]`` holds tp shard ``t`` of
    dp group ``g``. A device may repeat."""

    devices: tuple

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])

    @property
    def lead(self) -> torch.device:
        """The first device: the residual stream of group 0, sampling and
        the cache lengths live here."""
        return self.devices[0][0]

    @property
    def flat(self) -> tuple:
        return tuple(d for row in self.devices for d in row)


def make_mesh(dp: int = 1, tp: int = 1, devices=None) -> Mesh:
    """The ``dp x tp`` mesh over the first ``dp * tp`` of ``devices``, by
    default the cards ``cuda:0 .. cuda:n-1`` (raising without a card). A
    device may repeat: ``["cpu"] * 4`` runs a 2 x 2 mesh on the CPU,
    ``["cuda:0"] * 4`` on one card."""
    if devices is None:
        default_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    n = dp * tp
    if dp < 1 or tp < 1 or len(devices) < n:
        raise ValueError(f"a {dp} x {tp} mesh needs {n} devices, got {len(devices)}")
    return Mesh(tuple(tuple(devices[g * tp:(g + 1) * tp]) for g in range(dp)))


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, as a tensor's own device reads."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def param_partition_specs(params: dict) -> dict:
    """The spec tree of crane_tpu's ``param_partition_specs``, leaf for
    leaf, each ``PartitionSpec`` written as a plain tuple of axis names
    (``()`` replicates). Linear weights are stored ``[in, out]``."""

    def mlp_spec(mlp: dict) -> dict:
        if "router" in mlp:
            spec = {"router": (), "experts_gate": ("tp", None, None),
                    "experts_up": ("tp", None, None), "experts_down": ("tp", None, None)}
            for k in ("shared_gate_proj", "shared_up"):
                if k in mlp:
                    spec[k] = (None, "tp")
            if "shared_down" in mlp:
                spec["shared_down"] = ("tp", None)
            for k in ("shared_gate", "expert_bias"):
                if k in mlp:
                    spec[k] = ()
            return spec
        return {"gate": (None, "tp"), "up": (None, "tp"), "down": ("tp", None)}

    def gdn_spec(gdn: dict) -> dict:
        spec = {"in_proj_qkvz": (None, "tp"), "in_proj_ba": (None, "tp"), "A_log": ("tp",),
                "dt_bias": ("tp",), "out_proj": ("tp", None), "conv_w": (), "norm": ()}
        return {k: spec.get(k, ()) for k in gdn}

    def layer_spec(layer: dict) -> dict:
        out = {"mlp": mlp_spec(layer["mlp"]), "input_ln": ()}
        if "post_ln" in layer:
            out["post_ln"] = ()
        if "gdn" in layer:
            out["gdn"] = gdn_spec(layer["gdn"])
        if "attn" in layer:
            attn = {"wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"), "wo": ("tp", None)}
            for b in ("bq", "bk", "bv"):
                if b in layer["attn"]:
                    attn[b] = ("tp",)
            for nrm in ("q_norm", "k_norm"):
                if nrm in layer["attn"]:
                    attn[nrm] = ()
            out["attn"] = attn
        for k in layer:
            if k not in out:
                out[k] = _map(layer[k], lambda _: ())
        return out

    spec: dict[str, Any] = {"embed": ("tp", None),
                            "layers": tuple(layer_spec(l) for l in params["layers"]),
                            "final_norm": ()}
    if "lm_head" in params:
        spec["lm_head"] = (None, "tp")
    return spec


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def leaves(tree, path=()):
    """``(path, leaf)`` over a param tree (or a spec tree, whose leaves are
    tuples of axis names), a path being its keys and indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)) and not _is_spec(tree):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def whole_attention(cfg, tp: int) -> tuple[bool, ...]:
    """Per layer: an attention layer whose kv heads tp does not divide,
    kept whole (crane_tpu replicates its attention kernels there)."""
    return tuple(cfg.layer_type(i) not in ("gdn", "conv") and cfg.num_kv_heads % tp != 0
                 for i in range(cfg.num_layers))


@dataclasses.dataclass
class ShardedParams:
    """The parameters split over ``mesh``: ``trees[g][t]`` is shard ``t``'s
    param tree of dp group ``g``, on ``mesh.devices[g][t]``, the tree of
    the unsharded model with each leaf cut to the shard's part
    (:func:`shard_params`). A layer kept whole (:func:`whole_attention`)
    has its ``attn`` in shard 0 only. ``specs`` is
    :func:`param_partition_specs`' tree; ``split[path]`` says whether a
    leaf differs between tp shards (a split leaf, GDN's conv channels, a
    whole layer's attention) or is a replicated copy; ``whole[i]`` says
    whether layer ``i``'s attention is kept whole."""

    mesh: Mesh
    trees: tuple
    specs: dict
    split: dict
    whole: tuple

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    def device_bytes(self) -> dict:
        """Bytes of weights each device holds (the copies on a repeated
        device add up)."""
        held: dict = {}
        for row, devs in zip(self.trees, self.mesh.devices):
            for tree, dev in zip(row, devs):
                held[dev] = held.get(dev, 0) + sum(
                    t.numel() * t.element_size() for _, t in leaves(tree))
        return held


def _spec_at(specs, path):
    spec = get(specs, path)
    if not _is_spec(spec):
        raise ValueError(f"no spec for the leaf at {path}")
    return spec


def shard_leaf(cfg, x: torch.Tensor, path, spec: tuple, t: int, tp: int) -> torch.Tensor:
    """Shard ``t``'s part of the leaf ``x`` at ``path`` (a view of ``x``)."""
    if path[-2:] == ("gdn", "conv_w"):
        # the channels of the shard's q, k and v parts, in [Q|K|V] order
        kd, vd = cfg.gdn.key_dim, cfg.gdn.value_dim
        k_t, v_t = kd // tp, vd // tp
        return torch.cat([x[t * k_t:(t + 1) * k_t], x[kd + t * k_t:kd + (t + 1) * k_t],
                          x[2 * kd + t * v_t:2 * kd + (t + 1) * v_t]])
    if "tp" not in spec:
        return x
    axis = spec.index("tp")
    if x.shape[axis] % tp:
        raise ValueError(f"{'/'.join(map(str, path))}: {x.shape[axis]} does not split {tp} ways")
    n = x.shape[axis] // tp
    return x.narrow(axis, t * n, n)


def _check_divisible(cfg, tp: int) -> None:
    if cfg.gdn is not None and cfg.gdn.num_k_heads % tp:
        raise ValueError(f"tp={tp} must divide the GDN key heads ({cfg.gdn.num_k_heads})")


def shard_params(cfg, params: dict, mesh: Mesh) -> ShardedParams:
    """Split ``params`` (the unsharded tree of config ``cfg``) over
    ``mesh``: each position ``(g, t)`` gets shard ``t``'s parts, copied onto
    its device (contiguous, sharing no memory with ``params``). Raises
    ``ValueError`` on a quantized weight (:data:`ISQ_UNDER_MESH`)."""
    if any(isinstance(x, QuantizedWeight) for _, x in leaves(params)):
        raise ValueError(ISQ_UNDER_MESH)
    tp = mesh.tp
    _check_divisible(cfg, tp)
    specs = param_partition_specs(params)
    whole = whole_attention(cfg, tp)
    split = {}
    parts = []
    for t in range(tp):
        shard: dict = {}
        for path, x in leaves(params):
            spec = _spec_at(specs, path)
            if path[0] == "layers" and path[2] == "attn" and whole[path[1]]:
                split[path] = True
                if t:
                    continue
                part = x
            else:
                part = shard_leaf(cfg, x, path, spec, t, tp)
                split[path] = part is not x
            shard[path] = part
        parts.append(shard)
    trees = tuple(tuple(_build(params, parts[t], dev) for t, dev in enumerate(row))
                  for row in mesh.devices)
    return ShardedParams(mesh=mesh, trees=trees, specs=specs, split=split, whole=whole)


def _build(like, flat: dict, device, path=()):
    """The tree of ``like``'s shape from ``flat`` (path -> tensor), each
    leaf copied onto ``device``; a path missing from ``flat`` is left out."""
    if isinstance(like, dict):
        out = {}
        for k, v in like.items():
            sub = _build(v, flat, device, path + (k,))
            if sub is not None:
                out[k] = sub
        return out or None
    if isinstance(like, (tuple, list)):
        return type(like)(_build(v, flat, device, path + (i,)) for i, v in enumerate(like))
    x = flat.get(path)
    return None if x is None else place(x, device)


def place(x: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device``, detached, sharing no memory
    with it."""
    return torch.empty_like(x, device=device, memory_format=torch.contiguous_format).copy_(
        x.detach())


def gather_params(cfg, params: ShardedParams, grads: bool = False) -> dict:
    """The unsharded tree of config ``cfg`` (on the lead device) from dp
    group 0's shards: each split leaf put back together, each replicated
    one (and a whole layer's attention) from shard 0. ``grads=True``
    gathers the leaves' ``.grad`` the same way."""
    tp, row, lead = params.mesh.tp, params.trees[0], params.mesh.lead

    def value(t, path):
        x = get(row[t], path)
        if grads:
            if x.grad is None:
                raise ValueError(f"no gradient at {path}")
            x = x.grad
        return x.to(lead)

    flat = {}
    for path, _ in leaves(row[0]):
        if not params.split[path] or _in_whole(params, path):
            flat[path] = value(0, path)
        elif path[-2:] == ("gdn", "conv_w"):
            k_t = cfg.gdn.key_dim // tp
            ch = [value(t, path) for t in range(tp)]
            flat[path] = torch.cat([c[:k_t] for c in ch] + [c[k_t:2 * k_t] for c in ch]
                                   + [c[2 * k_t:] for c in ch])
        else:
            axis = _spec_at(params.specs, path).index("tp")
            flat[path] = torch.cat([value(t, path) for t in range(tp)], dim=axis)
    return _unflatten(row[0], flat)


def _in_whole(params: ShardedParams, path) -> bool:
    return path[0] == "layers" and path[2] == "attn" and params.whole[path[1]]


def _unflatten(like, flat: dict, path=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, path + (k,)) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, flat, path + (i,)) for i, v in enumerate(like))
    return flat[path]


def cache_partition_spec() -> tuple:
    """KV buffers ``[B, S, H, D]``: slot rows over dp, kv heads over tp."""
    return ("dp", None, "tp", None)


def token_partition_spec() -> tuple:
    """Token rows over dp."""
    return ("dp", None)
