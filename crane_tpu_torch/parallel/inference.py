"""Tensor- and data-parallel inference: a CausalLM run over a dp x tp mesh.

Port of ``crane_tpu/parallel/inference.py``. crane_tpu hands GSPMD a
Megatron-sharded param tree and a sharded cache, and XLA places the psum and
all-gather. Here one process drives every shard, as the sequence-parallel
slice does (:mod:`crane_tpu_torch.parallel.sequence`): NCCL refuses two
ranks on one card, so ``torch.distributed`` could not run a mesh whose
devices repeat (``make_mesh(2, 2, ["cuda:0"] * 4)``, the counterpart of
XLA's forced host device count), and one controller over a device grid
can. On separate cards the same code moves the partials by peer copies.

The forward (:func:`sharded_forward_hidden`) runs each dp group on its rows
of the batch and of the cache, layer by layer through the unsharded layer
body (``decoder_layer``) given the fan-out calls of :func:`shard_blocks`.
Within a group:

- the residual stream, the norms and the layers with nothing to split (a
  short conv, an attention layer kept whole) run on the group's first
  device, over its rows;
- every other mixer and MLP runs on each tp shard, at the shard's local
  head counts against the shard's own cache part: the attention block
  with ``Hq/tp`` and ``Hkv/tp`` heads (its kernels launched at those
  shapes, the port's counterpart of ``ops/pallas/partitioning.py``), the
  GDN block with ``Hv/tp`` v-heads, the MoE over the shard's experts;
- the row-split products (wo, down, the experts' down, out_proj) write
  float32 partial sums, which are added on the group's first device and
  rounded once to the model's dtype (the all-reduce), as one unsharded
  product rounds once;
- the embedding: each shard looks up the ids in its vocab rows, the rest
  read 0, and the parts add up; the head: each shard writes its vocab
  columns and the logits are concatenated (:func:`sharded_lm_logits`).

    mesh = make_mesh(dp=1, tp=2)
    lm = shard_lm(lm, mesh)          # same CausalLM API, sharded weights
    out = lm.generate(ids, gen)      # the single-device tokens
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.fuse import unfuse_params
from crane_tpu_torch.models.modules.gdn_layer import gdn_block
from crane_tpu_torch.models.modules.transformer import (
    LayerBlocks,
    TransformerConfig,
    attention_block,
    decoder_layer,
    make_layer_cache,
    mlp_block,
    rope_rows,
    run_layer,
    scale_embeds,
    short_conv_block,
    step_positions,
)
from crane_tpu_torch.ops.cuda.quant_matmul import matmul_f32
from crane_tpu_torch.ops.kv_cache import (
    ConvLayerCache,
    GdnLayerCache,
    KVCache,
    LayerKVCache,
    MeshLayerCache,
    QuantLayerKVCache,
)
from crane_tpu_torch.ops.norm import rms_norm
from crane_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedParams,
    place,
    shard_params,
    whole_attention,
)


@functools.lru_cache(maxsize=None)
def local_config(cfg: TransformerConfig, tp: int) -> TransformerConfig:
    """``cfg`` at one tp shard's head counts: ``Hq/tp`` and ``Hkv/tp``
    attention heads where tp divides them, ``Hk/tp`` and ``Hv/tp`` GDN
    heads."""
    heads = {}
    if cfg.num_kv_heads % tp == 0:
        heads = dict(num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp)
    if cfg.gdn is not None:
        heads["gdn"] = dataclasses.replace(cfg.gdn, num_v_heads=cfg.gdn.num_v_heads // tp,
                                           num_k_heads=cfg.gdn.num_k_heads // tp)
    return dataclasses.replace(cfg, **heads)


def _on(device, x):
    """``x`` on ``device``: a tensor moved, the tensors of a dict or a tuple
    moved, anything else (an int, None) as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _on(device, v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_on(device, v) for v in x)
    return x


def all_reduce(parts, device, dtype) -> torch.Tensor:
    """The sum of the shards' partials, added in float32 on ``device`` and
    cast once to ``dtype``."""
    total = parts[0].to(device, torch.float32)
    for p in parts[1:]:
        total = total + p.to(device, torch.float32)
    return total.to(dtype)


def _embed(cfg: TransformerConfig, row, ids: torch.Tensor, device) -> torch.Tensor:
    """The embedding of ``ids`` from one group's shards ``row``: each looks
    up the ids in its vocab rows, reading 0 for the rest, and the parts add
    up (exactly: one part is nonzero per id)."""
    parts = []
    for t, tree in enumerate(row):
        table = tree["embed"]
        n = table.shape[0]
        local = ids.to(table.device).long() - t * n
        hit = (local >= 0) & (local < n)
        parts.append(torch.where(hit[..., None], table[local.clamp(0, n - 1)], 0))
    return scale_embeds(cfg, all_reduce(parts, device, row[0]["embed"].dtype))


def shard_blocks(cfg: TransformerConfig, params: ShardedParams, i: int, g: int) -> LayerBlocks:
    """:func:`decoder_layer`'s calls for layer ``i`` of dp group ``g``. The
    layer runs on the group's first device, with shard 0's params and the
    tuple of the layer's cache parts; each call runs its block on every tp
    shard, with the params at the same path of that shard's tree, at the
    shard's heads against its own part, and returns the partials summed
    (:func:`all_reduce`) and the parts (written in place): attention at
    ``Hq/tp`` and ``Hkv/tp`` heads (its kernels launched at those shapes),
    GDN at ``Hv/tp`` v-heads, the MoE over the shard's experts. What has
    nothing to split (a short conv, an attention layer kept whole) runs
    once, on the first device."""
    row, devices = params.trees[g], params.mesh.devices[g]
    local = local_config(cfg, len(row))

    def fan(x, call):
        """``call(t, device)`` on every shard, the partials all-reduced."""
        return all_reduce([call(t, d) for t, d in enumerate(devices)], x.device, x.dtype)

    def attention(cfg_, p, x, parts, *args, **kw):
        if params.whole[i]:
            return attention_block(cfg_, p, x, parts[0], *args, **kw)[0], parts
        return fan(x, lambda t, d: attention_block(
            local, row[t]["layers"][i]["attn"], x.to(d), parts[t], *_on(d, args),
            partial=True, **_on(d, kw))[0]), parts

    def gdn(gcfg, p, x, parts, **kw):
        return fan(x, lambda t, d: gdn_block(
            local.gdn, row[t]["layers"][i]["gdn"], x.to(d), parts[t], partial=True,
            **_on(d, kw))[0]), parts

    def conv(cfg_, p, x, parts, **kw):
        return short_conv_block(cfg_, p, x, parts[0], **kw)[0], parts

    def mlp(cfg_, p, x):
        def shard(t, d):
            pt = row[t]["layers"][i]["mlp"]
            offset = t * pt["experts_down"].shape[0] if "router" in pt else 0
            return mlp_block(cfg_, pt, x.to(d), offset, partial=True)

        return fan(x, shard)

    return LayerBlocks(attention=attention, gdn=gdn, conv=conv, mlp=mlp)


def _mesh_layers(cache: KVCache) -> MeshLayerCache:
    layer = cache.layers[0]
    if not isinstance(layer, MeshLayerCache):
        raise ValueError("a sharded model needs its own cache (ShardedCausalLM.init_cache)")
    return layer


def sharded_forward_hidden(cfg: TransformerConfig, params: ShardedParams, tokens: torch.Tensor,
                           cache: KVCache, cache_positions, rope: dict, *,
                           read_cache: bool = True, cache_row: int | None = None,
                           active: torch.Tensor | None = None,
                           true_lengths: torch.Tensor | None = None, remat: bool = False,
                           plain_attention: bool = False) -> tuple[torch.Tensor, KVCache]:
    """:func:`~crane_tpu_torch.models.modules.transformer.forward_hidden`'s
    contract over a mesh: ``tokens [B, S]`` on the lead device, ``cache``
    from :func:`make_sharded_cache`. The batch's rows split evenly over the
    cache's dp groups (a row view covers one group); with ``cache_row`` the
    one row goes to the group that holds that slot. Returns the hidden
    states on the lead device and the cache, written in place."""
    mesh = params.mesh
    B, S = tokens.shape
    lead = mesh.lead
    positions, write_pos, new_lengths = step_positions(cache, cache_positions, B, S, active,
                                                       tokens.device)
    rope_embeds = rope_rows(rope, positions)
    layout = _mesh_layers(cache)
    if cache_row is not None:
        gi, local_row = divmod(cache_row, layout.rows)
        work = [(gi, slice(0, B), local_row)]
    else:
        n = len(layout.groups)
        if B != n * layout.rows:
            raise ValueError(f"{B} rows over {n} dp groups of {layout.rows}")
        work = [(gi, slice(gi * layout.rows, (gi + 1) * layout.rows), None) for gi in range(n)]

    hidden = []
    for gi, rows, crow in work:
        g = layout.groups[gi]
        dev = mesh.devices[g][0]
        x = _embed(cfg, params.trees[g], tokens[rows], dev)
        pos, wpos = positions[rows].to(dev), write_pos
        if isinstance(write_pos, torch.Tensor):
            wpos = write_pos[rows].to(dev)
        rope_g = {k: v[rows].to(dev) for k, v in rope_embeds.items()}
        kw = dict(read_cache=read_cache, cache_row=crow,
                  active=None if active is None else active[rows].to(dev),
                  true_lengths=None if true_lengths is None else true_lengths[rows].to(dev),
                  plain_attention=plain_attention)
        for i in range(cfg.num_layers):
            layer = functools.partial(decoder_layer, cfg, params.trees[g][0]["layers"][i],
                                      layer_idx=i, blocks=shard_blocks(cfg, params, i, g), **kw)
            x, _ = run_layer(layer, remat, x, cache.layers[i].parts[gi], pos, wpos, rope_g)
        x = rms_norm(x, params.trees[g][0]["final_norm"], eps=cfg.rms_norm_eps,
                     weight_offset=cfg.norm_weight_offset)
        hidden.append(x.to(lead))
    hidden = hidden[0] if len(hidden) == 1 else torch.cat(hidden)
    return hidden, KVCache(layers=cache.layers, lengths=new_lengths)


def sharded_lm_logits(cfg: TransformerConfig, params: ShardedParams,
                      hidden: torch.Tensor) -> torch.Tensor:
    """float32 logits from the shards' vocab columns (``lm_head``'s, or the
    embedding's rows transposed when tied), concatenated on the lead device.
    ``hidden``'s rows split over the dp groups where they divide evenly
    (a batched step), else go to group 0 (a slot prefill's one row): every
    group holds the same head."""
    mesh = params.mesh
    B = hidden.shape[0]
    chunks = hidden.chunk(mesh.dp) if B % mesh.dp == 0 else (hidden,)
    out = []
    for g, h in enumerate(chunks):
        cols = []
        for tree, d in zip(params.trees[g], mesh.devices[g]):
            head = tree["lm_head"] if "lm_head" in tree else tree["embed"].T
            cols.append(matmul_f32(h.to(d), head.to(h.dtype)).to(mesh.lead))
        out.append(torch.cat(cols, dim=-1))
    logits = out[0] if len(out) == 1 else torch.cat(out)
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def make_sharded_cache(cfg: TransformerConfig, mesh: Mesh, batch: int, max_seq: int, dtype, *,
                       quant_bits: int | None = None, device=None) -> KVCache:
    """The cache of a model sharded over ``mesh``: ``batch`` slot rows split
    evenly over the dp groups; each layer's part per tp shard at the
    shard's heads (an fp or int8/int4 attention cache, a GDN state), or
    one part a group for a layer computed once. The lengths live on the
    lead device. ``device="meta"`` sizes without allocating."""
    if batch % mesh.dp:
        raise ValueError(f"a batch of {batch} rows does not split over dp={mesh.dp}")
    rows, local = batch // mesh.dp, local_config(cfg, mesh.tp)
    whole = whole_attention(cfg, mesh.tp)
    layers = []
    for i in range(cfg.num_layers):
        once = cfg.layer_type(i) == "conv" or whole[i]
        devs = tuple(row[:1] if once else row for row in mesh.devices)
        parts = tuple(tuple(make_layer_cache(cfg if once else local, i, rows, max_seq, dtype,
                                             quant_bits=quant_bits, device=device or d)
                            for d in row) for row in devs)
        layers.append(MeshLayerCache(parts, devs, tuple(range(mesh.dp))))
    return KVCache(layers=tuple(layers),
                   lengths=torch.zeros((batch,), dtype=torch.int32, device=device or mesh.lead))


def _cut(layer, rows: slice, t: int, tp: int, cfg: TransformerConfig):
    """Shard ``t``'s part of a whole layer cache's ``rows``: its kv heads
    (quantized codes by their head-major columns, scales on the head axis),
    or its GDN v-heads and q/k/v conv channels; ``tp=1`` keeps the rows
    whole."""
    def heads(x, axis, n):
        size = x.shape[axis] // n
        return x[rows].narrow(axis, t * size, size)

    if isinstance(layer, LayerKVCache):
        return LayerKVCache(k=heads(layer.k, 2, tp), v=heads(layer.v, 2, tp))
    if isinstance(layer, QuantLayerKVCache):
        return dataclasses.replace(layer, k=heads(layer.k, 2, tp), v=heads(layer.v, 2, tp),
                                   k_scale=heads(layer.k_scale, 1, tp),
                                   v_scale=heads(layer.v_scale, 1, tp),
                                   n_kv_heads=layer.n_kv_heads // tp)
    if isinstance(layer, GdnLayerCache):
        kd, vd = cfg.gdn.key_dim, cfg.gdn.value_dim
        k_t, v_t = kd // tp, vd // tp
        cs = layer.conv_state[rows]
        conv = torch.cat([cs[..., t * k_t:(t + 1) * k_t], cs[..., kd + t * k_t:kd + (t + 1) * k_t],
                          cs[..., 2 * kd + t * v_t:2 * kd + (t + 1) * v_t]], dim=-1)
        return GdnLayerCache(conv_state=conv,
                             recurrent_state=heads(layer.recurrent_state, 1, tp))
    if isinstance(layer, ConvLayerCache):
        return ConvLayerCache(conv_state=layer.conv_state[rows])
    raise TypeError(f"no mesh split for {type(layer).__name__}")


def shard_cache(cfg: TransformerConfig, cache: KVCache, mesh: Mesh) -> KVCache:
    """A whole cache split over ``mesh`` as :func:`make_sharded_cache`
    lays it out, copied onto the parts' devices: slot rows over dp, kv
    heads over tp (quantized codes ``[B, T, Hkv*stored]`` by columns, scales
    ``[B, Hkv, T]`` on the head axis), GDN states over v-heads with each
    shard's q/k/v conv channels; a layer computed once keeps its rows
    whole."""
    B = cache.lengths.shape[0]
    if B % mesh.dp:
        raise ValueError(f"a batch of {B} rows does not split over dp={mesh.dp}")
    R = B // mesh.dp
    whole = whole_attention(cfg, mesh.tp)
    layers = []
    for i, layer in enumerate(cache.layers):
        once = cfg.layer_type(i) == "conv" or whole[i]
        devs = tuple(row[:1] if once else row for row in mesh.devices)
        parts = tuple(
            tuple(_placed(_cut(layer, slice(g * R, (g + 1) * R), t, len(row), cfg), d)
                  for t, d in enumerate(row))
            for g, row in enumerate(devs))
        layers.append(MeshLayerCache(parts, devs, tuple(range(mesh.dp))))
    return KVCache(layers=tuple(layers), lengths=place(cache.lengths, mesh.lead))


def _placed(layer, device):
    return dataclasses.replace(layer, **{
        f.name: place(getattr(layer, f.name), device) for f in dataclasses.fields(layer)
        if isinstance(getattr(layer, f.name), torch.Tensor)})


def gather_cache(cfg: TransformerConfig, cache: KVCache) -> KVCache:
    """The whole cache (on the lead device) a sharded one stands for: the
    inverse of :func:`shard_cache`, each GDN conv window put back in its
    ``[Q|K|V]`` channel order."""
    lead = cache.lengths.device
    layers = []
    for layer in cache.layers:
        groups = [_join([_placed(p, lead) for p in row], cfg) for row in layer.parts]
        layers.append(_join_rows(groups))
    return KVCache(layers=tuple(layers), lengths=cache.lengths.clone())


def _join(parts: list, cfg):
    """One group's parts joined over tp."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    if isinstance(first, LayerKVCache):
        return LayerKVCache(k=torch.cat([p.k for p in parts], 2),
                            v=torch.cat([p.v for p in parts], 2))
    if isinstance(first, QuantLayerKVCache):
        return dataclasses.replace(
            first, k=torch.cat([p.k for p in parts], 2), v=torch.cat([p.v for p in parts], 2),
            k_scale=torch.cat([p.k_scale for p in parts], 1),
            v_scale=torch.cat([p.v_scale for p in parts], 1),
            n_kv_heads=sum(p.n_kv_heads for p in parts))
    if isinstance(first, GdnLayerCache):
        k_t = cfg.gdn.key_dim // len(parts)
        cs = [p.conv_state for p in parts]
        conv = torch.cat([c[..., :k_t] for c in cs] + [c[..., k_t:2 * k_t] for c in cs]
                         + [c[..., 2 * k_t:] for c in cs], dim=-1)
        return GdnLayerCache(conv_state=conv, recurrent_state=torch.cat(
            [p.recurrent_state for p in parts], 1))
    raise TypeError(f"no tp join for {type(first).__name__}")


def _join_rows(groups: list):
    """Groups' layer caches stacked by rows."""
    if len(groups) == 1:
        return groups[0]
    return dataclasses.replace(groups[0], **{
        f.name: torch.cat([getattr(g, f.name) for g in groups]) for f in
        dataclasses.fields(groups[0]) if isinstance(getattr(groups[0], f.name), torch.Tensor)})


class ShardedCausalLM(CausalLM):
    """A :class:`CausalLM` whose weights are split over ``mesh``
    (:func:`~crane_tpu_torch.parallel.sharding.make_mesh`) and whose caches
    from :meth:`init_cache` match them, so every step function, the engine
    included, runs the sharded forward unchanged. ``mesh`` (the flat device
    tuple) tells :mod:`crane_tpu_torch.models.graphs` whether decode blocks
    can run as CUDA graphs: on a mesh whose devices are all one card they
    do. A fused base (``models/fuse.py``) is unfused first: a tp split of
    ``wqkv`` or ``gate_up`` would mix q, k and v (or gate and up) columns
    across shards, so the shards keep the unfused names (``fuse=False``),
    as crane_tpu's do."""

    def __init__(self, base: CausalLM, mesh: Mesh):
        params = unfuse_params(base.config, base.params)
        super().__init__(base.config, shard_params(base.config, params, mesh),
                         tokenizer=base.tokenizer, eos_token_ids=base.eos_token_ids,
                         dtype=base.dtype, fuse=False)
        self.grid = mesh
        self.mesh = mesh.flat

    def init_cache(self, batch: int, max_seq: int, *, quant_bits: int | None = None,
                   device=None) -> KVCache:
        """``batch`` must divide by dp; ``device="meta"`` sizes without
        allocating (the parts still name their devices)."""
        return make_sharded_cache(self.config, self.grid, batch, max_seq, self.dtype,
                                  quant_bits=quant_bits, device=device)


def shard_lm(lm: CausalLM, mesh: Mesh) -> ShardedCausalLM:
    """Split a loaded model over ``mesh`` (Megatron tp + dp slot groups).
    Raises ``ValueError`` on quantized weights, as crane_tpu does."""
    return ShardedCausalLM(lm, mesh)
