"""Fixed-shape KV caches (port of ``crane_tpu/ops/kv_cache.py``).

Layouts are the reference's, byte for byte, allocated once at ``max_seq``
and never regrown:

- fp (:class:`LayerKVCache`): per layer ``k``/``v`` ``[B, S_max, H_kv, D]``;
- int8 / nibble-packed int4 (:class:`QuantLayerKVCache`): flat codes
  ``[B, S_max, H_kv * stored]`` int8 (``stored = D``, or ``D/2`` packed) and
  head-major per-(token, head) scales ``[B, H_kv, S_max]`` float32;
- Gated-Delta-Net layers (:class:`GdnLayerCache`): a rolling conv window
  ``[B, k, conv_dim]`` and a float32 recurrent state ``[B, H_v, K, V]``;
- short-conv layers (:class:`ConvLayerCache`): a rolling window
  ``[B, L, C]``;
- sequence parallelism (:class:`SequenceShardedKVCache`): an fp or
  quantized layer cache split along its sequence axis into slabs, one per
  slab device;
- tensor and data parallelism (:class:`MeshLayerCache`): any of the above
  split by slot rows over dp groups and by heads over tp shards;

plus per row ``lengths [B]`` int32. Where JAX donated the buffers and
returned updated copies, the port writes into them in place and returns the
same object.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LayerKVCache:
    """One layer's pre-allocated KV buffer: k/v are ``[B, S_max, H_kv, D]``."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def empty(batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
              dtype, device=None) -> "LayerKVCache":
        shape = (batch, max_seq, n_kv_heads, head_dim)
        return LayerKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )

    @property
    def max_seq(self) -> int:
        return self.k.shape[1]

    def row(self, slot: int) -> "LayerKVCache":
        """Batch-1 view of row ``slot``: writes through it land in this
        cache (the port of ``_prefill_slot_cont``'s slice-and-merge)."""
        return LayerKVCache(k=self.k[slot:slot + 1], v=self.v[slot:slot + 1])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.k, self.v)

    def update(
        self,
        k_new: torch.Tensor,
        v_new: torch.Tensor,
        positions,
        row: int | torch.Tensor | None = None,
    ) -> "LayerKVCache":
        """Write ``k_new/v_new`` ``[B, S_new, H, D]`` at ``positions``, in
        place.

        ``positions`` is either an ``int`` start shared by all rows (prefill)
        or a ``[B]`` tensor of per-row starts (batched decode, speculative
        verify). ``row`` offsets the batch row of an ``int``-start write
        (slot prefill into a multi-slot cache); with per-row starts it is a
        ``[B]`` tensor naming each written row's buffer row (a slot chosen
        on the device, as a CUDA graph replays it). Per-row positions outside
        ``[0, max_seq)`` are dropped (inactive-slot masking in the serving
        engine; a sequence-sharded slab's positions of other slabs).
        Returns ``self``."""
        if not isinstance(positions, torch.Tensor):
            r, t = _slab(int(positions), k_new.shape[1], self.max_seq, row)
            self.k[r, t] = k_new.to(self.k.dtype)
            self.v[r, t] = v_new.to(self.v.dtype)
            return self
        w = _row_writes(positions, k_new.shape[0], k_new.shape[1], self.max_seq)
        _put(self.k, *w, k_new, row)
        _put(self.v, *w, v_new, row)
        return self


def _slab(start: int, s: int, max_seq: int, row: int | None) -> tuple[slice, slice]:
    """(row slice, position slice) of an ``int``-start write of ``s`` tokens."""
    if start < 0 or start + s > max_seq:
        # jax's dynamic_update_slice would clamp the start and shift the
        # write onto live slots; callers size writes to fit
        raise ValueError(f"cache write [{start}, {start + s}) outside [0, {max_seq})")
    r = slice(None) if row is None else slice(row, row + 1)
    return r, slice(start, start + s)


def _row_writes(positions: torch.Tensor, B: int, s: int, max_seq: int):
    """Indices of a per-row write of ``s`` tokens from ``positions [B]``:
    (``b [B, 1]``, ``idx [B, s]`` clamped into the buffer, ``src [B, s]``,
    ``hit [B, 1]``). A position outside ``[0, max_seq)`` is dropped: its
    clamped slot is the nearest slot the row does write, and it carries that
    slot's token (``src``), so no two writes to a slot disagree and the
    order of an ``index_put`` cannot matter. A row that writes no slot
    (``hit`` False) stores back what its clamped slot held."""
    if positions.ndim != 1:
        raise ValueError(f"per-row positions must be [B], got {tuple(positions.shape)}")
    device = positions.device
    b = torch.arange(B, device=device)[:, None]
    start = positions.to(torch.long)[:, None]
    j = torch.arange(s, device=device)[None, :]
    first = (-start).clamp(min=0)  # the row's first and last kept token
    last = (max_seq - start).clamp(max=s) - 1
    src = torch.minimum(torch.maximum(j, first), last.clamp(min=0))
    return b, (start + j).clamp(0, max_seq - 1), src, first <= last


def _put(buf: torch.Tensor, b, idx, src, hit, new: torch.Tensor, rows=None) -> None:
    """``buf[r, idx] = new[b, src]`` along dims 0 and 1, ``r`` the buffer
    row of each written row (``rows [B]``, else ``b``), a row with no kept
    token storing back what the slot already held, so no host-side
    filtering (and no device sync) is needed."""
    r = b if rows is None else rows.long()[:, None]
    hit = hit.reshape(*hit.shape, *([1] * (new.ndim - 2)))
    buf[r, idx] = torch.where(hit, new[b, src].to(buf.dtype), buf[r, idx])


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8, in [-7, 7]) two per byte along the last dim:
    ``byte = 16 * codes[..., D/2:] + codes[..., :D/2]``, arithmetic, as the
    reference packs them (max |byte| = 119, inside int8)."""
    d = codes.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even last dim, got {d}")
    lo, hi = codes[..., : d // 2], codes[..., d // 2:]
    return (hi.to(torch.int16) * 16 + lo).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[..., D/2]`` -> ``[..., D]`` int8, with
    ``hi = floor((b + 8) / 16)`` and ``lo = b - 16 * hi``."""
    p = packed.to(torch.int16)
    hi = torch.div(p + 8, 16, rounding_mode="floor")
    lo = p - 16 * hi
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quant_symmetric(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric quantization over the last axis, the
    reference's ``_quant_symmetric``: ``scale = amax / qmax``, codes rounded
    half to even and clipped to ``[-qmax, qmax]``, a zero scale for an
    all-zero vector. Returns (int8 codes, float32 scales ``[..., 1]``); int4
    codes are unpacked here."""
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / qmax
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0), 0.0)
    q = torch.round(xf * inv).clamp(-qmax, qmax).to(torch.int8)
    return q, scale


@dataclasses.dataclass
class QuantLayerKVCache:
    """One layer's int8 / nibble-packed int4 KV buffer.

    ``k``/``v``: flat codes ``[B, S_max, H_kv * stored]`` int8, column
    ``h * stored + j`` being byte ``j`` of head ``h`` (``stored = D`` for
    int8; ``D/2`` for int4, byte ``j`` holding dim ``j`` low and dim
    ``j + D/2`` high). ``k_scale``/``v_scale``: ``[B, H_kv, S_max]`` float32,
    head-major, so the decode kernel reads one contiguous scale row per
    (row, kv-head). Tokens are quantized at write time; attention folds the
    scales in (K4, K5) or reads :meth:`dequant`."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    bits: int = 8
    n_kv_heads: int = 1

    @staticmethod
    def empty(batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
              dtype=None, *, bits: int = 8, device=None) -> "QuantLayerKVCache":
        """``dtype`` is ignored (codes are int8, scales float32); kept for
        the fp cache's signature. ``device="meta"`` sizes without allocating."""
        if bits not in (4, 8):
            raise ValueError(f"KV cache quantization takes 8 or 4 bits, got {bits}")
        stored = head_dim // 2 if bits == 4 else head_dim
        shape = (batch, max_seq, n_kv_heads * stored)
        sshape = (batch, n_kv_heads, max_seq)
        return QuantLayerKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            bits=bits, n_kv_heads=n_kv_heads,
        )

    @property
    def max_seq(self) -> int:
        return self.k.shape[1]

    @property
    def head_dim(self) -> int:
        stored = self.k.shape[2] // self.n_kv_heads
        return stored * 2 if self.bits == 4 else stored

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.k, self.v, self.k_scale, self.v_scale)

    def row(self, slot: int) -> "QuantLayerKVCache":
        """Batch-1 view of row ``slot``: writes through it land in this cache."""
        r = slice(slot, slot + 1)
        return dataclasses.replace(self, k=self.k[r], v=self.v[r],
                                   k_scale=self.k_scale[r], v_scale=self.v_scale[r])

    def _encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``[B, S, H, D]`` -> flat codes ``[B, S, H * stored]`` and
        head-major scales ``[B, H, S]``."""
        q, s = quant_symmetric(x, self.bits)
        if self.bits == 4:
            q = pack_int4(q)
        B, S = q.shape[0], q.shape[1]
        return q.reshape(B, S, -1), s[..., 0].transpose(1, 2)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor, positions,
               row: int | None = None) -> "QuantLayerKVCache":
        """Quantize ``k_new/v_new`` ``[B, S_new, H, D]`` and write codes and
        scales at ``positions``, in place, with :meth:`LayerKVCache.update`'s
        contract: an ``int`` start (with ``row``) or ``[B]`` per-row starts,
        whose writes outside ``[0, max_seq)`` are dropped for codes and
        scales alike. A device ``row`` is refused: quantized caches keep the
        eager prefill. Returns ``self``."""
        if isinstance(row, torch.Tensor):
            raise TypeError("QuantLayerKVCache.update: row must be an int")
        kq, ks = self._encode(k_new)
        vq, vs = self._encode(v_new)
        if not isinstance(positions, torch.Tensor):
            r, t = _slab(int(positions), k_new.shape[1], self.max_seq, row)
            self.k[r, t] = kq
            self.v[r, t] = vq
            self.k_scale[r, :, t] = ks
            self.v_scale[r, :, t] = vs
            return self
        w = _row_writes(positions, k_new.shape[0], k_new.shape[1], self.max_seq)
        _put(self.k, *w, kq)
        _put(self.v, *w, vq)
        # scales [B, H, T] are written through a [B, T, H] view of themselves
        _put(self.k_scale.transpose(1, 2), *w, ks.transpose(1, 2))
        _put(self.v_scale.transpose(1, 2), *w, vs.transpose(1, 2))
        return self

    def dequant(self, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole buffer as K/V ``[B, S_max, H, D]``: ``codes * scale`` in
        float32, cast to ``dtype``."""
        return (dequant_codes(self.k, self.k_scale, self.bits, self.n_kv_heads, dtype),
                dequant_codes(self.v, self.v_scale, self.bits, self.n_kv_heads, dtype))


def dequant_codes(codes: torch.Tensor, scales: torch.Tensor, bits: int,
                  n_kv_heads: int, dtype=torch.float32) -> torch.Tensor:
    """Flat cache codes ``[B, T, H * stored]`` and scales ``[B, H, T]`` ->
    ``[B, T, H, D]`` in ``dtype`` (the product is taken in float32)."""
    B, T = codes.shape[0], codes.shape[1]
    c = codes.reshape(B, T, n_kv_heads, -1)
    if bits == 4:
        c = unpack_int4(c)
    return (c.float() * scales.transpose(1, 2)[..., None]).to(dtype)


def slot_errors(layers_a, layers_b, row: int, n: int) -> torch.Tensor:
    """How far two caches' K/V rows part, slot by slot: for each of the
    first ``n`` positions of batch row ``row``, the largest relative L2
    distance over the attention layers and over K and V between
    ``layers_a``' vector of that slot (all kv heads) and ``layers_b``'
    (fp or int8/int4 layer caches, quantized ones dequantized). Returns
    float32 ``[n]`` on the CPU. Two paths that wrote the same tokens' K/V
    sit near 0; a K/V written one slot off sits near 1 or above."""
    worst = torch.zeros(n)
    for a, b in zip(layers_a, layers_b):
        if isinstance(a, QuantLayerKVCache):
            pairs = zip(a.dequant(), b.dequant())
        elif isinstance(a, LayerKVCache):
            pairs = ((a.k, b.k), (a.v, b.v))
        else:
            continue
        for x, y in pairs:
            x = x[row, :n].float().cpu().reshape(n, -1)
            y = y[row, :n].float().cpu().reshape(n, -1)
            err = (x - y).norm(dim=1) / y.norm(dim=1).clamp_min(1e-30)
            worst = torch.maximum(worst, err)
    return worst


@dataclasses.dataclass
class GdnLayerCache:
    """Gated-Delta-Net layer state: the rolling conv window
    ``conv_state [B, k, conv_dim]`` (the last k pre-activation conv inputs,
    in the model dtype) and ``recurrent_state [B, H_v, K, V]``, always
    float32."""

    conv_state: torch.Tensor
    recurrent_state: torch.Tensor

    @staticmethod
    def empty(batch: int, conv_kernel: int, conv_dim: int, n_v_heads: int,
              head_k_dim: int, head_v_dim: int, dtype=torch.bfloat16,
              device=None) -> "GdnLayerCache":
        """``device="meta"`` sizes without allocating."""
        return GdnLayerCache(
            conv_state=torch.zeros((batch, conv_kernel, conv_dim), dtype=dtype, device=device),
            recurrent_state=torch.zeros((batch, n_v_heads, head_k_dim, head_v_dim),
                                        dtype=torch.float32, device=device),
        )

    def row(self, slot: int) -> "GdnLayerCache":
        """Batch-1 view of row ``slot``: writes through it land in this cache."""
        return GdnLayerCache(conv_state=self.conv_state[slot:slot + 1],
                             recurrent_state=self.recurrent_state[slot:slot + 1])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.conv_state, self.recurrent_state)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def replace_rows(self, conv_state: torch.Tensor, recurrent_state: torch.Tensor,
                     row: int | None = None,
                     active: torch.Tensor | None = None) -> "GdnLayerCache":
        """Write new states in place: for the whole batch, for one ``row``
        (slot prefill; the new states have batch 1), or only where
        ``active [B]`` (masked batched decode). Returns ``self``."""
        conv_state = conv_state.to(self.conv_state.dtype)
        if row is not None:
            self.conv_state[row:row + 1] = conv_state
            self.recurrent_state[row:row + 1] = recurrent_state
        elif active is not None:
            self.conv_state.copy_(torch.where(active[:, None, None], conv_state,
                                              self.conv_state))
            self.recurrent_state.copy_(torch.where(active[:, None, None, None],
                                                   recurrent_state, self.recurrent_state))
        else:
            self.conv_state.copy_(conv_state)
            self.recurrent_state.copy_(recurrent_state)
        return self


@dataclasses.dataclass
class ConvLayerCache:
    """Short-conv layer state (LFM2's hybrid conv layers): the rolling window
    of the last L pre-conv inputs, ``conv_state [B, L, C]`` in the model
    dtype."""

    conv_state: torch.Tensor

    @staticmethod
    def empty(batch: int, l_cache: int, channels: int, dtype=torch.bfloat16,
              device=None) -> "ConvLayerCache":
        """``device="meta"`` sizes without allocating."""
        return ConvLayerCache(conv_state=torch.zeros((batch, l_cache, channels), dtype=dtype,
                                                     device=device))

    def row(self, slot: int) -> "ConvLayerCache":
        """Batch-1 view of row ``slot``: writes through it land in this cache."""
        return ConvLayerCache(conv_state=self.conv_state[slot:slot + 1])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.conv_state,)

    def nbytes(self) -> int:
        return self.conv_state.numel() * self.conv_state.element_size()

    def replace_rows(self, conv_state: torch.Tensor, row: int | None = None,
                     active: torch.Tensor | None = None) -> "ConvLayerCache":
        """Write the new window in place: for the whole batch, for one
        ``row`` (slot prefill; the new window has batch 1), or only where
        ``active [B]`` (masked batched decode). Returns ``self``."""
        conv_state = conv_state.to(self.conv_state.dtype)
        if row is not None:
            self.conv_state[row:row + 1] = conv_state
        elif active is not None:
            self.conv_state.copy_(torch.where(active[:, None, None], conv_state,
                                              self.conv_state))
        else:
            self.conv_state.copy_(conv_state)
        return self


@dataclasses.dataclass
class SequenceShardedKVCache:
    """One attention layer's KV cache split along its sequence axis into
    ``n`` contiguous slabs (sequence parallelism,
    :mod:`crane_tpu_torch.parallel.sequence`): slab ``i`` is a
    :class:`LayerKVCache` or :class:`QuantLayerKVCache` of ``T/n`` positions
    holding ``[i T/n, (i + 1) T/n)``, on ``devices[i]``. The port of the JAX
    package's ``P(None, "sp", ...)`` placement of the K/V buffers (fp or
    codes) and ``P(None, None, "sp")`` placement of the scale planes.

    ``devices`` names each slab's device apart from its tensors', so a cache
    sized on the ``meta`` device still says where each slab would live (the
    engine's memory budget). Writes route each token to its slab."""

    slabs: tuple
    devices: tuple

    @property
    def slab_len(self) -> int:
        return self.slabs[0].max_seq

    @property
    def max_seq(self) -> int:
        return self.slab_len * len(self.slabs)

    @property
    def bits(self) -> int:
        """16 for fp slabs, else the codes' 8 or 4."""
        return self.slabs[0].bits if isinstance(self.slabs[0], QuantLayerKVCache) else 16

    def row(self, slot: int) -> "SequenceShardedKVCache":
        """Batch-1 view of row ``slot`` in every slab: writes through it
        land in this cache."""
        return SequenceShardedKVCache(tuple(s.row(slot) for s in self.slabs), self.devices)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(t for s in self.slabs for t in s.tensors())

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor, positions,
               row: int | None = None) -> "SequenceShardedKVCache":
        """:meth:`LayerKVCache.update`'s contract over the whole sequence
        axis, in place: an ``int`` start (with ``row``) writes each slab its
        part of the span; ``[B]`` per-row starts (decode; a verify chunk of
        several tokens a row) write each token into the slab that holds its
        position, a chunk across a slab boundary into both, and drop a
        position ``>= max_seq`` in every slab. Returns ``self``."""
        T = self.slab_len
        if not isinstance(positions, torch.Tensor):
            start, s = int(positions), k_new.shape[1]
            if start < 0 or start + s > self.max_seq:
                raise ValueError(f"cache write [{start}, {start + s}) outside [0, {self.max_seq})")
            for i, (slab, dev) in enumerate(zip(self.slabs, self.devices)):
                lo, hi = max(start, i * T), min(start + s, (i + 1) * T)
                if lo < hi:
                    span = slice(lo - start, hi - start)
                    slab.update(k_new[:, span].to(dev), v_new[:, span].to(dev), lo - i * T,
                                row=row)
            return self
        for i, (slab, dev) in enumerate(zip(self.slabs, self.devices)):
            # a token whose position lies in another slab is outside this
            # slab's [0, T) and dropped here
            slab.update(k_new.to(dev), v_new.to(dev), (positions - i * T).to(dev))
        return self


@dataclasses.dataclass
class MeshLayerCache:
    """One layer's cache over a dp x tp mesh
    (:mod:`crane_tpu_torch.parallel.inference`): ``parts[i][t]`` is tp
    shard ``t``'s layer cache of dp group ``groups[i]`` (its slot rows, its
    kv heads; a GDN layer's v-heads and conv channels), on
    ``devices[i][t]``. A layer computed once per group (a short conv, an
    attention layer kept whole) has one part a group. Group ``groups[i]``
    holds the rows ``i * rows .. (i + 1) * rows`` of the model's batch. The
    port of crane_tpu's ``P("dp", None, "tp", None)`` cache placement.

    ``devices`` names each part's device apart from its tensors', so a
    cache sized on the ``meta`` device still says where each part would
    live (the engine's memory budget)."""

    parts: tuple
    devices: tuple
    groups: tuple

    @property
    def rows(self) -> int:
        """Slot rows a group holds."""
        return self.parts[0][0].tensors()[0].shape[0]

    @property
    def max_seq(self) -> int:
        # raises AttributeError for a GDN or conv layer, as its parts do
        return self.parts[0][0].max_seq

    def row(self, slot: int) -> "MeshLayerCache":
        """Batch-1 view of row ``slot``: its group's parts, each the row's
        view; writes through it land in this cache."""
        i, local = divmod(slot, self.rows)
        return MeshLayerCache((tuple(p.row(local) for p in self.parts[i]),),
                              (self.devices[i],), (self.groups[i],))

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(t for group in self.parts for p in group for t in p.tensors())


@dataclasses.dataclass
class KVCache:
    """Whole-model cache: one layer cache per layer (:class:`LayerKVCache`,
    :class:`QuantLayerKVCache`, :class:`SequenceShardedKVCache`,
    :class:`MeshLayerCache` or, in hybrid
    models, :class:`GdnLayerCache` and :class:`ConvLayerCache`) + per-row
    ``lengths [B]`` int32 (the number of valid tokens, i.e. the next write
    position)."""

    layers: tuple
    lengths: torch.Tensor

    @staticmethod
    def empty(n_layers: int, batch: int, max_seq: int, n_kv_heads: int,
              head_dim: int, dtype, device=None, *,
              quant_bits: int | None = None) -> "KVCache":
        """fp layers, or int8/int4 ones with ``quant_bits`` 8 or 4."""
        def layer():
            if quant_bits is None:
                return LayerKVCache.empty(batch, max_seq, n_kv_heads, head_dim, dtype, device)
            return QuantLayerKVCache.empty(batch, max_seq, n_kv_heads, head_dim,
                                           bits=quant_bits, device=device)

        return KVCache(
            layers=tuple(layer() for _ in range(n_layers)),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def max_seq(self) -> int:
        """The KV buffers' length; a model with no attention layer has
        none, and any position fits."""
        for layer in self.layers:
            if hasattr(layer, "max_seq"):
                return layer.max_seq
        return 1 << 30

    def row(self, slot: int) -> "KVCache":
        """Batch-1 view of row ``slot`` (layers and length): in-place writes
        through the view update this cache."""
        return KVCache(
            layers=tuple(layer.row(slot) for layer in self.layers),
            lengths=self.lengths[slot:slot + 1],
        )

    def nbytes(self) -> int:
        """Bytes of every buffer: lengths, codes or K/V, and scale planes."""
        tensors = [self.lengths] + [t for layer in self.layers for t in layer.tensors()]
        return sum(t.numel() * t.element_size() for t in tensors)
