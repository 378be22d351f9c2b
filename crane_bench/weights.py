"""The weights of a configuration, drawn on the card from the run's seed in
the published tensor shapes and names (HF's ``[out, in]`` layout), in the
type they are served in.

A :class:`Weights` is a read-only mapping from tensor name to tensor that
draws one layer at a time, in a few large calls (one per tensor, the
experts of a layer as one stack each), and keeps only the layer last asked
for. The port's loader walks it layer by layer, so its peak is the port's
tree plus one layer; the plain reference walks it again later and gets the
same tensors, drawn anew from the same seed.
"""

from __future__ import annotations

import re

import torch

_LAYER = re.compile(r"^model\.layers\.(\d+)\.")


def _layer_seed(seed: int, index: int) -> int:
    return (seed * 0x9E3779B1 + 7919 * (index + 2)) % (2 ** 63)


def draw(gen: torch.Generator, shape, init: tuple, device, dtype) -> torch.Tensor:
    """One tensor: ``("normal", scale)`` a normal draw times ``scale``;
    ``("norm", base)`` ``base`` plus a normal draw times 0.1 (a norm's
    weight, around 1 or around 0 where the model adds 1); ``("alog",)``
    the log of a uniform draw from [1, 16] (a GDN head's ``A_log``)."""
    kind = init[0]
    if kind == "alog":
        return torch.empty(shape, device=device, dtype=dtype).uniform_(
            1.0, 16.0, generator=gen).log_()
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if kind == "normal":
        return t.mul_(init[1])
    if kind == "norm":
        return t.mul_(0.1).add_(init[1])
    raise ValueError(f"unknown init {init!r}")


def quantized(name: str, t: torch.Tensor) -> bool:
    """Whether the fp8 control rounds this tensor: every product's weight
    (the projections, routers, experts and the head), not the embedding,
    the norms, the conv taps or a GDN head's decay parameters."""
    return t.dim() >= 2 and "embed_tokens" not in name and "conv1d" not in name


FP8_MAX = 448.0  # the largest float8 e4m3 number


def fp8_rows(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 per row (each row scaled so its largest
    magnitude is 448) and back, in float32."""
    w = w.float()
    scale = w.abs().amax(-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float().mul_(scale)


class Weights:
    """Name -> tensor over the model module's ``global_spec(hf)`` and
    ``layer_spec(hf, i)``: lists of ``(name, shape, init)``, where a name
    holding ``{e}`` is a stack over the experts whose expert ``e`` answers
    to the name with ``e`` filled in. ``fp8`` gives every product's weight
    rounded to float8 rows (:func:`fp8_rows`): with the activations rounded
    too (``plain.fp8_products``), the reference computed in the precision
    below bf16, the control of the comparison."""

    def __init__(self, model, hf: dict, seed: int, device, dtype=torch.bfloat16,
                 fp8: bool = False):
        self.model, self.hf, self.seed = model, hf, seed
        self.device, self.dtype = torch.device(device), dtype
        self.fp8 = fp8
        self._index: int | None = None
        self._tensors: dict = {}
        self._globals: dict | None = None

    def _draw(self, index: int, spec) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(_layer_seed(self.seed, index))
        out = {}
        for name, shape, init in spec:
            t = draw(gen, shape, init, self.device, self.dtype)
            if self.fp8 and quantized(name, t):
                t = fp8_rows(t)
            out[name] = t
            if "{e}" in name:
                for e in range(shape[0]):
                    out[name.format(e=e)] = t[e]
        return out

    def globals(self) -> dict:
        if self._globals is None:
            self._globals = self._draw(-1, self.model.global_spec(self.hf))
        return self._globals

    def layer(self, i: int) -> dict:
        """Layer ``i``'s tensors (the stacks under their ``{e}`` names too);
        the layer asked for before is let go."""
        if self._index != i:
            self._tensors, self._index = {}, None  # freed before the next is drawn
            self._tensors, self._index = self._draw(i, self.model.layer_spec(self.hf, i)), i
        return self._tensors

    def release(self) -> None:
        self._tensors, self._index, self._globals = {}, None, None

    def _group(self, name: str) -> dict:
        m = _LAYER.match(name)
        return self.layer(int(m.group(1))) if m else self.globals()

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._group(name)[name]

    def __contains__(self, name: str) -> bool:
        return name in self._group(name)

    def get(self, name: str, default=None):
        return self._group(name).get(name, default)
