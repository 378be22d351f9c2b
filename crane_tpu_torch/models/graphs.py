"""Decode programs as CUDA graphs: the counterpart of crane_tpu's jitted
``lax.scan`` blocks.

crane_tpu runs a whole decode block (``_decode_steps``, ``_decode_active``,
``_decode_active_hist``, ``_spec_rounds``) as one device program: ``jax.jit``
over ``lax.scan``. Eager PyTorch launches every kernel of every step from the host,
a few thousand a step, and the card idles most of the step. Here such a
block is captured once into a ``torch.cuda.CUDAGraph`` and replayed, so one
block is one dispatch, as one ``lax.scan`` is.

A :class:`Program` is keyed the way a jit is (:meth:`CausalLM._dispatch`):
by program kind, batch, the block's static sizes, the generator and the
identity (``data_ptr`` and shape) of the cache's layer buffers, which the
graph reads and writes in place. The program holds the generator and the
layers, so no other generator or buffer can take their identity while it
lives; it lives, with its graph's memory pool, until
:meth:`CausalLM.release_graphs`. Every other tensor
the block reads is a static buffer of the program: before each replay the
caller's values are copied in (stream-ordered ``copy_``), and after it the
results are read out of the static buffers.

- **Capture.** The block runs once eagerly on a side stream (the kernels'
  one-time set-up: their build, the decode kernels' ticket counters, the
  cuBLAS handle), then once under ``torch.cuda.graph``. Both runs see an
  all-false ``active`` mask, so they write nothing the caller can see: no
  KV slot, no GDN state, no length. A capture error raises; there is no
  eager retry.
- **Random numbers.** Sampling draws from the caller's ``torch.Generator``,
  registered with the graph (``CUDAGraph.register_generator_state``), so
  each replay advances it as the eager loop would.
- **Launch counts.** The kernels' counters (``ops.cuda.launch_counts``) and
  ``attention_block.plain_routes`` are Python integers: a capture would
  count its launches once and a replay never. The counts are restored to
  what they were before the warm-up, the capture's change is recorded, and
  every replay adds it, so the counts after N replays equal the eager
  loop's for the same work.
- **Device rule.** A model on a CUDA device whose slabs (if any) share its
  device runs programs; a CPU model, and a sequence-parallel model over
  several devices (which one graph cannot hold, ROADMAP Queue 1 item 12),
  run the same block functions eagerly. The choice is made by device,
  never by failure. :func:`eager` forces the eager loop on the card, for the
  card tests and ``chip_smoke.py`` to compare against.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from crane_tpu_torch.models.modules.transformer import attention_block
from crane_tpu_torch.ops import cuda as kernels

# graphs captured in this process (the engine's warmup must leave none to
# capture while serving)
captures = 0

_local = threading.local()


@contextlib.contextmanager
def eager():
    """Run decode blocks as the eager loop in this thread, even on the card
    (the reference the card tests and ``chip_smoke.py`` hold graphs to)."""
    prev = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = prev


def takes_graphs(lm) -> bool:
    """True when ``lm``'s decode blocks run as CUDA graphs: a model on a
    CUDA device whose slab devices (a sequence-parallel model's) are all its
    own, outside :func:`eager`."""
    if lm.device.type != "cuda" or getattr(_local, "eager", False):
        return False
    return all(torch.device(d) == lm.device for d in getattr(lm, "mesh", (lm.device,)))


def counts() -> tuple[dict[str, int], dict[str, int]]:
    """The kernels' launch counts and the attention router's plain-route
    counts."""
    return kernels.launch_counts(), dict(attention_block.plain_routes)


def set_counts(launches: dict[str, int], routes: dict[str, int]) -> None:
    """Set both counters to what :func:`counts` gave."""
    kernels.reset_launch_counts()
    kernels.add_launch_counts(launches)
    attention_block.plain_routes.update(routes)


def add_counts(launches: dict[str, int], routes: dict[str, int]) -> None:
    """Add to both counters (a replay adds its capture's counts)."""
    kernels.add_launch_counts(launches)
    for kind, n in routes.items():
        attention_block.plain_routes[kind] += n


def _changes(after: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


def _new_graph():
    return torch.cuda.CUDAGraph()


def _warm_up(fn, generator, device: torch.device) -> None:
    """Run ``fn`` once on a side stream of ``device`` (the kernels' one-time
    set-up), its random draws taken back."""
    state = generator.get_state() if generator is not None else None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    if generator is not None:
        generator.set_state(state)


def _capture(graph, fn, generator, device: torch.device) -> None:
    """Capture ``fn`` into ``graph``, the generator registered with it."""
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.device(device), torch.cuda.graph(graph):
        fn()


class Program:
    """One decode block captured as a CUDA graph over static buffers.

    ``body(**statics)`` runs the block: it reads the static inputs and writes
    its results into the static outputs (and the cache layers it closes
    over). ``statics`` must hold a bool ``active`` mask, which is all false
    while the program captures. The program holds the generator and the
    objects in ``keep`` (the cache layers the graph writes), so neither
    their memory nor their ``id`` can pass to another object while it lives.
    Calling the program copies the given tensors into their static buffers,
    replays the graph once and adds the capture's launch counts; it returns
    the static buffers, which the next replay overwrites."""

    def __init__(self, body, statics: dict[str, torch.Tensor], generator=None, keep=()):
        global captures
        self.statics = statics
        self.generator, self.keep = generator, keep
        self.graph = _new_graph()
        statics["active"].zero_()
        device = statics["active"].device
        fn = lambda: body(**statics)  # noqa: E731
        before = counts()
        _warm_up(fn, generator, device)
        start = counts()
        _capture(self.graph, fn, generator, device)
        end = counts()
        self.launches = _changes(end[0], start[0])
        self.routes = _changes(end[1], start[1])
        set_counts(*before)
        captures += 1

    def __call__(self, **inputs: torch.Tensor) -> dict[str, torch.Tensor]:
        for name, value in inputs.items():
            self.statics[name].copy_(value)
        self.graph.replay()
        add_counts(self.launches, self.routes)
        return self.statics
