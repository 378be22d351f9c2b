"""Decode programs (and the serving engine's slot prefills) as CUDA graphs:
the counterpart of crane_tpu's jitted ``lax.scan`` blocks and prefills.

crane_tpu runs a whole decode block (``_decode_steps``, ``_decode_active``,
``_decode_active_hist``, ``_spec_rounds``) as one device program: ``jax.jit``
over ``lax.scan``. Eager PyTorch launches every kernel of every step from the host,
a few thousand a step, and the card idles most of the step. Here such a
block is captured once into a ``torch.cuda.CUDAGraph`` and replayed, so one
block is one dispatch, as one ``lax.scan`` is.

A :class:`Program` is keyed the way a jit is (:func:`dispatch`):
by program kind, batch, the block's static sizes, the generator and the
identity (``data_ptr`` and shape) of the cache's layer buffers, which the
graph reads and writes in place. The program holds the generator and the
layers, so no other generator or buffer can take their identity while it
lives; it lives, with its graph's memory pool, until its model drops it
(``release_graphs``). Every other tensor
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
- **Launch counts.** The kernels' counters (``ops.cuda.launch_counts``,
  and K2's launches given segments) and ``attention_block.plain_routes``
  are Python integers: a capture would
  count its launches once and a replay never. The counts are restored to
  what they were before the warm-up, the capture's change is recorded, and
  every replay adds it, so the counts after N replays equal the eager
  loop's for the same work.
- **Memory.** A decode program's graph keeps a memory pool of its own. The
  slot prefill programs of a model share one (:func:`new_pool`): they run
  one at a time on one stream, so their scratch may overlap, and the pool
  holds one forward of the largest bucket, captured first.
- **Device rule.** A model on a CUDA device whose slabs or shards (if
  any) all share its device runs programs; a CPU model, and a sequence- or
  tensor-parallel model over several devices (which one graph cannot
  hold), run the same block functions eagerly. The choice is made by
  device, never by failure. :func:`eager` forces the eager loop on the card, for the
  card tests and ``chip_smoke.py`` to compare against.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading

import torch

from crane_tpu_torch.models.modules.transformer import attention_block
from crane_tpu_torch.ops import cuda as kernels
from crane_tpu_torch.ops.cuda.flash_attention import flash_attention_causal

# inputs a block writes back in place (its other outputs come back fresh)
IN_OUT = ("lengths", "recent", "history")

# graphs captured in this process (the engine's warmup must leave none to
# capture while serving), and replays of captured programs (a path's count
# of steps or blocks run as graphs)
captures = 0
replays = 0

_local = threading.local()


@contextlib.contextmanager
def eager():
    """Run decode blocks as the eager loop, and slot prefills eagerly, in this
    thread, even on the card (the reference the card tests and
    ``chip_smoke.py`` hold graphs to)."""
    prev = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = prev


def takes_graphs(device: torch.device, mesh=()) -> bool:
    """True when decode blocks on ``device`` run as CUDA graphs: a CUDA
    device whose mesh devices ``mesh`` (a sequence-parallel model's slabs, a
    tensor/data-parallel model's shards) are all itself, outside
    :func:`eager`."""
    if device.type != "cuda" or getattr(_local, "eager", False):
        return False
    return all(torch.device(d) == device for d in mesh)


# K2's launches given segments (``flash_attention_causal.segment_launches``),
# carried as one more entry of the launch counts here
SEGMENTS = "flash_attention_causal given segments"


def counts() -> tuple[dict[str, int], dict[str, int]]:
    """The kernels' launch counts (with :data:`SEGMENTS`) and the attention
    router's plain-route counts."""
    launches = kernels.launch_counts()
    launches[SEGMENTS] = flash_attention_causal.segment_launches
    return launches, dict(attention_block.plain_routes)


def set_counts(launches: dict[str, int], routes: dict[str, int]) -> None:
    """Set both counters to what :func:`counts` gave."""
    launches = dict(launches)
    kernels.reset_launch_counts()
    flash_attention_causal.segment_launches = launches.pop(SEGMENTS)
    kernels.add_launch_counts(launches)
    attention_block.plain_routes.update(routes)


def add_counts(launches: dict[str, int], routes: dict[str, int]) -> None:
    """Add to both counters (a replay adds its capture's counts)."""
    launches = dict(launches)
    flash_attention_causal.segment_launches += launches.pop(SEGMENTS, 0)
    kernels.add_launch_counts(launches)
    for kind, n in routes.items():
        attention_block.plain_routes[kind] += n


def _changes(after: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


def _new_graph():
    return torch.cuda.CUDAGraph()


_side_streams: dict = {}


def _side_stream(device: torch.device):
    """The one side stream of ``device`` that every warm-up runs on. cuBLAS
    keeps a workspace (32 MiB on an H100) for each stream it runs on, for
    the life of the process, so a new stream a warm-up would hold a new
    one."""
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


def _warm_up(fn, generator, device: torch.device) -> None:
    """Run ``fn`` once on the side stream of ``device`` (the kernels'
    one-time set-up), its random draws taken back."""
    state = generator.get_state() if generator is not None else None
    side = _side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    if generator is not None:
        generator.set_state(state)


_capture_lock = threading.Lock()


@contextlib.contextmanager
def _collector_paused():
    """Captures one at a time, with Python's cyclic garbage collector
    paused: a collection that frees another CUDA graph in the middle of a
    capture destroys it there (``cudaGraphExecDestroy``, which a capturing
    stream does not permit), and that invalidates the capture."""
    with _capture_lock:
        enabled = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if enabled:
                gc.enable()


def _capture(graph, fn, generator, device: torch.device, pool=None) -> None:
    """Capture ``fn`` into ``graph``, the generator registered with it, its
    memory from ``pool`` (None: a pool of its own)."""
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool):
        fn()


def new_pool(device: torch.device):
    """A graph memory pool programs can share (``pool`` of :func:`dispatch`);
    None off the card."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


class Program:
    """One decode block captured as a CUDA graph over static buffers.

    ``body(**statics)`` runs the block: it reads the static inputs and writes
    its results into the static outputs (and the cache layers it closes
    over). ``statics`` must hold a bool ``active`` mask, which is all false
    while the program captures. The program holds the generator and the
    objects in ``keep`` (the cache layers the graph writes), so neither
    their memory nor their ``id`` can pass to another object while it lives.
    ``pool`` is a memory pool shared with other programs (:func:`new_pool`).
    Calling the program copies the given tensors into their static buffers,
    replays the graph once and adds the capture's launch counts; it returns
    the static buffers, which the next replay overwrites."""

    def __init__(self, body, statics: dict[str, torch.Tensor], generator=None, keep=(),
                 pool=None):
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
        with _collector_paused():
            _capture(self.graph, fn, generator, device, pool)
        end = counts()
        self.launches = _changes(end[0], start[0])
        self.routes = _changes(end[1], start[1])
        set_counts(*before)
        captures += 1

    def __call__(self, **inputs: torch.Tensor) -> dict[str, torch.Tensor]:
        global replays
        for name, value in inputs.items():
            self.statics[name].copy_(value)
        self.graph.replay()
        replays += 1
        add_counts(self.launches, self.routes)
        return self.statics


def kept_copies(store: dict, key, pairs) -> tuple:
    """``pairs`` (tensor pairs, such as each decoder layer's cross K/V)
    copied into buffers kept in ``store[key]``, allocated at a key's first
    call: the fixed inputs a captured program reads in place, whatever
    tensors the caller computed."""
    if key not in store:
        store[key] = tuple(tuple(torch.empty_like(t) for t in pair) for pair in pairs)
    for kept, pair in zip(store[key], pairs):
        for buf, t in zip(kept, pair):
            buf.copy_(t)
    return store[key]


def dispatch(programs: dict, device: torch.device, kind: str, body, cache, inputs: dict,
             outputs: dict, *, generator=None, copy_out: bool = True, mesh=(), pool=None,
             **static) -> dict:
    """Run block ``body`` over ``cache`` on ``device``: ``inputs`` are read
    (and those named in :data:`IN_OUT` written back in place), ``outputs``
    (name -> shape, dtype) come back as fresh tensors (with
    ``copy_out=False`` on the card: the program's static outputs, which its
    next replay overwrites).

    On the card (:func:`takes_graphs`) this is one replay of a
    :class:`Program` kept in the model's ``programs`` dict and keyed, as a
    jit is, by ``kind``, the ``static`` sizes, the generator, the cache
    layers' buffers (address and shape) and the inputs' shapes; the first
    call of a key captures it (its memory from ``pool`` where one is given),
    and the program holds the generator and the layers. Elsewhere (and
    under :func:`eager`) the body runs eagerly on the caller's tensors."""
    fn = functools.partial(body, layers=cache.layers, **static)
    if generator is not None:
        fn = functools.partial(fn, generator=generator)
    if not takes_graphs(device, mesh):
        outs = {name: torch.empty(shape, dtype=dt, device=device)
                for name, (shape, dt) in outputs.items()}
        fn(**inputs, **outs)
        return outs
    key = (kind, tuple(sorted(static.items())), id(generator),
           tuple((t.data_ptr(), tuple(t.shape)) for layer in cache.layers
                 for t in layer.tensors()),
           tuple((name, tuple(t.shape), t.dtype) for name, t in sorted(inputs.items())))
    program = programs.get(key)
    if program is None:
        statics = {name: t.clone() for name, t in inputs.items()}
        statics.update({name: torch.empty(shape, dtype=dt, device=device)
                        for name, (shape, dt) in outputs.items()})
        program = programs[key] = Program(fn, statics, generator, keep=cache.layers,
                                          pool=pool)
    res = program(**inputs)
    for name in IN_OUT:
        if name in inputs:
            inputs[name].copy_(res[name])
    # the next replay overwrites the static outputs
    return {name: res[name].clone() if copy_out else res[name] for name in outputs}
