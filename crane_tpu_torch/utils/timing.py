"""Device timing by the host clock (port of ``crane_tpu/utils/timing.py``).

CUDA launches return before the card has run them, so a host clock read
after them measures the enqueue. The sync point here is a device-to-host
copy of one element of a value that depends on the work: on a CUDA tensor
``.item()`` waits for the stream that wrote it.

:func:`marginal_rate` times two chain lengths and reports the marginal
iterations a second, which takes the fixed cost of launching and syncing
out of the estimate.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def host_sync(x) -> float:
    """Wait for ``x`` by pulling one element of it to the host: a torch
    tensor on any device, or anything ``np.asarray`` takes."""
    if isinstance(x, torch.Tensor):
        return float(x.reshape(-1)[0].item())
    return float(np.asarray(x).ravel()[0])


def chain_time(step: Callable, n: int) -> float:
    """Run ``step`` n times (each consuming the state of the last) and
    return the wall time, ONE final host sync included. ``step()`` returns
    the value to sync on and keeps its own state."""
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = step()
    host_sync(out)
    return time.perf_counter() - t0


def marginal_rate(make_step: Callable[[], Callable], n_small: int, n_large: int) -> float:
    """Iterations a second from the marginal time between two chain
    lengths."""
    step = make_step()
    chain_time(step, 2)  # warm
    step = make_step()
    t_small = chain_time(step, n_small)
    step = make_step()
    t_large = chain_time(step, n_large)
    return (n_large - n_small) / max(t_large - t_small, 1e-9)
