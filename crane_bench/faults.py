"""Faults planted underneath the timed path, to see the comparison that
decides ``correct`` catch them: each is a context manager that patches the
port for a whole run, set-up included, so that the decode blocks captured
as CUDA graphs carry it too.

- ``altered_token``: every fifth served token is moved by one where the
  engine emits it.
- ``frozen_kv``: a decode step leaves the attention layers' KV cache as it
  was (its per-row write is left out; the slot prefill still writes).
- ``frozen_gdn_state``: a decode step hands the Gated-DeltaNet recurrent
  state back unchanged (the conv window still rolls).
- ``half_slots``: the second half of the slots is left out of each decode
  block; those rows repeat the token they had.

(The exchange between chips does not exist here: every cell runs on one
card.)
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _altered_token():
    from crane_tpu_torch.serve.engine import InferenceEngine

    emit = InferenceEngine._emit

    def altered(self, seq, token):
        if len(seq.generated) % 5 == 3:
            token = (token + 1) % self.lm.config.vocab_size
        return emit(self, seq, token)

    return mock.patch.object(InferenceEngine, "_emit", altered)


def _frozen_kv():
    from crane_tpu_torch.ops.kv_cache import LayerKVCache

    update = LayerKVCache.update

    def frozen(self, k_new, v_new, positions, row=None):
        if isinstance(positions, torch.Tensor):  # a decode step's per-row write
            return self
        return update(self, k_new, v_new, positions, row)

    return mock.patch.object(LayerKVCache, "update", frozen)


def _frozen_gdn_state():
    from crane_tpu_torch.models.modules import gdn_layer

    step = gdn_layer.gdn_decode_step

    def frozen(q, k, v, g, beta, state):
        y, _ = step(q, k, v, g, beta, state)
        return y, state

    return mock.patch.object(gdn_layer, "gdn_decode_step", frozen)


def _half_slots():
    from crane_tpu_torch.serve.engine import InferenceEngine

    decode = InferenceEngine._run_decode

    def half(self, n_steps):
        before = self.cur_tokens.clone()
        out = decode(self, n_steps)
        rows = out.shape[0] // 2
        out[rows:] = before[rows:, None]  # the second half is not computed
        return out

    return mock.patch.object(InferenceEngine, "_run_decode", half)


FAULTS = {"altered_token": _altered_token, "frozen_kv": _frozen_kv,
          "frozen_gdn_state": _frozen_gdn_state, "half_slots": _half_slots}


def plant(name: str | None):
    """The fault ``name`` planted for the ``with`` block (None: nothing)."""
    return FAULTS[name]() if name else contextlib.nullcontext()
