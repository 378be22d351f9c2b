"""SNAC-24kHz ONNX decoder: multi-scale codec codes -> 24 kHz waveform.

Reference behavior (crane-core src/models/snac_onnx/
model.rs:1-49): the released ``onnx-community/snac_24khz-ONNX`` decoder
graph takes the three SNAC code streams (coarse 12 Hz, medium 2x, fine 4x
rate) and emits audio; it drives Orpheus-style token-to-audio decoding. The
graph runs through the in-tree evaluator (``crane_tpu_torch.onnx``) — no runtime
dependency.

A copy of ``crane_tpu/models/snac_onnx.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import numpy as np


class Snac24Decoder:
    """codes (c1 ``[T]``, c2 ``[2T]``, c3 ``[4T]`` int) -> waveform f32."""

    sample_rate = 24000

    def __init__(self, session):
        self.session = session
        ins = list(session.input_names)
        if len(ins) != 3:
            raise ValueError(
                f"SNAC decoder graph must have 3 code inputs, got {ins}"
            )
        self.input_names = ins

    def decode(self, c1, c2, c3) -> np.ndarray:
        """Three code streams (1-D or ``[1, T]``) -> audio ``[N]`` f32
        (reference model.rs:30-48: feeds c1/c2/c3, returns the graph's
        first output)."""
        feeds = {
            n: np.asarray(c, np.int64).reshape(1, -1)
            for n, c in zip(self.input_names, (c1, c2, c3))
        }
        out = self.session.run(feeds)
        first = self.session.output_names[0]
        return np.asarray(out[first], np.float32).reshape(-1)


def load_snac_onnx(path: str) -> Snac24Decoder:
    """Load a released SNAC-24kHz decoder ``.onnx`` file."""
    from crane_tpu_torch.onnx import Session, read_file

    return Snac24Decoder(Session(read_file(path)))
