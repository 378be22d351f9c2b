"""ONNX loading + eager evaluation (reference crane-core/src/onnx/).

``read_file(path)`` parses the protobuf; ``Session(model).run(feeds)``
evaluates the graph. Used by the Kokoro-82M and PaddleOCR v6 production
checkpoints, which ship as ``.onnx`` graphs.

A copy of ``crane_tpu/onnx/__init__.py``: the port imports nothing of ``crane_tpu``.
"""

from crane_tpu_torch.onnx.session import Session
from crane_tpu_torch.onnx.wire import Model, read_file

__all__ = ["Model", "Session", "read_file"]
