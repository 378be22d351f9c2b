"""A copy of ``crane_tpu/ocr/__init__.py``: the port imports nothing of ``crane_tpu``."""

from crane_tpu_torch.ocr.pipeline import (  # noqa: F401
    OcrDocument,
    OcrRegion,
    PaddleOcrPipeline,
    ctc_greedy_decode,
    db_regions,
    load_dictionary,
    sort_reading_order,
)
