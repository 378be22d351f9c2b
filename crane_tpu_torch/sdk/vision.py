"""Vision SDK: OCR + image-analysis clients over the VLM
(reference crane/src/vision/{ocr,image_analysis}.rs and the PaddleOCR-VL
task-prompt recognize API, paddleocr_vl/model.rs:1-22).

A copy of ``crane_tpu/sdk/vision.py`` (it imports no jax) over the port's
models: the port imports nothing of ``crane_tpu``."""

from __future__ import annotations

from typing import Iterator, Optional

from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.generation.streamer import CollectStreamer

TASK_PROMPTS = {
    "ocr": "Recognize all text in this image.",
    "table": "Extract the table in this image as markdown.",
    "formula": "Transcribe the mathematical formula in this image as LaTeX.",
    "chart": "Describe the data shown in this chart.",
}


class OcrClient:
    """Task-prompted recognition over a Qwen3-VL-style model."""

    def __init__(self, vlm, *, max_new_tokens: int = 1024):
        self.vlm = vlm
        self.max_new_tokens = max_new_tokens

    @classmethod
    def from_pretrained(cls, model_dir: str, **kw) -> "OcrClient":
        from crane_tpu_torch.models.auto import load_hf_config

        mt = load_hf_config(model_dir).get("model_type", "")
        if mt.startswith("paddleocr"):
            from crane_tpu_torch.models.paddleocr_vl import load_paddleocr_vl

            return cls(load_paddleocr_vl(model_dir), **kw)
        from crane_tpu_torch.models.qwen3_vl import load_qwen3_vl

        return cls(load_qwen3_vl(model_dir), **kw)

    def _prompt_ids(self, image, task_prompt: str):
        from crane_tpu_torch.models.image_processing import preprocess_image

        vc = self.vlm.vision_config
        patches, grid = preprocess_image(
            image, patch_size=vc.patch_size, merge_size=vc.spatial_merge_size,
            temporal_patch_size=vc.temporal_patch_size,
        )
        n = grid[0] * (grid[1] // vc.spatial_merge_size) * (grid[2] // vc.spatial_merge_size)
        prompt = (
            "<|im_start|>user\n<|vision_start|>" + "<|image_pad|>" * n
            + f"<|vision_end|>{task_prompt}<|im_end|>\n<|im_start|>assistant\n"
        )
        return self.vlm.tokenizer.encode(prompt), [(patches, grid)]

    def recognize(self, image, *, task: str = "ocr", prompt: Optional[str] = None) -> str:
        if hasattr(self.vlm, "recognize"):  # PaddleOCR-VL native task API
            return self.vlm.recognize(
                image, task=task, prompt=prompt, max_new_tokens=self.max_new_tokens
            )
        ids, images = self._prompt_ids(image, prompt or TASK_PROMPTS[task])
        st = CollectStreamer(self.vlm.tokenizer)
        self.vlm.generate(
            ids, images=images,
            gen=GenerationConfig.greedy(
                self.max_new_tokens, eos_token_ids=tuple(self.vlm.eos_token_ids)
            ),
            streamer=st,
        )
        return st.text

    def recognize_stream(self, image, *, task: str = "ocr") -> Iterator[str]:
        from crane_tpu_torch.generation.streamer import AsyncTextStreamer
        import threading

        if hasattr(self.vlm, "recognize_stream"):  # PaddleOCR-VL native API
            yield from self.vlm.recognize_stream(
                image, task=task, max_new_tokens=self.max_new_tokens
            )
            return
        ids, images = self._prompt_ids(image, TASK_PROMPTS[task])
        st = AsyncTextStreamer(self.vlm.tokenizer)
        t = threading.Thread(
            target=self.vlm.generate, args=(ids,),
            kwargs=dict(
                images=images,
                gen=GenerationConfig.greedy(
                    self.max_new_tokens, eos_token_ids=tuple(self.vlm.eos_token_ids)
                ),
                streamer=st,
            ),
        )
        t.start()
        yield from st
        t.join()


class VisionClient(OcrClient):
    """Freeform image analysis over the VLM (reference
    crane/src/vision/image_analysis.rs ``VisionClient`` — a placeholder
    there returning "not fully implemented yet"; functional here: the
    question becomes the task prompt on the same prompt/splice path the
    OCR client uses)."""

    DEFAULT_QUESTION = "Describe this image in detail."

    def analyze(self, image, question: str | None = None) -> str:
        return self.recognize(image, prompt=question or self.DEFAULT_QUESTION)

    # reference method names (image_analysis.rs:20, :60)
    analyze_image = analyze

    def analyze_image_data(self, image_bytes: bytes, question: str | None = None) -> str:
        import io

        import numpy as np
        from PIL import Image

        img = np.asarray(Image.open(io.BytesIO(image_bytes)).convert("RGB"))
        return self.analyze(img, question)
