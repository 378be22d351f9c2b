"""PaddleOCR-VL: NaViT dynamic-resolution vision tower + Ernie-4.5 decoder.

Port of ``crane_tpu/models/paddleocr_vl.py``. Reference behavior (crane-core
``src/models/paddleocr_vl/model.rs`` + ``utils/image_utils.rs:74-190``):

- preprocessing: RGB / 255 (no mean/std norm), bilinear resize to the
  smart-resize shape (factor = patch*merge = 28, min 147384 px, max
  1473600 px, round-half-up to the factor, sqrt rescale when out of range,
  aspect guard 200:1) -> grid_thw = (1, H/14, W/14);
- prompt: ``<|begin_of_sentence|>User: <|image_start|>`` + image pads
  (``(h/merge)*(w/merge)`` of them) + ``<|image_end|>`` + task prompt +
  ``\\nAssistant: `` (model.rs:363-413), tasks OCR/Table/Formula/Chart
  (:26-42), greedy decode to ``</s>``;
- tower: SigLIP-so400m-shaped NaViT: 14x14 patch conv, bilinear-interpolated
  learned position embeddings over the native grid, pre-LN bidirectional
  blocks with QKV bias + 2-D rotary, post_layernorm, then a 2x2
  spatial-merge projector (LN -> fc1 GELU fc2) into the Ernie hidden size.

crane_tpu resizes with ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples (a triangle kernel widened by the scale);
``F.interpolate`` computes another function. The port builds JAX's
scale-and-translate weights itself in numpy (:func:`resize_weights`) and
applies them per axis. The prompt's prefill runs over the cache
(:func:`~crane_tpu_torch.models.modules.embeds_decode.embeds_prefill`, K3)
and the decode steps take K1, each one replay of a CUDA graph on the card
(the counterpart of crane_tpu's jitted step); the tower's attention is
plain.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.models.modules.vision import (
    VisionConfig,
    affine,
    layer_norm,
    vision_block,
)
from crane_tpu_torch.utils.device import default_device

FACTOR = 28  # patch 14 * spatial merge 2
MIN_PIXELS = 147_384
MAX_PIXELS = 1_473_600

TASK_PROMPTS = {
    "ocr": "OCR:",
    "table": "Table Recognition:",
    "formula": "Formula Recognition:",
    "chart": "Chart Recognition:",
}


def smart_resize(h: int, w: int, factor: int = FACTOR,
                 min_pixels: int = MIN_PIXELS, max_pixels: int = MAX_PIXELS) -> tuple[int, int]:
    """Exact port of the reference smart_resize (image_utils.rs:131-177)."""
    height, width = h, w
    if height < factor:
        width = width * factor // max(height, 1)
        height = factor
    if width < factor:
        height = height * factor // max(width, 1)
        width = factor
    h_bar = ((height + factor // 2) // factor) * factor
    w_bar = ((width + factor // 2) // factor) * factor
    pixels = h_bar * w_bar
    if pixels > max_pixels:
        scale = (pixels / max_pixels) ** 0.5
        h_bar = max(int(height / scale / factor), 1) * factor
        w_bar = max(int(width / scale / factor), 1) * factor
    elif pixels < min_pixels:
        scale = (min_pixels / pixels) ** 0.5
        h_bar = int(np.ceil(height * scale / factor)) * factor
        w_bar = int(np.ceil(width * scale / factor)) * factor
    if max(h_bar / w_bar, w_bar / h_bar) > 200.0:
        raise ValueError("Aspect ratio too extreme after resize")
    return h_bar, w_bar


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` float32 weights of JAX's bilinear resize
    along one axis (``jax.image.scale_and_translate`` with the triangle
    kernel, translation 0, antialiased): the kernel is widened by
    ``in / out`` when downsampling, each output column's weights are
    normalised to sum 1, and a sample outside the input gets none."""
    # jax takes 1 / scale in double precision, then rounds it to float32
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    # XLA contracts (o + 0.5) * inv - 0.5 into one fused multiply-add: one
    # rounding to float32, which float64 arithmetic reproduces
    sample = ((np.arange(out_size, dtype=np.float64) + 0.5) * np.float64(inv_scale)
              - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """HWC float32 -> ``[out_h, out_w, C]``, as ``jax.image.resize(img,
    (out_h, out_w, C), "bilinear")`` computes it (an axis whose size is
    kept is left as it is)."""
    x = np.asarray(img, np.float32)
    if out_h != x.shape[0]:
        x = np.einsum("hwc,ho->owc", x, resize_weights(x.shape[0], out_h))
    if out_w != x.shape[1]:
        x = np.einsum("hwc,wo->hoc", x, resize_weights(x.shape[1], out_w))
    return x.astype(np.float32)


def preprocess_image(image: np.ndarray) -> tuple[np.ndarray, tuple[int, int, int]]:
    """HWC uint8/float RGB -> (raster patches ``[h*w, 3*14*14]``, grid (1,h,w)).
    Reference: /255 then bilinear resize (image_utils.rs:104-118)."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    H, W = img.shape[:2]
    rh, rw = smart_resize(H, W)
    x = resize_bilinear(img, rh, rw).transpose(2, 0, 1)  # [3, H, W]
    h, w = rh // 14, rw // 14
    # conv(k=14, s=14) == one product over patches flattened in (C, ph, pw) order
    patches = x.reshape(3, h, 14, w, 14).transpose(1, 3, 0, 2, 4).reshape(h * w, 3 * 14 * 14)
    return patches.astype(np.float32), (1, h, w)


def navit_rope_tables(cfg: VisionConfig, grid: tuple[int, int, int]) -> tuple[np.ndarray, np.ndarray]:
    """2-D rope over RASTER patch order: half the rotary dims carry the row
    index, half the column (Qwen2-VL-style duplicated half tables)."""
    _, h, w = grid
    dim = cfg.head_dim // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    rows = np.repeat(np.arange(h), w)
    cols = np.tile(np.arange(w), h)
    pos = np.stack([rows, cols], axis=1)  # [S, 2]
    freqs = pos[:, :, None].astype(np.float64) * inv[None, None, :]
    half = freqs.reshape(pos.shape[0], -1)
    emb = np.concatenate([half, half], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def navit_pos_taps(side: int, grid: tuple[int, int, int]) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear interpolation taps of the ``side x side`` learned PE onto the
    native ``h x w`` grid, raster order: (idx [4, S], weight [4, S])."""
    _, h, w = grid
    h_idx = np.linspace(0, side - 1, h)
    w_idx = np.linspace(0, side - 1, w)
    hf, wf = h_idx.astype(np.int64), w_idx.astype(np.int64)
    hc = np.clip(hf + 1, None, side - 1)
    wc = np.clip(wf + 1, None, side - 1)
    dh, dw = h_idx - hf, w_idx - wf
    idx = np.stack([
        (hf[:, None] * side + wf[None, :]).ravel(),
        (hf[:, None] * side + wc[None, :]).ravel(),
        (hc[:, None] * side + wf[None, :]).ravel(),
        (hc[:, None] * side + wc[None, :]).ravel(),
    ])
    wgt = np.stack([
        ((1 - dh)[:, None] * (1 - dw)[None, :]).ravel(),
        ((1 - dh)[:, None] * dw[None, :]).ravel(),
        (dh[:, None] * (1 - dw)[None, :]).ravel(),
        (dh[:, None] * dw[None, :]).ravel(),
    ])
    return idx.astype(np.int32), wgt.astype(np.float32)


def navit_forward(
    cfg: VisionConfig,
    p: dict,
    patches: torch.Tensor,   # [S, 3*14*14] raster order
    pos_idx: torch.Tensor,   # [4, S]
    pos_wgt: torch.Tensor,   # [4, S]
    rope: tuple,             # (cos [S, head_dim], sin)
    grid_hw: tuple,          # (h, w)
) -> torch.Tensor:
    """Tower + projector: raster patches -> ``[h/2*w/2, llm_hidden]``."""
    h, w = grid_hw
    x = patches.to(p["embed_w"].dtype) @ p["embed_w"] + p["embed_b"]
    pe = torch.einsum("ksd,ks->sd", p["pos_embed"][pos_idx.long()].float(), pos_wgt)
    x = x + pe.to(x.dtype)
    cos, sin = rope
    for layer in p["layers"]:
        x = vision_block(cfg, layer, x, cos, sin)
    x = layer_norm(x, p["post_ln_w"], p["post_ln_b"], cfg.eps)
    # 2x2 spatial merge from raster order, then LN -> fc1 GELU fc2
    m = cfg.spatial_merge_size
    C = x.shape[-1]
    x = x.reshape(h // m, m, w // m, m, C).permute(0, 2, 1, 3, 4)
    x = x.reshape((h // m) * (w // m), m * m * C)
    if "proj_ln_w" in p:
        x = layer_norm(x, p["proj_ln_w"], p["proj_ln_b"], cfg.eps)
    x = F.gelu(affine(x, p["proj_fc1_w"], p["proj_fc1_b"]))
    return affine(x, p["proj_fc2_w"], p["proj_fc2_b"])


class PaddleOcrVL:
    """Vision tower + Ernie backbone with the reference recognize API."""

    def __init__(self, lm, vision_cfg: VisionConfig, vision_params: dict, *,
                 image_token_id: int, dtype=torch.float32):
        self.lm = lm  # CausalLM (Ernie-4.5)
        self.vision_config = vision_cfg
        self.vision_params = vision_params
        self.image_token_id = image_token_id
        self.dtype = dtype
        self._programs: dict = {}  # the captured decode step (models/graphs.py)

    def release_graphs(self) -> None:
        """Drop the captured decode steps and the kept caches."""
        self._programs.clear()
        self.lm.release_graphs()

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.lm.device, dtype=dtype)

    @torch.no_grad()
    def encode_patches(self, patches, grid: tuple[int, int, int]) -> torch.Tensor:
        """Raster patches ``[h*w, 3*14*14]`` of ``grid`` -> visual embeds
        ``[n_tokens, llm_hidden]``."""
        side = int(round(self.vision_params["pos_embed"].shape[0] ** 0.5))
        idx, wgt = navit_pos_taps(side, grid)
        cos, sin = navit_rope_tables(self.vision_config, grid)
        return navit_forward(self.vision_config, self.vision_params,
                             self._t(patches, self.dtype), self._t(idx), self._t(wgt),
                             (self._t(cos), self._t(sin)), (grid[1], grid[2]))

    def encode_image(self, image: np.ndarray) -> tuple[torch.Tensor, int]:
        """image -> (visual embeds [n_tokens, llm_hidden], n_tokens)."""
        feats = self.encode_patches(*preprocess_image(image))
        return feats, feats.shape[0]

    def build_prompt_ids(self, n_image_tokens: int, task: str = "ocr",
                         prompt: Optional[str] = None) -> list[int]:
        """Reference build_input_tokens (model.rs:363-413)."""
        tok = self.lm.tokenizer
        bos = tok.token_to_id("<|begin_of_sentence|>")
        ids = [bos] if bos is not None else []
        ids += tok.encode("User: ")
        ids += tok.encode("<|image_start|>")
        ids += [self.image_token_id] * n_image_tokens
        ids += tok.encode("<|image_end|>")
        ids += tok.encode(prompt or TASK_PROMPTS[task])
        ids += tok.encode("\nAssistant: ")
        return ids

    def recognize(self, image: np.ndarray, *, task: str = "ocr",
                  prompt: Optional[str] = None, max_new_tokens: int = 1024) -> str:
        """Full image -> text OCR (greedy, reference generate_stream)."""
        return "".join(self.recognize_stream(
            image, task=task, prompt=prompt, max_new_tokens=max_new_tokens
        )).strip()

    @torch.no_grad()
    def recognize_ids(self, feats: torch.Tensor, ids, max_new_tokens: int):
        """Greedy token ids after the prompt ``ids`` whose image pads take
        ``feats``; stops before ``</s>`` (the ids ``recognize_stream``
        detokenizes). The text model's batch-1 cache is kept per length
        across calls (so a second page replays the decode step the first
        captured), so calls must not overlap."""
        from crane_tpu_torch.models.modules.embeds_decode import (
            embeds_prefill,
            greedy_decode_step,
            splice_prompt,
        )
        from crane_tpu_torch.utils.buckets import bucket_length

        lm = self.lm
        embeds, S = splice_prompt(lm.params["embed"], ids, self.image_token_id, feats, self.dtype)
        cache, _ = lm._generate_cache(bucket_length(S + max_new_tokens, floor=256), None)
        logits, cache = embeds_prefill(lm.config, lm.params, lm.rope, cache, embeds, S)
        cur = torch.argmax(logits, -1).to(torch.int32)
        eos = set(lm.eos_token_ids)
        for _ in range(max_new_tokens):
            t = int(cur[0])
            if t in eos:
                break
            yield t
            cur, cache = greedy_decode_step(self._programs, lm.config, lm.params, lm.rope,
                                            cache, cur)

    def recognize_stream(self, image, *, task: str = "ocr", prompt=None,
                         max_new_tokens: int = 1024):
        """Greedy decode, yielding detokenized text pieces as they emerge."""
        from crane_tpu_torch.tokenizer.token_stream import TokenOutputStream

        feats, n = self.encode_image(image)
        detok = TokenOutputStream(self.lm.tokenizer)
        for t in self.recognize_ids(feats, self.build_prompt_ids(n, task, prompt),
                                    max_new_tokens):
            piece = detok.next_token(t)
            if piece:
                yield piece
        rest = detok.decode_rest()
        if rest:
            yield rest


def _pick(sd: dict, *names: str):
    for n in names:
        if n in sd:
            return sd[n]
    raise KeyError(f"none of {names} in checkpoint (have {len(sd)} keys)")


def map_navit_weights(cfg: VisionConfig, sd: dict, dtype=torch.float32, device=None) -> dict:
    """Map the PaddleOCR-VL vision tower + projector weights. Accepts the
    public checkpoint's SigLIP-style naming (separate q/k/v fused here)."""
    def a(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def t(x):
        return torch.as_tensor(x).T.to(device=device, dtype=dtype).contiguous()

    emb_w = torch.as_tensor(_pick(sd, "embeddings.patch_embedding.weight",
                                  "patch_embed.proj.weight"))
    # conv [C_out, 3, 14, 14] -> [3*14*14, C_out]
    emb_w = emb_w.reshape(emb_w.shape[0], -1) if emb_w.ndim == 4 else emb_w
    layers = []
    for i in range(cfg.depth):
        L = f"encoder.layers.{i}."
        qkv_w = torch.cat([torch.as_tensor(sd[L + f"self_attn.{n}_proj.weight"]) for n in "qkv"])
        qkv_b = torch.cat([torch.as_tensor(sd[L + f"self_attn.{n}_proj.bias"]) for n in "qkv"])
        layers.append({
            "qkv_w": t(qkv_w),
            "qkv_b": a(qkv_b),
            "proj_w": t(_pick(sd, L + "self_attn.out_proj.weight", L + "self_attn.o_proj.weight")),
            "proj_b": a(_pick(sd, L + "self_attn.out_proj.bias", L + "self_attn.o_proj.bias")),
            "ln1_w": a(sd[L + "layer_norm1.weight"]), "ln1_b": a(sd[L + "layer_norm1.bias"]),
            "ln2_w": a(sd[L + "layer_norm2.weight"]), "ln2_b": a(sd[L + "layer_norm2.bias"]),
            "fc1_w": t(sd[L + "mlp.fc1.weight"]), "fc1_b": a(sd[L + "mlp.fc1.bias"]),
            "fc2_w": t(sd[L + "mlp.fc2.weight"]), "fc2_b": a(sd[L + "mlp.fc2.bias"]),
        })
    p = {
        "embed_w": t(emb_w),
        "embed_b": a(_pick(sd, "embeddings.patch_embedding.bias", "patch_embed.proj.bias")),
        "pos_embed": a(_pick(sd, "embeddings.position_embedding.weight", "pos_embed")),
        "layers": layers,
        "post_ln_w": a(sd["post_layernorm.weight"]),
        "post_ln_b": a(sd["post_layernorm.bias"]),
        "proj_fc1_w": t(_pick(sd, "_projector.linear_1.weight", "_projector.0.weight")),
        "proj_fc1_b": a(_pick(sd, "_projector.linear_1.bias", "_projector.0.bias")),
        "proj_fc2_w": t(_pick(sd, "_projector.linear_2.weight", "_projector.2.weight")),
        "proj_fc2_b": a(_pick(sd, "_projector.linear_2.bias", "_projector.2.bias")),
    }
    for cand_w, cand_b in (("_projector.norm.weight", "_projector.norm.bias"),
                           ("_projector.pre_norm.weight", "_projector.pre_norm.bias")):
        if cand_w in sd:
            p["proj_ln_w"] = a(sd[cand_w])
            p["proj_ln_b"] = a(sd[cand_b])
            break
    return p


def navit_config_from_hf(hf: dict) -> VisionConfig:
    vc = hf.get("vision_config", {})
    return VisionConfig(
        depth=vc.get("num_hidden_layers", vc.get("depth", 27)),
        hidden_size=vc.get("hidden_size", 1152),
        intermediate_size=vc.get("intermediate_size", 4304),
        num_heads=vc.get("num_attention_heads", 16),
        patch_size=vc.get("patch_size", 14),
        temporal_patch_size=1,
        spatial_merge_size=vc.get("spatial_merge_size", 2),
        out_hidden_size=vc.get("out_hidden_size", 1024),
        eps=vc.get("layer_norm_eps", 1e-6),
        act="gelu_tanh" if "tanh" in vc.get("hidden_act", "gelu_pytorch_tanh") else "gelu",
    )


def split_state_dict(sd: dict) -> tuple[dict, dict]:
    """(tower + projector tensors under ``encoder.``/``embeddings.``/
    ``_projector.`` names, the language model's under ``model.`` names)."""
    def strip(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    v_sd = {}
    for pref in ("visual.vision_model.", "vision_model.", "model.visual.", "visual."):
        v_sd = strip(pref)
        if any(k.startswith("encoder.layers.0.") for k in v_sd):
            break
    # Sequential-style projector (mlp_AR.0 / mlp_AR.2) or named linears
    for pref in ("mlp_AR.", "projector.", "visual.projector.", "model.projector."):
        for k, v in strip(pref).items():
            v_sd.setdefault("_projector." + k, v)
    lm_prefix = "model.language_model." if any(
        k.startswith("model.language_model.") for k in sd
    ) else ("language_model.model." if any(k.startswith("language_model.") for k in sd)
            else "model.")
    text_sd = {"model." + k: v for k, v in strip(lm_prefix).items()}
    for hk in ("lm_head.weight", "language_model.lm_head.weight"):
        if hk in sd:
            text_sd["lm_head.weight"] = sd[hk]
            break
    return v_sd, text_sd


def text_config_from_hf(hf: dict):
    from crane_tpu_torch.models.auto import transformer_config_from_hf

    text_hf = hf.get("text_config", hf)
    if "model_type" not in text_hf or text_hf is hf:
        text_hf = {**text_hf, "model_type": "ernie4_5"}
    return transformer_config_from_hf(text_hf)


def load_paddleocr_vl(model_dir: str, *, dtype=torch.float32, device=None) -> PaddleOcrVL:
    """Load a PaddleOCR-VL checkpoint (Ernie LLM + NaViT tower + projector)
    onto ``device`` (the card unless the caller asks for the CPU).

    Tower keys are searched under the ``visual.``/``vision_model.``/
    ``model.visual.`` prefixes; the projector under ``mlp_AR.``/
    ``projector.``/``visual.projector.`` (normalized to ``_projector.``)."""
    from crane_tpu_torch.models.auto import (
        load_hf_config,
        load_state_dict,
        map_hf_weights,
        read_eos_ids,
    )
    from crane_tpu_torch.models.causal_lm import CausalLM
    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    device = default_device(device)
    hf = load_hf_config(model_dir)
    vcfg, tcfg = navit_config_from_hf(hf), text_config_from_hf(hf)
    v_sd, text_sd = split_state_dict(load_state_dict(model_dir))
    vision_params = map_navit_weights(vcfg, v_sd, dtype, device)
    params = map_hf_weights(tcfg, text_sd, dtype, device)
    tok = AutoTokenizer.from_pretrained(model_dir)
    lm = CausalLM(tcfg, params, tokenizer=tok, eos_token_ids=read_eos_ids(model_dir),
                  dtype=dtype)
    image_token_id = hf.get("image_token_id") or tok.token_to_id("<|IMAGE_PLACEHOLDER|>") or 0
    return PaddleOcrVL(lm, vcfg, vision_params, image_token_id=int(image_token_id), dtype=dtype)
