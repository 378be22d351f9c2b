"""Gemma3 vision-language model (reference "Gemma4 VL",
``gemma4/{vision,vlm}.rs``).

Port of ``crane_tpu/models/gemma3_vl.py``. SigLIP vision tower (conv patch
embed, learned position embeddings, pre-LN bidirectional transformer with
biases, gelu-tanh MLP, final LN) -> multimodal projector (average pool ->
unit-offset RMSNorm -> projection matrix) -> image features spliced over
``<image>`` token positions. Image tokens attend bidirectionally within
their image block while text stays causal (HF token_type_ids mask).

The fresh prefill hands the transformer both forms of that mask, as
crane_tpu does: the boolean ``extra_mask`` and the compact ``segments``
(each image block one positive id). The prefill passes ``segments``, so its
attention takes K2 with segments
(:func:`~crane_tpu_torch.ops.cuda.flash_attention.flash_attention_causal`);
decode steps take K1, each one replay of a CUDA graph on the card (the
counterpart of crane_tpu's jitted ``_vl_decode_step``). The tower's
attention is plain products and a softmax, as crane_tpu's is plain XLA.

Numerics match HF transformers ``Gemma3ForConditionalGeneration``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.modules.embeds_decode import greedy_decode_step
from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    forward_hidden,
    lm_logits,
)
from crane_tpu_torch.models.modules.vision import bidirectional_attention, layer_norm
from crane_tpu_torch.ops.kv_cache import KVCache
from crane_tpu_torch.ops.norm import rms_norm
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.utils.device import default_device


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    image_size: int
    patch_size: int
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size


def siglip_encode(cfg: SiglipConfig, p: dict, pixels: torch.Tensor) -> torch.Tensor:
    """pixels ``[B, C, H, W]`` -> features ``[B, n_patches, E]``."""
    B = pixels.shape[0]
    P, n = cfg.patch_size, cfg.patches_per_side
    # conv(k=P, s=P) == one product over flattened patches
    x = pixels.reshape(B, 3, n, P, n, P).permute(0, 2, 4, 1, 3, 5).reshape(B, n * n, 3 * P * P)
    x = x @ p["patch_w"] + p["patch_b"] + p["pos_embed"]
    H, D, T = cfg.num_heads, cfg.head_dim, n * n
    for lp in p["layers"]:
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.eps)
        q = (h @ lp["wq"] + lp["bq"]).reshape(B, T, H, D)
        k = (h @ lp["wk"] + lp["bk"]).reshape(B, T, H, D)
        v = (h @ lp["wv"] + lp["bv"]).reshape(B, T, H, D)
        o = bidirectional_attention(q, k, v).reshape(B, T, -1)
        x = x + (o @ lp["wo"] + lp["bo"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.eps)
        h = F.gelu(h @ lp["fc1_w"] + lp["fc1_b"], approximate="tanh")
        x = x + (h @ lp["fc2_w"] + lp["fc2_b"])
    return layer_norm(x, p["post_ln_w"], p["post_ln_b"], cfg.eps)


def project_features(cfg: SiglipConfig, p: dict, feats: torch.Tensor,
                     tokens_per_image: int) -> torch.Tensor:
    """Average-pool to mm_tokens_per_image, unit-offset RMSNorm, project."""
    B, T, E = feats.shape
    n = cfg.patches_per_side
    side = int(tokens_per_image ** 0.5)
    k = n // side
    x = feats.reshape(B, side, k, side, k, E).mean(dim=(2, 4)).reshape(B, side * side, E)
    x = rms_norm(x, p["mm_norm"], eps=cfg.eps, weight_offset=1.0)
    return x @ p["mm_proj"]


def preprocess_gemma3(image, *, image_size: int = 224) -> np.ndarray:
    """PIL image -> normalized ``[3, H, W]`` (SigLIP processing: bilinear
    resize, rescale 1/255, mean/std 0.5). PIL is imported here only."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    image = image.convert("RGB").resize((image_size, image_size), Image.BILINEAR)
    arr = np.asarray(image, np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return arr.transpose(2, 0, 1)


def image_block_masks(ids: np.ndarray, img_mask: np.ndarray, s_bucket: int):
    """Each contiguous run of image tokens is one bidirectional block:
    (the boolean ``extra_mask [S_bucket, S_bucket]``, the ``segments
    [S_bucket]`` int32 that say the same, a block's id > 0)."""
    S = len(ids)
    m = np.zeros((s_bucket, s_bucket), bool)
    seg = np.zeros((s_bucket,), np.int32)
    if img_mask.any():
        group = np.cumsum(~img_mask)  # constant within an image run
        m[:S, :S] = img_mask[:, None] & img_mask[None, :] & (group[:, None] == group[None, :])
        seg[:S] = np.where(img_mask, group + 1, 0)
    return m, seg


class Gemma3VLModel:
    def __init__(
        self,
        text_config: TransformerConfig,
        vision_config: SiglipConfig,
        params: dict,
        vision_params: dict,
        *,
        image_token_id: int,
        mm_tokens_per_image: int = 256,
        tokenizer=None,
        eos_token_ids: Sequence[int] = (),
        dtype=torch.float32,
    ):
        self.config = text_config
        self.vision_config = vision_config
        self.params = params
        self.vision_params = vision_params
        self.image_token_id = image_token_id
        self.mm_tokens_per_image = mm_tokens_per_image
        self.tokenizer = tokenizer
        self.eos_token_ids = tuple(eos_token_ids)
        self.dtype = dtype
        # crane_tpu's model has no CausalLM, so nothing fuses: the forwards
        # here read self.params, and the helper shares them
        self.lm = CausalLM(text_config, params, tokenizer=tokenizer,
                           eos_token_ids=eos_token_ids, dtype=dtype, fuse=False)
        self.device = self.lm.device
        self.rope = self.lm.rope
        self._programs: dict = {}  # the captured decode step (models/graphs.py)

    def release_graphs(self) -> None:
        """Drop the captured decode steps and the kept caches."""
        self._programs.clear()
        self.lm.release_graphs()

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    @torch.no_grad()
    def encode_images(self, pixels) -> torch.Tensor:
        """pixels ``[N, 3, H, W]`` -> features ``[N, mm_tokens, E_text]``."""
        feats = siglip_encode(self.vision_config, self.vision_params,
                              self._t(pixels, self.dtype))
        return project_features(self.vision_config, self.vision_params, feats,
                                self.mm_tokens_per_image)

    @torch.no_grad()
    def prefill(self, cache: KVCache, embeds, extra_mask, segments, true_length: int):
        """A fresh prefill of the spliced ``embeds [1, S_bucket, E]`` with
        the image blocks' masks: (last-token logits ``[1, V]``, cache with
        lengths ``true_length``)."""
        cfg = self.config
        lengths = torch.full_like(cache.lengths, true_length)
        hidden, cache = forward_hidden(
            cfg, self.params, torch.zeros(embeds.shape[:2], dtype=torch.int32,
                                          device=self.device),
            cache, 0, self.rope, inputs_embeds=embeds, true_lengths=lengths,
            extra_mask=extra_mask, segments=segments, read_cache=False)
        cache.lengths = lengths
        return lm_logits(cfg, self.params, hidden[:, true_length - 1:true_length])[:, 0], cache

    @torch.no_grad()
    def prompt_inputs(self, input_ids: Sequence[int], pixels=None):
        """The fresh prefill's inputs: (embeds ``[1, S_bucket, E]`` with the
        image features spliced in, ``extra_mask [1, S_bucket, S_bucket]``,
        ``segments [1, S_bucket]``)."""
        cfg = self.config
        ids = np.asarray(list(input_ids), np.int32)
        S = len(ids)
        embeds = self.params["embed"][self._t(ids).long()][None].to(self.dtype)
        img_mask = ids == self.image_token_id
        if pixels is not None:
            flat = self.encode_images(pixels)
            flat = flat.reshape(-1, flat.shape[-1])
            (pos,) = np.where(img_mask)
            if len(pos) != flat.shape[0]:
                raise ValueError(f"{len(pos)} image tokens for {flat.shape[0]} features")
            # forward_hidden multiplies all inputs_embeds by embed_scale;
            # features enter pre-divided so they come out unscaled (HF
            # splices after the scaled text embedding)
            scale = cfg.embed_scale or 1.0
            embeds[0, self._t(pos).long()] = (flat / scale).to(self.dtype)
        s_bucket = bucket_length(S, floor=64)
        embeds = F.pad(embeds, (0, 0, 0, s_bucket - S))
        m, seg = image_block_masks(ids, img_mask, s_bucket)
        return embeds, self._t(m)[None], self._t(seg)[None]

    @torch.no_grad()
    def generate(
        self,
        input_ids: Sequence[int],
        pixels: Optional[np.ndarray] = None,
        gen: GenerationConfig | None = None,
        streamer=None,
    ) -> list[int]:
        gen = gen or GenerationConfig()
        eos = set(gen.eos_token_ids) | set(self.eos_token_ids)
        S = len(input_ids)
        embeds, extra_mask, segments = self.prompt_inputs(input_ids, pixels)
        cache, _ = self.lm._generate_cache(bucket_length(S + gen.max_new_tokens, floor=256),
                                           None)
        logits, cache = self.prefill(cache, embeds, extra_mask, segments, S)
        cur = torch.argmax(logits, -1).to(torch.int32)
        out = []
        for _ in range(gen.max_new_tokens):
            out.append(int(cur[0]))
            if streamer is not None and streamer.append(out[-1]) is False:
                break
            if out[-1] in eos:
                break
            cur, cache = greedy_decode_step(self._programs, self.config, self.params, self.rope,
                                            cache, cur)
        if streamer is not None:
            streamer.finalize()
        return out


def siglip_config_from_hf(hf: dict) -> SiglipConfig:
    vc = hf["vision_config"]
    return SiglipConfig(
        hidden_size=vc["hidden_size"],
        num_layers=vc["num_hidden_layers"],
        num_heads=vc["num_attention_heads"],
        intermediate_size=vc["intermediate_size"],
        image_size=vc["image_size"],
        patch_size=vc["patch_size"],
        eps=vc.get("layer_norm_eps", 1e-6),
    )


def text_config_from_hf(hf: dict) -> TransformerConfig:
    from crane_tpu_torch.models.auto import transformer_config_from_hf

    return transformer_config_from_hf(dict(hf["text_config"], model_type="gemma3_text"))


def map_siglip_weights(vision_cfg: SiglipConfig, sd: dict, dtype=torch.float32,
                       device=None) -> dict:
    """The SigLIP tower and projector tensors of an HF Gemma3 checkpoint ->
    the tower's tree (``[in, out]`` linears)."""
    vt = ("model.vision_tower.vision_model."
          if any(k.startswith("model.vision_tower.") for k in sd)
          else "vision_tower.vision_model.")

    def t(n):
        return torch.as_tensor(sd[vt + n]).T.to(device=device, dtype=dtype).contiguous()

    def a(n):
        return torch.as_tensor(sd[vt + n]).to(device=device, dtype=dtype)

    def mm(name):
        w = sd.get("model.multi_modal_projector." + name,
                   sd.get("multi_modal_projector." + name))
        return torch.as_tensor(w).to(device=device, dtype=dtype)

    pw = torch.as_tensor(sd[vt + "embeddings.patch_embedding.weight"])  # [E, 3, P, P]
    layers = []
    for i in range(vision_cfg.num_layers):
        lp = f"encoder.layers.{i}."
        layers.append({
            "ln1_w": a(lp + "layer_norm1.weight"), "ln1_b": a(lp + "layer_norm1.bias"),
            "ln2_w": a(lp + "layer_norm2.weight"), "ln2_b": a(lp + "layer_norm2.bias"),
            "wq": t(lp + "self_attn.q_proj.weight"), "bq": a(lp + "self_attn.q_proj.bias"),
            "wk": t(lp + "self_attn.k_proj.weight"), "bk": a(lp + "self_attn.k_proj.bias"),
            "wv": t(lp + "self_attn.v_proj.weight"), "bv": a(lp + "self_attn.v_proj.bias"),
            "wo": t(lp + "self_attn.out_proj.weight"), "bo": a(lp + "self_attn.out_proj.bias"),
            "fc1_w": t(lp + "mlp.fc1.weight"), "fc1_b": a(lp + "mlp.fc1.bias"),
            "fc2_w": t(lp + "mlp.fc2.weight"), "fc2_b": a(lp + "mlp.fc2.bias"),
        })
    return {
        # conv weight [E, 3, P, P] -> [3*P*P, E], the (c, ph, pw) patch flatten
        "patch_w": pw.reshape(pw.shape[0], -1).T.to(device=device, dtype=dtype).contiguous(),
        "patch_b": a("embeddings.patch_embedding.bias"),
        "pos_embed": a("embeddings.position_embedding.weight"),
        "layers": tuple(layers),
        "post_ln_w": a("post_layernorm.weight"),
        "post_ln_b": a("post_layernorm.bias"),
        "mm_norm": mm("mm_soft_emb_norm.weight"),
        "mm_proj": mm("mm_input_projection_weight"),
    }


def text_state_dict(sd: dict) -> dict:
    """The language model's tensors under llama-style ``model.`` names."""
    lm_prefix = ("model.language_model." if any(k.startswith("model.language_model.") for k in sd)
                 else "language_model.model.")
    text_sd = {k.replace(lm_prefix, "model."): v for k, v in sd.items()
               if k.startswith(lm_prefix)}
    if "lm_head.weight" in sd:
        text_sd["lm_head.weight"] = sd["lm_head.weight"]
    return text_sd


def load_gemma3_vl(model_dir: str, *, dtype=torch.float32, device=None) -> Gemma3VLModel:
    """Load an HF Gemma3 (vision) checkpoint onto ``device`` (the card
    unless the caller asks for the CPU)."""
    from crane_tpu_torch.models.auto import (
        load_hf_config,
        load_state_dict,
        map_hf_weights,
        read_eos_ids,
    )

    device = default_device(device)
    hf = load_hf_config(model_dir)
    text_cfg, vision_cfg = text_config_from_hf(hf), siglip_config_from_hf(hf)
    sd = load_state_dict(model_dir)
    params = map_hf_weights(text_cfg, text_state_dict(sd), dtype, device)
    vision_params = map_siglip_weights(vision_cfg, sd, dtype, device)

    tokenizer = None
    try:
        from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir)
    except (ImportError, OSError, ValueError):
        tokenizer = None  # token ids only
    return Gemma3VLModel(
        text_cfg, vision_cfg, params, vision_params,
        image_token_id=hf.get("image_token_id", hf.get("image_token_index")),
        mm_tokens_per_image=hf.get("mm_tokens_per_image", 256),
        tokenizer=tokenizer, eos_token_ids=read_eos_ids(model_dir), dtype=dtype,
    )
