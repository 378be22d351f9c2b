"""Qwen3-VL: vision-language model (image chat / OCR).

Port of ``crane_tpu/models/qwen3_vl.py``. Reference behavior (crane-core
``src/models/qwen3_5/{vision,processor,vlm}.rs``): smart-resized
merge-block-major patches -> ViT + 2x2 merger -> image embeds spliced over
``<|image_pad|>`` positions -> 3-D MRoPE position ids (text advances the
counter, image spans use base + (t, h, w), the counter resumes at base + max
— get_rope_index, vlm.rs:187-235) -> greedy decode with a separately tracked
mrope position (decode position != token index, vlm.rs:288-299). Plus
Qwen3-VL DeepStack: mid-ViT features added to the first text layers at
visual positions.

The prefill runs eagerly over the cache (a continuation from position 0,
so its attention takes K3, as crane_tpu's ``use_flash_cached`` does). The
decode block, crane_tpu's ``lax.scan`` of 8 steps, is one CUDA-graph replay
on the card (:func:`crane_tpu_torch.models.graphs.dispatch`):
each step derives its 3-D position from the cache's lengths and the mrope
delta on the device, the delta being an input of the program. Single-sequence
generation, like the reference VLM path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.causal_lm import CausalLM
from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    forward_hidden,
    lm_logits,
)
from crane_tpu_torch.models.modules.vision import (
    VisionConfig,
    pos_embed_bilinear_taps,
    vision_forward,
    vision_rope_tables,
)
from crane_tpu_torch.ops.kv_cache import KVCache
from crane_tpu_torch.ops.rope import mrope_cos_sin
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.utils.device import default_device

# greedy tokens a decode block emits (one graph replay)
BLOCK = 8


class Qwen3VLModel:
    def __init__(
        self,
        text_config: TransformerConfig,
        vision_config: VisionConfig,
        params: dict,
        vision_params: dict,
        *,
        mrope_section: tuple[int, int, int] = (24, 20, 20),
        image_token_id: int,
        video_token_id: int,
        vision_start_token_id: int,
        tokenizer=None,
        eos_token_ids: Sequence[int] = (),
        dtype=torch.bfloat16,
    ):
        self.config = text_config
        self.vision_config = vision_config
        self.params = params
        self.vision_params = vision_params
        self.mrope_section = tuple(mrope_section)
        self.image_token_id = image_token_id
        self.video_token_id = video_token_id
        self.vision_start_token_id = vision_start_token_id
        self.tokenizer = tokenizer
        self.eos_token_ids = tuple(eos_token_ids)
        self.dtype = dtype
        # the text model: its rope tables and kept caches. crane_tpu's model
        # has no CausalLM, so nothing fuses: the forwards here read
        # self.params, and the helper shares them
        self.lm = CausalLM(text_config, params, tokenizer=tokenizer,
                           eos_token_ids=eos_token_ids, dtype=dtype, fuse=False)
        self.device = self.lm.device
        self.rope = self.lm.rope
        self._programs: dict = {}  # captured decode blocks (models/graphs.py)

    def release_graphs(self) -> None:
        """Drop the captured decode blocks and the kept caches."""
        self._programs.clear()
        self.lm.release_graphs()

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    # -- vision --------------------------------------------------------------
    @torch.no_grad()
    def encode_images(self, patches, grid_thw: tuple[int, int, int]):
        """patches ``[S, C*T*P*P]`` -> (features ``[S/4, E]``, deepstack)."""
        pos_idx, pos_w = pos_embed_bilinear_taps(self.vision_config, grid_thw)
        cos, sin = vision_rope_tables(self.vision_config, grid_thw)
        return vision_forward(
            self.vision_config, self.vision_params, self._t(patches, self.dtype),
            self._t(pos_idx), self._t(pos_w), self._t(cos), self._t(sin))

    # -- 3-D positions (host-side; numpy port of HF get_rope_index) ----------
    def get_rope_index(
        self, input_ids: np.ndarray, image_grid_thw, video_grid_thw=None
    ) -> tuple[np.ndarray, int]:
        """input_ids ``[S]`` -> (positions ``[3, S]``, mrope_delta).

        Videos are timestamp-separated in Qwen3-VL: each video frame is its
        own t=1 vision span (HF pre-splits video_grid_thw by t and zeroes the
        temporal index — temporal information lives in the timestamp text
        tokens between frames, not in the rope t channel)."""
        ids = list(np.asarray(input_ids).tolist())
        merge = self.vision_config.spatial_merge_size
        img_grids = [tuple(g) for g in (image_grid_thw or [])]
        vid_grids = []
        for t, h, w in (video_grid_thw or []):
            vid_grids.extend([(1, h, w)] * int(t))  # per-frame spans
        pos_chunks = []
        st, img_i, vid_i = 0, 0, 0
        for _ in range(len(img_grids) + len(vid_grids)):
            ed_img = ids.index(self.image_token_id, st) if (
                img_i < len(img_grids) and self.image_token_id in ids[st:]
            ) else len(ids) + 1
            ed_vid = ids.index(self.video_token_id, st) if (
                vid_i < len(vid_grids) and self.video_token_id in ids[st:]
            ) else len(ids) + 1
            if ed_img < ed_vid:
                t, h, w = img_grids[img_i]
                img_i += 1
                ed = ed_img
            else:
                t, h, w = vid_grids[vid_i]
                vid_i += 1
                ed = ed_vid
            gh, gw = h // merge, w // merge
            st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
            text_len = ed - st
            pos_chunks.append(np.tile(np.arange(text_len), (3, 1)) + st_idx)
            t_idx = np.repeat(np.arange(t), gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
            w_idx = np.tile(np.arange(gw), t * gh)
            pos_chunks.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + t * gh * gw
        if st < len(ids):
            st_idx = pos_chunks[-1].max() + 1 if pos_chunks else 0
            pos_chunks.append(np.tile(np.arange(len(ids) - st), (3, 1)) + st_idx)
        pos = np.concatenate(pos_chunks, axis=1).astype(np.int32)
        delta = int(pos.max()) + 1 - len(ids)
        return pos, delta

    # -- prefill and decode blocks -------------------------------------------
    @torch.no_grad()
    def prefill(self, cache: KVCache, embeds, cos, sin, deepstack, true_length: int):
        """The spliced prompt ``embeds [1, S_bucket, E]`` with its MRoPE
        tables ``[1, S_bucket, R/2]`` and DeepStack (mask, features) or
        None, from position 0 over the cache: (last-token logits ``[1, V]``,
        cache with lengths ``true_length``)."""
        cfg = self.config
        lengths = torch.full_like(cache.lengths, true_length)
        hidden, cache = forward_hidden(
            cfg, self.params, torch.zeros(embeds.shape[:2], dtype=torch.int32,
                                          device=self.device),
            cache, 0, self.rope, inputs_embeds=embeds,
            rope_embeds={"cos": cos, "sin": sin}, deepstack=deepstack,
            true_lengths=lengths)
        cache.lengths = lengths
        return lm_logits(cfg, self.params, hidden[:, true_length - 1:true_length])[:, 0], cache

    def _decode_body(self, *, layers, n_steps, tokens, lengths, pos_delta, active, out):
        """``n_steps`` greedy steps (crane_tpu's ``_vlm_decode_block``): the
        decode position is the token index plus the mrope delta, all three
        streams equal, computed on the device from the cache's lengths."""
        cfg = self.config
        cache = KVCache(layers=layers, lengths=lengths)
        tok = tokens
        for i in range(n_steps):
            p = (cache.lengths + pos_delta).to(torch.int32)
            cos, sin = mrope_cos_sin(p[None, :, None].expand(3, -1, 1), cfg.rot_dim,
                                     self.mrope_section, theta=cfg.rope_theta)
            hidden, cache = forward_hidden(cfg, self.params, tok[:, None], cache,
                                           cache.lengths, self.rope, active=active,
                                           rope_embeds={"cos": cos, "sin": sin})
            nxt = torch.argmax(lm_logits(cfg, self.params, hidden)[:, 0], -1).to(torch.int32)
            tok = torch.where(active, nxt, tok)
            out[:, i] = tok
        lengths.copy_(cache.lengths)

    @torch.no_grad()
    def decode_block(self, cache: KVCache, tokens: torch.Tensor, pos_delta: torch.Tensor,
                     n_steps: int = BLOCK) -> torch.Tensor:
        """``n_steps`` greedy tokens ``[B, n_steps]`` after ``tokens [B]``:
        one graph replay on the card; the cache's lengths roll in place."""
        B = tokens.shape[0]
        inputs = dict(tokens=tokens, lengths=cache.lengths, pos_delta=pos_delta,
                      active=torch.ones((B,), dtype=torch.bool, device=self.device))
        return graphs.dispatch(self._programs, self.device, "vlm_decode", self._decode_body,
                               cache, inputs, {"out": ((B, n_steps), torch.int32)},
                               n_steps=n_steps)["out"]

    # -- generation ----------------------------------------------------------
    @torch.no_grad()
    def prompt_inputs(self, input_ids: Sequence[int], images: Optional[list] = None,
                      videos: Optional[list] = None):
        """The prefill's inputs for a prompt with its images and videos:
        (embeds ``[1, S_bucket, E]`` with the visual features spliced in,
        MRoPE cos and sin ``[1, S_bucket, R/2]``, DeepStack (mask,
        features) or None, the mrope delta). ``images``/``videos`` are
        lists of ``(patches, grid_thw)``; video grids have t > 1 (frames /
        temporal_patch_size) and splice at ``video_token_id`` pads.
        DeepStack features from both modalities are merged in token-position
        order (HF Qwen3VLModel.forward semantics)."""
        ids = np.asarray(list(input_ids), np.int32)
        S = len(ids)
        cfg = self.config

        def encode_all(items):
            feats, deeps, grids = [], [], []
            for patches, grid in items or []:
                f, dsk = self.encode_images(patches, grid)
                feats.append(f)
                deeps.append(dsk)
                grids.append(grid)
            return feats, deeps, grids

        img_feats, img_deep, img_grids = encode_all(images)
        # video frames are separate attention blocks in the vision tower (HF
        # builds per-frame cu_seqlens), so each frame is encoded on its own
        per_frame = []
        for patches, (t, h, w) in videos or []:
            fp = np.asarray(patches).reshape(t, h * w, -1)
            per_frame.extend((fp[i], (1, h, w)) for i in range(t))
        vid_feats, vid_deep, _ = encode_all(per_frame)
        vid_grids = [grid for _, grid in (videos or [])]

        embeds = self.params["embed"][self._t(ids).long()][None].to(self.dtype)
        img_mask = ids == self.image_token_id
        vid_mask = ids == self.video_token_id
        mask = img_mask | vid_mask
        deep_parts = []  # (positions, deepstack [L, n, E]) per modality
        for m, feats_list, deep_list in (
            (img_mask, img_feats, img_deep), (vid_mask, vid_feats, vid_deep)
        ):
            if not feats_list:
                continue
            feats = torch.cat(feats_list, dim=0)
            (pos,) = np.where(m)
            if len(pos) != feats.shape[0]:
                raise ValueError(f"{len(pos)} placeholder tokens for {feats.shape[0]} "
                                 f"visual features")
            embeds[0, self._t(pos).long()] = feats.to(self.dtype)
            deep_parts.append((pos, torch.cat(deep_list, dim=1)))

        pos3, delta = self.get_rope_index(ids, img_grids, vid_grids)
        pad = bucket_length(S, floor=64) - S
        embeds = torch.nn.functional.pad(embeds, (0, 0, 0, pad))
        deepstack = None
        if deep_parts:
            # merge deepstack features in token-position order across modalities
            (all_pos,) = np.where(mask)
            merged = torch.zeros((deep_parts[0][1].shape[0], len(all_pos), cfg.hidden_size),
                                 dtype=self.dtype, device=self.device)
            lookup = {p: i for i, p in enumerate(all_pos)}
            for pos, d in deep_parts:
                merged[:, self._t([lookup[p] for p in pos]).long()] = d.to(self.dtype)
            deepstack = (self._t(np.pad(mask, (0, pad)))[None], merged)
        cos, sin = mrope_cos_sin(self._t(np.pad(pos3, ((0, 0), (0, pad))))[:, None, :],
                                 cfg.rot_dim, self.mrope_section, theta=cfg.rope_theta)
        return embeds, cos, sin, deepstack, delta

    @torch.no_grad()
    def generate(
        self,
        input_ids: Sequence[int],
        images: Optional[list] = None,
        gen: GenerationConfig | None = None,
        streamer=None,
        videos: Optional[list] = None,
    ) -> list[int]:
        """Greedy decode with spliced image/video embeds (single sequence;
        inputs as :meth:`prompt_inputs` takes them). The batch-1 cache is
        kept per length across calls (as ``CausalLM.generate`` keeps its
        own), so calls must not overlap."""
        gen = gen or GenerationConfig()
        eos = set(gen.eos_token_ids) | set(self.eos_token_ids)
        S = len(input_ids)
        embeds, cos, sin, deepstack, delta = self.prompt_inputs(input_ids, images, videos)
        cache, _ = self.lm._generate_cache(bucket_length(S + gen.max_new_tokens, floor=256),
                                           None)
        logits, cache = self.prefill(cache, embeds, cos, sin, deepstack, S)
        tok = int(torch.argmax(logits, -1)[0])

        # block decode: BLOCK tokens a replay; EOS is detected on the host
        # within the block and the overrun tokens are dropped
        if gen.max_new_tokens <= 0:
            if streamer is not None:
                streamer.finalize()
            return []
        out = [tok]
        stopped = (streamer is not None and streamer.append(tok) is False) or tok in eos
        cur = self._t([tok], torch.int32)
        pos_delta = self._t([delta], torch.int32)
        while not stopped and len(out) < gen.max_new_tokens:
            toks = self.decode_block(cache, cur, pos_delta)
            cur = toks[:, -1]
            for t in toks[0].tolist():
                if len(out) >= gen.max_new_tokens:
                    stopped = True
                    break
                out.append(int(t))
                if streamer is not None and streamer.append(out[-1]) is False:
                    stopped = True
                    break
                if out[-1] in eos:
                    stopped = True
                    break
        if streamer is not None:
            streamer.finalize()
        return out


# -- loading -----------------------------------------------------------------


def text_config_from_hf(hf: dict) -> TransformerConfig:
    """The text model's config from a Qwen3-VL ``config.json``."""
    tc = hf["text_config"]
    return TransformerConfig(
        vocab_size=tc["vocab_size"],
        hidden_size=tc["hidden_size"],
        num_layers=tc["num_hidden_layers"],
        num_heads=tc["num_attention_heads"],
        num_kv_heads=tc.get("num_key_value_heads", tc["num_attention_heads"]),
        head_dim=tc.get("head_dim") or tc["hidden_size"] // tc["num_attention_heads"],
        intermediate_size=tc["intermediate_size"],
        rms_norm_eps=tc.get("rms_norm_eps", 1e-6),
        rope_theta=tc.get("rope_theta", 5_000_000.0),
        max_position_embeddings=tc.get("max_position_embeddings", 128000),
        qk_norm=True,
        tie_word_embeddings=hf.get("tie_word_embeddings", tc.get("tie_word_embeddings", False)),
    )


def vision_config_from_hf(hf: dict) -> VisionConfig:
    """The vision tower's config from a Qwen3-VL ``config.json``."""
    vc = hf["vision_config"]
    act = vc.get("hidden_act", "gelu_pytorch_tanh")
    return VisionConfig(
        depth=vc["depth"],
        hidden_size=vc["hidden_size"],
        intermediate_size=vc["intermediate_size"],
        num_heads=vc["num_heads"],
        patch_size=vc["patch_size"],
        temporal_patch_size=vc["temporal_patch_size"],
        spatial_merge_size=vc["spatial_merge_size"],
        out_hidden_size=vc["out_hidden_size"],
        in_channels=vc.get("in_channels", 3),
        num_position_embeddings=vc["num_position_embeddings"],
        deepstack_indexes=tuple(vc.get("deepstack_visual_indexes", ())),
        act="gelu_tanh" if act == "gelu_pytorch_tanh" else act,
    )


def map_vision_weights(vision_cfg: VisionConfig, sd: dict, dtype=torch.bfloat16,
                       device=None) -> dict:
    """The ``model.visual.`` tensors of an HF Qwen3-VL checkpoint -> the
    tower's tree (``[in, out]`` linears)."""
    def v(n):
        return torch.as_tensor(sd["model.visual." + n])

    def t(n):
        return v(n).T.to(device=device, dtype=dtype).contiguous()

    def a(n):
        return v(n).to(device=device, dtype=dtype)

    def merger_params(prefix):
        return {
            "ln_w": a(prefix + ".norm.weight"), "ln_b": a(prefix + ".norm.bias"),
            "fc1_w": t(prefix + ".linear_fc1.weight"), "fc1_b": a(prefix + ".linear_fc1.bias"),
            "fc2_w": t(prefix + ".linear_fc2.weight"), "fc2_b": a(prefix + ".linear_fc2.bias"),
        }

    blocks = []
    for i in range(vision_cfg.depth):
        b = f"blocks.{i}."
        blocks.append({
            "ln1_w": a(b + "norm1.weight"), "ln1_b": a(b + "norm1.bias"),
            "ln2_w": a(b + "norm2.weight"), "ln2_b": a(b + "norm2.bias"),
            "qkv_w": t(b + "attn.qkv.weight"), "qkv_b": a(b + "attn.qkv.bias"),
            "proj_w": t(b + "attn.proj.weight"), "proj_b": a(b + "attn.proj.bias"),
            "fc1_w": t(b + "mlp.linear_fc1.weight"), "fc1_b": a(b + "mlp.linear_fc1.bias"),
            "fc2_w": t(b + "mlp.linear_fc2.weight"), "fc2_b": a(b + "mlp.linear_fc2.bias"),
        })
    # Conv3d [E, C, T, P, P] with kernel == stride -> one product over
    # patches laid out (c, t, p_h, p_w), patchify's order
    pw = v("patch_embed.proj.weight")
    return {
        "patch_w": pw.reshape(pw.shape[0], -1).T.to(device=device, dtype=dtype).contiguous(),
        "patch_b": a("patch_embed.proj.bias"),
        "pos_embed": a("pos_embed.weight"),
        "blocks": tuple(blocks),
        "merger": merger_params("merger"),
        "deepstack": tuple(merger_params(f"deepstack_merger_list.{j}")
                           for j in range(len(vision_cfg.deepstack_indexes))),
    }


def load_qwen3_vl(model_dir: str, *, dtype=torch.bfloat16, device=None) -> Qwen3VLModel:
    """Load a Qwen3-VL checkpoint onto ``device`` (the card unless the
    caller asks for the CPU)."""
    from crane_tpu_torch.models.auto import (
        load_hf_config,
        load_state_dict,
        map_hf_weights,
        read_eos_ids,
    )

    device = default_device(device)
    hf = load_hf_config(model_dir)
    text_cfg, vision_cfg = text_config_from_hf(hf), vision_config_from_hf(hf)
    sd = load_state_dict(model_dir)
    # text weights use the standard llama-style names under language_model.
    text_sd = {k.replace("model.language_model.", "model."): v for k, v in sd.items()
               if k.startswith("model.language_model.")}
    if "lm_head.weight" in sd:
        text_sd["lm_head.weight"] = sd["lm_head.weight"]
    params = map_hf_weights(text_cfg, text_sd, dtype, device)
    vision_params = map_vision_weights(vision_cfg, sd, dtype, device)

    tokenizer = None
    try:
        from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir)
    except (ImportError, OSError, ValueError):
        tokenizer = None  # token ids only

    rs = hf["text_config"].get("rope_scaling") or {}
    return Qwen3VLModel(
        text_cfg, vision_cfg, params, vision_params,
        mrope_section=tuple(rs.get("mrope_section", (24, 20, 20))),
        image_token_id=hf["image_token_id"],
        video_token_id=hf.get("video_token_id", -1),
        vision_start_token_id=hf.get("vision_start_token_id", -1),
        tokenizer=tokenizer,
        eos_token_ids=read_eos_ids(model_dir),
        dtype=dtype,
    )
