"""Qwen3-TTS: Talker + CodePredictor two-level autoregressive synthesis.

Port of ``crane_tpu/models/qwen3_tts.py``. Reference behavior (crane-core
``src/models/qwen3_tts/modeling.rs``): a 12.5 Hz frame loop where the
**Talker** (Qwen3-style decoder with QK-norm, rope theta 1e6) predicts the
first codebook token from its last hidden state (:473-744), and the
**CodePredictor** (small decoder sharing the same block, one lm_head +
codec_embedding per group) autoregressively fills the other
``num_code_groups-1`` codebooks conditioned on the talker hidden + code-0
embedding (:259-472). The next talker input is the SUM of all 16 codec
embeddings plus the next trailing-text embedding (streaming text guidance,
:1440-1456).

Prefill layout (:579-715): role prefix ``text_proj([im_start, assistant,
newline])`` + codec control tokens ``[think/nothink, think_bos, (lang,)
think_eos, (spk,) pad, bos]`` overlaid with ``tts_pad``*(n-2)+``tts_bos``
projections + (first text token + codec_bos).

Sampling matches the vendor defaults: top-k 50 then top-p with temperature
(:1360-1367), suppress of the last-1024 control ids except EOS, EOS
suppressed for the first 2 frames (min_new_tokens=2, :1370-1384);
repetition penalty on a 128-code window of code-0 history. The predictor's
own window is four ``-1`` slots that are never filled, as in crane_tpu.

Device programs. Both transformers run through the shared
``forward_hidden``: the talker's prefill is a continuation over its cache
(K3), each talker step and each predictor step is a one-token decode (K1),
and the predictor's two-token prefill is a continuation over its 32-slot
cache (K3 at S=2). crane_tpu runs ``n_frames`` whole frames in one
``lax.scan`` (``_gen_frame_block``); here such a block is one replay of one
CUDA graph on the card (``graphs.dispatch``, kind ``tts_frames``), and
``generate_one_frame`` is a block of one frame. Inside a block nothing is
read on the host: the frame step and the trailing-guidance row are device
tensors, EOS is a flag per frame that the host reads after the block and
truncates at (a block runs past EOS, and the state is then finished). The
model owns one 32-slot predictor cache, rewritten from slot 0 each frame, so
the captured programs read the same buffers every replay; the talker cache
and the sampling ``torch.Generator`` are kept per cache length and reset by
each ``prepare_streaming``, which makes its state their owner: a state whose
kept cache a newer stream of the same length took raises in
``generate_frames``. Calls on one model therefore must not overlap.
Sampling draws from that generator in the same order on the block path and
the one-frame path, so both give the same codes from one seed; the numbers
are not ``jax.random``'s (ROADMAP Queue 3).

Streaming: ``prepare_streaming`` / ``generate_frames`` /
``generate_one_frame`` (:1497-1658) expose the frame loop the serving layer
streams from. Voice clone (:746-915, :1659-1760): ECAPA x-vector spliced
into the codec prefix, ICL prompt = [ref_text + target_text + tts_eos]
overlaid on [codec_bos + summed ref codec embeds].

Checkpoint layout is the released HF ``Qwen3TTSForConditionalGeneration``:
``talker.model.*`` / ``talker.codec_head`` / ``talker.text_projection`` /
``talker.code_predictor.*`` / ``speaker_encoder.*``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.generation.config import SpeechOptions
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    forward_hidden,
    make_cache,
    make_rope_tables,
)
from crane_tpu_torch.ops.kv_cache import KVCache
from crane_tpu_torch.ops.sampling import SamplingParams, sample, update_recent
from crane_tpu_torch.utils.buckets import bucket_length
from crane_tpu_torch.utils.device import default_device

ROLE_PREFIX_IDS = (151644, 77091, 198)  # <|im_start|>, "assistant", "\n"
REP_WINDOW = 128  # code-0 repetition-penalty window (static shape)
PRED_SLOTS = 32  # the code predictor's cache: 2 prefill tokens + 15 steps fit

# ISO 639-1 <-> the full English names codec_language_id uses as keys
# (reference crane/src/audio/tts_qwen3.rs:16-59); unknown codes, "auto", and
# already-full names pass through unchanged so both formats work.
LANGUAGE_NAME_TO_CODE = {
    "chinese": "zh", "english": "en", "german": "de", "italian": "it",
    "portuguese": "pt", "spanish": "es", "japanese": "ja", "korean": "ko",
    "french": "fr", "russian": "ru",
}
LANGUAGE_CODE_TO_NAME = {v: k for k, v in LANGUAGE_NAME_TO_CODE.items()}


@dataclasses.dataclass
class TalkerSpecials:
    """Non-hashable config bits: control-token ids and name maps."""

    vocab_size: int
    codec_eos: int
    codec_think: int
    codec_nothink: int
    codec_think_bos: int
    codec_think_eos: int
    codec_pad: int
    codec_bos: int
    language_ids: dict
    speaker_ids: dict
    spk_is_dialect: dict
    tts_bos: int = 151672
    tts_eos: int = 151673
    tts_pad: int = 151671


def _tcfg_from_hf(c: dict) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim", 128),
        intermediate_size=c["intermediate_size"],
        rms_norm_eps=c.get("rms_norm_eps", 1e-6),
        rope_theta=c.get("rope_theta", 1e6),
        max_position_embeddings=c.get("max_position_embeddings", 32768),
        qk_norm=True,
        attn_bias=c.get("attention_bias", False),
        tie_word_embeddings=False,
    )


# ── device steps ──────────────────────────────────────────────────────────


@torch.no_grad()
def _prefill_embeds(cfg, params, rope, cache, embeds, true_length: int):
    """The bucket-padded prompt embeddings ``[1, S_bucket, D]`` from
    position 0 over the cache (K3): (the last real position's hidden
    ``[1, 1, D]``, the cache with its lengths at ``true_length``)."""
    B, S, _ = embeds.shape
    tokens = torch.zeros((B, S), dtype=torch.int32, device=embeds.device)
    lengths = torch.full((B,), true_length, dtype=torch.int32, device=embeds.device)
    hidden, cache = forward_hidden(cfg, params, tokens, cache, 0, rope, inputs_embeds=embeds,
                                   true_lengths=lengths)
    cache.lengths = lengths
    return hidden[:, true_length - 1:true_length], cache


def _step_embed(cfg, params, rope, cache, embed, active=None):
    """One talker step from the input embedding ``[1, 1, D]`` (K1):
    (hidden ``[1, 1, D]``, cache with its lengths advanced)."""
    tokens = torch.zeros((1, 1), dtype=torch.int32, device=embed.device)
    return forward_hidden(cfg, params, tokens, cache, cache.lengths, rope, inputs_embeds=embed,
                          active=active)


def _sample_first_code(params, hidden, recent, generator, suppress, eos_suppress, step, sp):
    """codec_head logits + suppress masks + top-k/top-p sample -> code0 ``[1]``."""
    logits = (hidden[:, 0] @ params["codec_head"]).float()
    logits = logits + suppress[None, :]
    logits = torch.where(step[:, None] < 2, logits + eos_suppress[None, :], logits)
    return sample(logits, sp, recent, generator)


def _predict_rest_codes(pcfg, n_groups, p, rope, pred_layers, talker_hidden, code0,
                        generator, sp):
    """CodePredictor: 2-token prefill [talker_hidden, embed(code0)] over the
    predictor cache from slot 0 (K3), then n_groups-1 steps (K1) with the
    per-group heads and embeddings. Returns the codes ``[n_groups - 1]``."""
    def proj(x):
        return x if "mtp_w" not in p else x @ p["mtp_w"] + p["mtp_b"]

    device = talker_hidden.device
    e0 = p["codec_embedding0"][code0.long()][:, None, :]  # [1, 1, Dt]
    pre = proj(torch.cat([talker_hidden, e0], dim=1)).to(p["tree"]["embed"].dtype)
    cache = KVCache(layers=pred_layers, lengths=torch.zeros((1,), dtype=torch.int32,
                                                             device=device))
    hidden, cache = forward_hidden(pcfg, p["tree"], torch.zeros((1, 2), dtype=torch.int32,
                                                                device=device),
                                   cache, 0, rope, inputs_embeds=pre)
    h = hidden[:, -1:]
    recent = torch.full((1, 4), -1, dtype=torch.int32, device=device)
    codes = []
    for g in range(n_groups - 1):
        logits = (h[:, 0] @ p["lm_heads"][g]).float()
        code = sample(logits, sp, recent, generator)
        emb = proj(p["codec_embeddings"][g][code.long()][:, None, :]).to(h.dtype)
        h, cache = _step_embed(pcfg, p["tree"], rope, cache, emb)
        codes.append(code)
    return torch.cat(codes)


def _advance_frame(tcfg, pcfg, n_groups, params, rope, pred_rope, talker_cache, pred_layers,
                   talker_hidden, code0, guidance, generator, sp, active):
    """One frame after code 0: the CodePredictor's rest codes, the summed
    codec embedding plus the guidance row, and a talker step (its KV write
    dropped for an inactive row). Returns (rest ``[n_groups - 1]``, hidden
    ``[1, 1, D]``, talker cache)."""
    p = params["pred"]
    rest = _predict_rest_codes(pcfg, n_groups, p, pred_rope, pred_layers, talker_hidden, code0,
                               generator, sp)
    emb = params["talker"]["tree"]["embed"][code0.long()][:, None, :]
    groups = torch.arange(n_groups - 1, device=rest.device)
    emb = emb + p["codec_embeddings"][groups, rest.long()].sum(dim=0)[None, None, :]
    emb = emb + guidance
    hidden, cache = _step_embed(tcfg, params["talker"]["tree"], rope, talker_cache,
                                emb.to(talker_hidden.dtype), active)
    return rest, hidden, cache


@dataclasses.dataclass
class StreamingState:
    """prepare_streaming/generate_one_frame state (reference :1225-1248)."""

    cache: KVCache
    past_hidden: torch.Tensor  # [1, 1, D]
    step: int
    trailing: torch.Tensor  # [1, n_trailing, D]
    tts_pad_embed: torch.Tensor  # [1, 1, D]
    recent0: torch.Tensor  # [1, REP_WINDOW] code-0 repetition window
    generator: torch.Generator
    sp: SamplingParams
    codes: list
    # trailing + tts_pad pre-concatenated to a bucketed length so a frame
    # block reads each step's guidance row on the device
    trailing_pad: torch.Tensor
    finished: bool = False
    ticket: int = -1  # prepare_streaming's mark of the owner of the kept cache


class Qwen3TTSModel:
    """The talker, the code predictor and (optionally) the speech decoder,
    speaker encoder and reference encoder, on the parameters' device."""

    def __init__(
        self,
        talker_cfg: TransformerConfig,
        pred_cfg: TransformerConfig,
        specials: TalkerSpecials,
        params: dict,
        *,
        num_code_groups: int = 16,
        tokenizer=None,
        decoder=None,
        speaker_encoder=None,
        dtype=torch.float32,
    ):
        self.tcfg = talker_cfg
        self.pcfg = pred_cfg
        self.sp_tokens = specials
        self.params = params
        self.num_code_groups = num_code_groups
        self.tokenizer = tokenizer
        self.decoder = decoder
        self.speaker_encoder = speaker_encoder
        self.dtype = dtype
        self.device = params["talker"]["codec_head"].device
        self.rope = make_rope_tables(talker_cfg, self.device)
        self.pred_rope = make_rope_tables(pred_cfg, self.device)
        # optional audio -> [T, n_groups] codes encoder (Mimi-style, from the
        # speech tokenizer's encoder weights) for voice-clone reference audio
        self.ref_encoder = None

        V = specials.vocab_size
        sup = np.zeros(V, np.float32)
        sup[max(V - 1024, 0):] = -np.inf
        sup[specials.codec_eos] = 0.0
        self._suppress = torch.as_tensor(sup, device=self.device)
        eos_m = np.zeros(V, np.float32)
        eos_m[specials.codec_eos] = -np.inf
        self._eos_suppress = torch.as_tensor(eos_m, device=self.device)
        self._programs: dict = {}  # the captured frame blocks (models/graphs.py)
        self._streams: dict = {}  # max_seq -> [talker cache, generator, owner's ticket]
        self._tickets = 0
        self._pred_cache = make_cache(pred_cfg, 1, PRED_SLOTS, dtype, device=self.device)

    def release_graphs(self) -> None:
        """Drop the captured frame blocks and the kept talker caches."""
        self._programs.clear()
        self._streams.clear()

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(list(ids), np.int64), device=self.device)

    # ── embedding helpers ────────────────────────────────────────────────
    def _text_proj(self, emb: torch.Tensor) -> torch.Tensor:
        p = self.params["talker"]
        return F.silu(emb @ p["text_fc1_w"] + p["text_fc1_b"]) @ p["text_fc2_w"] + p["text_fc2_b"]

    def _text_embed(self, ids) -> torch.Tensor:
        return self._text_proj(self.params["talker"]["text_embedding"][self._ids(ids)][None])

    def _codec_embed(self, ids) -> torch.Tensor:
        return self.params["talker"]["tree"]["embed"][self._ids(ids)][None]

    def _language_id(self, language: str, speaker: Optional[str]) -> Optional[int]:
        s = self.sp_tokens
        lang = LANGUAGE_CODE_TO_NAME.get(language.lower(), language.lower())
        lid = None if lang == "auto" else s.language_ids.get(lang)
        if speaker and lang in ("chinese", "auto"):
            d = s.spk_is_dialect.get(speaker.lower())
            if isinstance(d, str):
                lid = s.language_ids.get(d, lid)
        return lid

    @torch.no_grad()
    def build_prefill_embeds(self, text_ids: Sequence[int], language: str,
                             speaker: Optional[str]):
        """Reference build_prefill_embeds (:579-715). Returns
        (prefill [1,S,D], trailing [1,N,D], tts_pad [1,1,D])."""
        s = self.sp_tokens
        role = self._text_embed(ROLE_PREFIX_IDS)  # [1, 3, D]
        tts = self._text_embed([s.tts_pad, s.tts_bos, s.tts_eos])
        tts_pad, tts_bos, tts_eos = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]

        lid = self._language_id(language, speaker)
        sid = s.speaker_ids.get(speaker.lower()) if speaker else None
        codec_ids = (
            [s.codec_think, s.codec_think_bos, lid, s.codec_think_eos]
            if lid is not None
            else [s.codec_nothink, s.codec_think_bos, s.codec_think_eos]
        )
        if sid is not None:
            codec_ids.append(sid)
        codec_ids += [s.codec_pad, s.codec_bos]
        codec = self._codec_embed(codec_ids)  # [1, N, D]
        n = codec.shape[1]
        overlay = torch.cat([tts_pad.expand(1, n - 2, tts_pad.shape[2]), tts_bos], dim=1)
        codec_hidden = overlay + codec[:, : n - 1]

        text_ids = list(text_ids)
        first = (self._text_embed(text_ids[:1]) if text_ids else tts_pad) + codec[:, n - 1:]
        prefill = torch.cat([role, codec_hidden, first], dim=1)
        if len(text_ids) > 1:
            trailing = torch.cat([self._text_embed(text_ids[1:]), tts_eos], dim=1)
        else:
            trailing = tts_eos
        return prefill.to(self.dtype), trailing.to(self.dtype), tts_pad.to(self.dtype)

    # ── streaming loop ───────────────────────────────────────────────────
    def _stream(self, max_seq: int):
        """The kept talker cache and generator for ``max_seq`` slots (so a
        second stream of the same length replays the blocks the first
        captured, as a jitted function compiles once)."""
        if max_seq not in self._streams:
            self._streams[max_seq] = [
                make_cache(self.tcfg, 1, max_seq, self.dtype, device=self.device),
                torch.Generator(device=self.device), -1]
        return self._streams[max_seq]

    @torch.no_grad()
    def prepare_streaming(
        self,
        text_ids: Sequence[int],
        language: str = "auto",
        speaker: Optional[str] = None,
        opts: SpeechOptions | None = None,
        *,
        prefill_embeds: torch.Tensor | None = None,
        trailing: torch.Tensor | None = None,
        tts_pad: torch.Tensor | None = None,
    ) -> StreamingState:
        """Prefill the talker (K3) over the kept cache of
        ``bucket_length(S + max_new_tokens, floor=512)`` slots, reseed the
        kept generator from ``opts.seed`` and return the stream's state, their
        owner. A new stream of the same cache length resets them and takes
        them over: the previous state's ``generate_frames`` then raises."""
        opts = opts or SpeechOptions()
        if prefill_embeds is None:
            prefill_embeds, trailing, tts_pad = self.build_prefill_embeds(
                text_ids, language, speaker)
        S = prefill_embeds.shape[1]
        padded = F.pad(prefill_embeds, (0, 0, 0, bucket_length(S, floor=32) - S))
        max_new = opts.max_new_tokens
        kept = self._stream(bucket_length(S + max_new, floor=512))
        cache, generator = kept[0], kept[1]
        self._tickets += 1
        kept[2] = self._tickets
        cache.lengths.zero_()
        generator.manual_seed(opts.seed)
        hidden, cache = _prefill_embeds(self.tcfg, self.params["talker"]["tree"], self.rope,
                                        cache, padded, S)
        sp = SamplingParams.make(
            1,
            temperature=opts.temperature or 0.9,
            top_k=50,
            top_p=opts.top_p or 1.0,
            repetition_penalty=opts.repetition_penalty or 1.0,
            do_sample=True,
            device=self.device,
        )
        n_total = bucket_length(trailing.shape[1] + max_new + 1, floor=256)
        trailing_pad = torch.cat(
            [trailing, tts_pad.expand(1, n_total - trailing.shape[1], tts_pad.shape[2])], dim=1)
        return StreamingState(
            cache=cache,
            past_hidden=hidden,
            step=0,
            trailing=trailing,
            tts_pad_embed=tts_pad,
            recent0=torch.full((1, REP_WINDOW), -1, dtype=torch.int32, device=self.device),
            generator=generator,
            sp=sp,
            codes=[],
            trailing_pad=trailing_pad,
            ticket=self._tickets,
        )

    def _frame_block_body(self, *, layers, generator, n_frames, hidden, recent, step, lengths,
                          active, trailing_pad, temperature, top_k, top_p, repetition_penalty,
                          do_sample, frames, eos, hidden_out):
        """``n_frames`` whole frames (crane_tpu's ``_gen_frame_block``): per
        frame, code 0 sampled, the predictor's rest codes, the summed codec
        embedding plus the guidance row at ``step``, a talker step. Frame i's
        codes go to ``frames[i]``, its EOS flag to ``eos[i]``; ``lengths``
        and ``recent`` roll in place and the last hidden goes to
        ``hidden_out``. Runs past EOS: the host truncates."""
        sp = SamplingParams(temperature, top_k, top_p, repetition_penalty, do_sample)
        n_talker = self.tcfg.num_layers
        cache = KVCache(layers=layers[:n_talker], lengths=lengths)
        pred_layers = layers[n_talker:]
        last = trailing_pad.shape[1] - 1
        h, rec, st = hidden, recent, step
        for i in range(n_frames):
            code0 = _sample_first_code(self.params["talker"], h, rec, generator, self._suppress,
                                       self._eos_suppress, st, sp)
            eos[i] = code0[0] == self.sp_tokens.codec_eos
            # jax's dynamic_slice clamps a start past the end; so does this
            guidance = trailing_pad.index_select(1, st.clamp(max=last).long())
            rest, h, cache = _advance_frame(self.tcfg, self.pcfg, self.num_code_groups,
                                            self.params, self.rope, self.pred_rope, cache,
                                            pred_layers, h, code0, guidance, generator, sp,
                                            active)
            rec = update_recent(rec, code0)
            frames[i, 0] = code0[0]
            frames[i, 1:] = rest
            st = st + 1
        lengths.copy_(cache.lengths)
        recent.copy_(rec)
        hidden_out.copy_(h)

    @torch.no_grad()
    def generate_frames(self, state: StreamingState, n_frames: int = 8) -> Optional[np.ndarray]:
        """Up to ``n_frames`` frames in one block (one graph replay on the
        card). Returns ``[k, num_code_groups]`` int32 with ``k < n_frames``
        iff EOS was hit inside the block, or ``None`` if the very first
        frame was EOS / the state is finished. Raises ``RuntimeError`` if a
        newer ``prepare_streaming`` took the state's kept cache over."""
        if state.finished:
            return None
        kept = self._streams.get(state.cache.max_seq)
        if kept is not None and kept[1] is state.generator and kept[2] != state.ticket:
            raise RuntimeError(
                "this stream's talker cache and generator were taken over by a newer "
                "prepare_streaming of the same length; streams of one length on one model "
                "run one after another")
        inputs = dict(
            hidden=state.past_hidden, recent=state.recent0,
            step=torch.tensor([state.step], dtype=torch.int32, device=self.device),
            lengths=state.cache.lengths,
            active=torch.ones((1,), dtype=torch.bool, device=self.device),
            trailing_pad=state.trailing_pad, **vars(state.sp))
        both = KVCache(layers=tuple(state.cache.layers) + tuple(self._pred_cache.layers),
                       lengths=state.cache.lengths)
        res = graphs.dispatch(
            self._programs, self.device, "tts_frames", self._frame_block_body, both, inputs,
            {"frames": ((n_frames, self.num_code_groups), torch.int32),
             "eos": ((n_frames,), torch.bool),
             "hidden_out": (tuple(state.past_hidden.shape), state.past_hidden.dtype)},
            generator=state.generator, n_frames=n_frames)
        state.past_hidden = res["hidden_out"]
        eos_np = res["eos"].cpu().numpy()
        k = int(np.argmax(eos_np)) if eos_np.any() else n_frames
        state.step += k  # host view: frames actually kept
        if k < n_frames:
            state.finished = True  # device state ran past EOS; do not resume
        if k == 0:
            return None
        out = res["frames"][:k].cpu().numpy().astype(np.int32)
        state.codes.extend(out.tolist())
        return out

    def generate_one_frame(self, state: StreamingState) -> Optional[list[int]]:
        """One 12.5 Hz frame (a block of one, one graph replay on the card):
        the frame's codes, or None on EOS. Reference :1575-1651. The random
        draws are the block path's, in its order."""
        out = self.generate_frames(state, 1)
        return None if out is None else out[0].tolist()

    def generate_speech_codes(
        self,
        text_ids: Sequence[int],
        language: str = "auto",
        speaker: Optional[str] = None,
        opts: SpeechOptions | None = None,
        *,
        block_frames: int = 16,
    ) -> np.ndarray:
        """Block loop over :meth:`generate_frames` (reference's per-frame
        loop, :1327-1490, in device-side blocks). Returns
        ``[T, num_code_groups]`` int32."""
        opts = opts or SpeechOptions()
        state = self.prepare_streaming(text_ids, language, speaker, opts)
        budget = opts.max_new_tokens
        while budget > 0:
            out = self.generate_frames(state, block_frames)  # fixed block size
            if out is None or state.finished:
                break
            budget -= len(out)
        codes = np.asarray(state.codes, np.int32).reshape(-1, self.num_code_groups)
        return codes[: opts.max_new_tokens]

    # ── voice clone (ICL) ────────────────────────────────────────────────
    @torch.no_grad()
    def build_voice_clone_prefill(self, spk_embed, language: str):
        """Reference :746-827: role prefix + codec control tokens with the
        speaker x-vector spliced between think_eos and pad; no codec_bos."""
        s = self.sp_tokens
        role = self._text_embed(ROLE_PREFIX_IDS)
        tts = self._text_embed([s.tts_pad, s.tts_bos])
        tts_pad, tts_bos = tts[:, 0:1], tts[:, 1:2]
        lid = self._language_id(language, None)
        prefix_ids = (
            [s.codec_think, s.codec_think_bos, lid, s.codec_think_eos]
            if lid is not None
            else [s.codec_nothink, s.codec_think_bos, s.codec_think_eos]
        )
        prefix = self._codec_embed(prefix_ids)
        spk = torch.as_tensor(np.asarray(spk_embed, np.float32), device=self.device) \
            .reshape(1, 1, -1).to(prefix.dtype)
        suffix = self._codec_embed([s.codec_pad, s.codec_bos])
        codec_full = torch.cat([prefix, spk, suffix], dim=1)
        n = codec_full.shape[1]
        overlay = torch.cat([tts_pad.expand(1, n - 2, tts_pad.shape[2]), tts_bos], dim=1)
        codec_hidden = overlay + codec_full[:, : n - 1]
        prefill = torch.cat([role, codec_hidden], dim=1)
        return prefill.to(self.dtype), tts_pad.to(self.dtype)

    @torch.no_grad()
    def sum_codec_embeds(self, codes) -> torch.Tensor:
        """ref codes ``[T, n_groups]`` -> summed embeddings ``[1, T, D]``."""
        codes = torch.as_tensor(np.asarray(codes), device=self.device).long()
        emb = self.params["talker"]["tree"]["embed"][codes[:, 0]]
        for g in range(1, codes.shape[1]):
            emb = emb + self.params["pred"]["codec_embeddings"][g - 1][codes[:, g]]
        return emb[None]

    @torch.no_grad()
    def build_icl_prompt(self, target_ids, ref_ids, ref_codec_embeds):
        """Reference :839-915, streaming overlay mode."""
        s = self.sp_tokens
        text = self._text_embed(list(ref_ids) + list(target_ids) + [s.tts_eos])
        bos = self._codec_embed([s.codec_bos])
        codec = torch.cat([bos, ref_codec_embeds.to(bos.dtype)], dim=1)
        n_text, n_codec = text.shape[1], codec.shape[1]
        tts_pad = self._text_embed([s.tts_pad])
        if n_text > n_codec:
            icl = text[:, :n_codec] + codec
            trailing = text[:, n_codec:]
        else:
            if n_codec > n_text:
                text = torch.cat([text, tts_pad.expand(1, n_codec - n_text, text.shape[2])],
                                 dim=1)
            icl = text + codec
            trailing = tts_pad
        return icl.to(self.dtype), trailing.to(self.dtype)

    def generate_voice_clone_codes(
        self,
        text_ids: Sequence[int],
        ref_ids: Sequence[int],
        ref_codes,
        spk_embed,
        language: str = "auto",
        opts: SpeechOptions | None = None,
    ) -> np.ndarray:
        """Reference :1659-1760: combined [prefill + ICL] single prefill,
        then the frame loop with ICL guardrails, one frame a replay."""
        opts = opts or SpeechOptions()
        rep = max(opts.repetition_penalty or 1.05, 1.05)
        max_frames = min(opts.max_new_tokens, max(75, len(list(text_ids)) * 6))
        prefill, tts_pad = self.build_voice_clone_prefill(spk_embed, language)
        icl, trailing = self.build_icl_prompt(text_ids, ref_ids, self.sum_codec_embeds(ref_codes))
        combined = torch.cat([prefill, icl], dim=1)
        state = self.prepare_streaming(
            [], language, None, dataclasses.replace(opts, repetition_penalty=rep),
            prefill_embeds=combined, trailing=trailing, tts_pad=tts_pad,
        )
        for _ in range(max_frames):
            if self.generate_one_frame(state) is None:
                break
        return np.asarray(state.codes, np.int32).reshape(-1, self.num_code_groups)

    def encode_reference(self, audio) -> np.ndarray:
        """Reference audio -> codec codes ``[T, n_groups]`` via the speech
        tokenizer's Mimi encoder (reference speech_tokenizer_v2.rs:1584-1594).
        Voice clone also accepts precomputed codes directly."""
        if self.ref_encoder is None:
            raise ValueError(
                "speech tokenizer encoder not loaded; pass ref_codes to "
                "generate_voice_clone_codes directly"
            )
        return self.ref_encoder(np.asarray(audio, np.float32))

    # ── top-level synthesis ──────────────────────────────────────────────
    def generate_speech(
        self, text: str, language: str = "auto", speaker: Optional[str] = None,
        opts: SpeechOptions | None = None,
    ) -> tuple[np.ndarray, int]:
        """text -> (waveform float32 [N], sample_rate). Decoder required."""
        if self.tokenizer is None or self.decoder is None:
            raise ValueError("tokenizer and speech decoder required")
        ids = self.tokenizer.encode(text)
        codes = self.generate_speech_codes(ids, language, speaker, opts)
        if codes.shape[0] == 0:
            return np.zeros(0, np.float32), self.decoder.sample_rate
        audio = self.decoder.chunked_decode(codes[None], 300, 25)
        return audio[0], self.decoder.sample_rate


# ── loading ───────────────────────────────────────────────────────────────


def map_talker_weights(tcfg, pcfg, sd: dict, num_code_groups: int, dtype=torch.float32,
                       device=None) -> dict:
    """HF Qwen3TTSForConditionalGeneration names (torch tensors or numpy
    arrays) -> params trees in ``dtype`` on ``device``."""
    from crane_tpu_torch.models.auto import map_hf_weights

    def sub(prefix):
        return {k[len(prefix):]: torch.as_tensor(v) for k, v in sd.items()
                if k.startswith(prefix)}

    def a(x):
        return x.to(device=device, dtype=dtype)

    def t(x):
        return x.T.contiguous().to(device=device, dtype=dtype)

    t_sd = sub("talker.")
    t_sd["model.embed_tokens.weight"] = t_sd["model.codec_embedding.weight"]
    t_sd["lm_head.weight"] = t_sd["codec_head.weight"]
    tree = map_hf_weights(tcfg, t_sd, dtype, device)
    talker = {
        "tree": tree,
        "codec_head": t(t_sd["codec_head.weight"]),
        "text_embedding": a(t_sd["model.text_embedding.weight"]),
        "text_fc1_w": t(t_sd["text_projection.linear_fc1.weight"]),
        "text_fc1_b": a(t_sd["text_projection.linear_fc1.bias"]),
        "text_fc2_w": t(t_sd["text_projection.linear_fc2.weight"]),
        "text_fc2_b": a(t_sd["text_projection.linear_fc2.bias"]),
    }

    p_sd = sub("talker.code_predictor.")
    n = num_code_groups - 1
    p_sd["model.embed_tokens.weight"] = p_sd["model.codec_embedding.0.weight"]
    p_sd["lm_head.weight"] = p_sd["lm_head.0.weight"]
    ptree = map_hf_weights(pcfg, p_sd, dtype, device)
    pred = {
        "tree": ptree,
        "codec_embedding0": tree["embed"],  # talker codec embedding for code-0
        "codec_embeddings": torch.stack(
            [a(p_sd[f"model.codec_embedding.{i}.weight"]) for i in range(n)]),
        "lm_heads": torch.stack([t(p_sd[f"lm_head.{i}.weight"]) for i in range(n)]),
    }
    if "small_to_mtp_projection.weight" in p_sd:
        pred["mtp_w"] = t(p_sd["small_to_mtp_projection.weight"])
        pred["mtp_b"] = a(p_sd["small_to_mtp_projection.bias"])
    return {"talker": talker, "pred": pred}


def specials_from_hf(hf: dict) -> TalkerSpecials:
    """The talker's control ids and name maps from a Qwen3-TTS config.json."""
    tc = hf["talker_config"]
    return TalkerSpecials(
        vocab_size=tc["vocab_size"],
        codec_eos=tc.get("codec_eos_token_id", 0),
        codec_think=tc.get("codec_think_id", 0),
        codec_nothink=tc.get("codec_nothink_id", 0),
        codec_think_bos=tc.get("codec_think_bos_id", 0),
        codec_think_eos=tc.get("codec_think_eos_id", 0),
        codec_pad=tc.get("codec_pad_id", 0),
        codec_bos=tc.get("codec_bos_id", 0),
        language_ids={k.lower(): v for k, v in tc.get("codec_language_id", {}).items()},
        speaker_ids={k.lower(): v for k, v in tc.get("spk_id", {}).items()},
        spk_is_dialect={k.lower(): v for k, v in tc.get("spk_is_dialect", {}).items()},
        tts_bos=hf.get("tts_bos_token_id", 151672),
        tts_eos=hf.get("tts_eos_token_id", 151673),
        tts_pad=hf.get("tts_pad_token_id", 151671),
    )


def load_qwen3_tts(model_dir: str, *, dtype=torch.float32, load_decoder: bool = True,
                   device=None) -> Qwen3TTSModel:
    """Load a released Qwen3-TTS checkpoint directory onto ``device`` (the
    card unless the caller asks for the CPU); the RVQGAN speech tokenizer
    (decoder and, where shipped, the reference encoder) is read from
    ``<dir>/speech_tokenizer`` when present, and the ECAPA speaker encoder
    from the ``speaker_encoder.*`` tensors."""
    import os

    from crane_tpu_torch.loaders.safetensors_loader import load_state_dict
    from crane_tpu_torch.models.auto import load_hf_config
    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    device = default_device(device)
    hf = load_hf_config(model_dir)
    tc = hf["talker_config"]
    tcfg = _tcfg_from_hf(tc)
    pcfg = _tcfg_from_hf(tc["code_predictor_config"])
    sd = load_state_dict(model_dir)
    n_groups = tc.get("num_code_groups", 16)
    params = map_talker_weights(tcfg, pcfg, sd, n_groups, dtype, device)

    speaker_encoder = None
    if any(k.startswith("speaker_encoder.") for k in sd):
        # base checkpoints ship the ECAPA x-vector tower for voice clone
        # (reference modeling.rs:1149-1223; model.rs:411-450)
        from crane_tpu_torch.models.speaker_encoder import (
            EcapaConfig,
            SpeakerEncoder,
            map_speaker_encoder_weights,
        )

        sec = hf.get("speaker_encoder_config", {})
        ecfg = EcapaConfig(
            mel_dim=sec.get("mel_dim", 128),
            enc_dim=sec.get("enc_dim", 1024),
            enc_channels=tuple(sec.get("enc_channels", (512, 512, 512, 512, 1536))),
            enc_kernel_sizes=tuple(sec.get("enc_kernel_sizes", (5, 3, 3, 3, 1))),
            enc_dilations=tuple(sec.get("enc_dilations", (1, 2, 3, 4, 1))),
            enc_attention_channels=sec.get("enc_attention_channels", 128),
            enc_res2net_scale=sec.get("enc_res2net_scale", 8),
            enc_se_channels=sec.get("enc_se_channels", 128),
            sample_rate=sec.get("sample_rate", 24000),
        )
        speaker_encoder = SpeakerEncoder(
            ecfg, map_speaker_encoder_weights(ecfg, sd, device=device))

    decoder = ref_encoder = None
    st_dir = os.path.join(model_dir, "speech_tokenizer")
    if load_decoder and os.path.isdir(st_dir):
        from crane_tpu_torch.models.speech_tokenizer import (
            load_speech_tokenizer,
            load_speech_tokenizer_encoder,
        )

        decoder = load_speech_tokenizer(st_dir, device=device)
        # the same safetensors carry the Mimi-style encoder (prefix
        # ``encoder.*``) used to turn reference audio into codec codes for
        # ICL voice clone (reference speech_tokenizer_v2.rs:1548-1565)
        ref_encoder = load_speech_tokenizer_encoder(st_dir, device=device)

    tok = None
    try:
        tok = AutoTokenizer.from_pretrained(model_dir)
    except Exception:
        pass
    model = Qwen3TTSModel(
        tcfg, pcfg, specials_from_hf(hf), params,
        num_code_groups=n_groups, tokenizer=tok, decoder=decoder, dtype=dtype,
        speaker_encoder=speaker_encoder,
    )
    model.ref_encoder = ref_encoder
    return model
