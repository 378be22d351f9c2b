"""Qwen3-TTS in crane_tpu_torch against crane_tpu (CPU, float32).

Both packages load the same tiny checkpoint in the released layout
(``talker.model.*`` / ``talker.code_predictor.*`` / ``speaker_encoder.*`` and
``speech_tokenizer/``) through their own ``load_qwen3_tts``:

- the prefill layout (``build_prefill_embeds`` with and without language
  and speaker, the voice-clone prefix, the ICL overlay's two branches) on
  tests/test_qwen3_tts.py's tiny model, within 1e-4 relative;
- sampled codes: the two packages draw from different generators
  (``jax.random`` against ``torch.Generator``), so the codes are compared on
  a peaked-head checkpoint, whose codec head and predictor heads are scaled
  by 1e6: every top-50 draw at temperature 0.9 then takes the argmax, and
  ``generate_speech_codes`` and the voice-clone loop give identical codes;
- with ordinary heads, the code-0 and per-group logits of every frame of
  crane_tpu's own codes, teacher-forced through each package's public
  functions (``forward_hidden`` and the params), within 2e-4;
- the port's block path against its one-frame path from one seed, a
  stream whose kept cache a newer stream took over raising, the
  control ids never sampled and no EOS in the first two frames, a block
  past EOS truncated, the frame block as one replay of the stand-in graph;
- ``load_qwen3_tts`` wiring the decoder, the reference encoder and ECAPA
  (their outputs against crane_tpu's), voice clone through the SDK, and
  the SDK's voices and language codes.

The sampling tiny models have a codec vocabulary of 1056 and a predictor
vocabulary of 32: the suppress mask covers the top 1024 ids (the control
range), so code 0 is one of 32 ids, as every code is, and the tiny speech
decoder's 32 bins take them. tests/test_qwen3_tts.py's 64-id vocabulary
lies wholly inside the suppressed range: its code-0 draws see no finite
logit, and it serves the layout and loading tests.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.generation.config import SpeechOptions as JSpeechOptions
from crane_tpu.models import qwen3_tts as jtts
from crane_tpu_torch.generation.config import SpeechOptions
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models import qwen3_tts as ttts
from crane_tpu_torch.models.modules.transformer import forward_hidden, make_cache
from tests.test_qwen3_tts import _tiny_decoder_cfg, _tts_checkpoint
from tests.test_torch_graphs import stand_in  # noqa: F401

torch.set_num_threads(2)

FEAT = dict(rtol=1e-4, atol=1e-5)
LOGITS = dict(rtol=2e-4, atol=2e-4)
PEAK = 1e6
V = 1056  # codec vocabulary: 32 code ids below the 1024 control ids
PV = 32  # the code predictor's vocabulary
GROUPS = 4


def make_tts_checkpoint(path, *, vocab=V, peak=1.0, eos_bias=0.0, seed=0):
    """tests/test_qwen3_tts.py's tiny layout (talker 2 layers of 32, 4/2
    heads of 8; predictor 2 layers of 24; 4 code groups; a 160000 x 40 text
    table covering the role ids) with a codec vocabulary of ``vocab`` and a
    predictor vocabulary of PV, the codec head and the predictor heads
    scaled by ``peak``. With ``eos_bias`` every talker input carries a large
    constant (the text projection's bias, which the guidance rows carry), so
    the talker's final hidden state points along the ones direction, and
    the codec head's EOS row gets ``eos_bias`` along it: EOS dominates.
    Control ids sit at the top: EOS at vocab-1."""
    import safetensors.numpy as st

    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    D, Dp, TV, TD = 32, 24, 160000, 40
    sd = {}

    def block(prefix, hidden, H, Hkv, hd):
        for i in range(2):
            L = f"{prefix}model.layers.{i}."
            sd[L + "self_attn.q_proj.weight"] = r(H * hd, hidden)
            sd[L + "self_attn.k_proj.weight"] = r(Hkv * hd, hidden)
            sd[L + "self_attn.v_proj.weight"] = r(Hkv * hd, hidden)
            sd[L + "self_attn.o_proj.weight"] = r(hidden, H * hd)
            sd[L + "self_attn.q_norm.weight"] = np.ones(hd, np.float32)
            sd[L + "self_attn.k_norm.weight"] = np.ones(hd, np.float32)
            sd[L + "input_layernorm.weight"] = np.ones(hidden, np.float32)
            sd[L + "post_attention_layernorm.weight"] = np.ones(hidden, np.float32)
            sd[L + "mlp.gate_proj.weight"] = r(2 * hidden, hidden)
            sd[L + "mlp.up_proj.weight"] = r(2 * hidden, hidden)
            sd[L + "mlp.down_proj.weight"] = r(hidden, 2 * hidden)
        sd[f"{prefix}model.norm.weight"] = np.ones(hidden, np.float32)

    block("talker.", D, 4, 2, 8)
    sd["talker.model.codec_embedding.weight"] = r(vocab, D, scale=0.2)
    sd["talker.model.text_embedding.weight"] = r(TV, TD, scale=0.2)
    head = r(vocab, D, scale=0.2)
    head[vocab - 1] += eos_bias
    sd["talker.codec_head.weight"] = head * np.float32(peak)
    sd["talker.text_projection.linear_fc1.weight"] = r(TD, TD)
    sd["talker.text_projection.linear_fc1.bias"] = r(TD)
    sd["talker.text_projection.linear_fc2.weight"] = r(D, TD)
    sd["talker.text_projection.linear_fc2.bias"] = r(D) + np.float32(100.0 if eos_bias else 0.0)
    block("talker.code_predictor.", Dp, 2, 2, 8)
    for i in range(GROUPS - 1):
        sd[f"talker.code_predictor.model.codec_embedding.{i}.weight"] = r(PV, D, scale=0.2)
        sd[f"talker.code_predictor.lm_head.{i}.weight"] = r(PV, Dp, scale=0.2) * np.float32(peak)
    sd["talker.code_predictor.small_to_mtp_projection.weight"] = r(Dp, D)
    sd["talker.code_predictor.small_to_mtp_projection.bias"] = r(Dp)
    path.mkdir(parents=True, exist_ok=True)
    st.save_file(sd, str(path / "model.safetensors"))
    V_ = vocab
    cfg = {
        "model_type": "qwen3_tts",
        "tts_bos_token_id": 151672, "tts_eos_token_id": 151673, "tts_pad_token_id": 151671,
        "talker_config": {
            "vocab_size": V_, "hidden_size": D, "intermediate_size": 2 * D,
            "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 8, "num_code_groups": GROUPS, "text_hidden_size": TD,
            "text_vocab_size": TV,
            "codec_eos_token_id": V_ - 1, "codec_think_id": V_ - 2, "codec_nothink_id": V_ - 3,
            "codec_think_bos_id": V_ - 4, "codec_think_eos_id": V_ - 5, "codec_pad_id": V_ - 6,
            "codec_bos_id": V_ - 7,
            "codec_language_id": {"english": V_ - 10, "sichuan dialect": V_ - 11},
            "spk_id": {"vivian": V_ - 12},
            "spk_is_dialect": {"vivian": False},
            "code_predictor_config": {
                "vocab_size": PV, "hidden_size": Dp, "intermediate_size": 2 * Dp,
                "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 2,
                "head_dim": 8, "num_code_groups": GROUPS,
            },
        },
    }
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


def both(path):
    return (jtts.load_qwen3_tts(str(path)),
            ttts.load_qwen3_tts(str(path), device="cpu"))


@pytest.fixture(scope="module")
def layout_pair(tmp_path_factory):
    """tests/test_qwen3_tts.py's tiny model through both loaders."""
    return both(_tts_checkpoint(tmp_path_factory.mktemp("qwen3tts")))


@pytest.fixture(scope="module")
def peaked(tmp_path_factory):
    return both(make_tts_checkpoint(tmp_path_factory.mktemp("peaked") / "m", peak=PEAK))


@pytest.fixture(scope="module")
def ordinary(tmp_path_factory):
    return both(make_tts_checkpoint(tmp_path_factory.mktemp("ordinary") / "m"))


def close(got: torch.Tensor, ref, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("language,speaker", [("auto", None), ("english", None),
                                              ("en", "Vivian"), ("sichuan dialect", None)])
def test_prefill_layout_matches(layout_pair, language, speaker):
    jm, tm = layout_pair
    ref = jm.build_prefill_embeds([5, 6, 7], language, speaker)
    got = tm.build_prefill_embeds([5, 6, 7], language, speaker)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        close(g, r, **FEAT)
    # one text token: trailing is tts_eos alone; no text: tts_pad stands in
    for ids in ([9], []):
        for g, r in zip(tm.build_prefill_embeds(ids, "auto", None),
                        jm.build_prefill_embeds(ids, "auto", None)):
            close(g, r, **FEAT)


def test_voice_clone_prefix_and_icl_overlay_match(layout_pair):
    jm, tm = layout_pair
    spk = np.random.default_rng(3).normal(size=tm.tcfg.hidden_size).astype(np.float32)
    for g, r in zip(tm.build_voice_clone_prefill(spk, "english"),
                    jm.build_voice_clone_prefill(jnp.asarray(spk), "english")):
        close(g, r, **FEAT)
    ref_embeds = np.random.default_rng(4).normal(size=(1, 5, tm.tcfg.hidden_size)) \
        .astype(np.float32)
    # text (2+2+1=5) < codec (1+5=6): padded overlay, trailing = tts_pad;
    # text (8+2+1=11) > codec (6): overlay the first 6, trailing = the rest
    for target, n_trailing in (([1, 2], 1), (list(range(10, 18)), 5)):
        got = tm.build_icl_prompt(target, [3, 4], torch.from_numpy(ref_embeds))
        ref = jm.build_icl_prompt(target, [3, 4], jnp.asarray(ref_embeds))
        assert got[0].shape[1] == 6 and got[1].shape[1] == n_trailing
        for g, r in zip(got, ref):
            close(g, r, **FEAT)
    codes = np.random.default_rng(5).integers(0, 40, size=(6, tm.num_code_groups))
    close(tm.sum_codec_embeds(codes), jm.sum_codec_embeds(codes), **FEAT)


@pytest.mark.parametrize("seed,language,speaker", [(1, "english", "Vivian"), (7, "auto", None)])
def test_peaked_codes_equal_crane_tpus(peaked, seed, language, speaker):
    jm, tm = peaked
    text = [5, 6, 7, 8, 9]
    ref = jm.generate_speech_codes(text, language, speaker,
                                   JSpeechOptions(max_new_tokens=20, seed=seed))
    got = tm.generate_speech_codes(text, language, speaker,
                                   SpeechOptions(max_new_tokens=20, seed=seed))
    assert got.shape == ref.shape and got.shape[1] == GROUPS and len(got) >= 2
    np.testing.assert_array_equal(got, ref)


def test_peaked_voice_clone_codes_equal_crane_tpus(peaked):
    jm, tm = peaked
    rng = np.random.default_rng(6)
    ref_codes = rng.integers(0, PV, size=(6, GROUPS))
    spk = rng.normal(size=tm.tcfg.hidden_size).astype(np.float32)
    ref = jm.generate_voice_clone_codes([5, 6], [7, 8], ref_codes, jnp.asarray(spk), "english",
                                        JSpeechOptions(max_new_tokens=9, seed=5))
    got = tm.generate_voice_clone_codes([5, 6], [7, 8], ref_codes, spk, "english",
                                        SpeechOptions(max_new_tokens=9, seed=5))
    assert len(got) >= 2
    np.testing.assert_array_equal(got, ref)


def _teacher_forced_logits(pkg, m, codes, text):
    """Each frame's code-0 logits (masks applied) and the predictor's
    per-group logits, with ``codes`` fed back: composed from the package's
    ``prepare_streaming`` (the prefill), ``forward_hidden``, ``make_cache``
    and the params."""
    tensor = (lambda a: torch.as_tensor(np.asarray(a))) if pkg == "torch" else jnp.asarray
    tfwd = forward_hidden if pkg == "torch" else jtts.forward_hidden
    tcache = (lambda cfg, n: make_cache(cfg, 1, n, torch.float32, device="cpu")) \
        if pkg == "torch" else (lambda cfg, n: jtts.make_cache(cfg, 1, n, jnp.float32))
    zeros = (lambda n: torch.zeros((1, n), dtype=torch.int32)) if pkg == "torch" \
        else (lambda n: jnp.zeros((1, n), jnp.int32))
    start = 0 if pkg == "torch" else jnp.asarray(0, jnp.int32)
    opts = (SpeechOptions if pkg == "torch" else JSpeechOptions)(max_new_tokens=len(codes))
    state = m.prepare_streaming(text, "english", None, opts)
    talker, pred = m.params["talker"], m.params["pred"]
    prope = ttts.make_rope_tables(m.pcfg) if pkg == "torch" else jtts.make_rope_tables(m.pcfg)
    trailing = np.asarray(state.trailing, np.float32)
    pad = np.asarray(state.tts_pad_embed, np.float32)
    h, cache = state.past_hidden, state.cache
    out = []
    for step, frame in enumerate(codes):
        c0 = np.asarray(h[:, 0] @ talker["codec_head"], np.float32)[0] \
            + np.asarray(m._suppress) + (np.asarray(m._eos_suppress) if step < 2 else 0)
        e = [np.asarray(pred["codec_embedding0"][int(frame[0])], np.float32)] + [
            np.asarray(pred["codec_embeddings"][g][int(frame[g + 1])], np.float32)
            for g in range(GROUPS - 1)]
        seq = np.concatenate([np.asarray(h, np.float32)[0], np.stack(e[:-1])])
        seq = seq @ np.asarray(pred["mtp_w"]) + np.asarray(pred["mtp_b"])
        ph, _ = tfwd(m.pcfg, pred["tree"], zeros(GROUPS), tcache(m.pcfg, 32), start, prope,
                     inputs_embeds=tensor(seq[None]))
        ph = np.asarray(ph, np.float32)[0]
        groups = [ph[g + 1] @ np.asarray(pred["lm_heads"][g]) for g in range(GROUPS - 1)]
        out.append((c0, np.stack(groups)))
        guidance = trailing[0, step] if step < trailing.shape[1] else pad[0, 0]
        emb = sum(e) + guidance
        h, cache = tfwd(m.tcfg, talker["tree"], zeros(1), cache, cache.lengths, m.rope,
                        inputs_embeds=tensor(emb[None, None]))
    return np.stack([c for c, _ in out]), np.stack([g for _, g in out])


def test_teacher_forced_logits_match(ordinary):
    jm, tm = ordinary
    text = [5, 6, 7, 8]
    codes = jm.generate_speech_codes(text, "english", None,
                                     JSpeechOptions(max_new_tokens=6, seed=2))
    assert len(codes) >= 2
    refs = _teacher_forced_logits("jax", jm, codes, text)
    with torch.no_grad():
        gots = _teacher_forced_logits("torch", tm, codes, text)
    for got, ref in zip(gots, refs):  # code 0 (control ids at -inf), then the groups
        finite = np.isfinite(ref)
        assert finite.any()
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_allclose(got[finite], ref[finite], **LOGITS)


def test_streaming_equals_block_path(ordinary):
    """The block path (generate_speech_codes in blocks of 16, and of 3) and
    a loop of generate_one_frame give the same codes from one seed."""
    _, tm = ordinary
    opts = SpeechOptions(max_new_tokens=12, seed=0)
    block = tm.generate_speech_codes([9, 10, 11], "auto", None, opts)
    small = tm.generate_speech_codes([9, 10, 11], "auto", None, opts, block_frames=3)
    state = tm.prepare_streaming([9, 10, 11], "auto", None, opts)
    frames = []
    for _ in range(12):
        f = tm.generate_one_frame(state)
        if f is None:
            break
        frames.append(f)
    stream = np.asarray(frames, np.int32).reshape(-1, GROUPS)
    assert len(block) == 12
    np.testing.assert_array_equal(small, block)
    np.testing.assert_array_equal(stream, block)


def test_a_stream_taken_over_raises(ordinary):
    """Streams of one cache length share the model's kept talker cache and
    generator: a newer ``prepare_streaming`` takes them over, and the older
    state's next block raises instead of reading the newer stream's cache.
    A stream of another length keeps its own and goes on with the codes it
    gives alone."""
    _, tm = ordinary
    opts = SpeechOptions(max_new_tokens=6, seed=0)
    alone = tm.generate_speech_codes([9, 10, 11], "auto", None, opts)
    first = tm.prepare_streaming([9, 10, 11], "auto", None, opts)
    tm.generate_frames(first, 2)
    other = tm.prepare_streaming([5, 6], "auto", None, SpeechOptions(max_new_tokens=600, seed=3))
    assert other.generator is not first.generator
    tm.generate_frames(other, 2)
    tm.generate_frames(first, 4)
    np.testing.assert_array_equal(np.asarray(first.codes, np.int32), alone)
    second = tm.prepare_streaming([5, 6, 7], "auto", None, opts)
    assert second.generator is first.generator
    with pytest.raises(RuntimeError, match="taken over"):
        tm.generate_frames(first, 2)
    assert len(tm.generate_frames(second, 2)) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_no_control_id_is_sampled(ordinary, seed):
    _, tm = ordinary
    codes = tm.generate_speech_codes([5, 6, 7], "english", "Vivian",
                                     SpeechOptions(max_new_tokens=10, seed=seed))
    assert np.all(codes[:, 0] < V - 1024) and np.all((codes >= 0) & (codes < PV))


def test_eos_is_held_back_two_frames_then_ends_the_block(tmp_path):
    """A codec head whose EOS row dominates: EOS is suppressed for the first
    two frames, then ends generation inside the block (both packages)."""
    d = make_tts_checkpoint(tmp_path / "eos", eos_bias=50.0)
    jm, tm = both(d)
    got = tm.generate_speech_codes([5, 6], "auto", None, SpeechOptions(max_new_tokens=16, seed=1))
    ref = jm.generate_speech_codes([5, 6], "auto", None,
                                   JSpeechOptions(max_new_tokens=16, seed=1))
    assert got.shape == ref.shape == (2, GROUPS)
    state = tm.prepare_streaming([5, 6], "auto", None, SpeechOptions(seed=1))
    assert len(tm.generate_frames(state, 8)) == 2 and state.finished
    assert tm.generate_frames(state, 8) is None and state.step == 2


def test_frame_block_is_one_replay(ordinary, stand_in):
    """On the card a block is one graph replay: under the stand-in graph
    each block replays one program, with the eager loop's codes."""
    _, tm = ordinary
    tm.release_graphs()
    opts = SpeechOptions(max_new_tokens=8, seed=4)
    with graphs.eager():
        eager = tm.generate_speech_codes([9, 10], "auto", None, opts, block_frames=4)
    replays = graphs.replays
    got = tm.generate_speech_codes([9, 10], "auto", None, opts, block_frames=4)
    np.testing.assert_array_equal(got, eager)
    assert graphs.replays - replays == -(-len(got) // 4) and len(stand_in) == 1
    # the next stream of the same length replays the same program
    again = tm.generate_speech_codes([9, 10], "auto", None, opts, block_frames=4)
    np.testing.assert_array_equal(again, eager)
    assert len(stand_in) == 1
    tm.release_graphs()


def add_clone_stack(d):
    """tests/test_qwen3_tts.py:357's additions to a tiny checkpoint:
    ``speaker_encoder.*`` in the main safetensors and a ``speech_tokenizer/``
    holding ``decoder.*`` and ``encoder.*``."""
    import safetensors.numpy as st

    from crane_tpu.models.speaker_encoder import EcapaConfig, random_speaker_encoder_state_dict
    from crane_tpu.models.speech_tokenizer import (
        SpeechEncoderConfig,
        random_decoder_state_dict,
        random_encoder_state_dict,
    )

    sd = dict(st.load_file(str(d / "model.safetensors")))
    sd.update(random_speaker_encoder_state_dict(EcapaConfig(
        mel_dim=128, enc_dim=32, enc_channels=(32, 32, 48), enc_kernel_sizes=(5, 3, 1),
        enc_dilations=(1, 2, 1), enc_attention_channels=8, enc_res2net_scale=4,
        enc_se_channels=8), seed=3))
    st.save_file(sd, str(d / "model.safetensors"))
    cfg = json.loads((d / "config.json").read_text())
    cfg["speaker_encoder_config"] = {
        "mel_dim": 128, "enc_dim": 32, "enc_channels": [32, 32, 48],
        "enc_kernel_sizes": [5, 3, 1], "enc_dilations": [1, 2, 1],
        "enc_attention_channels": 8, "enc_res2net_scale": 4, "enc_se_channels": 8,
        "sample_rate": 24000}
    (d / "config.json").write_text(json.dumps(cfg))
    stdir = d / "speech_tokenizer"
    stdir.mkdir()
    ecfg = SpeechEncoderConfig(
        num_filters=8, hidden_size=24, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=2, head_dim=8, upsampling_ratios=(4, 3),
        codebook_size=32, codebook_dim=12, num_quantizers=6, num_semantic_quantizers=1,
        sliding_window=8, vector_quantization_hidden_dimension=12, valid_num_quantizers=4)
    st.save_file({**random_decoder_state_dict(_tiny_decoder_cfg(), seed=4),
                  **random_encoder_state_dict(ecfg, seed=5)}, str(stdir / "model.safetensors"))
    (stdir / "config.json").write_text(json.dumps({
        "decoder_config": {
            "codebook_size": 32, "hidden_size": 48, "latent_dim": 40, "codebook_dim": 40,
            "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 12,
            "sliding_window": 8, "intermediate_size": 64, "num_hidden_layers": 2,
            "num_quantizers": 4, "upsample_rates": [4, 3], "upsampling_ratios": [2, 2],
            "decoder_dim": 32},
        "encoder_config": {
            "num_filters": 8, "hidden_size": 24, "intermediate_size": 48,
            "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 2,
            "head_dim": 8, "upsampling_ratios": [4, 3], "codebook_size": 32, "codebook_dim": 12,
            "num_quantizers": 6, "num_semantic_quantizers": 1, "sliding_window": 8,
            "vector_quantization_hidden_dimension": 12},
        "encoder_valid_num_quantizers": 4,
        "output_sample_rate": 24000,
    }))
    return d


class _Tok:
    def encode(self, s):
        return [5 + (ord(c) % 7) for c in s][:6]


def test_load_wires_the_clone_stack(tmp_path):
    """``load_qwen3_tts`` on tests/test_qwen3_tts.py:357's checkpoint reads
    ECAPA from ``speaker_encoder.*`` and the decoder and reference encoder
    from ``speech_tokenizer/``; each gives crane_tpu's output."""
    from crane_tpu_torch.models.speaker_encoder import SpeakerEncoder
    from crane_tpu_torch.models.speech_tokenizer import (
        SpeechTokenizerDecoder,
        SpeechTokenizerEncoder,
    )

    jm, tm = both(add_clone_stack(_tts_checkpoint(tmp_path)))
    assert isinstance(tm.speaker_encoder, SpeakerEncoder)
    assert isinstance(tm.ref_encoder, SpeechTokenizerEncoder)
    assert isinstance(tm.decoder, SpeechTokenizerDecoder)
    wav = (np.random.default_rng(8).normal(size=4800) * 0.2).astype(np.float32)
    np.testing.assert_allclose(tm.speaker_encoder(wav), jm.speaker_encoder(wav), **FEAT)
    np.testing.assert_array_equal(tm.encode_reference(wav), jm.encode_reference(wav))
    codes = np.random.default_rng(9).integers(0, 32, size=(1, 7, 4))
    np.testing.assert_allclose(tm.decoder.decode(codes), jm.decoder.decode(codes), **FEAT)


def test_voice_clone_through_the_sdk_equals_crane_tpus(tmp_path):
    """WAV in, cloned speech out through ``Qwen3Tts.generate_voice_clone``
    on the peaked checkpoint with the clone stack: the same codes, so the
    same audio as crane_tpu's adapter, and the same again on a second call."""
    from crane_tpu.sdk.audio import Qwen3Tts as JQwen3Tts
    from crane_tpu_torch.sdk.audio import Qwen3Tts

    make_tts_checkpoint(tmp_path / "m", peak=PEAK)
    jm, tm = both(add_clone_stack(tmp_path / "m"))
    jm.tokenizer = tm.tokenizer = _Tok()
    wav = (np.random.default_rng(8).normal(size=4800) * 0.2).astype(np.float32)
    tts = Qwen3Tts(tm)
    assert tts.supports_voice_cloning()
    out = tts.generate_voice_clone("hello", wav, "ref words", SpeechOptions(max_new_tokens=5,
                                                                            seed=9))
    ref = JQwen3Tts(jm).generate_voice_clone("hello", wav, "ref words",
                                             JSpeechOptions(max_new_tokens=5, seed=9))
    assert out.ndim == 1 and len(out) > 0 and len(out) % tm.decoder.config.total_upsample == 0
    np.testing.assert_allclose(out, ref, **FEAT)
    np.testing.assert_array_equal(out, tts.generate_voice_clone(
        "hello", wav, "ref words", SpeechOptions(max_new_tokens=5, seed=9)))


def test_sdk_voices_and_language_codes(layout_pair):
    from crane_tpu.sdk.audio import Qwen3Tts as JQwen3Tts
    from crane_tpu_torch.sdk.audio import Qwen3Tts, VoiceInfo

    jm, tm = layout_pair
    voices = Qwen3Tts(tm).voices()
    assert voices == [VoiceInfo(name="vivian", languages=["en", "sichuan dialect"])]
    assert [(v.name, v.languages) for v in voices] == \
        [(v.name, v.languages) for v in JQwen3Tts(jm).voices()]
    assert tm._language_id("en", None) == tm._language_id("english", None) is not None
    assert tm._language_id("auto", None) is None
    assert Qwen3Tts(tm).audio_info().sample_rate == 24000
