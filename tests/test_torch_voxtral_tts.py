"""Voxtral TTS of crane_tpu_torch against crane_tpu (CPU, float32).

tests/test_voxtral_tts.py's ``tiny_config()``, crane_tpu's
``init_voxtral_params`` carried across by ``utils/bridge.py``
``voxtral_params_from_jax`` (the codec's convs WIO there, PyTorch's here; its
transposed convs pre-flipped there), the same seeded numpy inputs on both
sides:

- FSQ codes equal (lattice points, round-half-even ties, out of range),
  offsets and the 37-code embedding sum, ``_bidir_layer``, the time
  embedding, the masked semantic logits, ``flow_match`` with the same noise
  (codes equal, the latent within 2e-4);
- ALiBi slopes and bias, both causal convs at T = 1, 2 (the reflect pad as
  long as the input, which ``F.pad`` refuses) and longer, ``_codec_layer``,
  ``codec_decode`` (2e-4), chunked against full (chunks of 1, 2 and 6);
- ``map_voxtral_weights`` of one random state dict in both packages, leaf
  for leaf; ``config_from_params_json``; ``load_voice_embedding`` from a
  torch ZIP built here;
- ``generate``'s codes against crane_tpu's own jitted ``_prefill``,
  ``_frame_step`` and ``_decode_step`` fed the port's noise (one
  ``torch.randn(n_acoustic)`` a frame from the CPU generator seeded with
  ``seed``), and the PCM; an END_AUDIO stop inside a block; the block as one
  replay of tests/test_torch_graphs.py's stand-in graph; no decode step past
  the last allowed frame;
- ``load_voxtral_tts`` of a tiny directory written here (params.json,
  safetensors, a voice, tekken.json), and the SDK adapter over it.
"""

import dataclasses
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_tpu.models import voxtral_tts as jv
from crane_tpu.models.modules.transformer import make_cache as jax_make_cache
from crane_tpu_torch.models import graphs
from crane_tpu_torch.models import voxtral_tts as tv
from crane_tpu_torch.models.modules.transformer import attention_block
from crane_tpu_torch.utils.bridge import voxtral_params_from_jax
from tests.test_tekken import _tekken_file
from tests.test_torch_graphs import stand_in  # noqa: F401
from tests.test_voxtral_tts import tiny_config

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 1e-5  # float32, the same sums in another order

# crane_tpu's codec, jitted per shape (op by op it takes seconds a call)
jax_codec_decode = jax.jit(jv.codec_decode, static_argnums=0)


def port_config(cfg) -> tv.VoxtralConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("acoustic", "codec")}
    return tv.VoxtralConfig(**fields, acoustic=tv.AcousticArgs(**dataclasses.asdict(cfg.acoustic)),
                            codec=tv.CodecArgs(**dataclasses.asdict(cfg.codec)))


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_config()
    jparams = jv.init_voxtral_params(jcfg, seed=0)
    return jcfg, jparams, port_config(jcfg), voxtral_params_from_jax(jparams, device="cpu")


def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- the acoustic transformer --------------------------------------------------


def test_fsq_offsets_and_frame_embedding(tiny):
    jcfg, jparams, cfg, params = tiny
    x = np.concatenate([np.linspace(-1.2, 1.2, 97), [-0.95, -0.05, 0.05, 0.95, -5.0, 5.0],
                        rnd(1, 64)]).astype(np.float32)
    for levels in (21, 5):
        ref = np.asarray(jv.fsq_quantize(jnp.asarray(x), levels))
        got = tv.fsq_quantize(torch.from_numpy(x), levels)
        np.testing.assert_array_equal(got.numpy(), ref)
        close(tv.fsq_dequantize(got, levels), jv.fsq_dequantize(jnp.asarray(ref), levels))
    np.testing.assert_array_equal(tv.codebook_offsets(cfg).numpy(), jv.codebook_offsets(jcfg))
    codes = np.random.default_rng(2).integers(0, jcfg.fsq_levels + 2, (3, jcfg.n_codebooks))
    codes = codes.astype(np.int32)
    close(tv.embed_frame_codes(params["codebook_table"], tv.codebook_offsets(cfg),
                               torch.from_numpy(codes)),
          jv.embed_frame_codes(jparams["codebook_table"], jv.codebook_offsets(jcfg),
                               jnp.asarray(codes)))


def test_bidir_layer_time_embedding_and_semantic_logits(tiny):
    jcfg, jparams, cfg, params = tiny
    ac = jcfg.acoustic
    x = rnd(3, 2, 3, ac.dim)
    kw = dict(n_heads=ac.n_heads, head_dim=ac.head_dim, eps=jcfg.norm_eps)
    close(tv._bidir_layer(params["acoustic"]["layers"][0], torch.from_numpy(x), **kw),
          jv._bidir_layer(jparams["acoustic"]["layers"][0], jnp.asarray(x), **kw))
    for t in tv.flow_times():
        close(tv.time_embedding(t, ac.dim), jv.time_embedding(jnp.float32(t.item()), ac.dim))
    h = rnd(4, jcfg.dim)
    got = tv.predict_semantic_logits(cfg, params["acoustic"], torch.from_numpy(h)).numpy()
    ref = np.asarray(jv.predict_semantic_logits(jcfg, jparams["acoustic"], jnp.asarray(h)))
    assert got.shape == ref.shape == (jcfg.semantic_padded,)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    close(got[finite], ref[finite])
    assert np.isneginf(got[0]) and np.isneginf(got[jcfg.semantic_valid_end:]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flow_match_with_the_same_noise(tiny, seed):
    jcfg, jparams, cfg, params = tiny
    h, noise = rnd(10 + seed, jcfg.dim, scale=3.0), rnd(20 + seed, jcfg.n_acoustic)
    ref = np.asarray(jv.flow_match(jcfg, jparams["acoustic"], jnp.asarray(h), jnp.asarray(noise)))
    got = tv.flow_match(cfg, params["acoustic"], torch.from_numpy(h), torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the latent before FSQ, against crane_tpu's Euler steps written out
    tokens = tv.time_tokens(cfg, params["acoustic"])
    latent = tv.flow_latent(cfg, params["acoustic"], torch.from_numpy(h),
                            torch.from_numpy(noise), tokens)
    np.testing.assert_array_equal(tv.fsq_quantize(latent, jcfg.fsq_levels).numpy(), ref)
    assert (ref >= 2).all() and (ref <= jcfg.fsq_levels + 1).all()


# -- the codec --------------------------------------------------------------------


def test_alibi(tiny):
    for n in (2, 8):
        close(tv.alibi_slopes(n), jv.alibi_slopes(n), rtol=0, atol=0)
    for T, window in ((6, 2), (9, 4), (5, 0)):
        ref = np.asarray(jv.alibi_sliding_bias(T, window, jv.alibi_slopes(2)))
        got = tv.alibi_sliding_bias(T, window, tv.alibi_slopes(2)).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
        close(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=0, atol=0)


@pytest.mark.parametrize("T", [1, 2, 3, 5, 20])
@pytest.mark.parametrize("k,stride", [(3, 1), (7, 1), (4, 2)])
def test_causal_conv_short_and_long(T, k, stride):
    """The reflect pad (k - stride rows) reflects again where it is as long
    as the input, as numpy and jax do; F.pad(mode="reflect") refuses it."""
    x, w, b = rnd(30 + T, 2, T, 5), rnd(31 + k, k, 5, 7), rnd(32, 7)
    ref = jv.causal_conv1d_nwc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride)
    got = tv.causal_conv1d_nwc(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                               torch.from_numpy(b), stride=stride)
    assert got.shape == ref.shape
    close(got, ref)
    if k - stride >= T:
        with pytest.raises(RuntimeError):
            torch.nn.functional.pad(torch.from_numpy(x).transpose(1, 2), (k - stride, 0),
                                    mode="reflect")


@pytest.mark.parametrize("T", [1, 2, 9])
def test_causal_transpose_conv(T):
    k, s = 4, 2
    x, w_pt, b = rnd(40 + T, 2, T, 5), rnd(41, 5, 3, k), rnd(42, 3)
    w_jax = jnp.asarray(w_pt.transpose(2, 0, 1)[::-1].copy())  # as map_voxtral_weights makes it
    ref = jv.causal_conv_transpose1d_nwc(jnp.asarray(x), w_jax, jnp.asarray(b), stride=s)
    got = tv.causal_conv_transpose1d_nwc(torch.from_numpy(x), torch.from_numpy(w_pt),
                                         torch.from_numpy(b), stride=s)
    assert got.shape == ref.shape == (2, T * s, 3)
    close(got, ref)


def codes_of(cfg, n_frames, seed=0):
    rng = np.random.default_rng(seed)
    sem = rng.integers(2, cfg.semantic_valid_end, (1, n_frames, 1))
    ac = rng.integers(2, 2 + cfg.fsq_levels, (1, n_frames, cfg.n_acoustic))
    return np.concatenate([sem, ac], -1).astype(np.int32)


def test_codec_layer(tiny):
    jcfg, jparams, cfg, params = tiny
    T = 7
    x = rnd(50, 1, T, jcfg.codec.dim)
    jbias = jv.alibi_sliding_bias(T, 4, jv.alibi_slopes(jcfg.codec.n_heads))
    tbias = tv.alibi_sliding_bias(T, 4, tv.alibi_slopes(cfg.codec.n_heads))
    close(tv._codec_layer(params["codec"]["stages"][0]["layers"][0], torch.from_numpy(x), tbias,
                          cfg=cfg.codec),
          jv._codec_layer(jparams["codec"]["stages"][0]["layers"][0], jnp.asarray(x), jbias,
                          cfg=jcfg.codec))


@pytest.mark.parametrize("n_frames", [1, 2, 12])
def test_codec_decode(tiny, n_frames):
    jcfg, jparams, cfg, params = tiny
    codes = codes_of(jcfg, n_frames, seed=n_frames)
    ref = np.asarray(jax_codec_decode(jcfg, jparams["codec"], jnp.asarray(codes)))
    got = tv.codec_decode(cfg, params["codec"], torch.from_numpy(codes))
    assert got.shape == ref.shape == (1, n_frames * cfg.codec.samples_per_frame)
    close(got, ref)


@pytest.mark.parametrize("chunk,n,context", [(1, 6, 2), (2, 6, 2), (6, 20, 16)])
def test_chunked_decode(tiny, monkeypatch, chunk, n, context):
    """Chunks of 1 and 2 frames decode their first chunk alone, its reflect
    pads as long as the chunk (crane_tpu's result, not the full decode's);
    chunks of 6 with 16 frames of context equal the full decode."""
    jcfg, jparams, cfg, params = tiny
    monkeypatch.setattr(jv, "codec_decode", jax_codec_decode)
    codes = codes_of(jcfg, n, seed=3)
    got = tv.codec_chunked_decode(cfg, params["codec"], torch.from_numpy(codes), chunk_size=chunk,
                                  left_context=context)
    ref = jv.codec_chunked_decode(jcfg, jparams["codec"], jnp.asarray(codes), chunk_size=chunk,
                                  left_context=context)
    close(got, ref)
    if chunk >= 3:
        close(got, tv.codec_decode(cfg, params["codec"], torch.from_numpy(codes)), rtol=1e-4,
              atol=1e-5)


# -- weights, config, voices ----------------------------------------------------


def voxtral_state_dict(cfg, seed=0) -> dict:
    """A random Mistral-style Voxtral state dict (tests/test_voxtral_tts.py's
    names and shapes), float32 numpy."""
    rng = np.random.default_rng(seed)
    sd = {}

    def lin(name, o, i):
        sd[name] = rng.standard_normal((o, i)).astype(np.float32) * i ** -0.5

    def vec(name, n, val=None):
        sd[name] = (np.full(n, val, np.float32) if val is not None
                    else rng.standard_normal(n).astype(np.float32))

    E, H = cfg.dim, cfg.hidden_dim
    qd, kd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    sd["mm_audio_embeddings.tok_embeddings.weight"] = rng.standard_normal(
        (cfg.vocab_size, E)).astype(np.float32) * 0.02
    vec("norm.weight", E, 1.0)
    for i in range(cfg.n_layers):
        lp = f"layers.{i}."
        lin(lp + "attention.wq.weight", qd, E)
        lin(lp + "attention.wk.weight", kd, E)
        lin(lp + "attention.wv.weight", kd, E)
        lin(lp + "attention.wo.weight", E, qd)
        lin(lp + "feed_forward.w1.weight", H, E)
        lin(lp + "feed_forward.w2.weight", E, H)
        lin(lp + "feed_forward.w3.weight", H, E)
        vec(lp + "attention_norm.weight", E)
        vec(lp + "ffn_norm.weight", E)
    ac = cfg.acoustic
    aqd = ac.n_heads * ac.head_dim
    for i in range(ac.n_layers):
        lp = f"acoustic_transformer.layers.{i}."
        lin(lp + "attention.wq.weight", aqd, ac.dim)
        lin(lp + "attention.wk.weight", aqd, ac.dim)
        lin(lp + "attention.wv.weight", aqd, ac.dim)
        lin(lp + "attention.wo.weight", ac.dim, aqd)
        lin(lp + "feed_forward.w1.weight", ac.hidden_dim, ac.dim)
        lin(lp + "feed_forward.w2.weight", ac.dim, ac.hidden_dim)
        lin(lp + "feed_forward.w3.weight", ac.hidden_dim, ac.dim)
        vec(lp + "attention_norm.weight", ac.dim)
        vec(lp + "ffn_norm.weight", ac.dim)
    vec("acoustic_transformer.norm.weight", ac.dim)
    lin("acoustic_transformer.input_projection.weight", ac.dim, cfg.n_acoustic)
    lin("acoustic_transformer.time_projection.weight", ac.dim, ac.dim)
    lin("acoustic_transformer.llm_projection.weight", ac.dim, ac.dim)
    lin("acoustic_transformer.semantic_codebook_output.weight", cfg.semantic_padded, ac.dim)
    lin("acoustic_transformer.acoustic_codebook_output.weight", cfg.n_acoustic, ac.dim)
    rows = cfg.semantic_valid_end + cfg.n_acoustic * (cfg.fsq_levels + 2)
    sd["mm_audio_embeddings.audio_codebook_embeddings.embeddings.weight"] = (
        rng.standard_normal((rows, E)).astype(np.float32) * 0.02)
    cc = cfg.codec
    tp = "audio_tokenizer."
    sd[tp + "quantizer.semantic_codebook.embedding_sum"] = rng.standard_normal(
        (cfg.semantic_codebook_size, cc.semantic_dim)).astype(np.float32)
    sd[tp + "quantizer.semantic_codebook.cluster_usage"] = np.abs(
        rng.standard_normal(cfg.semantic_codebook_size)).astype(np.float32) + 0.5

    def wn(prefix, out_c, in_c, k, transpose=False):
        shape = (in_c, out_c, k) if transpose else (out_c, in_c, k)
        sd[prefix + ".conv.parametrizations.weight.original1"] = (
            rng.standard_normal(shape).astype(np.float32))
        sd[prefix + ".conv.parametrizations.weight.original0"] = (
            np.abs(rng.standard_normal((shape[0], 1, 1))).astype(np.float32) + 0.1)
        sd[prefix + ".conv.bias"] = rng.standard_normal(out_c).astype(np.float32)

    wn(tp + "decoder_blocks.0", cc.dim, cc.semantic_dim + cfg.n_acoustic, cc.conv_kernels[0])
    block = 1
    cqd = cc.n_heads * cc.head_dim
    for s in range(len(cc.transformer_lengths)):
        for li in range(cc.transformer_lengths[s]):
            lp = f"{tp}decoder_blocks.{block}.layers.{li}."
            lin(lp + "attention.wq.weight", cqd, cc.dim)
            lin(lp + "attention.wk.weight", cqd, cc.dim)
            lin(lp + "attention.wv.weight", cqd, cc.dim)
            lin(lp + "attention.wo.weight", cc.dim, cqd)
            vec(lp + "attention.q_norm.weight", cqd)
            vec(lp + "attention.k_norm.weight", cqd)
            vec(lp + "attention_norm.weight", cc.dim)
            vec(lp + "ffn_norm.weight", cc.dim)
            vec(lp + "attention_scale", cc.dim, 0.1)
            vec(lp + "ffn_scale", cc.dim, 0.1)
            lin(lp + "feed_forward.w1.weight", cc.hidden_dim, cc.dim)
            lin(lp + "feed_forward.w2.weight", cc.dim, cc.hidden_dim)
            lin(lp + "feed_forward.w3.weight", cc.hidden_dim, cc.dim)
        block += 1
        if s < len(cc.transformer_lengths) - 1:
            wn(f"{tp}decoder_blocks.{block}", cc.dim, cc.dim, cc.conv_kernels[s + 1],
               transpose=True)
            block += 1
    wn(tp + "output_proj", cc.patch_size, cc.dim, 7)
    return sd


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_map_voxtral_weights_leaf_for_leaf(tiny):
    jcfg, _, cfg, _ = tiny
    sd = voxtral_state_dict(jcfg)
    ref = dict(leaves(voxtral_params_from_jax(jv.map_voxtral_weights(jcfg, sd, jnp.float32),
                                              device="cpu")))
    for source in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        got = dict(leaves(tv.map_voxtral_weights(cfg, source, torch.float32, device="cpu")))
        assert got.keys() == ref.keys()
        for name, t in got.items():
            if ref[name] is None:
                assert t is None, name
                continue
            assert t.dtype == torch.float32 and t.shape == ref[name].shape, name
            close(t, ref[name], rtol=1e-6, atol=1e-7)
    bf16 = tv.map_voxtral_weights(cfg, sd, device="cpu")
    assert bf16["codec"]["input_conv"]["w"].dtype == torch.bfloat16


def test_config_from_params_json():
    raw = {
        "dim": 128, "n_layers": 2, "head_dim": 32, "hidden_dim": 256, "n_heads": 4,
        "n_kv_heads": 2, "rope_theta": 10000.0, "norm_eps": 1e-5, "vocab_size": 512,
        "max_seq_len": 100000,
        "multimodal": {
            "audio_model_args": {
                "semantic_codebook_size": 64, "acoustic_codebook_size": 5,
                "n_acoustic_codebook": 4,
                "acoustic_transformer_args": {"dim": 128, "n_layers": 1, "head_dim": 32,
                                              "hidden_dim": 256, "n_heads": 4, "n_kv_heads": 4},
            },
            "audio_tokenizer_args": {
                "sampling_rate": 24000, "pretransform_patch_size": 240, "semantic_dim": 16,
                "dim": 64, "hidden_dim": 128, "head_dim": 16, "n_heads": 4, "n_kv_heads": 4,
                "decoder_transformer_lengths_str": "2,2",
                "decoder_convs_kernels_str": "3,4", "decoder_convs_strides_str": [1, 2],
            },
        },
    }
    ref, got = jv.config_from_params_json(raw), tv.config_from_params_json(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.max_seq_len == 65536 and got.codec.conv_strides == (1, 2)
    assert got.llm_config().rope_mode == "interleaved"
    assert dataclasses.asdict(tv.config_from_params_json({})) == dataclasses.asdict(
        jv.config_from_params_json({}))


def voice_zip(path, rows: int, seed: int):
    """A torch-ZIP voice file: one raw bf16 [rows, 3072] entry."""
    x = torch.randn(rows, 3072, generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("voice_embed/data.pkl", b"")
        z.writestr("voice_embed/data/0", x.view(torch.int16).numpy().tobytes())
    return x


def test_load_voice_embedding(tmp_path):
    x = voice_zip(tmp_path / "alice.pt", 4, 0)
    got, ref = tv.load_voice_embedding(str(tmp_path / "alice.pt")), jv.load_voice_embedding(
        str(tmp_path / "alice.pt"))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, x.float().numpy())
    np.save(tmp_path / "bob.npy", got[:2])
    np.testing.assert_array_equal(tv.load_voice_embedding(str(tmp_path / "bob.npy")), got[:2])
    with zipfile.ZipFile(tmp_path / "bad.pt", "w") as z:
        z.writestr("archive/data/0", b"\0" * 10)
    with pytest.raises(ValueError):
        tv.load_voice_embedding(str(tmp_path / "bad.pt"))


# -- generation -------------------------------------------------------------------


def jax_codes(jm, text_ids, voice, max_frames: int, seed: int) -> np.ndarray:
    """crane_tpu's own jitted prefill, frame and decode steps in its frame
    loop, fed the port's noise: one ``torch.randn(n_acoustic)`` a frame from
    the CPU generator seeded with ``seed``."""
    voice_embed = jm.voices[voice] if voice else next(iter(jm.voices.values()), None)
    embeds = jm._prompt_embeds(text_ids, voice_embed)
    cache = jax_make_cache(jm.llm_cfg, 1, jm.max_seq, dtype=jm.dtype)
    h, cache = jm._prefill(jm.params, embeds, cache)
    gen = torch.Generator().manual_seed(seed)
    frames = []
    for i in range(max_frames):
        noise = torch.randn((jm.cfg.n_acoustic,), generator=gen, dtype=torch.float32).numpy()
        sem, codes, emb = jm._frame_step(jm.params, h[0], jnp.asarray(noise))
        if int(sem) == jv.END_AUDIO_CODE:
            break
        frames.append(np.asarray(codes))
        if i + 1 < max_frames:
            h, cache = jm._decode_step(jm.params, emb, cache,
                                       jnp.asarray([embeds.shape[1] + i], jnp.int32))
    return np.stack(frames) if frames else np.zeros((0, jm.cfg.n_codebooks), np.int32)


def models(tiny, semantic_head=None):
    jcfg, jparams, cfg, params = tiny
    voice = rnd(60, 3, jcfg.dim, scale=0.1)
    if semantic_head is not None:
        jparams = {**jparams, "acoustic": {**jparams["acoustic"],
                                           "semantic_head": jnp.asarray(semantic_head)}}
        params = {**params, "acoustic": {**params["acoustic"],
                                         "semantic_head": torch.from_numpy(semantic_head)}}
    jm = jv.VoxtralTts(jcfg, jparams, voices={"demo": voice}, max_seq=128)
    tm = tv.VoxtralTts(cfg, params, voices={"demo": voice}, max_seq=128)
    return jm, tm


@pytest.mark.parametrize("max_frames,block", [(6, 4), (5, 16), (3, 1)])
def test_generate_codes_and_pcm(tiny, max_frames, block):
    jm, tm = models(tiny)
    ref = jax_codes(jm, [10, 11, 12], "demo", max_frames, seed=7)
    got = tm.generate_codes([10, 11, 12], voice="demo", max_frames=max_frames, seed=7,
                            block_frames=block)
    assert ref.shape == (max_frames, tm.cfg.n_codebooks)
    np.testing.assert_array_equal(got, ref)
    # the backbone's cache holds the prompt (3 voice rows, 3 text ids, 5
    # specials) and one step for each frame but the last
    assert int(tm._cache.lengths[0]) == 3 + 3 + 5 + max_frames - 1
    wav, sr = tm.generate([10, 11, 12], voice="demo", max_frames=max_frames, seed=7,
                          block_frames=block)
    ref_wav = jax_codec_decode(jm.cfg, jm.params["codec"], jnp.asarray(ref)[None])[0]
    assert sr == 24_000 and wav.shape == (max_frames * tm.cfg.codec.samples_per_frame,)
    close(wav, ref_wav)


def test_end_audio_stop_inside_a_block(tiny):
    """END_AUDIO's column of the semantic head raised so that crane_tpu stops
    inside the run (at frame 7 of 12): the port stops at the same frame, with
    its codes, and its cache holds no step past it."""
    jcfg = tiny[0]
    base = np.asarray(tiny[1]["acoustic"]["semantic_head"]).copy()
    head = base.copy()
    head[:, jv.END_AUDIO_CODE] = 3.0 * (base[:, jv.END_AUDIO_CODE] + base[:, 2:8].mean(1))
    jm, tm = models(tiny, head)
    ref = jax_codes(jm, [5, 6], None, 12, seed=3)
    assert 1 <= len(ref) < 12 and len(ref) % 4  # inside the run, inside a block of 4
    got = tm.generate_codes([5, 6], max_frames=12, seed=3, block_frames=4)
    np.testing.assert_array_equal(got, ref)
    assert int(tm._cache.lengths[0]) == 3 + 2 + 5 + len(ref)
    # END at the first frame: no frames, no audio
    head = np.zeros((jcfg.dim, jcfg.semantic_padded), np.float32)
    head[:, jv.END_AUDIO_CODE] = 1.0
    jm, tm = models(tiny, head)
    wav, _ = tm.generate([5], max_frames=4, seed=0)
    ref_wav, _ = jm.generate([5], max_frames=4, seed=0)
    assert wav.shape == ref_wav.shape == (0,)


def test_frame_block_is_one_replay(tiny, stand_in):  # noqa: F811
    """On the card a block is one graph replay: under the stand-in graph each
    block replays one program, with the eager loop's codes, and the plain
    attention routes (head_dim 8: no kernel takes it) count a frame's decode
    calls per frame."""
    _, tm = models(tiny)
    with graphs.eager():
        eager = tm.generate_codes([9, 10], max_frames=8, seed=4, block_frames=4)
    replays = graphs.replays
    before = dict(attention_block.plain_routes)
    got = tm.generate_codes([9, 10], max_frames=8, seed=4, block_frames=4)
    np.testing.assert_array_equal(got, eager)
    assert graphs.replays - replays == 2 and len(stand_in) == 1
    routes = {k: n - before[k] for k, n in attention_block.plain_routes.items()}
    layers = tm.cfg.n_layers
    assert routes == {"prefill": 0, "chunk": layers, "decode": 8 * layers}
    again = tm.generate_codes([9, 10], max_frames=8, seed=4, block_frames=4)
    np.testing.assert_array_equal(again, eager)
    assert len(stand_in) == 1
    tm.release_graphs()


def test_load_voxtral_tts_and_the_sdk(tiny, tmp_path):
    from safetensors.numpy import save_file

    from crane_tpu.sdk.audio import VoxtralTts as JAdapter
    from crane_tpu_torch.generation.config import SpeechOptions
    from crane_tpu_torch.sdk.audio import VoxtralTts as TAdapter
    from crane_tpu_torch.sdk.audio import voxtral_voice_languages

    jcfg = dataclasses.replace(tiny[0], vocab_size=300)  # the tekken file's 268 ids
    cfg_json = {"dim": jcfg.dim, "n_layers": jcfg.n_layers, "head_dim": jcfg.head_dim,
                "hidden_dim": jcfg.hidden_dim, "n_heads": jcfg.n_heads,
                "n_kv_heads": jcfg.n_kv_heads, "vocab_size": jcfg.vocab_size,
                "max_seq_len": jcfg.max_seq_len,
                "multimodal": {
                    "audio_model_args": {
                        "semantic_codebook_size": jcfg.semantic_codebook_size,
                        "acoustic_codebook_size": jcfg.fsq_levels,
                        "n_acoustic_codebook": jcfg.n_acoustic,
                        "acoustic_transformer_args": dataclasses.asdict(jcfg.acoustic)},
                    "audio_tokenizer_args": {
                        "dim": jcfg.codec.dim, "hidden_dim": jcfg.codec.hidden_dim,
                        "n_heads": jcfg.codec.n_heads, "n_kv_heads": jcfg.codec.n_kv_heads,
                        "head_dim": jcfg.codec.head_dim, "semantic_dim": jcfg.codec.semantic_dim,
                        "pretransform_patch_size": jcfg.codec.patch_size,
                        "decoder_transformer_lengths_str": "1,1",
                        "decoder_convs_kernels_str": "3,4", "decoder_convs_strides_str": "1,2"}}}
    (tmp_path / "params.json").write_text(json.dumps(cfg_json))
    save_file(voxtral_state_dict(jcfg, seed=5), str(tmp_path / "consolidated.safetensors"))
    (tmp_path / "voice_embedding").mkdir()
    voice = np.random.default_rng(6).standard_normal((2, jcfg.dim)).astype(np.float32) * 0.1
    np.save(tmp_path / "voice_embedding" / "de_male.npy", voice)
    _tekken_file(tmp_path, [b"he", b"ll", b"llo", b"hello"])
    tm, tok = tv.load_voxtral_tts(str(tmp_path), dtype=torch.float32, device="cpu")
    jm, _ = jv.load_voxtral_tts(str(tmp_path), dtype=jnp.float32)
    assert tm.tokenizer is tok and tok.encode("hello") == jm.tokenizer.encode("hello")
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert sorted(tm.voices) == ["de_male"]
    ids = tok.encode("hello")
    np.testing.assert_array_equal(tm.generate_codes(ids, voice="de_male", max_frames=4, seed=2),
                                  jax_codes(jm, ids, "de_male", 4, seed=2))
    adapter = TAdapter(tm, max_frames=3)
    assert [(v.name, v.languages) for v in adapter.voices()] == \
        [(v.name, v.languages) for v in JAdapter(jm).voices()] == [("de_male", ["de"])]
    assert voxtral_voice_languages("casual_female") == ["en"]
    assert adapter.audio_info().sample_rate == 24_000 and not adapter.supports_voice_cloning()
    wav = adapter.generate_speech("hello", SpeechOptions(voice="de_male"))
    ref, _ = tm.generate(ids, voice="de_male", max_frames=3, seed=0)
    np.testing.assert_array_equal(wav, ref)
    assert [w.shape for w in adapter.generate_speech_stream("hello")] == [ref.shape]
    with pytest.raises(KeyError):
        tm.generate(ids, voice="nobody")
