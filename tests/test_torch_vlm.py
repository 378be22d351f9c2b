"""The vision-language models in crane_tpu_torch against crane_tpu (CPU, f32).

- MRoPE tables and ``forward_hidden``'s multimodal hooks (``inputs_embeds``,
  ``rope_embeds``, ``deepstack``, ``extra_mask``, ``segments``) on seeded
  numpy inputs, over one tree of weights handed to both packages;
- Qwen3-VL on tests/test_qwen3_vl_parity.py's tiny checkpoint: the vision
  tower, ``get_rope_index``, and greedy tokens of image, video and mixed
  prompts;
- Gemma3-VL on tests/test_gemma3_vl_parity.py's tiny checkpoint: features,
  image chat, text only, and a prompt of 300 tokens, whose fresh prefill
  hands ``segments`` to K2 (its plain version here);
- PaddleOCR-VL on tests/test_paddleocr_vl.py's tiny checkpoint: the
  antialiased resize (down and up), the NaViT tower and ``recognize``;
- ``models/factory.py`` on each family (the audio LLMs too), and the vision
  SDK.

Features and logits agree within rtol/atol 2e-4; greedy tokens are
identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from crane_tpu.generation.config import GenerationConfig as JGen
from crane_tpu.models import gemma3_vl as jg3
from crane_tpu.models import paddleocr_vl as jpo
from crane_tpu.models import qwen3_vl as jq
from crane_tpu.models.init import init_params as jinit
from crane_tpu.models.modules import transformer as jtf
from crane_tpu.ops import rope as jrope
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models import gemma3_vl as tg3
from crane_tpu_torch.models import paddleocr_vl as tpo
from crane_tpu_torch.models import qwen3_vl as tq
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops import rope as trope
from crane_tpu_torch.ops.cuda import flash_attention as k23
from crane_tpu_torch.utils.bridge import params_from_jax
from tests.test_gemma3_vl_parity import IMG_TOKEN as G3_IMG
from tests.test_gemma3_vl_parity import _pixels
from tests.test_gemma3_vl_parity import tiny as g3_tiny  # noqa: F401
from tests.test_paddleocr_vl import _tiny_ocr_checkpoint, _tiny_vcfg, _tower_params
from tests.test_qwen2_audio_parity import tiny as qa_tiny  # noqa: F401
from tests.test_qwen3_vl_parity import IMG_TOKEN, VID_TOKEN, VSTART, _positional_image
from tests.test_qwen3_vl_parity import tiny as vl_tiny  # noqa: F401
from tests.test_torch_moe import same_leaves

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)


def close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# -- MRoPE and the forward hooks ---------------------------------------------


def test_mrope_cos_sin_matches():
    pos3 = np.random.default_rng(0).integers(0, 300, (3, 2, 7)).astype(np.int32)
    for section in ((24, 20, 20), (2, 3, 3)):
        got = trope.mrope_cos_sin(torch.from_numpy(pos3), 128, section, theta=5e6)
        ref = jrope.mrope_cos_sin(jnp.asarray(pos3), 128, section, theta=5e6)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            close(g, r)
    # equal streams give standard RoPE
    same = np.broadcast_to(np.arange(9, dtype=np.int32)[None, None], (3, 1, 9)).copy()
    cos, sin = trope.mrope_cos_sin(torch.from_numpy(same), 64, (16, 8, 8))
    tc, ts = trope.rope_table(64, 9)
    close(cos[0], tc)
    close(sin[0], ts)


HOOK_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                head_dim=64, intermediate_size=96, qk_norm=True,
                layer_types=("sliding", "full"), sliding_window=8, max_position_embeddings=128)


@pytest.fixture(scope="module")
def hook_models():
    jcfg = jtf.TransformerConfig(**HOOK_CFG)
    tcfg = ttf.TransformerConfig(**HOOK_CFG)
    jparams = jinit(jcfg, seed=3, dtype=jnp.float32)
    return jcfg, jparams, tcfg, params_from_jax(jparams)


def _both_forward(hook_models, S, T, start, read_cache, **hooks):
    """crane_tpu's and the port's forward_hidden on the same inputs; hooks
    are numpy arrays (deepstack a (mask, embeds) pair)."""
    jcfg, jparams, tcfg, tparams = hook_models
    outs = []
    for pkg, cfg, params in ((jtf, jcfg, jparams), (ttf, tcfg, tparams)):
        is_t = pkg is ttf
        conv = (lambda a: torch.from_numpy(np.ascontiguousarray(a))) if is_t else jnp.asarray
        cache = pkg.make_cache(cfg, 1, T, torch.float32 if is_t else jnp.float32)
        rope = pkg.make_rope_tables(cfg)
        kw = {}
        for name, val in hooks.items():
            if name == "deepstack":
                kw[name] = (conv(val[0]), conv(val[1]))
            elif name == "rope_embeds":
                kw[name] = {k: conv(v) for k, v in val.items()}
            else:
                kw[name] = conv(val)
        tokens = conv(np.zeros((1, S), np.int32))
        pos = start if is_t else jnp.asarray(start, jnp.int32)
        hidden, cache = pkg.forward_hidden(cfg, params, tokens, cache, pos, rope,
                                           read_cache=read_cache, **kw)
        outs.append((hidden, cache))
    (jh, jc), (th, tc) = outs
    close(th, jh)
    for tl, jl in zip(tc.layers, jc.layers):
        close(tl.k, jl.k)
        close(tl.v, jl.v)
    return th


def test_forward_hidden_embeds_rope_and_deepstack(hook_models):
    """inputs_embeds + MRoPE rope_embeds + DeepStack (3 visual slots, 2
    layers of features) over the cache from position 0 (the VLM prefill)."""
    S = 12
    mask = np.zeros((1, S), bool)
    mask[0, 4:7] = True
    pos3 = np.stack([np.arange(S), np.arange(S) // 2, np.arange(S) % 3])[:, None].astype(np.int32)
    cos, sin = (np.asarray(a) for a in jrope.mrope_cos_sin(jnp.asarray(pos3), 64, (12, 10, 10)))
    _both_forward(hook_models, S, 32, 0, True,
                  inputs_embeds=rnd(1, 1, S, 64), rope_embeds={"cos": cos, "sin": sin},
                  deepstack=(mask, rnd(2, 2, 3, 64)))


@pytest.mark.parametrize("with_segments", [True, False])
def test_forward_hidden_extra_mask_and_segments(hook_models, with_segments, monkeypatch):
    """Gemma3-VL's image blocks: a fresh prefill with the bidirectional
    ``extra_mask`` and its ``segments``. With segments the port takes K2
    with them (its plain version here); without, the plain gqa_attention,
    counted as a plain route. Both equal crane_tpu's."""
    S = 20
    img = np.zeros(S, bool)
    img[3:8] = img[11:14] = True
    m, seg = tg3.image_block_masks(np.zeros(S, np.int32), img, S)
    calls = []
    orig = k23.flash_attention_causal

    def counted(q, k, v, segments=None, **kw):
        calls.append(segments is not None)
        return orig(q, k, v, segments, **kw)

    monkeypatch.setattr(ttf, "flash_attention_causal", counted)
    before = dict(ttf.attention_block.plain_routes)
    hooks = dict(inputs_embeds=rnd(3, 1, S, 64), extra_mask=m[None])
    if with_segments:
        hooks["segments"] = seg[None]
    _both_forward(hook_models, S, 32, 0, False, **hooks)
    routed = ttf.attention_block.plain_routes["prefill"] - before["prefill"]
    assert calls == ([True, True] if with_segments else [])
    assert routed == (0 if with_segments else 2)


def test_extra_mask_over_the_cache(hook_models):
    """An extra_mask on a read of the cache (crane_tpu: gqa_attention over
    the buffers) takes the plain route too."""
    S = 6
    m = np.zeros((1, S, 16), bool)
    m[0, :, 10:12] = True
    _both_forward(hook_models, S, 16, 0, True, inputs_embeds=rnd(4, 1, S, 64), extra_mask=m)


# -- Qwen3-VL ----------------------------------------------------------------


@pytest.fixture(scope="module")
def vl_pair(vl_tiny):  # noqa: F811
    _, d = vl_tiny
    return (jq.load_qwen3_vl(d, dtype=jnp.float32),
            tq.load_qwen3_vl(d, dtype=torch.float32, device="cpu"))


def _image_patches():
    from crane_tpu_torch.models.image_processing import preprocess_image

    return preprocess_image(_positional_image(16, 24), patch_size=4, merge_size=2,
                            temporal_patch_size=2, min_pixels=16, max_pixels=10 ** 8)


def test_qwen3_vl_weights_and_vision_tower(vl_pair):
    jm, tm = vl_pair
    assert tm.vision_config.__dict__ == jm.vision_config.__dict__
    same_leaves(tm.params, jm.params)
    same_leaves(tm.vision_params, jm.vision_params)
    patches, grid = _image_patches()
    feats, deep = tm.encode_images(patches, grid)
    jfeats, jdeep = jm.encode_images(patches, grid)
    close(feats, jfeats)
    close(deep, jdeep)
    assert deep.shape[0] == 2


def test_qwen3_vl_rope_index(vl_pair):
    jm, tm = vl_pair
    ids = [5, 6, VSTART] + [IMG_TOKEN] * 6 + [7, VSTART] + [VID_TOKEN] * 4 + [8] \
        + [VSTART] + [VID_TOKEN] * 4 + [9]
    got = tm.get_rope_index(np.asarray(ids), [(1, 4, 6)], [(2, 4, 4)])
    ref = jm.get_rope_index(np.asarray(ids), [(1, 4, 6)], [(2, 4, 4)])
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]


def _video():
    rng = np.random.default_rng(0)
    t, h, w = 2, 4, 4
    return rng.standard_normal((t * h * w, 3 * 2 * 4 * 4)).astype(np.float32) * 0.5, (t, h, w)


def test_qwen3_vl_image_generate(vl_pair):
    jm, tm = vl_pair
    patches, grid = _image_patches()
    ids = [5, 6, VSTART] + [IMG_TOKEN] * ((grid[1] // 2) * (grid[2] // 2)) + [7, 8, 9]
    # 20 tokens: two decode blocks and a part
    got = tm.generate(ids, images=[(patches, grid)], gen=GenerationConfig.greedy(20))
    assert got == jm.generate(ids, images=[(patches, grid)], gen=JGen.greedy(20))
    assert len(got) == 20


def test_qwen3_vl_video_and_mixed_generate(vl_pair):
    jm, tm = vl_pair
    vpatches, vgrid = _video()
    ids = [5, 6, 11, VSTART] + [VID_TOKEN] * 4 + [12, VSTART] + [VID_TOKEN] * 4 + [7, 8, 9]
    got = tm.generate(ids, videos=[(vpatches, vgrid)], gen=GenerationConfig.greedy(8))
    assert got == jm.generate(ids, videos=[(vpatches, vgrid)], gen=JGen.greedy(8))
    ipatches, igrid = _image_patches()
    ids = ([5, VSTART] + [VID_TOKEN] * 4 + [13, VSTART] + [VID_TOKEN] * 4
           + [6, VSTART] + [IMG_TOKEN] * 6 + [7, 9])
    kw = dict(images=[(ipatches, igrid)], videos=[(vpatches, vgrid)])
    assert tm.generate(ids, gen=GenerationConfig.greedy(8), **kw) == jm.generate(
        ids, gen=JGen.greedy(8), **kw)
    # text only
    assert tm.generate([5, 6, 7, 8, 9], gen=GenerationConfig.greedy(6)) == jm.generate(
        [5, 6, 7, 8, 9], gen=JGen.greedy(6))


def test_qwen3_vl_prefill_logits_and_eos(vl_pair):
    """The prefill's last logits against crane_tpu's ``_vlm_prefill``, and
    an EOS inside a decode block stops the stream there."""
    jm, tm = vl_pair
    patches, grid = _image_patches()
    ids = [5, 6, VSTART] + [IMG_TOKEN] * 6 + [7, 8, 9]
    full = tm.generate(ids, images=[(patches, grid)], gen=GenerationConfig.greedy(12))
    stop = full[5]
    cut = tm.generate(ids, images=[(patches, grid)],
                      gen=GenerationConfig.greedy(12, eos_token_ids=(stop,)))
    assert cut == full[:full.index(stop) + 1]
    assert cut == jm.generate(ids, images=[(patches, grid)],
                              gen=JGen.greedy(12, eos_token_ids=(stop,)))


# -- Gemma3-VL ---------------------------------------------------------------


@pytest.fixture(scope="module")
def g3_pair(g3_tiny):  # noqa: F811
    _, d = g3_tiny
    return (jg3.load_gemma3_vl(d, dtype=jnp.float32),
            tg3.load_gemma3_vl(d, dtype=torch.float32, device="cpu"))


def test_gemma3_vl_features(g3_pair):
    jm, tm = g3_pair
    same_leaves(tm.params, jm.params)
    same_leaves(tm.vision_params, jm.vision_params)
    close(tm.encode_images(_pixels()), jm.encode_images(_pixels()))


def test_gemma3_vl_image_chat_and_text(g3_pair):
    jm, tm = g3_pair
    ids = [2, 5, 151] + [G3_IMG] * 4 + [152, 9, 3]
    assert tm.generate(ids, pixels=_pixels(), gen=GenerationConfig.greedy(8)) == jm.generate(
        ids, pixels=_pixels(), gen=JGen.greedy(8))
    ids = [2, 5, 9, 3, 7]
    assert tm.generate(ids, gen=GenerationConfig.greedy(6)) == jm.generate(
        ids, gen=JGen.greedy(6))


def test_gemma3_vl_long_prompt_hands_segments_to_k2(g3_pair, monkeypatch):
    """A 300-token prompt with one image block (crane_tpu's flash bucket):
    the port's fresh prefill hands the segments to K2's plain version on
    every layer (the tiny config's head_dim 16 is a shape the kernel does
    not take, so the router picks the plain version and counts it), and
    gives crane_tpu's tokens (crane_tpu's CPU run uses gqa_attention with
    the extra mask: the two masks say the same)."""
    jm, tm = g3_pair
    rng = np.random.default_rng(7)
    text = rng.integers(10, 150, 296).tolist()
    ids = text[:100] + [151] + [G3_IMG] * 4 + [152] + text[100:294]
    assert len(ids) == 300
    calls = []
    orig = k23.flash_attention_causal_plain

    def counted(q, k, v, segments=None, **kw):
        calls.append(None if segments is None else int((segments > 0).sum()))
        return orig(q, k, v, segments, **kw)

    monkeypatch.setattr(ttf, "flash_attention_causal_plain", counted)
    before = dict(ttf.attention_block.plain_routes)
    got = tm.generate(ids, pixels=_pixels(), gen=GenerationConfig.greedy(6))
    assert calls == [4] * tm.config.num_layers
    assert ttf.attention_block.plain_routes["prefill"] - before["prefill"] == len(calls)
    assert got == jm.generate(ids, pixels=_pixels(), gen=JGen.greedy(6))


# -- PaddleOCR-VL ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(300, 500), (100, 100), (40, 1200)],
                         ids=["down", "up", "wide"])
def test_paddleocr_preprocess_matches_jax_resize(shape):
    """The antialiased bilinear resize (downscaled, upscaled, one axis each
    way) against crane_tpu's jax.image.resize, patch for patch."""
    img = np.random.default_rng(1).integers(0, 255, size=(*shape, 3), dtype=np.uint8)
    got, grid = tpo.preprocess_image(img)
    ref, rgrid = jpo.preprocess_image(img)
    assert grid == rgrid
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


def test_paddleocr_resize_is_not_plain_interpolate():
    """Downscaling by 3 with JAX's antialias is not F.interpolate's
    bilinear (no antialias): the port computes JAX's function."""
    img = np.random.default_rng(2).random((90, 60, 3)).astype(np.float32)
    got = tpo.resize_bilinear(img, 30, 20)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (30, 20, 3), method="bilinear"))
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    plain = torch.nn.functional.interpolate(torch.from_numpy(img).permute(2, 0, 1)[None],
                                            size=(30, 20), mode="bilinear")[0].permute(1, 2, 0)
    assert np.abs(plain.numpy() - ref).max() > 1e-2


def test_paddleocr_navit_matches():
    cfg = _tiny_vcfg()
    jp = _tower_params(cfg, llm_dim=16)
    tp = params_from_jax(jp)
    h, w = 4, 6
    patches = rnd(5, h * w, 3 * 14 * 14)
    idx, wgt = tpo.navit_pos_taps(6, (1, h, w))
    cos, sin = tpo.navit_rope_tables(cfg, (1, h, w))
    got = tpo.navit_forward(cfg, tp, torch.from_numpy(patches), torch.from_numpy(idx),
                            torch.from_numpy(wgt), (torch.from_numpy(cos), torch.from_numpy(sin)),
                            (h, w))
    ref = jpo.navit_forward(cfg, jp, jnp.asarray(patches), jnp.asarray(idx), jnp.asarray(wgt),
                            (jnp.asarray(cos), jnp.asarray(sin)), (h, w))
    close(got, ref)


@pytest.fixture(scope="module")
def ocr_dir(tmp_path_factory):
    return _tiny_ocr_checkpoint(tmp_path_factory.mktemp("ocr"))


def test_paddleocr_recognize_matches(ocr_dir):
    jm = jpo.load_paddleocr_vl(str(ocr_dir))
    tm = tpo.load_paddleocr_vl(str(ocr_dir), device="cpu")
    same_leaves(tm.vision_params, jm.vision_params)
    img = np.random.default_rng(3).integers(0, 255, size=(290, 400, 3), dtype=np.uint8)
    feats, n = tm.encode_image(img)
    jfeats, jn = jm.encode_image(img)
    assert n == jn
    close(feats, jfeats)
    assert tm.build_prompt_ids(n, "table") == jm.build_prompt_ids(n, "table")
    for image in (img, 255 - img):
        assert tm.recognize(image, max_new_tokens=6) == jm.recognize(image, max_new_tokens=6)
    pieces = list(tm.recognize_stream(img, max_new_tokens=6))
    assert "".join(pieces).strip() == tm.recognize(img, max_new_tokens=6)


def test_vision_sdk_over_the_port(ocr_dir):
    from crane_tpu_torch.sdk.vision import OcrClient, VisionClient

    tm = tpo.load_paddleocr_vl(str(ocr_dir), device="cpu")
    img = np.random.default_rng(4).integers(0, 255, size=(290, 400, 3), dtype=np.uint8)
    client = OcrClient(tm, max_new_tokens=5)
    assert "".join(client.recognize_stream(img)).strip() == client.recognize(img)
    vision = VisionClient(tm, max_new_tokens=4)
    assert vision.analyze_image(img) == vision.analyze(img)


# -- the factory -------------------------------------------------------------


def test_factory_detects_and_loads_each_family(vl_tiny, g3_tiny, ocr_dir, qa_tiny,  # noqa: F811
                                               tmp_path):
    from tests.fixtures import make_tiny_qwen3_checkpoint
    from crane_tpu.models import factory as jf
    from crane_tpu_torch.models import factory as tf
    from crane_tpu_torch.models.causal_lm import CausalLM
    from crane_tpu_torch.models.gemma3n import Gemma3nLM

    dense = str(tmp_path / "dense")
    make_tiny_qwen3_checkpoint(dense)
    g3n = tmp_path / "g3n"
    torch.manual_seed(0)
    cfg = transformers.Gemma3nTextConfig(
        vocab_size=64, vocab_size_per_layer_input=64, hidden_size=16,
        hidden_size_per_layer_input=8, intermediate_size=[32] * 2, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, head_dim=8,
        layer_types=["sliding_attention", "full_attention"], laurel_rank=2,
        num_kv_shared_layers=0,
        activation_sparsity_pattern=[0.0, 0.0], max_position_embeddings=64)
    transformers.Gemma3nForCausalLM(cfg).save_pretrained(str(g3n), safe_serialization=True)
    cases = {dense: (CausalLM, "qwen3"), str(g3n): (Gemma3nLM, "gemma3n_text"),
             vl_tiny[1]: (tq.Qwen3VLModel, "qwen3_vl"),
             g3_tiny[1]: (tg3.Gemma3VLModel, "gemma3"),
             str(ocr_dir): (tpo.PaddleOcrVL, "paddleocr_vl")}
    for path, (cls, mt) in cases.items():
        assert tf.detect_model_type(path) == jf.detect_model_type(path) == mt
        model = tf.load_model(path, dtype=torch.float32, device="cpu")
        assert type(model) is cls
        assert model.__class__.__name__ == type(jf.load_model(path, dtype=jnp.float32)).__name__
    assert tf.detect_model_type(str(tmp_path / "x.gguf")) == "gguf"
    # a Qwen3-TTS checkpoint loads as the port's Qwen3TTSModel (ROADMAP
    # Queue 1 item 11)
    from crane_tpu_torch.models.qwen3_tts import Qwen3TTSModel
    from tests.test_torch_qwen3_tts import make_tts_checkpoint

    tts = make_tts_checkpoint(tmp_path / "qwen3_tts")
    assert tf.detect_model_type(tts) == jf.detect_model_type(tts) == "qwen3_tts"
    model = tf.load_model(tts, dtype=torch.float32, device="cpu")
    assert type(model) is Qwen3TTSModel and model.device.type == "cpu"
    assert model.__class__.__name__ == type(jf.load_model(tts, dtype=jnp.float32)).__name__
    # the audio LLMs load as the port's classes (ROADMAP Queue 1 item 10)
    from crane_tpu_torch.models.qwen2_audio import AudioLLM
    from crane_tpu_torch.models.qwen3_asr import Qwen3AsrModel
    from tests.test_torch_qwen3_asr import make_tiny_qwen3_asr_checkpoint

    (tmp_path / "asr").mkdir()
    audio = {make_tiny_qwen3_asr_checkpoint(tmp_path / "asr"): (Qwen3AsrModel, "qwen3_asr"),
             qa_tiny[1]: (AudioLLM, "qwen2_audio")}
    for path, (cls, mt) in audio.items():
        assert tf.detect_model_type(path) == jf.detect_model_type(path) == mt
        model = tf.load_model(path, dtype=torch.float32, device="cpu")
        assert type(model) is cls
        assert model.__class__.__name__ == type(jf.load_model(path, dtype=jnp.float32)).__name__
