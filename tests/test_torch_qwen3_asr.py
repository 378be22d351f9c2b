"""Qwen3-ASR in crane_tpu_torch against crane_tpu (CPU, float32).

- ``aut_encode`` (the AuT tower and projector) on weights mapped from
  transformers' ``Qwen3OmniMoeAudioEncoder`` by crane_tpu and carried
  across by ``utils/bridge.py``, at mel lengths 100, 137, 240, 455 and 800
  (one chunk, a ragged tail, several windows), within 1e-4 relative; the
  port's own ``map_aut_weights`` gives the same tree; window isolation;
  the masks and output lengths;
- the tiny checkpoint of tests/test_qwen3_asr_parity.py (the reference's
  layout: ``model.audio_tower``, ``model.multi_modal_projector``,
  ``model.language_model``) through both packages' ``load_qwen3_asr``: the
  spliced prefill's logits within 2e-4, greedy ids identical over several
  16-step decode blocks, EOS inside a block and from the prefill, and the
  same text from ``transcribe``;
- the decode block (``embeds_decode.greedy_decode_block``) against 16
  single greedy steps, and ``init_aut_params`` against crane_tpu's draw.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from crane_tpu.models import qwen3_asr as jasr
from crane_tpu_torch.models import qwen3_asr as tasr
from crane_tpu_torch.utils.bridge import audio_params_from_jax, params_from_jax
from tests.test_qwen3_asr_parity import _hf_encoder, _params_from_hf, _tiny_cfg
from tests.test_torch_graphs import stand_in  # noqa: F401

torch.set_num_threads(2)

FEAT = dict(rtol=1e-4, atol=1e-5)
LOGITS = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def encoder():
    cfg = _tiny_cfg()
    m = _hf_encoder(cfg)
    return cfg, m, _params_from_hf(cfg, m)


def chunked(cfg, mel, mel_len):
    ck = cfg.chunk_frames
    n_chunks = -(-mel_len // ck)
    mel_p = np.zeros((cfg.num_mel_bins, n_chunks * ck), np.float32)
    mel_p[:, :mel_len] = mel
    return mel_p.T.reshape(n_chunks, ck, cfg.num_mel_bins).transpose(0, 2, 1)


def both_encode(cfg, jp, tp, chunks, mel_len, mask=None):
    valid, block = jasr.encoder_masks(cfg, mel_len, chunks.shape[0])
    block = block if mask is None else mask
    ref = np.asarray(jasr.aut_encode(cfg, jp, jnp.asarray(chunks), jnp.asarray(valid),
                                     jnp.asarray(block)))[valid]
    got = tasr.aut_encode(cfg, tp, torch.from_numpy(chunks), torch.from_numpy(valid),
                          torch.from_numpy(block)).numpy()[valid]
    return got, ref


@pytest.mark.parametrize("mel_len", [100, 137, 240, 455, 800])
def test_aut_encode_matches_crane_tpu(encoder, mel_len):
    cfg, _, jp = encoder
    tp = audio_params_from_jax(jp)
    mel = np.random.default_rng(mel_len).normal(size=(cfg.num_mel_bins, mel_len)).astype(np.float32)
    got, ref = both_encode(cfg, jp, tp, chunked(cfg, mel, mel_len), mel_len)
    assert got.shape == ref.shape == (tasr.feat_extract_output_lengths(cfg, mel_len),
                                      cfg.output_dim)
    np.testing.assert_allclose(got, ref, **FEAT)


def test_map_aut_weights_gives_the_bridged_tree(encoder):
    cfg, m, jp = encoder
    sd = {k: v.detach() for k, v in m.state_dict().items()}
    mine = tasr.map_aut_weights(cfg, sd, torch.float32, "cpu")
    bridged = audio_params_from_jax(jp)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    a, b = dict(leaves(mine)), dict(leaves(bridged))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_window_isolation(encoder):
    """Tokens in different n_window_infer windows do not interact, and
    without the window mask they do."""
    cfg, _, jp = encoder
    tp = audio_params_from_jax(jp)
    rng = np.random.default_rng(0)
    mel_len = 800
    mel = rng.normal(size=(cfg.num_mel_bins, mel_len)).astype(np.float32)
    mel2 = mel.copy()
    mel2[:, 400:] = rng.normal(size=(cfg.num_mel_bins, 400)).astype(np.float32)
    w = cfg.window_tokens
    o1, _ = both_encode(cfg, jp, tp, chunked(cfg, mel, mel_len), mel_len)
    o2, _ = both_encode(cfg, jp, tp, chunked(cfg, mel2, mel_len), mel_len)
    np.testing.assert_array_equal(o1[:w], o2[:w])
    assert np.abs(o1[w:] - o2[w:]).max() > 0
    valid, _ = tasr.encoder_masks(cfg, mel_len, mel_len // cfg.chunk_frames)
    full = np.ones((len(valid), len(valid)), bool)
    a1, r1 = both_encode(cfg, jp, tp, chunked(cfg, mel, mel_len), mel_len, full)
    a2, _ = both_encode(cfg, jp, tp, chunked(cfg, mel2, mel_len), mel_len, full)
    assert np.abs(a1[:w] - a2[:w]).max() > 0
    np.testing.assert_allclose(a1, r1, **FEAT)


def test_output_lengths_and_masks_match():
    for cfg in (jasr.AuTConfig(), _tiny_cfg()):
        tcfg = tasr.AuTConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        assert (tcfg.tokens_per_chunk, tcfg.window_tokens, tcfg.post_conv_mel_bins) == \
            (cfg.tokens_per_chunk, cfg.window_tokens, cfg.post_conv_mel_bins)
        for n in [1, 80, 100, 101, 137, 200, 299, 300, 455, 1000, 1499, 2000]:
            assert tasr.feat_extract_output_lengths(tcfg, n) == \
                jasr.feat_extract_output_lengths(cfg, n), n
            chunks = -(-n // cfg.chunk_frames)
            for a, b in zip(tasr.encoder_masks(tcfg, n, chunks), jasr.encoder_masks(cfg, n, chunks)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tasr.sinusoid_table(50, 64), jasr.sinusoid_table(50, 64))


def test_init_aut_params_draws_crane_tpus_values():
    cfg = _tiny_cfg()
    got = tasr.init_aut_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    ref = audio_params_from_jax(jasr.init_aut_params(cfg, seed=3, dtype=jnp.float32))
    torch.testing.assert_close(got["conv2_w"], ref["conv2_w"], rtol=0, atol=0)
    torch.testing.assert_close(got["layers"][1]["fc2_w"], ref["layers"][1]["fc2_w"],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["proj2_w"], ref["proj2_w"], rtol=0, atol=0)


AUDIO_TOKENS = ["<|audio_start|>", "<|audio_pad|>", "<|audio_end|>", "<|im_start|>", "<|im_end|>"]


def make_tiny_qwen3_asr_checkpoint(path) -> str:
    """tests/test_qwen3_asr_parity.py's tiny checkpoint (its
    ``test_e2e_transcribe_with_tiny_checkpoint``) written to ``path``."""
    import safetensors.numpy as st
    import tokenizers

    from tests.fixtures import make_tiny_tokenizer

    cfg = _tiny_cfg()
    m = _hf_encoder(cfg)
    hf_sd = m.state_dict()
    a_sd = {"model.audio_tower." + k: v.detach().numpy() for k, v in hf_sd.items()
            if not k.startswith(("proj1", "proj2", "positional_embedding"))}
    for i in (1, 2):
        for w in ("weight", "bias"):
            a_sd[f"model.multi_modal_projector.linear_{i}.{w}"] = hf_sd[f"proj{i}.{w}"].numpy()
    make_tiny_tokenizer(str(path), extra_tokens=AUDIO_TOKENS)
    V = tokenizers.Tokenizer.from_file(str(path / "tokenizer.json")).get_vocab_size()
    rng = np.random.default_rng(0)
    E = 48

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.05

    lm_sd = {"model.language_model.embed_tokens.weight": r(V, E),
             "model.language_model.norm.weight": np.ones(E, np.float32),
             "lm_head.weight": r(V, E)}
    for i in range(2):
        L = f"model.language_model.layers.{i}."
        lm_sd |= {
            L + "input_layernorm.weight": np.ones(E, np.float32),
            L + "post_attention_layernorm.weight": np.ones(E, np.float32),
            L + "self_attn.q_proj.weight": r(64, E), L + "self_attn.k_proj.weight": r(32, E),
            L + "self_attn.v_proj.weight": r(32, E), L + "self_attn.o_proj.weight": r(E, 64),
            L + "self_attn.q_norm.weight": np.ones(16, np.float32),
            L + "self_attn.k_norm.weight": np.ones(16, np.float32),
            L + "mlp.gate_proj.weight": r(96, E), L + "mlp.up_proj.weight": r(96, E),
            L + "mlp.down_proj.weight": r(E, 96),
        }
    st.save_file({**a_sd, **lm_sd}, str(path / "model.safetensors"))
    config = {
        "model_type": "qwen3_asr",
        "audio_config": {
            "d_model": cfg.d_model, "encoder_layers": cfg.num_layers,
            "encoder_attention_heads": cfg.num_heads, "encoder_ffn_dim": cfg.ffn_dim,
            "num_mel_bins": cfg.num_mel_bins, "downsample_hidden_size": cfg.downsample_hidden_size,
            "output_dim": cfg.output_dim, "n_window": cfg.n_window,
            "n_window_infer": cfg.n_window_infer, "max_source_positions": cfg.max_source_positions,
        },
        "text_config": {
            "model_type": "qwen3", "vocab_size": V, "hidden_size": E, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
            "intermediate_size": 96, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
            "max_position_embeddings": 2048, "tie_word_embeddings": False,
        },
    }
    (path / "config.json").write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope="module")
def asr_pair(tmp_path_factory):
    d = make_tiny_qwen3_asr_checkpoint(tmp_path_factory.mktemp("qwen3_asr"))
    return d, jasr.load_qwen3_asr(d), tasr.load_qwen3_asr(d, device="cpu")


def speech(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 250 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def test_features_and_prefill_logits_match(asr_pair):
    _, jm, tm = asr_pair
    for n in (4000, 16000, 37000):
        wav = speech(n, n)
        assert tm.n_audio_tokens(n) == jm.n_audio_tokens(n)
        np.testing.assert_allclose(tm.encode_audio(wav).numpy(),
                                   np.asarray(jm.encode_audio(wav)), **FEAT)
    from crane_tpu.models.modules.embeds_decode import embeds_prefill as jprefill
    from crane_tpu.models.modules.transformer import make_cache as jcache
    from crane_tpu_torch.models.modules.embeds_decode import embeds_prefill
    from crane_tpu_torch.models.modules.transformer import make_cache

    wav = speech(1, 16000)
    ids = jm.tokenizer.encode(jm.build_prompt(jm.n_audio_tokens(len(wav))))
    pos = np.where(np.asarray(ids) == jm.audio_token_id)[0]
    feats = np.asarray(jm.encode_audio(wav))
    embeds = np.asarray(jm.params["embed"])[ids][None].copy()
    embeds[0, pos] = feats
    embeds = np.pad(embeds, ((0, 0), (0, 64 * ((len(ids) + 63) // 64) - len(ids)), (0, 0)))
    ref, _ = jprefill(jm.config, jm.params, jm.rope, jcache(jm.config, 1, 256, jnp.float32),
                      jnp.asarray(embeds), jnp.asarray(len(ids), jnp.int32))
    got, _ = embeds_prefill(tm.config, tm.params, tm.rope, make_cache(tm.config, 1, 256, torch.float32),
                            torch.from_numpy(embeds), len(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGITS)


@pytest.mark.parametrize("n,new", [(16000, 40), (9000, 17), (24000, 1)])
def test_greedy_ids_and_text_match(asr_pair, n, new):
    _, jm, tm = asr_pair
    wav = speech(n, n)
    ids = jm.tokenizer.encode(jm.build_prompt(jm.n_audio_tokens(n), "hi"))
    ref = jm.generate(ids, wav, max_new_tokens=new)
    assert tm.generate(ids, wav, max_new_tokens=new) == ref
    assert len(ref) == new
    assert tm.transcribe(wav, context="hi", max_new_tokens=new) == \
        jm.transcribe(wav, context="hi", max_new_tokens=new)


def test_eos_inside_a_block_and_from_the_prefill(asr_pair, monkeypatch):
    _, jm, tm = asr_pair
    wav = speech(2, 16000)
    ids = jm.tokenizer.encode(jm.build_prompt(jm.n_audio_tokens(len(wav))))
    free = jm.generate(ids, wav, max_new_tokens=30)
    for eos in (free[5], free[0]):  # inside the first block; the prefill's token
        for m in (jm, tm):
            monkeypatch.setattr(m, "eos_token_ids", (eos,))
        ref = jm.generate(ids, wav, max_new_tokens=30)
        assert tm.generate(ids, wav, max_new_tokens=30) == ref
        assert ref[-1] == eos and len(ref) <= 30


def test_decode_block_equals_single_steps(asr_pair):
    from crane_tpu_torch.models.modules.embeds_decode import (
        greedy_decode_block,
        greedy_decode_step,
    )
    from crane_tpu_torch.models.modules.transformer import make_cache

    _, _, tm = asr_pair
    cfg = tm.config
    out = {}
    for kind in ("block", "steps"):
        cache = make_cache(cfg, 2, 64, torch.float32)
        cache.lengths.fill_(0)
        tok = torch.tensor([7, 11], dtype=torch.int32)
        if kind == "block":
            toks, cache = greedy_decode_block({}, cfg, tm.params, tm.rope, cache, tok, 16)
        else:
            steps = []
            for _ in range(16):
                tok, cache = greedy_decode_step({}, cfg, tm.params, tm.rope, cache, tok)
                steps.append(tok)
            toks = torch.stack(steps, 1)
        out[kind] = (toks, cache.lengths.clone(), cache.layers[1].k.clone())
    assert torch.equal(out["block"][0], out["steps"][0])
    assert out["block"][1].tolist() == out["steps"][1].tolist() == [16, 16]
    torch.testing.assert_close(out["block"][2], out["steps"][2], rtol=0, atol=0)


def test_loaded_params_equal_crane_tpus(asr_pair):
    _, jm, tm = asr_pair
    ref = params_from_jax({k: v for k, v in jm.params.items() if k != "audio"})
    for k in ("embed", "lm_head", "final_norm"):
        torch.testing.assert_close(tm.params[k], ref[k], rtol=0, atol=0)
    torch.testing.assert_close(tm.params["audio"]["conv_out"],
                               audio_params_from_jax(jm.params["audio"])["conv_out"],
                               rtol=0, atol=0)
    assert tm.audio_token_id == jm.audio_token_id
    assert tm.eos_token_ids == jm.eos_token_ids


def test_generate_replays_one_block_program(asr_pair, stand_in):  # noqa: F811
    """Through the graph dispatch (a stand-in for the card's CUDA graph):
    one program of 16 steps, captured once and replayed once a block, the
    same ids as the eager blocks and crane_tpu."""
    from crane_tpu_torch.models import graphs

    _, jm, tm = asr_pair
    wav = speech(3, 16000)
    ids = jm.tokenizer.encode(jm.build_prompt(jm.n_audio_tokens(len(wav))))
    with graphs.eager():
        eager = tm.generate(ids, wav, max_new_tokens=40)
    tm.release_graphs()
    start = graphs.replays
    got = tm.generate(ids, wav, max_new_tokens=40)
    assert got == eager == jm.generate(ids, wav, max_new_tokens=40)
    assert len(stand_in) == len(tm._programs) == 1
    assert graphs.replays - start == 3  # 1 + 3 x 16 tokens cover 40
    tm.release_graphs()
