"""crane_tpu_torch's GGUF loading against crane_tpu's on the same files.

- ``loaders/gguf.py`` (a copy) parses and dequantizes every GGML type
  byte-identically to ``crane_tpu.loaders.gguf``, by the native route and by
  ``CRANE_NATIVE=0``; the native library is built under ``build/native/``.
- ``config_from_gguf`` equals crane_tpu's field by field; the weights of
  ``map_gguf_weights`` equal crane_tpu's through the bridge (f32, and q8_0
  and q4_0 kept quantized as blockwise weights).
- ``from_gguf``'s greedy tokens equal crane_tpu's on the files of
  tests/test_gguf_model.py and on the qwen35 hybrid file of
  tests/test_gguf_hybrid.py, whose value-head order matters.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as RefGen
from crane_tpu.loaders import gguf as ref_gguf
from crane_tpu.loaders import gguf_model as ref_model
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.loaders import gguf, gguf_model
from crane_tpu_torch.ops.linear import QuantizedWeight
from crane_tpu_torch.utils.bridge import params_from_jax
from tests.fixtures import make_tiny_qwen3_checkpoint
from tests.test_gguf import write_gguf
from tests.test_gguf_model import HF_TO_GGUF, LAYER_MAP, _gguf_metadata

torch.set_num_threads(2)

BLOCK_TYPES = {
    gguf.GGML_Q8_0: (32, 34), gguf.GGML_Q4_0: (32, 18), gguf.GGML_Q4_1: (32, 20),
    gguf.GGML_Q5_0: (32, 22), gguf.GGML_Q5_1: (32, 24), gguf.GGML_Q4_K: (256, 144),
    gguf.GGML_Q5_K: (256, 176), gguf.GGML_Q6_K: (256, 210),
}
PROMPT = [3, 14, 15, 52, 6]  # in the tiny tokenizer's 67-token vocabulary


def random_raw(ggml_type: int, n_blocks: int, seed: int) -> tuple[np.ndarray, int]:
    """Random bytes of ``n_blocks`` blocks of ``ggml_type`` with finite f16
    scale fields (tests/test_native_dequant.py's recipe), and the element
    count."""
    rng = np.random.default_rng(seed)
    if ggml_type in (gguf.GGML_F32, gguf.GGML_F16, gguf.GGML_BF16):
        x = rng.standard_normal(n_blocks * 32).astype(np.float32)
        raw = {gguf.GGML_F32: x, gguf.GGML_F16: x.astype(np.float16),
               gguf.GGML_BF16: (x.view(np.uint32) >> 16).astype(np.uint16)}[ggml_type]
        return np.frombuffer(raw.tobytes(), np.uint8), x.size
    be, bb = BLOCK_TYPES[ggml_type]
    blocks = rng.integers(0, 256, (n_blocks, bb), dtype=np.uint8)
    halves = 2 if ggml_type in (gguf.GGML_Q4_1, gguf.GGML_Q5_1, gguf.GGML_Q4_K,
                                gguf.GGML_Q5_K) else 1
    blocks[:, :2 * halves] = (rng.standard_normal((n_blocks, halves)) * 0.01) \
        .astype(np.float16).view(np.uint8)
    if ggml_type == gguf.GGML_Q6_K:
        blocks[:, 208:210] = (rng.standard_normal((n_blocks, 1)) * 0.01) \
            .astype(np.float16).view(np.uint8)
    return blocks.reshape(-1), n_blocks * be


ALL_TYPES = [gguf.GGML_F32, gguf.GGML_F16, gguf.GGML_BF16, *sorted(BLOCK_TYPES)]


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("ggml_type", ALL_TYPES, ids=[gguf.GGML_TYPE_NAMES[t] for t in ALL_TYPES])
def test_dequantize_byte_identical(ggml_type, native, monkeypatch):
    if native == "numpy":
        monkeypatch.setenv("CRANE_NATIVE", "0")
    raw, n = random_raw(ggml_type, 24, ggml_type)
    got = gguf.dequantize(raw.copy(), ggml_type, n)
    ref = ref_gguf.dequantize(raw.copy(), ggml_type, n)
    assert got.dtype == ref.dtype  # float32; the NumPy q5_0/q5_1 route promotes to float64
    assert got.tobytes() == ref.tobytes()


def test_native_route_builds_under_build_dir(monkeypatch):
    from crane_tpu.native import gguf_dequant_native as ref_native
    from crane_tpu_torch import native

    if ref_native(np.zeros(34, np.uint8), ref_gguf.GGML_Q8_0, 32) is None:
        pytest.skip("no g++ with OpenMP for the reference's native route either")
    assert gguf.dequant_route() == "native"
    path = native.library_path("gguf_dequant")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    monkeypatch.setenv("CRANE_NATIVE", "0")
    assert gguf.dequant_route() == "numpy"


def test_quantizers_and_reader_match(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    assert gguf.quantize_q8_0(x).tobytes() == ref_gguf.quantize_q8_0(x).tobytes()
    assert gguf.quantize_q4_0(x).tobytes() == ref_gguf.quantize_q4_0(x).tobytes()
    tensors = {"dense.weight": (gguf.GGML_F32, x.shape, x.tobytes()),
               "q8.weight": (gguf.GGML_Q8_0, x.shape, gguf.quantize_q8_0(x).tobytes()),
               "q4.weight": (gguf.GGML_Q4_0, x.shape, gguf.quantize_q4_0(x).tobytes())}
    for t in sorted(BLOCK_TYPES)[2:]:
        raw, n = random_raw(t, 2, t)
        tensors[f"{gguf.GGML_TYPE_NAMES[t]}.weight"] = (t, (n // 64, 64), raw.tobytes())
    path = write_gguf(str(tmp_path / "t.gguf"),
                      {"general.architecture": "qwen3", "qwen3.block_count": 2,
                       "tokenizer.ggml.tokens": ["<unk>", "a", "b"], "general.alignment": 32},
                      tensors)
    r, ref = gguf.GGUFReader(path), ref_gguf.GGUFReader(path)
    assert r.metadata == ref.metadata and r.architecture == ref.architecture
    assert r.tensors.keys() == ref.tensors.keys()
    for name in r.tensors:
        assert dataclasses.asdict(r.tensors[name]) == dataclasses.asdict(ref.tensors[name])
        assert r.tensor(name).tobytes() == ref.tensor(name).tobytes()
        assert r.raw_tensor(name)[1].tobytes() == ref.raw_tensor(name)[1].tobytes()


# ── tiny Qwen3 GGUF files (tests/test_gguf_model.py's conversion) ─────────


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_qwen3_checkpoint(str(tmp_path_factory.mktemp("gg") / "m"))


def gguf_tensors(d, quant=None):
    """The checkpoint's tensors in the GGUF layout; ``quant`` ("q8_0" or
    "q4_0") stores its 2-D linears quantized, the rest f32."""
    from crane_tpu.loaders.safetensors_loader import load_state_dict

    quantize = {"q8_0": (gguf.GGML_Q8_0, gguf.quantize_q8_0),
                "q4_0": (gguf.GGML_Q4_0, gguf.quantize_q4_0)}.get(quant)
    out = {}
    for name, arr in load_state_dict(d).items():
        arr = np.asarray(arr, np.float32)
        gname = HF_TO_GGUF.get(name)
        if gname is None:
            parts = name.split(".")
            gname = f"blk.{parts[2]}.{LAYER_MAP['.'.join(parts[3:])]}"
        if quantize and arr.ndim == 2 and arr.shape[1] % 32 == 0 and "embd" not in gname \
                and gname != "output.weight":
            out[gname] = (quantize[0], arr.shape, quantize[1](arr).tobytes())
        else:
            out[gname] = (gguf.GGML_F32, arr.shape, arr.tobytes())
    return out


@pytest.fixture(scope="module")
def files(ckpt, tmp_path_factory):
    """f32, q8_0 and q4_0 files, and one with the embedded BPE tokenizer."""
    from tokenizers import Tokenizer

    d = tmp_path_factory.mktemp("files")
    md = _gguf_metadata(ckpt, Tokenizer.from_file(f"{ckpt}/tokenizer.json"))
    out = {q or "f32": write_gguf(str(d / f"{q or 'f32'}.gguf"), md, gguf_tensors(ckpt, q))
           for q in (None, "q8_0", "q4_0")}
    with open(f"{ckpt}/tokenizer.json") as f:
        merges = json.load(f)["model"]["merges"]
    md_tok = {**md, "tokenizer.ggml.merges": [m if isinstance(m, str) else " ".join(m)
                                              for m in merges]}
    out["tok"] = write_gguf(str(d / "tok.gguf"), md_tok, gguf_tensors(ckpt))
    return out


def assert_same_tree(got, ref, path="params"):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            assert_same_tree(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_tree(g, r, f"{path}[{i}]")
    elif isinstance(ref, QuantizedWeight):
        assert isinstance(got, QuantizedWeight), path
        assert (got.block, got.bits) == (ref.block, ref.bits), path
        assert torch.equal(got.codes, ref.codes) and torch.equal(got.scales, ref.scales), path
    else:
        assert got.dtype == ref.dtype and torch.equal(got, ref), path


@pytest.mark.parametrize("name", ["f32", "q8_0", "q4_0"])
def test_config_and_weights_match(files, name):
    r, ref = gguf.GGUFReader(files[name]), ref_gguf.GGUFReader(files[name])
    cfg, ref_cfg = gguf_model.config_from_gguf(r), ref_model.config_from_gguf(ref)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    params = gguf_model.map_gguf_weights(cfg, r, torch.float32, device="cpu")
    ref_params = params_from_jax(ref_model.map_gguf_weights(ref_cfg, ref, jnp.float32))
    assert_same_tree(params, ref_params)
    wq = params["layers"][0]["attn"]["wq"]
    if name == "f32":
        assert isinstance(wq, torch.Tensor)
    else:
        assert isinstance(wq, QuantizedWeight) and wq.block == 32
        assert wq.bits == (8 if name == "q8_0" else 4)
        dense = gguf_model.map_gguf_weights(cfg, r, torch.float32, keep_quant=False,
                                            device="cpu")
        torch.testing.assert_close(wq.dequant(torch.float32), dense["layers"][0]["attn"]["wq"],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 16, 64), (2, 1, 64), (16, 64), (3, 5, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blockwise_linear_output_is_contiguous(shape, dtype):
    """A GGUF blockwise weight's product comes back contiguous, as the
    dense and per-channel routes' do: the attention kernels on the card
    refuse strided q/k/v (found on the card, where the GGUF model's prefill
    stopped at K2)."""
    from crane_tpu_torch.ops.linear import linear, quantize_weight

    w = quantize_weight(torch.randn(64, 96, generator=torch.Generator().manual_seed(1)),
                        bits=8, block=32, granularity="block")
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    y = linear(x, w)
    assert y.shape == (*shape[:-1], 96) and y.is_contiguous()
    ref = (x.float() @ w.dequant(torch.float32)).to(dtype)
    torch.testing.assert_close(y, ref, rtol=1e-2 if dtype == torch.bfloat16 else 1e-5,
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("name", ["f32", "q8_0", "q4_0"])
def test_from_gguf_greedy_tokens_match(files, ckpt, name):
    lm = gguf_model.from_gguf(files[name], dtype=torch.float32, device="cpu")
    ref = ref_model.from_gguf(files[name], dtype=jnp.float32)
    got = lm.generate(PROMPT, GenerationConfig.greedy(10))
    assert got == ref.generate(PROMPT, RefGen.greedy(10))
    if name == "f32":  # the same weights: token-exact against the safetensors checkpoint too
        from crane_tpu_torch.models.auto import from_pretrained

        st = from_pretrained(ckpt, dtype=torch.float32, device="cpu")
        assert got == st.generate(PROMPT, GenerationConfig.greedy(10))
    assert lm.eos_token_ids == ref.eos_token_ids == (1,)


def test_embedded_tokenizer_matches(files):
    lm = gguf_model.from_gguf(files["tok"], dtype=torch.float32, device="cpu")
    ref = ref_model.from_gguf(files["tok"], dtype=jnp.float32)
    assert lm.tokenizer is not None
    ids = lm.tokenizer.encode("hello world")
    assert ids == ref.tokenizer.encode("hello world")
    msgs = [{"role": "user", "content": "hi"}]
    assert lm.tokenizer.apply_chat_template(msgs) == ref.tokenizer.apply_chat_template(msgs) \
        == "hi"
    assert lm.tokenizer.decode(ids) == ref.tokenizer.decode(ids)


def test_from_gguf_without_tokenizers_package(files, monkeypatch):
    """Where ``tokenizers`` cannot be imported (the machine with the card),
    from_gguf loads the model with no tokenizer."""
    import builtins

    real_import = builtins.__import__

    def no_tokenizers(name, *args, **kw):
        if name.split(".")[0] == "tokenizers":
            raise ImportError("blocked")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    lm = gguf_model.from_gguf(files["tok"], dtype=torch.float32, device="cpu")
    assert lm.tokenizer is None and lm.config.num_layers == 2


def test_from_gguf_defaults_to_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gguf_model.from_gguf(files["f32"])


# ── the qwen35 hybrid (tests/test_gguf_hybrid.py's conversion) ─────────────


@pytest.fixture(scope="module")
def hybrid_file(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    from tests.test_gguf_hybrid import HK, K, V, VG, _convert_to_gguf

    torch.manual_seed(0)
    cfg = transformers.Qwen3NextConfig(
        vocab_size=160, hidden_size=64, intermediate_size=96,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, linear_num_value_heads=HK * VG, linear_num_key_heads=HK,
        linear_key_head_dim=K, linear_value_head_dim=V,
        linear_conv_kernel_dim=4, partial_rotary_factor=0.25,
        max_position_embeddings=256, num_experts=0, decoder_sparse_step=0,
        tie_word_embeddings=False,
        layer_types=["linear_attention"] * 3 + ["full_attention"],
    )
    d = tmp_path_factory.mktemp("gh")
    transformers.Qwen3NextForCausalLM(cfg).eval().to(torch.float32) \
        .save_pretrained(str(d / "m"), safe_serialization=True)
    return _convert_to_gguf(str(d / "m"), str(d / "m.gguf"))


def test_hybrid_config_weights_and_tokens_match(hybrid_file):
    r, ref = gguf.GGUFReader(hybrid_file), ref_gguf.GGUFReader(hybrid_file)
    cfg = gguf_model.config_from_gguf(r)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_model.config_from_gguf(ref))
    assert cfg.layer_type(0) == "gdn" and cfg.layer_type(3) == "full" and cfg.attn_output_gate
    assert_same_tree(gguf_model.map_gguf_weights(cfg, r, torch.float32, device="cpu"),
                     params_from_jax(ref_model.map_gguf_weights(cfg, ref, jnp.float32)))
    lm = gguf_model.from_gguf(hybrid_file, dtype=torch.float32, device="cpu")
    ref_lm = ref_model.from_gguf(hybrid_file, dtype=jnp.float32)
    assert lm.generate(PROMPT, GenerationConfig.greedy(10)) \
        == ref_lm.generate(PROMPT, RefGen.greedy(10))


def test_hybrid_head_order_matters(hybrid_file, monkeypatch):
    """Without the chunked -> interleaved value-head permutation the logits
    change: the port's loader applies it (tests/test_gguf_hybrid.py's
    guard against silently mispaired heads)."""
    from crane_tpu_torch.models.causal_lm import CausalLM

    r = gguf.GGUFReader(hybrid_file)
    cfg = gguf_model.config_from_gguf(r)

    def logits(params):
        lm = CausalLM(cfg, params, dtype=torch.float32)
        out, _ = lm.prefill(lm.init_cache(1, 16), [PROMPT], [len(PROMPT)])
        return out

    good = logits(gguf_model.map_gguf_weights(cfg, r, torch.float32, device="cpu"))
    monkeypatch.setattr(gguf_model, "_chunked_to_interleaved_perm",
                        lambda n, v: np.arange(n * v))
    bad = logits(gguf_model.map_gguf_weights(cfg, r, torch.float32, device="cpu"))
    assert (good - bad).abs().max().item() > 1e-3
