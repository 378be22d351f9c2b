"""Package-level guarantees of crane_tpu_torch, checked without a card.

- Every module imports with jax, crane_tpu (the JAX package, whose jax-free
  modules the port keeps its own copies of) and the packages the card
  machine lacks (PIL and regex among them) blocked, in a fresh interpreter:
  tests/conftest.py has already imported jax into this one. A root of exactly ``crane_tpu`` does
  not match ``crane_tpu_torch``.
- The kernel build directory is ignored by git.
- No CUDA wrapper catches an exception or reads an environment switch, so
  nothing can fall back from a kernel to the plain version.
- chip_smoke.py imports neither jax nor crane_tpu, and exits non-zero with
  no CUDA device or outside a checkout.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import crane_tpu_torch
from crane_tpu_torch.ops.cuda import build

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(crane_tpu_torch.__file__).parent

IMPORT_ALL = r"""
import importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "crane_tpu", "tokenizers", "safetensors", "transformers", "aiohttp",
           "jinja2", "PIL", "regex")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import crane_tpu_torch
names = [m.name for m in pkgutil.walk_packages(crane_tpu_torch.__path__, "crane_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(" ".join(names))
print(len(names))
"""


def test_every_module_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 100  # every module of the slices so far was walked
    walked = set(res.stdout.split())
    # the server, its transport, GGUF loading and the SDK import without aiohttp
    assert {"crane_tpu_torch.serve.api", "crane_tpu_torch.serve.transport",
            "crane_tpu_torch.serve.__main__", "crane_tpu_torch.loaders.gguf",
            "crane_tpu_torch.loaders.gguf_model", "crane_tpu_torch.native",
            "crane_tpu_torch.sdk.client"} <= walked
    # the MoE and short-conv hybrids (moe_block, short_conv_block and
    # ConvLayerCache, their configs, mapping and random weights) and the
    # out-of-vocabulary guard of generate, the engine and the server
    assert {"crane_tpu_torch.models.modules.transformer", "crane_tpu_torch.ops.kv_cache",
            "crane_tpu_torch.models.auto", "crane_tpu_torch.models.init",
            "crane_tpu_torch.models.causal_lm", "crane_tpu_torch.serve.engine",
            "crane_tpu_torch.utils.bridge"} <= walked
    # gemma3n, the vision-language models, their loaders and the vision SDK
    assert {"crane_tpu_torch.loaders.safetensors_loader", "crane_tpu_torch.models.factory",
            "crane_tpu_torch.models.gemma3n", "crane_tpu_torch.models.image_processing",
            "crane_tpu_torch.models.modules.vision", "crane_tpu_torch.models.modules.embeds_decode",
            "crane_tpu_torch.models.qwen3_vl", "crane_tpu_torch.models.gemma3_vl",
            "crane_tpu_torch.models.paddleocr_vl", "crane_tpu_torch.sdk.vision"} <= walked
    # audio in: the mel frontend, the ASR models, the VAD and the ASR SDK
    assert {"crane_tpu_torch.audio.mel", "crane_tpu_torch.models.qwen3_asr",
            "crane_tpu_torch.models.qwen2_audio", "crane_tpu_torch.models.whisper",
            "crane_tpu_torch.models.moonshine", "crane_tpu_torch.models.silero_vad",
            "crane_tpu_torch.sdk.audio"} <= walked
    # speech out: Qwen3-TTS, its speech tokenizer and speaker encoder, CSM, Mimi
    assert {"crane_tpu_torch.models.qwen3_tts", "crane_tpu_torch.models.speech_tokenizer",
            "crane_tpu_torch.models.speaker_encoder", "crane_tpu_torch.models.csm_tts",
            "crane_tpu_torch.models.mimi"} <= walked
    # the rest of speech and vision: Voxtral TTS, Kokoro, the OCR nets and
    # pipeline, SNAC, the ONNX evaluator, the G2P modules, the Tekken
    # tokenizer (regex is imported at first use: blocked here)
    assert {"crane_tpu_torch.models.voxtral_tts", "crane_tpu_torch.models.kokoro_tts",
            "crane_tpu_torch.models.snac_onnx", "crane_tpu_torch.ocr.nets",
            "crane_tpu_torch.ocr.pipeline", "crane_tpu_torch.onnx.wire",
            "crane_tpu_torch.onnx.session", "crane_tpu_torch.onnx.optimizer",
            "crane_tpu_torch.text.g2p", "crane_tpu_torch.text.german",
            "crane_tpu_torch.text.english_rules", "crane_tpu_torch.text.oov",
            "crane_tpu_torch.text.lexicon", "crane_tpu_torch.text.ipa_postprocess",
            "crane_tpu_torch.text.cer", "crane_tpu_torch.text.seed_lexicon",
            "crane_tpu_torch.tokenizer.tekken"} <= walked
    # projection fusion, host timing, tracing spans and the activations
    # (crane_tpu's timing.py imports no jax, but the port keeps its own copy)
    assert {"crane_tpu_torch.models.fuse", "crane_tpu_torch.utils.timing",
            "crane_tpu_torch.utils.tracing", "crane_tpu_torch.ops.activations"} <= walked


def test_kernel_build_directory_is_git_ignored():
    rel = build.BUILD_DIR.relative_to(ROOT)
    ignored = [ln.strip().rstrip("/") for ln in (ROOT / ".gitignore").read_text().splitlines()]
    assert rel.parts[0] in ignored
    assert build.library_path().parent == build.BUILD_DIR


def test_cuda_wrappers_never_fall_back():
    """A wrapper given a CUDA tensor launches its kernel or raises: no
    try/except anywhere in the kernel bindings, and no environment switch
    that could turn a kernel off."""
    for path in sorted((PKG / "ops" / "cuda").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            assert not isinstance(node, ast.Try), f"{path.name}:{node.lineno} catches"
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("environ", "getenv"), f"{path.name}:{node.lineno}"


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_and_refusals(tmp_path):
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "jax" not in roots and "crane_tpu" not in roots
    assert roots <= {"__future__", "concurrent", "contextlib", "dataclasses", "http", "json",
                     "os", "struct", "subprocess", "sys", "tempfile", "threading", "time", "uuid",
                     "numpy", "torch", "crane_tpu_torch"}
    # this interpreter's torch has no CUDA device: no result, non-zero exit
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    # alone in a directory, outside a checkout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode != 0 and '"ok"' not in res.stdout
