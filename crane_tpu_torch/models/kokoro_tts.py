"""Kokoro-style lightweight TTS: G2P -> phoneme IDs -> style-conditioned
synthesis -> 24 kHz waveform.

Port of ``crane_tpu/models/kokoro_tts.py``. Reference behavior (crane-core
``src/models/kokoro_tts/``): the reference keeps the synthesis net as an
ONNX graph (model.rs:278-331, run through its vendored evaluator) and
implements natively only the pipeline around it — per-language IPA
normalization collapsing multi-codepoint sequences into Kokoro's
single-codepoint vocab (ipa.rs:22-47: affricate ligatures, diphthong letters
A/I/W/O/Q/Y, English rhotic expansions), 510-codepoint phoneme chunking that
cuts at the last space (model.rs:227-276), per-chunk voice style row
``min(codepoints, rows) - 1`` (model.rs:540-543), and `$` as pad/BOS/EOS.

The pipeline (``KokoroIpaNormalizer``, ``parse_vocab``, ``chunk_phonemes``,
``style_row_index``, ``load_voice_bin``, ``KokoroTts``,
``OnnxKokoroSynthesizer``, ``load_kokoro_onnx``) is host code, copied from
crane_tpu as it is, over the port's copies of ``onnx/`` and ``text/``.

The native synthesis net is ported to PyTorch on the caller's device (the
card unless the caller asks for the CPU): a phoneme encoder (embedding, a
conv stack, a bidirectional GRU of crane_tpu's own formula: gates split as
``z, r, u``, the candidate ``tanh(u + r * (h @ wu))``, not ``nn.GRU``'s), a
style-conditioned duration predictor (softplus, scaled by 1/speed, rounded
half to even as ``jnp.round`` is), length regulation, style-AdaIN decoder
convs (the population std, with 1e-5 added outside the root) and a
projection to ``hop`` samples per frame. crane_tpu computes the net with
XLA's convolutions and a ``lax.scan``, no Pallas kernel; the port runs it as
plain PyTorch. Conv weights are PyTorch's ``[Cout, Cin, k]`` (crane_tpu's
are WIO; ``utils/bridge.py`` :func:`kokoro_params_from_jax` carries them
across). crane_tpu draws the default weights with ``jax.random``; the port
draws them from a seeded ``torch.Generator`` at the same scales (ROADMAP
Queue 3).
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import torch
import torch.nn.functional as F

from crane_tpu_torch.utils.device import default_device

SAMPLE_RATE = 24_000
STYLE_DIM = 256
MAX_PHONEME_CODEPOINTS = 510
DEFAULT_VOICE = "af_heart"

# Multi-codepoint IPA -> Kokoro single-codepoint vocab (ipa.rs:22-34)
SHARED_REPLACEMENTS = (
    ("t͡ʃ", "ʧ"),  # t͡ʃ -> ʧ
    ("d͡ʒ", "ʤ"),  # d͡ʒ -> ʤ
    ("tʃ", "ʧ"),
    ("dʒ", "ʤ"),
    ("eɪ", "A"),  # FACE
    ("aɪ", "I"),  # PRICE
    ("aʊ", "W"),  # MOUTH
    ("oʊ", "O"),  # GOAT
    ("əʊ", "Q"),  # GOAT (reduced)
    ("ɔɪ", "Y"),  # CHOICE
)
# English-only rhotic vowel expansions (ipa.rs:43-47)
EN_EXTRA_REPLACEMENTS = (
    ("ɝ", "ɜɹ"),  # ɝ -> ɜɹ
    ("ɚ", "əɹ"),  # ɚ -> əɹ
)


class KokoroIpaNormalizer:
    """One-pass multi-replacement (regex alternation — the same
    longest-match-first automaton semantics as the reference's Aho-Corasick)
    followed by dropping any codepoint outside the vocab."""

    def __init__(self, language: str, vocab: dict):
        rules = list(SHARED_REPLACEMENTS)
        if language.startswith("en"):
            rules += list(EN_EXTRA_REPLACEMENTS)
        self._rules = dict(rules)
        # longer patterns first so ligature+tie-bar wins over the 2-char form
        pattern = "|".join(
            re.escape(src) for src in sorted(self._rules, key=len, reverse=True)
        )
        self._re = re.compile(pattern)
        self._vocab_chars = set(vocab)

    def normalize(self, ipa: str) -> str:
        replaced = self._re.sub(lambda m: self._rules[m.group(0)], ipa)
        return "".join(c for c in replaced if c in self._vocab_chars)


def parse_vocab(tokenizer_json_path: str) -> dict:
    """``tokenizer.json`` -> {single-codepoint phoneme: id} (model.rs:106-125)."""
    with open(tokenizer_json_path, encoding="utf-8") as f:
        vocab = json.load(f)["model"]["vocab"]
    out = {}
    for key, idx in vocab.items():
        if len(key) != 1:
            raise ValueError(f"Kokoro vocab keys must be single codepoints, got {key!r}")
        out[key] = int(idx)
    return out


def chunk_phonemes(phonemes: str, max_cp: int = MAX_PHONEME_CODEPOINTS) -> list:
    """Split into <= max_cp-codepoint chunks, cutting at the last space in
    each window (falling back to a hard cut), trimming each piece
    (model.rs:227-276)."""
    chars = list(phonemes)
    if len(chars) <= max_cp:
        piece = phonemes.strip()
        return [piece] if piece else []
    chunks = []
    rest = chars
    while rest:
        if len(rest) <= max_cp:
            piece = "".join(rest).strip()
            if piece:
                chunks.append(piece)
            break
        window = rest[: min(max_cp + 1, len(rest))]
        spaces = [i for i, c in enumerate(window) if c == " " and i > 0]
        cut = spaces[-1] if spaces else max_cp
        piece = "".join(rest[:cut]).strip()
        if piece:
            chunks.append(piece)
        nxt = cut
        while nxt < len(rest) and rest[nxt] == " ":
            nxt += 1
        rest = rest[nxt:]
    return chunks


def style_row_index(chunk_codepoints: int, voice_rows: int) -> int:
    """Voice style tables have one row per input length; pick
    ``min(len, rows) - 1`` (model.rs:540-543)."""
    return min(max(chunk_codepoints, 1), voice_rows) - 1


def load_voice_bin(path: str, style_dim: int = STYLE_DIM) -> np.ndarray:
    """Raw little-endian f32 voice file -> ``[rows, style_dim]``
    (model.rs:176-212: total length must divide the style dim)."""
    raw = np.fromfile(path, dtype="<f4")
    if raw.size == 0 or raw.size % style_dim:
        raise ValueError(f"voice file {path} has {raw.size} floats, not a multiple of {style_dim}")
    return raw.reshape(-1, style_dim)


# ---------------------------------------------------------------------------
# Native synthesis net (StyleTTS2-shaped)


@dataclasses.dataclass(frozen=True)
class KokoroNetConfig:
    vocab_size: int = 178
    dim: int = 128
    style_dim: int = STYLE_DIM
    hop: int = 600  # output samples per frame (24 kHz / 40 fps)
    max_duration: int = 50


def _gru_scan(p: dict, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """crane_tpu's minimal GRU over ``[T, C]``, one step a row: the input
    products of all rows in one matmul, then the recurrence."""
    C = p["wh"].shape[0]
    xw = x @ p["wx"] + p["b"]
    h = torch.zeros((C,), dtype=x.dtype, device=x.device)
    ys = [None] * x.shape[0]
    for t in (range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])):
        z, r, u = (xw[t] + h @ p["wh"]).chunk(3, dim=-1)
        z, r = torch.sigmoid(z), torch.sigmoid(r)
        h = (1 - z) * h + z * torch.tanh(u + r * (h @ p["wu"]))
        ys[t] = h
    return torch.stack(ys)


def _ada_in(x: torch.Tensor, style: torch.Tensor, p: dict) -> torch.Tensor:
    """Style-conditioned instance norm: normalize channels (the population
    std, 1e-5 added outside the root, as ``jnp.std``), then scale/shift from
    the style vector (the StyleTTS2 conditioning mechanism)."""
    mu = x.mean(dim=0, keepdim=True)
    sd = x.std(dim=0, keepdim=True, correction=0) + 1e-5
    gamma = style @ p["wg"] + 1.0
    beta = style @ p["wb"]
    return (x - mu) / sd * gamma + beta


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME conv over ``[T, C]`` (odd k, stride 1); w ``[Cout, Cin, k]``."""
    k = w.shape[-1]
    return F.conv1d(x.T[None], w, b, padding=(k - 1) // 2)[0].T


def encode_text(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """Phoneme ids ``[T]`` -> features ``[T, dim]``: embed, conv stack, BiGRU."""
    x = p["embed"][ids.long()]
    for cp in p["convs"]:
        x = torch.relu(_conv1d(x, cp["w"], cp["b"]))
    fwd = _gru_scan(p["gru_f"], x)
    bwd = _gru_scan(p["gru_b"], x, reverse=True)
    return torch.cat([fwd, bwd], dim=-1) @ p["proj"]


def duration_values(p: dict, feats: torch.Tensor, style: torch.Tensor,
                    speed: float) -> torch.Tensor:
    """The duration head's values before rounding: softplus of the head on
    style-adapted features, divided by speed ``[T]``."""
    h = _ada_in(feats, style, p["ada"])
    h = torch.relu(_conv1d(h, p["w1"], p["b1"]))
    return F.softplus(h @ p["w2"] + p["b2"])[:, 0] / speed


def predict_durations(p: dict, feats: torch.Tensor, style: torch.Tensor, speed: float,
                      max_duration: int) -> torch.Tensor:
    """Per-phoneme frame counts: :func:`duration_values` rounded half to
    even, clamped to [1, max_duration]."""
    d = torch.round(duration_values(p, feats, style, speed))
    return d.clamp(1, max_duration).to(torch.int32)


def synthesize_frames(p: dict, frames: torch.Tensor, style: torch.Tensor, hop: int) -> torch.Tensor:
    """Expanded frame features ``[F, dim]`` -> waveform ``[F * hop]``:
    AdaIN conv resblocks, then a projection to hop-sample patches."""
    x = frames
    for rp in p["res"]:
        h = _ada_in(x, style, rp["ada"])
        h = F.leaky_relu(_conv1d(h, rp["w1"], rp["b1"]), 0.2)
        h = F.leaky_relu(_conv1d(h, rp["w2"], rp["b2"]), 0.2)
        x = x + h
    wav = torch.tanh(x @ p["head_w"] + p["head_b"])  # [F, hop]
    return wav.reshape(-1)


def init_kokoro_net(cfg: KokoroNetConfig, seed: int = 0, device=None) -> dict:
    """Random weights at crane_tpu's scales (normal; linears ``fan_in **
    -0.5``, convs ``(k * C) ** -0.5``, embedding and AdaIN 0.02; zero
    biases), drawn from a ``torch.Generator`` seeded with ``seed`` on the
    CPU and placed on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    D, S = cfg.dim, cfg.style_dim

    def nrm(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    def lin(i, o):
        return nrm((i, o), i ** -0.5)

    def conv(kw, c):
        return {"w": nrm((c, c, kw), (kw * c) ** -0.5), "b": zeros(c)}

    def gru(c):
        return {"wx": lin(c, 3 * c), "wh": lin(c, 3 * c), "wu": lin(c, c), "b": zeros(3 * c)}

    def ada(c):
        return {"wg": nrm((S, c), 0.02), "wb": nrm((S, c), 0.02)}

    def res():
        return {"ada": ada(D), "w1": conv(3, D)["w"], "b1": zeros(D),
                "w2": conv(3, D)["w"], "b2": zeros(D)}

    return {
        "encoder": {
            "embed": nrm((cfg.vocab_size, D), 0.02),
            "convs": tuple(conv(5, D) for _ in range(2)),
            "gru_f": gru(D), "gru_b": gru(D),
            "proj": lin(2 * D, D),
        },
        "duration": {"ada": ada(D), "w1": nrm((D, D, 3), (3 * D) ** -0.5),
                     "b1": zeros(D), "w2": lin(D, 1), "b2": zeros(1)},
        "decoder": {"res": tuple(res() for _ in range(3)),
                    "head_w": lin(D, cfg.hop), "head_b": zeros(cfg.hop)},
    }


class KokoroSynthesizer:
    """Native synthesis callable: (ids, style, speed) -> waveform, on the
    parameters' device. The durations are read on the host between the
    duration head and the length regulation (as crane_tpu reads them)."""

    def __init__(self, cfg: KokoroNetConfig, params: dict | None = None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.params = params if params is not None else init_kokoro_net(cfg, seed, device)
        self.device = self.params["encoder"]["embed"].device

    @torch.no_grad()
    def features(self, ids, style, speed: float = 1.0):
        """(encoder features ``[T, dim]``, durations ``[T]`` int32, style
        ``[style_dim]``) of one chunk."""
        ids = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1), device=self.device)
        style = torch.as_tensor(np.asarray(style, np.float32).reshape(-1), device=self.device)
        feats = encode_text(self.params["encoder"], ids)
        durs = predict_durations(self.params["duration"], feats, style, float(speed),
                                 self.cfg.max_duration)
        return feats, durs, style

    @torch.no_grad()
    def synthesize(self, feats: torch.Tensor, durs, style: torch.Tensor) -> np.ndarray:
        """The waveform of ``feats`` held for ``durs`` frames each."""
        durs = torch.as_tensor(np.asarray(durs, np.int64), device=feats.device)
        frames = torch.repeat_interleave(feats, durs, dim=0)
        wav = synthesize_frames(self.params["decoder"], frames, style, self.cfg.hop)
        return wav.float().cpu().numpy()

    def __call__(self, ids: np.ndarray, style: np.ndarray, speed: float = 1.0) -> np.ndarray:
        feats, durs, style = self.features(ids, style, speed)
        return self.synthesize(feats, durs.cpu().numpy(), style)


# ---------------------------------------------------------------------------
# Full pipeline


class KokoroTts:
    """Text -> IPA (via an injected phonemizer) -> normalized phonemes ->
    chunks -> per-chunk synthesis with length-indexed style rows -> waveform."""

    def __init__(self, vocab: dict, voices: dict, synthesizer,
                 *, max_seq_len: int = 512, phonemizer=None):
        if "$" not in vocab:
            raise ValueError("Kokoro vocab is missing the pad/BOS/EOS token '$'")
        self.vocab = vocab
        self.voices = voices  # name -> [rows, STYLE_DIM]
        self.synthesizer = synthesizer
        self.max_seq_len = max_seq_len
        self.phonemizer = phonemizer
        self._normalizers: dict = {}

    def _normalizer(self, language: str) -> KokoroIpaNormalizer:
        if language not in self._normalizers:
            self._normalizers[language] = KokoroIpaNormalizer(language, self.vocab)
        return self._normalizers[language]

    def phonemes_to_ids(self, phonemes: str) -> list:
        """``$`` pad on both ends; codepoints outside the vocab are dropped
        (model.rs:473-511)."""
        pad = self.vocab["$"]
        ids = [self.vocab[c] for c in phonemes if c in self.vocab]
        return [pad, *ids, pad]

    def available_voices(self) -> list:
        return sorted(self.voices)

    def generate_speech(self, text: str, *, language: str = "en_us",
                        voice: str | None = None, speed: float = 1.0) -> tuple:
        """Returns (waveform float32 [n_samples], sample_rate)."""
        name = voice or (DEFAULT_VOICE if DEFAULT_VOICE in self.voices
                         else next(iter(sorted(self.voices))))
        if name not in self.voices:
            raise KeyError(f"unknown voice {name!r}; available: {self.available_voices()}")
        voice_table = np.asarray(self.voices[name])

        if self.phonemizer is None:
            ipa = text  # caller passed phonemes directly
        elif hasattr(self.phonemizer, "text_to_ipa"):
            ipa = self.phonemizer.text_to_ipa(text, language)
        else:
            ipa = self.phonemizer.phonemize(text)  # crane_tpu_torch.text.g2p.Phonemizer
        phonemes = self._normalizer(language).normalize(ipa)
        chunks = chunk_phonemes(phonemes)
        if not chunks:
            raise ValueError(f"no phonemes produced for input text {text!r}")

        parts = []
        for chunk in chunks:
            ids = self.phonemes_to_ids(chunk)
            if len(ids) > self.max_seq_len:
                raise ValueError(
                    f"phoneme chunk has {len(ids)} tokens, exceeding max {self.max_seq_len}"
                )
            row = style_row_index(len(chunk), voice_table.shape[0])
            parts.append(np.asarray(
                self.synthesizer(np.asarray(ids), voice_table[row], speed), np.float32
            ))
        return np.concatenate(parts), SAMPLE_RATE


# ---------------------------------------------------------------------------
# Production ONNX checkpoint (the real Kokoro-82M release)


class OnnxKokoroSynthesizer:
    """Synthesis callable backed by the released Kokoro ONNX graph
    (reference model.rs:544-566: inputs ``input_ids [1, S]`` i64,
    ``style [1, 256]`` f32, ``speed [1]`` f32 -> output ``waveform``).
    Input names are introspected so hub re-exports with ``tokens``-style
    names also load."""

    def __init__(self, session):
        self.session = session
        names = session.input_names
        self.ids_name = next(
            (n for n in names if n in ("input_ids", "tokens")), names[0]
        )
        self.style_name = next((n for n in names if "style" in n), None)
        self.speed_name = next((n for n in names if "speed" in n), None)

    def __call__(self, ids: np.ndarray, style: np.ndarray, speed: float = 1.0) -> np.ndarray:
        feeds = {self.ids_name: np.asarray(ids, np.int64).reshape(1, -1)}
        if self.style_name:
            feeds[self.style_name] = np.asarray(style, np.float32).reshape(1, -1)
        if self.speed_name:
            feeds[self.speed_name] = np.asarray([speed], np.float32)
        outs = self.session.run(feeds)
        wav = outs.get("waveform", next(iter(outs.values())))
        return np.asarray(wav, np.float32).reshape(-1)


def load_kokoro_onnx(model_path: str, *, phonemizer=None) -> KokoroTts:
    """Load the released Kokoro-82M directory layout (reference
    model.rs:315-345): ``tokenizer.json`` (vocab), ``tokenizer_config.json``
    (max length), ``onnx/model.onnx`` (graph), ``voices/*.bin`` (style
    tables)."""
    import glob
    import os

    from crane_tpu_torch.onnx import Session, read_file

    root = model_path
    vocab = parse_vocab(os.path.join(root, "tokenizer.json"))
    max_seq_len = 512
    tc = os.path.join(root, "tokenizer_config.json")
    if os.path.exists(tc):
        with open(tc) as f:
            max_seq_len = int(json.load(f).get("model_max_length", 512))

    onnx_path = os.path.join(root, "onnx", "model.onnx")
    if not os.path.exists(onnx_path):
        cands = glob.glob(os.path.join(root, "*.onnx")) + glob.glob(
            os.path.join(root, "onnx", "*.onnx")
        )
        if not cands:
            raise FileNotFoundError(f"no ONNX graph under {root}")
        onnx_path = cands[0]
    synthesizer = OnnxKokoroSynthesizer(Session(read_file(onnx_path)))

    voices = {}
    for p in glob.glob(os.path.join(root, "voices", "*.bin")):
        voices[os.path.splitext(os.path.basename(p))[0]] = load_voice_bin(p)
    if not voices:
        raise FileNotFoundError(f"no voices/*.bin under {root}")

    if phonemizer is None:
        from crane_tpu_torch.text.g2p import MultilingualPhonemizer

        phonemizer = MultilingualPhonemizer()  # language routes en*/de*
    return KokoroTts(
        vocab, voices, synthesizer,
        max_seq_len=max_seq_len, phonemizer=phonemizer,
    )
