"""The port's copy of the NumPy ONNX evaluator and the loaders over it,
against crane_tpu's (CPU).

Graphs are exported from torch modules as tests/test_onnx.py exports them
(the legacy exporter, its onnxscript step patched to identity). Each runs
through ``crane_tpu_torch.onnx`` and ``crane_tpu.onnx``: the outputs are
byte-equal (the same NumPy code), and within tests/test_onnx.py's tolerance
of the torch module. Then the checkpoint loaders over the evaluator: the
SNAC-24kHz decoder, Kokoro's ``load_kokoro_onnx`` (text -> phonemes ->
chunks -> graph -> PCM through the copied ``text/g2p``), PaddleOCR's
``load_paddleocr_onnx`` and Silero's ``load_silero_onnx``
(tests/test_vad.py's export), each equal to crane_tpu's.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.onnx._internal.torchscript_exporter.onnx_proto_utils as _opu

from crane_tpu import onnx as jonnx
from crane_tpu_torch import onnx as tonnx

_opu._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes

torch.set_num_threads(2)


def export(module, args, path, **kw) -> None:
    with torch.no_grad():
        torch.onnx.export(module.eval(), args, str(path), opset_version=17, dynamo=False, **kw)


class Convs(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Conv2d(8, 16, 3, stride=2, padding=1)
        self.b = nn.Conv2d(16, 16, 3, padding=2, dilation=2, groups=4)
        self.c = nn.Conv2d(16, 16, 3, padding=1, groups=16)
        self.t = nn.ConvTranspose2d(16, 3, 4, stride=2, padding=1)

    def forward(self, x):
        return self.t(self.c(self.b(torch.relu(self.a(x)))))


class Conv1d(nn.Module):
    def __init__(self):
        super().__init__()
        self.m = nn.Sequential(nn.Conv1d(4, 8, 5, padding=2), nn.LeakyReLU(0.1),
                               nn.ConvTranspose1d(8, 8, 8, stride=4, padding=2),
                               nn.Conv1d(8, 1, 7, padding=3))

    def forward(self, x):
        return self.m(x)


class Pools(nn.Module):
    def forward(self, x):
        return (nn.functional.max_pool2d(x, 3, stride=2, padding=1).sum()
                + nn.functional.avg_pool2d(x, 2, stride=2).sum()
                + nn.functional.adaptive_avg_pool2d(x, 1).sum())


class Recurrent(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(12, 16, bidirectional=True)
        self.gru = nn.GRU(32, 8, bidirectional=True)

    def forward(self, x):
        y, _ = self.lstm(x)
        z, h = self.gru(y)
        return z, h


class Norms(nn.Module):
    def __init__(self):
        super().__init__()
        self.bn = nn.BatchNorm2d(6)
        self.inorm = nn.InstanceNorm2d(6, affine=True)
        self.ln = nn.LayerNorm(10)

    def forward(self, x, y):
        a = nn.functional.hardswish(self.bn(x))
        b = nn.functional.hardsigmoid(self.inorm(x))
        c = nn.functional.gelu(self.ln(y))
        return a.mean() + b.mean(), c + torch.sigmoid(y) + torch.tanh(y) + torch.erf(y)


class Shapes(nn.Module):
    def forward(self, x):
        y = x.transpose(1, 2).reshape(x.shape[0], -1)
        z = torch.cat([y, y], dim=-1)[:, ::3]
        w = nn.functional.pad(x, (1, 2, 0, 1), value=0.5)
        e1, e2 = torch.split(x, [3, 5], dim=-1)
        return (z.sum() + w.sum() + x.argmax(dim=-1).float().sum() + x.clamp(-0.5, 0.5).sum()
                + x.amax(dim=0).sum() + e1.sum() - e2.sum() + torch.where(z > 0, z, 0 * z).sum())


class Resize(nn.Module):
    def forward(self, x):
        return (nn.functional.interpolate(x, scale_factor=2.0, mode="nearest"),
                nn.functional.interpolate(x, scale_factor=2.0, mode="bilinear",
                                          align_corners=False),
                nn.functional.interpolate(x, size=(7, 9), mode="bilinear", align_corners=True))


class Attention(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(16, 8)

    def forward(self, x):
        att = torch.softmax(x @ x.transpose(-1, -2) / 4.0, dim=-1)
        return self.fc(att @ x), torch.log_softmax(x, dim=-1)


class StyleChain(nn.Module):
    """Kokoro's decoder pattern (tests/test_onnx.py's styletts chain)."""

    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(40, 16)
        self.enc = nn.Conv1d(16, 24, 5, padding=2)
        self.style_fc = nn.Linear(8, 48)
        self.up = nn.ConvTranspose1d(24, 8, 8, stride=4, padding=2)

    def forward(self, ids, style):
        h = self.enc(self.emb(ids).transpose(1, 2))
        g, b = self.style_fc(style)[:, :, None].chunk(2, dim=1)
        h = (h - h.mean(-1, keepdim=True)) / (h.std(-1, keepdim=True) + 1e-5) * (1 + g) + b
        return torch.tanh(self.up(h))


class CtcChain(nn.Module):
    """PP-OCR's recognizer pattern: conv backbone, height squeeze, BiLSTM, fc."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(3, 16, 3, stride=2, padding=1), nn.ReLU(),
                                  nn.Conv2d(16, 32, 3, stride=(2, 1), padding=1), nn.ReLU(),
                                  nn.MaxPool2d((2, 1)))
        self.rnn = nn.LSTM(32 * 4, 24, bidirectional=True, batch_first=True)
        self.fc = nn.Linear(48, 11)

    def forward(self, x):
        f = self.conv(x)
        B, C, H, W = f.shape
        y, _ = self.rnn(f.permute(0, 3, 1, 2).reshape(B, W, C * H))
        return torch.softmax(self.fc(y), dim=-1)


torch.manual_seed(0)
GRAPHS = {
    "convs": (Convs, lambda: (torch.randn(2, 8, 20, 24),), 1e-4, 1e-5),
    "conv1d": (Conv1d, lambda: (torch.randn(1, 4, 33),), 1e-4, 1e-5),
    "pools": (Pools, lambda: (torch.randn(1, 3, 17, 13),), 1e-4, 1e-5),
    "recurrent": (Recurrent, lambda: (torch.randn(9, 2, 12),), 1e-4, 1e-5),
    "norms": (Norms, lambda: (torch.randn(2, 6, 5, 5), torch.randn(3, 10)), 1e-4, 1e-5),
    "shapes": (Shapes, lambda: (torch.randn(2, 3, 8),), 1e-4, 1e-5),
    "resize": (Resize, lambda: (torch.randn(1, 3, 8, 8),), 1e-4, 1e-5),
    "attention": (Attention, lambda: (torch.randn(2, 5, 16),), 1e-4, 1e-5),
    "style chain": (StyleChain, lambda: (torch.randint(0, 40, (1, 23)), torch.randn(1, 8)),
                    1e-3, 1e-4),
    "ctc chain": (CtcChain, lambda: (torch.randn(1, 3, 32, 40),), 1e-3, 1e-4),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_evaluator_equals_crane_tpu(name, tmp_path):
    make, inputs, rtol, atol = GRAPHS[name]
    torch.manual_seed(1)
    module, args = make().eval(), inputs()
    export(module, args, tmp_path / "m.onnx")
    with torch.no_grad():
        ref = module(*args)
    refs = list(ref) if isinstance(ref, (tuple, list)) else [ref]
    got_sess = tonnx.Session(tonnx.read_file(str(tmp_path / "m.onnx")))
    jax_sess = jonnx.Session(jonnx.read_file(str(tmp_path / "m.onnx")))
    assert got_sess.input_names == jax_sess.input_names
    assert got_sess.output_names == jax_sess.output_names
    feeds = dict(zip(got_sess.input_names, [a.numpy() for a in args]))
    got, want = got_sess.run(feeds), jax_sess.run(feeds)
    for (gname, g), (wname, w), r in zip(got.items(), want.items(), refs):
        assert gname == wname
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(np.asarray(g, np.float32), r.numpy(), rtol=rtol, atol=atol)


def test_snac_decoder(tmp_path):
    from crane_tpu.models.snac_onnx import load_snac_onnx as jload
    from crane_tpu_torch.models.snac_onnx import load_snac_onnx

    class Decoder(nn.Module):
        def __init__(self, bins=64, dim=16):
            super().__init__()
            self.emb = nn.ModuleList(nn.Embedding(bins, dim) for _ in range(3))
            self.up1 = nn.ConvTranspose1d(dim, dim, 8, stride=4)
            self.up2 = nn.ConvTranspose1d(dim, dim, 4, stride=2)
            self.out = nn.ConvTranspose1d(dim, 1, 16, stride=8)

        def forward(self, c1, c2, c3):
            h1 = self.up1(self.emb[0](c1).transpose(1, 2))
            h2 = self.up2(self.emb[1](c2).transpose(1, 2))
            h3 = self.emb[2](c3).transpose(1, 2)
            n = min(h1.shape[-1], h2.shape[-1], h3.shape[-1])
            h = h1[..., :n] + h2[..., :n] + h3[..., :n]
            return self.out(h + torch.sin(h) ** 2)

    rng = np.random.default_rng(0)
    codes = [torch.from_numpy(rng.integers(0, 64, (1, 5 * m))) for m in (1, 2, 4)]
    export(Decoder(), tuple(codes), tmp_path / "snac.onnx", input_names=["c1", "c2", "c3"],
           output_names=["audio"])
    dec, jdec = load_snac_onnx(str(tmp_path / "snac.onnx")), jload(str(tmp_path / "snac.onnx"))
    assert dec.input_names == ["c1", "c2", "c3"] and dec.sample_rate == 24000
    got = dec.decode(*(c.numpy()[0] for c in codes))
    np.testing.assert_array_equal(got, jdec.decode(*(c.numpy()[0] for c in codes)))
    assert got.dtype == np.float32 and got.ndim == 1 and got.size > 0


def test_kokoro_onnx_checkpoint(tmp_path):
    """tests/test_onnx.py's Kokoro layout: load_kokoro_onnx (vocab, graph,
    voices, the copied MultilingualPhonemizer) gives crane_tpu's PCM."""
    from crane_tpu.models.kokoro_tts import load_kokoro_onnx as jload
    from crane_tpu_torch.models.kokoro_tts import OnnxKokoroSynthesizer, load_kokoro_onnx

    class KNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(60, 16)
            self.conv = nn.Conv1d(16, 8, 5, padding=2)
            self.style_fc = nn.Linear(256, 8)
            self.up = nn.ConvTranspose1d(8, 1, 8, stride=4, padding=2)

        def forward(self, input_ids, style, speed):
            h = torch.tanh(self.conv(self.emb(input_ids).transpose(1, 2)))
            return (self.up(h + self.style_fc(style)[:, :, None])[:, 0] * speed).reshape(-1)

    root = tmp_path / "kokoro"
    (root / "onnx").mkdir(parents=True)
    (root / "voices").mkdir()
    export(KNet(), (torch.zeros(1, 12, dtype=torch.long), torch.zeros(1, 256), torch.ones(1)),
           root / "onnx" / "model.onnx", input_names=["input_ids", "style", "speed"],
           output_names=["waveform"], dynamic_axes={"input_ids": {1: "S"}})
    vocab = {c: i for i, c in enumerate("$ abdefhiklmnoprstuvwzæɐɑəɹʃʊʌθð")}
    (root / "tokenizer.json").write_text(json.dumps({"model": {"vocab": vocab}}))
    (root / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 512}))
    rng = np.random.default_rng(0)
    for name in ("af_heart", "am_adam"):
        (root / "voices" / f"{name}.bin").write_bytes(
            rng.normal(size=(510, 256)).astype(np.float32).tobytes())
    tts, jtts = load_kokoro_onnx(str(root)), jload(str(root))
    assert isinstance(tts.synthesizer, OnnxKokoroSynthesizer)
    assert tts.available_voices() == jtts.available_voices() == ["af_heart", "am_adam"]
    for voice in ("af_heart", "am_adam"):
        wav, sr = tts.generate_speech("hello world, again", voice=voice)
        np.testing.assert_array_equal(wav, jtts.generate_speech("hello world, again",
                                                                voice=voice)[0])
        assert sr == 24000 and wav.size > 0


def test_paddleocr_onnx_checkpoint(tmp_path):
    from crane_tpu.ocr.pipeline import load_paddleocr_onnx as jload
    from crane_tpu_torch.ocr.pipeline import load_paddleocr_onnx

    class Det(nn.Module):
        def forward(self, x):
            return torch.sigmoid(x.mean(1, keepdim=True) * 4)

    class Rec(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Sequential(nn.Conv2d(3, 8, 3, stride=2, padding=1), nn.ReLU(),
                                      nn.Conv2d(8, 8, 3, stride=(2, 1), padding=1))
            self.fc = nn.Linear(8 * 12, 5)

        def forward(self, x):
            f = self.conv(x)
            B, C, H, W = f.shape
            return torch.softmax(self.fc(f.permute(0, 3, 1, 2).reshape(B, W, C * H)), -1)

    d = tmp_path / "ppocr"
    d.mkdir()
    export(Det(), torch.zeros(1, 3, 64, 64), d / "pp-ocrv6_small_det.onnx", input_names=["x"],
           dynamic_axes={"x": {2: "H", 3: "W"}})
    export(Rec(), torch.zeros(1, 3, 48, 80), d / "pp-ocrv6_small_rec.onnx", input_names=["x"],
           dynamic_axes={"x": {0: "B", 3: "W"}})
    (d / "ppocrv6_dict.txt").write_text("a\nb\nc\nd\n")
    img = np.zeros((120, 200, 3), np.uint8)
    img[40:70, 30:170] = 255
    img[85:100, 20:90] = 200
    pipe, jpipe = load_paddleocr_onnx(str(d)), jload(str(d))
    assert pipe.detect(img) == jpipe.detect(img) and len(pipe.detect(img)) >= 1
    got, ref = pipe.recognize(img), jpipe.recognize(img)
    assert got.text == ref.text
    assert [vars(r) for r in got.regions] == [vars(r) for r in ref.regions]
    with pytest.raises(FileNotFoundError):
        load_paddleocr_onnx(str(tmp_path))


def test_silero_onnx(tmp_path):
    """tests/test_vad.py's export of the onnx-community/silero-vad
    interface: the port's load_silero_onnx gives crane_tpu's probabilities,
    states and segments."""
    from crane_tpu.models.silero_vad import Vad as JVad
    from crane_tpu.models.silero_vad import VadConfig as JVadConfig
    from crane_tpu.models.silero_vad import load_silero_onnx as jload
    from crane_tpu_torch.models.silero_vad import Vad, VadConfig, load_silero_onnx
    from tests.test_vad import TestOnnxCheckpointPath

    _, _, path = TestOnnxCheckpointPath._build(tmp_path)
    model, jmodel = load_silero_onnx(path), jload(path)
    assert model.context_size == 64 and model.state_dim == jmodel.state_dim
    rng = np.random.default_rng(3)
    state, jstate = model.initial_state(), jmodel.initial_state()
    for _ in range(5):
        chunk = rng.normal(size=512).astype(np.float32) * 0.3
        p, state = model(chunk, state)
        jp_, jstate = jmodel(chunk, jstate)
        assert p == jp_
        for a, b in zip(state, jstate):
            np.testing.assert_array_equal(a, b)
    audio = np.random.default_rng(5).normal(size=512 * 8).astype(np.float32)
    cfg = dict(threshold=0.45, min_speech_duration_ms=30, min_silence_duration_ms=30)
    got = Vad(VadConfig(**cfg), model=model).segment_audio(audio)
    ref = JVad(JVadConfig(**cfg), model=jmodel).segment_audio(audio)
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in ref]
    with pytest.raises(ValueError):
        load_silero_onnx(path, sample_rate=22050)
