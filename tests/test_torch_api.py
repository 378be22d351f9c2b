"""crane_tpu_torch's HTTP server against crane_tpu's on the same checkpoint.

Both servers serve one tiny Qwen3 checkpoint in float32 with greedy
requests: crane_tpu's aiohttp app through aiohttp's in-process test client,
the port's standard-library server on a real local socket (``device="cpu"``).
Every case of tests/test_api.py is sent to both, in the same order, and the
JSON bodies (and SSE events) must be equal with ``id`` and ``created``
masked. Beyond those: stop strings, ``finish_reason: "length"``, a 413 body,
a client that hangs up mid-stream, the refused flags of ``main()``, the SDK
client, and the command line as a subprocess. Speech recognition: a tiny
Qwen3-ASR checkpoint served by ``main(["--asr-path", ...])`` beside a text
model, beside Gemma3n's ``TextBackend``, alone, and from the command line,
each transcription equal to crane_tpu's on the same samples.
"""

import asyncio
import http.client
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.fixtures import make_tiny_qwen3_checkpoint

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MASKED = ("id", "created")


def masked(body):
    """``body`` with the values of ``id`` and ``created`` keys blanked."""
    if isinstance(body, dict):
        return {k: None if k in MASKED else masked(v) for k, v in body.items()}
    if isinstance(body, list):
        return [masked(v) for v in body]
    return body


def sse_events(raw: bytes) -> list:
    text = raw.decode()
    assert text.rstrip().endswith("data: [DONE]"), text
    return [json.loads(line[6:]) for line in text.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


class RefClient:
    """Requests to a crane_tpu app through aiohttp's test client (a fresh
    app each time: apps freeze on start)."""

    def __init__(self, app_factory):
        self.app_factory = app_factory

    def request(self, method, path, body=None, raw=None, headers=None):
        from aiohttp.test_utils import TestClient, TestServer

        async def go():
            client = TestClient(TestServer(self.app_factory()))
            await client.start_server()
            try:
                kw = {"json": body} if body is not None else {"data": raw}
                r = await client.request(method, path, headers=headers, **kw)
                return r.status, dict(r.headers), await r.read()
            finally:
                await client.close()

        return asyncio.run(go())


class PortClient:
    """Requests to the port's server over a local socket (http.client)."""

    def __init__(self, port):
        self.port = port

    def request(self, method, path, body=None, raw=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            data = json.dumps(body).encode() if body is not None else raw
            if headers is None:
                headers = {"Content-Type": "application/json"} if body is not None else {}
            conn.request(method, path, body=data, headers=headers)
            r = conn.getresponse()
            return r.status, dict(r.getheaders()), r.read()
        finally:
            conn.close()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_qwen3_checkpoint(str(tmp_path_factory.mktemp("api") / "m"))


def _ref_engine(ckpt, **kw):
    from crane_tpu.models.auto import from_pretrained
    from crane_tpu.serve.engine import InferenceEngine

    engine = InferenceEngine(from_pretrained(ckpt, dtype=jnp.float32), **kw)
    engine.start()
    return engine


def _port_engine(ckpt, **kw):
    from crane_tpu_torch.models.auto import from_pretrained
    from crane_tpu_torch.serve.engine import InferenceEngine

    engine = InferenceEngine(from_pretrained(ckpt, dtype=torch.float32, device="cpu"), **kw)
    engine.start()
    return engine


ENGINE = dict(max_slots=2, max_seq_len=256, decode_tokens_per_seq=2)


@pytest.fixture(scope="module")
def both(ckpt):
    """(crane_tpu client, port client) over engines of one shape, tiny-qwen3."""
    from crane_tpu.serve.api import Server as RefServer
    from crane_tpu.serve.api import build_app as ref_app
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.transport import BackgroundServer

    ref_engine, engine = _ref_engine(ckpt, **ENGINE), _port_engine(ckpt, **ENGINE)
    ref = RefServer(ref_engine, model_name="tiny-qwen3")
    http_server = BackgroundServer(build_app(Server(engine, model_name="tiny-qwen3")))
    yield RefClient(lambda: ref_app(ref)), PortClient(http_server.port)
    http_server.close()
    ref_engine.stop()
    engine.stop()


def same(both, method, path, body=None):
    """Send one request to both servers; the statuses and the masked JSON
    bodies must be equal. Returns the port's body."""
    ref, port = both
    (s1, _, b1), (s2, _, b2) = ref.request(method, path, body), port.request(method, path, body)
    assert s1 == s2, (path, s1, s2, b1, b2)
    j1, j2 = json.loads(b1), json.loads(b2)
    assert masked(j2) == masked(j1), (path, j1, j2)
    return s2, j2


def same_sse(both, path, body):
    """One streamed request to both: equal statuses, event-stream content
    types and masked events. Returns the port's events."""
    ref, port = both
    (s1, h1, b1), (s2, h2, b2) = ref.request("POST", path, body), port.request("POST", path, body)
    assert s1 == s2 == 200
    assert h1["Content-Type"].startswith("text/event-stream")
    assert h2["Content-Type"].startswith("text/event-stream")
    e1, e2 = sse_events(b1), sse_events(b2)
    assert masked(e2) == masked(e1), (e1, e2)
    return e2


CHAT = {"model": "tiny-qwen3", "messages": [{"role": "user", "content": "hello"}],
        "max_tokens": 8, "temperature": 0}


class TestEndpoints:
    """tests/test_api.py's cases, each sent to both servers."""

    def test_health(self, both):
        assert same(both, "GET", "/health")[1]["status"] == "ok"

    def test_models(self, both):
        assert same(both, "GET", "/v1/models")[1]["data"][0]["object"] == "model"
        status, body = same(both, "GET", "/v1/models/tiny-qwen3")
        assert status == 200
        assert same(both, "GET", "/v1/models/nope")[0] == 404

    def test_unknown_route_and_method(self, both):
        ref, port = both
        for method, path in (("GET", "/nope"), ("GET", "/v1/chat/completions")):
            assert ref.request(method, path)[0] == port.request(method, path)[0]

    def test_tokenize_roundtrip(self, both):
        toks = same(both, "POST", "/tokenize", {"text": "hello world"})[1]["tokens"]
        assert len(toks) > 0
        assert same(both, "POST", "/detokenize", {"tokens": toks})[1]["text"] == "hello world"

    def test_chat_completion(self, both):
        status, body = same(both, "POST", "/v1/chat/completions", CHAT)
        assert status == 200 and body["object"] == "chat.completion"
        assert body["choices"][0]["message"]["role"] == "assistant"
        assert body["usage"]["completion_tokens"] > 0

    def test_chat_streaming_sse(self, both):
        payload = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
                   "temperature": 0, "stream": True, "stream_options": {"include_usage": True}}
        events = same_sse(both, "/v1/chat/completions", payload)
        assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
        assert [e for e in events if e.get("choices") and e["choices"][0]["finish_reason"]]
        usage = [e for e in events if e.get("usage")]
        assert usage and usage[0]["usage"]["completion_tokens"] > 0
        # the deltas add up to the non-streamed content
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events if e.get("choices"))
        whole = same(both, "POST", "/v1/chat/completions", {**payload, "stream": False})[1]
        assert text == whole["choices"][0]["message"]["content"]

    def test_completions(self, both):
        body = same(both, "POST", "/v1/completions",
                    {"prompt": "hello world", "max_tokens": 4, "temperature": 0})[1]
        assert body["object"] == "text_completion"
        assert body["usage"]["completion_tokens"] == 4

    def test_sglang_generate(self, both):
        body = same(both, "POST", "/generate",
                    {"text": "hello", "sampling_params": {"max_new_tokens": 4, "temperature": 0}})[1]
        assert body["meta_info"]["completion_tokens"] == 4
        same(both, "POST", "/generate",
             {"input_ids": [5, 6, 7], "sampling_params": {"max_new_tokens": 3, "temperature": 0}})
        events = same_sse(both, "/generate", {"text": "hello", "stream": True, "sampling_params":
                                              {"max_new_tokens": 4, "temperature": 0}})
        assert events[-1]["text"] == body["text"]

    def test_sglang_info_and_stats(self, both):
        assert same(both, "GET", "/model_info")[1]["is_generation"] is True
        ref, port = both
        keys = ("requests_received", "requests_completed", "requests_aborted",
                "requests_failed", "requests_preempted", "prompt_tokens", "generated_tokens",
                "prefix_hits", "prefix_tokens_reused", "running", "waiting",
                "max_num_reqs", "max_seq_len", "model_path")
        for path in ("/server_info", "/v1/stats"):
            (s1, _, b1), (s2, _, b2) = ref.request("GET", path), port.request("GET", path)
            j1, j2 = json.loads(b1), json.loads(b2)
            assert s1 == s2 == 200 and j1.keys() == j2.keys()
            assert {k: j1[k] for k in keys if k in j1} == {k: j2[k] for k in keys if k in j2}
        assert j2["requests_completed"] >= 1
        assert same(both, "POST", "/flush_cache")[1]["status"] == "ok"

    def test_abort_request_endpoint(self, both):
        assert same(both, "POST", "/abort_request", {"rid": "nonexistent"})[0] == 200
        assert same(both, "POST", "/abort_request", {})[0] == 400

    def test_prompt_too_long_400(self, both):
        status, body = same(both, "POST", "/v1/completions",
                            {"prompt": "word " * 400, "max_tokens": 4})
        assert status == 400 and "exceeds" in body["error"]["message"]

    def test_health_generate(self, both):
        status, body = same(both, "GET", "/health_generate")
        assert status == 200 and body["status"] == "ok"

    def test_max_tokens_finish_length(self, both):
        body = same(both, "POST", "/v1/chat/completions", {**CHAT, "max_tokens": 5})[1]
        assert body["choices"][0]["finish_reason"] == "length"
        assert body["usage"]["completion_tokens"] == 5

    def test_stop_strings(self, both):
        payload = {**CHAT, "max_tokens": 12}
        full = same(both, "POST", "/v1/chat/completions", payload)[1]
        text = full["choices"][0]["message"]["content"]
        stop = text[len(text) // 2:len(text) // 2 + 2]
        assert stop.strip()
        for body in ({**payload, "stop": stop}, {**payload, "stop": ["§", stop]}):
            got = same(both, "POST", "/v1/chat/completions", body)[1]
            assert got["choices"][0]["message"]["content"] == text[:text.index(stop)]
            assert got["choices"][0]["finish_reason"] == "stop"
        events = same_sse(both, "/v1/chat/completions", {**payload, "stop": stop, "stream": True})
        assert "".join(e["choices"][0]["delta"].get("content", "") for e in events) \
            == text[:text.index(stop)]

    def test_body_over_limit_413(self, both):
        ref, port = both
        limit = 25 * 1024 * 1024
        assert ref.request("POST", "/v1/completions", raw=b" " * (limit + 1))[0] == 413
        # the port refuses it from the header alone, before reading the body
        with socket.create_connection(("127.0.0.1", port.port), timeout=30) as s:
            s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n"
                      + f"Content-Length: {limit + 1}\r\n\r\n".encode())
            head = s.recv(4096).decode()
        assert head.startswith("HTTP/1.1 413 "), head
        assert port.request("GET", "/health")[0] == 200


class _StubStreamTts:
    """Minimal Tts with frame-chunked streaming (tests/test_api.py's)."""

    class _Info:
        sample_rate = 24000

    def audio_info(self):
        return self._Info()

    def supports_voice_cloning(self):
        return False

    def generate_speech(self, text, options=None):
        return np.zeros(480, np.float32)

    def generate_speech_stream(self, text, options=None):
        for i in range(3):
            yield np.full(240, 0.1 * (i + 1), np.float32)


def test_audio_speech_stream_endpoint(ckpt):
    """POST /v1/audio/speech with stream=true: chunked PCM of the
    generator's length; without: the same WAV bytes from both servers."""
    from crane_tpu.serve.api import Server as RefServer
    from crane_tpu.serve.api import build_app as ref_app
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.transport import BackgroundServer

    kw = dict(max_slots=1, max_seq_len=128, decode_tokens_per_seq=1)
    ref_engine, engine = _ref_engine(ckpt, **kw), _port_engine(ckpt, **kw)
    ref_server = RefServer(ref_engine, model_name="tiny", tts=_StubStreamTts())
    try:
        with BackgroundServer(build_app(Server(engine, model_name="tiny",
                                               tts=_StubStreamTts()))) as srv:
            ref, port = RefClient(lambda: ref_app(ref_server)), PortClient(srv.port)
            got = port.request("POST", "/v1/audio/speech", {"input": "hello", "stream": True})
            status, headers, body = got
            assert status == 200 and headers["Content-Type"].startswith("audio/pcm")
            assert headers["X-Sample-Rate"] == "24000"
            assert body == ref.request("POST", "/v1/audio/speech",
                                       {"input": "hello", "stream": True})[2]
            assert len(body) == 3 * 240 * 2
            wav = [c.request("POST", "/v1/audio/speech", {"input": "hi"}) for c in (ref, port)]
            assert wav[0][0] == wav[1][0] == 200 and wav[0][2] == wav[1][2]
            assert wav[1][1]["Content-Type"] == "audio/wav"
            missing = [c.request("POST", "/v1/audio/speech", {}) for c in (ref, port)]
            assert missing[0][0] == missing[1][0] == 400
            assert json.loads(missing[0][2]) == json.loads(missing[1][2])
    finally:
        ref_engine.stop()
        engine.stop()


class _StubAsr:
    """An ASR adapter that reports what it was given."""

    def input_sample_rate(self):
        return 16000

    def transcribe(self, samples, options):
        return type("Transcript", (), {"text": f"{len(samples)} samples, "
                                               f"peak {float(np.abs(samples).max()):.3f}"})()


def test_audio_transcriptions_endpoint(ckpt):
    """POST /v1/audio/transcriptions: a multipart ``file`` part (and a raw
    body) as WAV at 8 kHz, resampled to the adapter's 16 kHz; both servers
    give the same JSON, and the same 400 without audio."""
    from crane_tpu.audio.pcm import encode_wav
    from crane_tpu.serve.api import Server as RefServer
    from crane_tpu.serve.api import build_app as ref_app
    from crane_tpu.serve.backend import TextBackend as RefBackend
    from crane_tpu.tokenizer.autotokenizer import AutoTokenizer as RefTokenizer
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.backend import TextBackend
    from crane_tpu_torch.serve.transport import BackgroundServer
    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    ref_server = RefServer(None, asr=_StubAsr(), text_backend=RefBackend(
        _EchoModel([1]), RefTokenizer.from_pretrained(ckpt)))
    server = Server(None, asr=_StubAsr(), text_backend=TextBackend(
        _EchoModel([1]), AutoTokenizer.from_pretrained(ckpt)))
    wav = encode_wav(np.sin(np.arange(4000) / 5.0).astype(np.float32) * 0.5, 8000)
    boundary = "crane-boundary"
    multipart = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"model\"\r\n\r\n"
                 f"whisper\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                 f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() \
        + wav + f"\r\n--{boundary}--\r\n".encode()
    cases = [({"Content-Type": f"multipart/form-data; boundary={boundary}"}, multipart),
             ({"Content-Type": "audio/wav"}, wav),
             ({"Content-Type": "audio/wav"}, b"")]
    with BackgroundServer(build_app(server)) as srv:
        ref, port = RefClient(lambda: ref_app(ref_server)), PortClient(srv.port)
        for headers, raw in cases:
            got = [c.request("POST", "/v1/audio/transcriptions", raw=raw, headers=headers)
                   for c in (ref, port)]
            assert got[0][0] == got[1][0], got
            assert json.loads(got[0][2]) == json.loads(got[1][2]), got
        assert json.loads(got[1][2]) == {"error": "missing audio file"}
        assert json.loads(port.request("POST", "/v1/audio/transcriptions", raw=wav,
                                       headers=cases[1][0])[2])["text"].startswith("8000 samples")


def test_client_hangup_mid_stream_frees_the_slot(ckpt):
    """A client that closes its socket after the first SSE chunk aborts its
    engine request: the slot comes free and /v1/stats counts the abort."""
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.transport import BackgroundServer

    engine = _port_engine(ckpt, max_slots=1, max_seq_len=256, decode_tokens_per_seq=1)
    try:
        with BackgroundServer(build_app(Server(engine, model_name="tiny"))) as srv:
            port = PortClient(srv.port)
            body = json.dumps({**CHAT, "max_tokens": 200, "stream": True}).encode()
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
            s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n"
                      + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            seen = b""
            while b'"content"' not in seen:
                chunk = s.recv(4096)
                assert chunk, seen
                seen += chunk
            s.close()
            deadline = time.monotonic() + 30
            while True:
                stats = json.loads(port.request("GET", "/v1/stats")[2])
                if stats["requests_aborted"] == 1 and stats["running"] == 0:
                    break
                assert time.monotonic() < deadline, stats
                time.sleep(0.05)
            assert stats["generated_tokens"] < 200
            # the freed slot serves the next request
            out = json.loads(port.request("POST", "/v1/chat/completions", CHAT)[2])
            assert out["usage"]["completion_tokens"] == CHAT["max_tokens"]
    finally:
        engine.stop()


def test_out_of_vocabulary_ids_answer_400(ckpt):
    """/generate with an ``input_ids`` id outside ``[0, vocab)``, or not an
    integer, is answered 400 before the engine sees the request (crane_tpu
    clamps such an id; on the card the embedding gather would assert); the
    engine thread stays alive and the next request is served."""
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.transport import BackgroundServer

    engine = _port_engine(ckpt, **ENGINE)
    vocab = engine.lm.config.vocab_size
    params = {"max_new_tokens": 4, "temperature": 0, "repetition_penalty": 1.0}
    try:
        with BackgroundServer(build_app(Server(engine, model_name="tiny"))) as srv:
            port = PortClient(srv.port)
            for ids in ([1, 2, vocab], [-1, 5], [1.5, 2], "12", [[1, 2]]):
                for stream in (False, True):
                    status, _, body = port.request("POST", "/generate", {
                        "input_ids": ids, "sampling_params": params, "stream": stream})
                    assert status == 400, (ids, status, body)
                    assert "prompt" in json.loads(body)["error"]["message"]
            status, _, body = port.request("POST", "/generate",
                                           {"input_ids": [1, 2, 3], "sampling_params": params})
            assert status == 200 and json.loads(body)["meta_info"]["completion_tokens"] == 4
            stats = json.loads(port.request("GET", "/v1/stats")[2])
            assert stats["requests_received"] == 1 and stats["requests_failed"] == 0
        assert engine._thread.is_alive()
    finally:
        engine.stop()


class _EchoModel:
    """generate_greedy stub (tests/test_api.py's): a fixed token sequence."""

    def __init__(self, toks):
        self.toks = toks

    def generate_greedy(self, ids, max_new_tokens, *, eos=(), streamer=None):
        out = []
        for t in self.toks[:max_new_tokens]:
            out.append(t)
            if t in eos:
                break
            if streamer is not None and streamer.append(t) is False:
                break
        if streamer is not None:
            streamer.finalize()
        return out


@pytest.fixture(scope="module")
def backend_both(ckpt):
    """Both servers over a TextBackend (no engine) with the echo model."""
    from crane_tpu.serve.api import Server as RefServer
    from crane_tpu.serve.api import build_app as ref_app
    from crane_tpu.serve.backend import TextBackend as RefBackend
    from crane_tpu.tokenizer.autotokenizer import AutoTokenizer as RefTokenizer
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.backend import TextBackend
    from crane_tpu_torch.serve.transport import BackgroundServer
    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    servers = []
    for srv_cls, backend_cls, tok_cls in ((RefServer, RefBackend, RefTokenizer),
                                          (Server, TextBackend, AutoTokenizer)):
        tok = tok_cls.from_pretrained(ckpt)
        backend = backend_cls(_EchoModel(tok.encode("hello world again")), tok,
                              eos_token_ids=(), name="echo")
        servers.append(srv_cls(None, model_name="tiny-backend", text_backend=backend))
    http_server = BackgroundServer(build_app(servers[1]))
    yield RefClient(lambda: ref_app(servers[0])), PortClient(http_server.port)
    http_server.close()


class TestBackendServing:
    def test_backend_chat_completion(self, backend_both):
        body = same(backend_both, "POST", "/v1/chat/completions",
                    {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 8})[1]
        assert body["choices"][0]["message"]["content"].strip() != ""
        assert body["usage"]["completion_tokens"] > 0

    def test_backend_chat_streaming(self, backend_both):
        events = same_sse(backend_both, "/v1/chat/completions",
                          {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 8,
                           "stream": True})
        assert events[0]["choices"][0]["delta"].get("role") == "assistant"
        assert "".join(e["choices"][0]["delta"].get("content", "") for e in events).strip()
        assert events[-1]["choices"][0]["finish_reason"] == "stop"

    def test_engine_endpoints_rejected_without_engine(self, backend_both):
        for path in ("/v1/stats", "/server_info"):
            assert same(backend_both, "GET", path)[0] == 400
        assert same(backend_both, "POST", "/generate", {"text": "hi"})[0] == 400
        assert same(backend_both, "GET", "/health")[0] == 200


# what crane_tpu cannot do either: weights quantized in situ under a tp or dp
# mesh (its shard_params raises; tests/test_torch_parallel.py holds both)
REFUSED = [
    (["--tp", "2", "--quant", "q8"], "cannot be sharded"),
    (["--dp", "2", "--quant", "q4"], "cannot be sharded"),
]


@pytest.mark.parametrize("flags,reason", REFUSED, ids=[f[0][0] for f in REFUSED])
def test_main_refuses_what_is_not_ported(ckpt, flags, reason):
    from crane_tpu_torch.serve.api import main

    with pytest.raises(ValueError, match=reason):
        main(["--model-path", ckpt, "--device", "cpu", *flags])


WIRED = {
    "quant": (["--quant", "q8", "--kv-quant", "int8", "--prefill-chunk", "64",
               "--no-prefix-cache", "--preempt-after", "0", "--speculative", "ngram"],
              dict(weight_bits=8, kv_bits=8, prefill_chunk=64, prefix_cache=False,
                   preempt_after_s=None, speculation=True, slabs=None)),
    "sp": (["--sp", "2", "--kv-quant", "int4", "--preempt-after", "5"],
           dict(weight_bits=None, kv_bits=4, prefill_chunk=None, prefix_cache=True,
                preempt_after_s=5.0, speculation=False, slabs=2)),
}


@pytest.mark.parametrize("name", list(WIRED))
def test_main_wires_the_engine_flags(ckpt, name, monkeypatch):
    """main()'s flags reach the model and the engine it builds (the serving
    loop replaced by one chat completion over a local socket)."""
    from crane_tpu_torch.ops.kv_cache import QuantLayerKVCache
    from crane_tpu_torch.ops.linear import QuantizedWeight
    from crane_tpu_torch.serve import api, transport

    flags, want = WIRED[name]
    seen = {}

    def serve_once(app, *, host, port):
        seen["server"] = app.router.routes[0][2].__self__
        with transport.BackgroundServer(app) as srv:
            seen["answer"] = PortClient(srv.port).request("POST", "/v1/chat/completions", CHAT)

    monkeypatch.setattr(transport, "run_app", serve_once)
    api.main(["--model-path", ckpt, "--device", "cpu", "--dtype", "f32", "--max-concurrent", "2",
              "--max-seq-len", "256", *flags])
    engine = seen["server"].engine
    assert not engine._thread.is_alive()  # main() stopped it when serving ended
    wq = engine.lm.params["layers"][0]["attn"]["wq"]
    assert (wq.bits if isinstance(wq, QuantizedWeight) else None) == want["weight_bits"]
    layer = engine.cache.layers[0]
    slabs = getattr(layer, "slabs", None)
    assert (len(slabs) if slabs else None) == want["slabs"]
    layer = slabs[0] if slabs else layer
    assert (layer.bits if isinstance(layer, QuantLayerKVCache) else None) == want["kv_bits"]
    assert engine.prefill_chunk == want["prefill_chunk"]
    assert engine.prefix_cache == want["prefix_cache"]
    assert engine.preempt_after_s == want["preempt_after_s"]
    assert (engine.history is not None) == want["speculation"]
    status, _, body = seen["answer"]
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == CHAT["max_tokens"]


def _tiny_gemma3n(dirpath) -> str:
    """A random-weight Gemma3n checkpoint (tests/test_gemma3n.py's widths)
    with the trained tiny tokenizer."""
    import transformers

    from tests.fixtures import make_tiny_tokenizer
    from tests.test_gemma3n import LAYER_TYPES

    tok = make_tiny_tokenizer(str(dirpath))
    torch.manual_seed(0)
    cfg = transformers.Gemma3nTextConfig(
        vocab_size=tok.get_vocab_size(), vocab_size_per_layer_input=tok.get_vocab_size(),
        hidden_size=32, hidden_size_per_layer_input=16, intermediate_size=[64] * 6,
        num_hidden_layers=6, num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        layer_types=LAYER_TYPES, sliding_window=4, num_kv_shared_layers=2, laurel_rank=4,
        activation_sparsity_pattern=[0.95, 0.95, 0.0, 0.0, 0.0, 0.0],
        max_position_embeddings=256, tie_word_embeddings=True,
    )
    transformers.Gemma3nForCausalLM(cfg).save_pretrained(str(dirpath), safe_serialization=True)
    return str(dirpath)


def test_main_refuses_gemma3n(tmp_path, monkeypatch):
    """main() serves a Gemma3n checkpoint through ``TextBackend`` (no
    engine), as crane_tpu's main() means to: a chat completion over a local
    socket gives the tokens of crane_tpu's ``Gemma3nLM`` on the same
    checkpoint and prompt. (The name is the test's older one, from when
    main() refused the checkpoint; the refusal is gone.)"""
    from crane_tpu.models.gemma3n import from_pretrained as ref_g3n
    from crane_tpu_torch.models.gemma3n import Gemma3nLM
    from crane_tpu_torch.serve import api, transport
    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    d = _tiny_gemma3n(tmp_path / "g3n")
    seen = {}

    def serve_once(app, *, host, port):
        seen["server"] = app.router.routes[0][2].__self__
        with transport.BackgroundServer(app) as srv:
            seen["answer"] = PortClient(srv.port).request("POST", "/v1/chat/completions", CHAT)

    monkeypatch.setattr(transport, "run_app", serve_once)
    api.main(["--model-path", d, "--device", "cpu", "--dtype", "f32", "--max-seq-len", "64"])
    server = seen["server"]
    assert server.engine is None and isinstance(server.text_backend.model, Gemma3nLM)
    status, _, body = seen["answer"]
    assert status == 200, body
    tok = AutoTokenizer.from_pretrained(d)
    ids = tok.encode(tok.apply_chat_template(CHAT["messages"], add_generation_prompt=True))
    want = ref_g3n(d, dtype=jnp.float32, max_seq=64).generate_greedy(
        np.asarray([ids]), CHAT["max_tokens"], eos=server.text_backend.eos_token_ids)
    answer = json.loads(body)
    assert answer["usage"]["completion_tokens"] == len(want)
    assert answer["choices"][0]["message"]["content"] == tok.decode(
        [t for t in want if t not in server.text_backend.eos_token_ids])


def test_server_refuses_a_vision_model(vlm_both):
    """A ``Server`` holds a vision model (``Server(vlm=)``), and a chat
    request without an image still goes to the text backend, on both
    servers alike (image requests: test_image_chat_matches_crane_tpu). (The
    name is the test's older one, from when the port refused ``vlm=``; the
    refusal is gone.)"""
    ref, port, (_, server) = vlm_both
    assert server.vlm is not None
    body = same((ref, port), "POST", "/v1/chat/completions",
                {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})[1]
    assert body["choices"][0]["message"]["content"].strip()


def _png_data_url(h=16, w=24) -> str:
    import base64
    import io

    from PIL import Image

    from tests.test_qwen3_vl_parity import _positional_image

    buf = io.BytesIO()
    Image.fromarray(_positional_image(h, w)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def vlm_ckpt(tmp_path_factory):
    """A tiny Qwen3-VL checkpoint (tests/test_qwen3_vl_parity.py's widths)
    whose tokenizer holds the vision tokens."""
    import transformers

    from tests.fixtures import make_tiny_tokenizer

    d = tmp_path_factory.mktemp("vlm") / "m"
    tok = make_tiny_tokenizer(str(d), extra_tokens=[
        "<|vision_start|>", "<|image_pad|>", "<|vision_end|>", "<|video_pad|>"])
    torch.manual_seed(0)
    cfg = transformers.Qwen3VLConfig(
        text_config=dict(
            vocab_size=tok.get_vocab_size(), hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            max_position_embeddings=512, rope_theta=10000.0,
            rope_scaling={"rope_type": "default", "mrope_section": [2, 3, 3],
                          "mrope_interleaved": True},
            tie_word_embeddings=False),
        vision_config=dict(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=4, patch_size=4,
            temporal_patch_size=2, spatial_merge_size=2, out_hidden_size=64,
            num_position_embeddings=16, deepstack_visual_indexes=[0]),
        image_token_id=tok.token_to_id("<|image_pad|>"),
        video_token_id=tok.token_to_id("<|video_pad|>"),
        vision_start_token_id=tok.token_to_id("<|vision_start|>"),
    )
    transformers.Qwen3VLForConditionalGeneration(cfg).eval().save_pretrained(
        str(d), safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def vlm_both(ckpt, vlm_ckpt):
    """Both servers over the echo TextBackend with a Qwen3-VL for images."""
    from crane_tpu.models.qwen3_vl import load_qwen3_vl as ref_load
    from crane_tpu.serve.api import Server as RefServer
    from crane_tpu.serve.api import build_app as ref_app
    from crane_tpu.serve.backend import TextBackend as RefBackend
    from crane_tpu.tokenizer.autotokenizer import AutoTokenizer as RefTokenizer
    from crane_tpu_torch.models.qwen3_vl import load_qwen3_vl
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.backend import TextBackend
    from crane_tpu_torch.serve.transport import BackgroundServer
    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    servers = []
    for srv_cls, backend_cls, tok_cls, vlm in (
            (RefServer, RefBackend, RefTokenizer, ref_load(vlm_ckpt, dtype=jnp.float32)),
            (Server, TextBackend, AutoTokenizer,
             load_qwen3_vl(vlm_ckpt, dtype=torch.float32, device="cpu"))):
        tok = tok_cls.from_pretrained(ckpt)
        backend = backend_cls(_EchoModel(tok.encode("hello world again")), tok,
                              eos_token_ids=(), name="echo")
        servers.append(srv_cls(None, model_name="tiny-vlm", text_backend=backend, vlm=vlm))
    http_server = BackgroundServer(build_app(servers[1]))
    yield RefClient(lambda: ref_app(servers[0])), PortClient(http_server.port), servers
    http_server.close()


@pytest.fixture(scope="module")
def image_chat():
    """A chat request holding a PNG as a data: URL (built with PIL, which
    only the image tests need)."""
    return {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "what is this? "},
        {"type": "image_url", "image_url": {"url": _png_data_url()}},
        {"type": "text", "text": " tell me"}]}], "max_tokens": 10}


def test_image_chat_matches_crane_tpu(vlm_both, image_chat):
    """A PNG as a data: URL: the port's ``_vlm_generate_sync`` gives
    crane_tpu's text, prompt length and token count, and the HTTP answers,
    whole and streamed, equal crane_tpu's."""
    ref, port, (ref_server, server) = vlm_both
    got = server._vlm_generate_sync(image_chat["messages"], 10)
    want = ref_server._vlm_generate_sync(image_chat["messages"], 10)
    assert got == want and got[2] == 10
    body = same((ref, port), "POST", "/v1/chat/completions", image_chat)[1]
    assert body["usage"]["completion_tokens"] == 10
    assert body["choices"][0]["message"]["content"] == got[0]
    events = same_sse((ref, port), "/v1/chat/completions", dict(image_chat, stream=True))
    assert "".join(e["choices"][0]["delta"].get("content", "") for e in events) == got[0]


def test_image_chat_rejects_a_remote_url(vlm_both):
    ref, port, _ = vlm_both
    bad = {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "http://example.invalid/x.png"}}]}]}
    body = same((ref, port), "POST", "/v1/chat/completions", bad)[1]
    assert "data:" in body["error"]["message"]


def test_main_serves_image_chat(ckpt, vlm_ckpt, image_chat, monkeypatch):
    """``--vlm-path`` loads the Qwen3-VL beside the text model's engine;
    an image chat request goes to it."""
    from crane_tpu_torch.models.qwen3_vl import Qwen3VLModel
    from crane_tpu_torch.serve import api, transport

    seen = {}

    def serve_once(app, *, host, port):
        seen["server"] = app.router.routes[0][2].__self__
        with transport.BackgroundServer(app) as srv:
            seen["answer"] = PortClient(srv.port).request("POST", "/v1/chat/completions",
                                                         image_chat)

    monkeypatch.setattr(transport, "run_app", serve_once)
    api.main(["--model-path", ckpt, "--vlm-path", vlm_ckpt, "--device", "cpu", "--dtype", "f32",
              "--max-concurrent", "2", "--max-seq-len", "256"])
    assert isinstance(seen["server"].vlm, Qwen3VLModel)
    status, _, body = seen["answer"]
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == 10


def test_sdk_clients_match(ckpt):
    """LlmClient / ChatClient of both packages give the same text."""
    from crane_tpu.generation.config import GenerationConfig as RefGen
    from crane_tpu.sdk.client import ChatClient as RefChat
    from crane_tpu.sdk.client import LlmClient as RefLlm
    from crane_tpu_torch.generation.config import GenerationConfig
    from crane_tpu_torch.sdk.client import ChatClient, LlmClient

    ref = RefLlm.from_pretrained(ckpt, dtype=jnp.float32)
    llm = LlmClient.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    assert llm.generate_text("hello world", GenerationConfig.greedy(6)) \
        == ref.generate_text("hello world", RefGen.greedy(6))
    msgs = [{"role": "user", "content": "hi"}]
    text = llm.chat(msgs, GenerationConfig.greedy(6))
    assert text == ref.chat(msgs, RefGen.greedy(6))
    assert "".join(llm.chat_stream(msgs, GenerationConfig.greedy(6))) == text
    chats = [RefChat(ref, system="terse"), ChatClient(llm, system="terse")]
    replies = [[c.send(m, g.greedy(3)) for m in ("one", "two")]
               for c, g in zip(chats, (RefGen, GenerationConfig))]
    assert replies[0] == replies[1]
    assert [m["role"] for m in chats[1].history] == ["system", "user", "assistant", "user",
                                                     "assistant"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_command_line_serves_a_chat(ckpt, tmp_path):
    """``python -m crane_tpu_torch.serve --device cpu``: /health answers,
    then one chat completion; the process is terminated at the end. The
    whole test is bounded at 60 s."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    log = open(tmp_path / "serve.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "crane_tpu_torch.serve", "--model-path", ckpt, "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--max-concurrent", "2",
         "--max-seq-len", "256", "--dtype", "f32"],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    try:
        client = PortClient(port)
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()[-4000:]
            assert time.monotonic() < deadline - 10, "the server never answered /health"
            try:
                if client.request("GET", "/health")[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        status, _, body = client.request("POST", "/v1/chat/completions", CHAT)
        out = json.loads(body)
        assert status == 200 and out["object"] == "chat.completion", out
        assert out["usage"]["completion_tokens"] == CHAT["max_tokens"]
        assert out["model"] == "m"
    finally:
        proc.terminate()
        try:
            proc.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(5)
        log.close()


# -- speech recognition (--asr-path) -----------------------------------------


@pytest.fixture(scope="module")
def asr_ckpt(tmp_path_factory):
    from tests.test_torch_qwen3_asr import make_tiny_qwen3_asr_checkpoint

    return make_tiny_qwen3_asr_checkpoint(tmp_path_factory.mktemp("asr"))


def _speech(n: int, rate: int) -> np.ndarray:
    t = np.arange(n) / rate
    noise = 0.05 * np.random.default_rng(n).standard_normal(n)
    return (0.3 * np.sin(2 * np.pi * 300 * t) + noise).astype(np.float32)


def _wav_upload(samples: np.ndarray, rate: int) -> tuple[dict, bytes]:
    """A multipart/form-data body with the WAV as its ``file`` part."""
    from crane_tpu_torch.audio.pcm import encode_wav

    boundary = "asr-boundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() \
        + encode_wav(samples, rate) + f"\r\n--{boundary}--\r\n".encode()
    return {"Content-Type": f"multipart/form-data; boundary={boundary}"}, body


def _crane_transcripts(asr_ckpt, uploads) -> list[str]:
    """crane_tpu's Qwen3-ASR text for each (samples, rate) as the server
    sees it: decoded from the WAV, resampled to 16 kHz, the adapter's
    default options."""
    from crane_tpu.audio.pcm import decode_wav, encode_wav, resample
    from crane_tpu.generation.config import TranscribeOptions
    from crane_tpu.models.qwen3_asr import load_qwen3_asr
    from crane_tpu.sdk.audio import Qwen3AsrAdapter

    ref = Qwen3AsrAdapter(load_qwen3_asr(asr_ckpt))
    out = []
    for samples, rate in uploads:
        x, r = decode_wav(encode_wav(samples, rate))
        out.append(ref.transcribe(resample(x, r, 16000) if r != 16000 else x,
                                  TranscribeOptions()).text)
    return out


UPLOADS = ((_speech(16000, 16000), 16000), (_speech(12000, 8000), 8000))


def _serve_asr(monkeypatch, argv) -> dict:
    """main(argv) with the serving loop replaced by the UPLOADS posted to
    /v1/audio/transcriptions and one chat completion."""
    from crane_tpu_torch.serve import api, transport

    seen = {}

    def serve_once(app, *, host, port):
        seen["server"] = app.router.routes[0][2].__self__
        with transport.BackgroundServer(app) as srv:
            client = PortClient(srv.port)
            seen["asr"] = [client.request("POST", "/v1/audio/transcriptions", raw=body,
                                          headers=headers)
                           for headers, body in (_wav_upload(*u) for u in UPLOADS)]
            seen["chat"] = client.request("POST", "/v1/chat/completions", CHAT)

    monkeypatch.setattr(transport, "run_app", serve_once)
    api.main(argv)
    return seen


def _texts(seen) -> list[str]:
    for status, _, body in seen["asr"]:
        assert status == 200, body
    return [json.loads(body)["text"] for _, _, body in seen["asr"]]


def test_main_serves_speech_recognition(ckpt, asr_ckpt, monkeypatch):
    """``--asr-path`` loads Qwen3-ASR (a ``qwen3*`` config without a talker)
    beside the text model's engine: a 16 kHz and an 8 kHz WAV upload (the
    resample route) give crane_tpu's transcriptions, and chat still goes
    to the engine."""
    from crane_tpu_torch.models.qwen3_asr import Qwen3AsrModel
    from crane_tpu_torch.sdk.audio import Qwen3AsrAdapter

    seen = _serve_asr(monkeypatch, ["--model-path", ckpt, "--asr-path", asr_ckpt, "--device",
                                    "cpu", "--dtype", "f32", "--max-concurrent", "2",
                                    "--max-seq-len", "256"])
    server = seen["server"]
    assert isinstance(server.asr, Qwen3AsrAdapter) and isinstance(server.asr.model, Qwen3AsrModel)
    assert server.engine is not None and seen["chat"][0] == 200
    assert _texts(seen) == _crane_transcripts(asr_ckpt, UPLOADS)


def test_main_keeps_gemma3ns_text_backend_beside_asr(asr_ckpt, tmp_path, monkeypatch):
    """A Gemma3n checkpoint with ``--asr-path``: the server keeps the
    Gemma3n ``TextBackend`` for chat (crane_tpu's warm-up loop rebinds that
    name, ROADMAP Queue 3) and serves speech recognition beside it."""
    from crane_tpu_torch.models.gemma3n import Gemma3nLM

    d = _tiny_gemma3n(tmp_path / "g3n")
    seen = _serve_asr(monkeypatch, ["--model-path", d, "--asr-path", asr_ckpt, "--device", "cpu",
                                    "--dtype", "f32", "--max-seq-len", "64"])
    server = seen["server"]
    assert server.engine is None and isinstance(server.text_backend.model, Gemma3nLM)
    assert seen["chat"][0] == 200, seen["chat"]
    assert _texts(seen) == _crane_transcripts(asr_ckpt, UPLOADS)


def test_main_serves_speech_recognition_alone(asr_ckpt, monkeypatch):
    """``--asr-path`` without ``--model-path``: no text model, so a chat
    request answers 400, and transcriptions are crane_tpu's. Without
    ``--device cpu`` on a machine with no card, loading raises."""
    seen = _serve_asr(monkeypatch, ["--asr-path", asr_ckpt, "--device", "cpu", "--dtype", "f32"])
    server = seen["server"]
    assert server.engine is None and server.text_backend is None
    assert seen["chat"][0] == 400
    assert json.loads(seen["chat"][2]) == {"error": {"message": "no text model loaded"}}
    assert _texts(seen) == _crane_transcripts(asr_ckpt, UPLOADS)
    from crane_tpu_torch.serve import api

    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            api.main(["--asr-path", asr_ckpt, "--dtype", "f32"])
    with pytest.raises(SystemExit):
        api.main(["--device", "cpu"])  # neither --model-path nor --asr-path


def test_command_line_serves_a_transcription(asr_ckpt, tmp_path):
    """``python -m crane_tpu_torch.serve --asr-path <dir> --device cpu``
    answers /v1/audio/transcriptions with crane_tpu's text for the same
    WAV; the process is terminated at the end; bounded at 60 s."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    log = open(tmp_path / "serve.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "crane_tpu_torch.serve", "--asr-path", asr_ckpt, "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--dtype", "f32"],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    try:
        client = PortClient(port)
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()[-4000:]
            assert time.monotonic() < deadline - 10, "the server never answered /health"
            try:
                if client.request("GET", "/health")[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        headers, body = _wav_upload(*UPLOADS[0])
        status, _, out = client.request("POST", "/v1/audio/transcriptions", raw=body,
                                        headers=headers)
        assert status == 200, out
        assert json.loads(out)["text"] == _crane_transcripts(asr_ckpt, UPLOADS[:1])[0]
    finally:
        proc.terminate()
        try:
            proc.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(5)
        log.close()


# -- speech synthesis (--tts-path) ---------------------------------------------


@pytest.fixture(scope="module")
def tts_ckpt(tmp_path_factory):
    """tests/test_torch_qwen3_tts.py's tiny Qwen3-TTS checkpoint with peaked
    heads and a dominant EOS row (so both packages synthesize the same two
    frames), the speech tokenizer and speaker encoder beside it, and a
    tokenizer."""
    from tests.fixtures import make_tiny_tokenizer
    from tests.test_torch_qwen3_tts import PEAK, add_clone_stack, make_tts_checkpoint

    d = tmp_path_factory.mktemp("tts") / "m"
    make_tts_checkpoint(d, peak=PEAK, eos_bias=50.0)
    add_clone_stack(d)
    make_tiny_tokenizer(str(d))
    return str(d)


SPEECH = {"input": "hello world", "voice": None}


def _serve_tts(monkeypatch, argv) -> dict:
    """main(argv) with the serving loop replaced by a WAV and a streamed
    /v1/audio/speech request and one chat completion."""
    from crane_tpu_torch.serve import api, transport

    seen = {}

    def serve_once(app, *, host, port):
        seen["server"] = app.router.routes[0][2].__self__
        with transport.BackgroundServer(app) as srv:
            client = PortClient(srv.port)
            seen["wav"] = client.request("POST", "/v1/audio/speech", SPEECH)
            seen["stream"] = client.request("POST", "/v1/audio/speech", {**SPEECH, "stream": True})
            seen["chat"] = client.request("POST", "/v1/chat/completions", CHAT)

    monkeypatch.setattr(transport, "run_app", serve_once)
    api.main(argv)
    return seen


def _check_speech(seen, ref_samples, rate):
    """The WAV holds crane_tpu's samples (to one int16 step); the stream's
    PCM is the WAV's int16 data, chunk for chunk."""
    from crane_tpu.audio.pcm import encode_wav as ref_encode_wav
    from crane_tpu_torch.audio.pcm import decode_wav

    status, headers, body = seen["wav"]
    assert status == 200 and headers["Content-Type"].startswith("audio/wav"), body[:200]
    samples, sr = decode_wav(body)
    assert sr == rate and len(samples) == len(ref_samples) > 0
    np.testing.assert_allclose(samples, decode_wav(ref_encode_wav(ref_samples, rate))[0],
                               atol=1.5 / 32768)
    status, headers, pcm = seen["stream"]
    assert status == 200 and headers["X-Sample-Rate"] == str(rate)
    assert len(body) == 44 + len(pcm) and pcm == body[44:]  # the WAV's header is 44 bytes


def test_main_serves_speech_synthesis(ckpt, tts_ckpt, monkeypatch):
    """``--tts-path`` on a Qwen3-TTS checkpoint serves /v1/audio/speech
    beside the text model's engine: the WAV holds crane_tpu's
    ``Qwen3Tts.generate_speech`` on the same checkpoint and text, the
    streamed request the same samples as PCM (1920 / 48 samples a frame at
    the tiny decoder's upsampling), and chat still goes to the engine."""
    from crane_tpu.generation.config import SpeechOptions as RefOptions
    from crane_tpu.models.qwen3_tts import load_qwen3_tts as ref_load
    from crane_tpu.sdk.audio import Qwen3Tts as RefTts
    from crane_tpu_torch.models.qwen3_tts import Qwen3TTSModel
    from crane_tpu_torch.sdk.audio import Qwen3Tts

    seen = _serve_tts(monkeypatch, ["--model-path", ckpt, "--tts-path", tts_ckpt, "--device",
                                    "cpu", "--dtype", "f32", "--max-concurrent", "2",
                                    "--max-seq-len", "256"])
    server = seen["server"]
    assert isinstance(server.tts, Qwen3Tts) and isinstance(server.tts.model, Qwen3TTSModel)
    assert server.engine is not None and seen["chat"][0] == 200
    ref = RefTts(ref_load(tts_ckpt)).generate_speech(SPEECH["input"], RefOptions())
    assert len(ref) == 2 * server.tts.model.decoder.config.total_upsample
    _check_speech(seen, ref, 24000)


def _tiny_csm(dirpath) -> str:
    """tests/test_csm_tts_parity.py's tiny CSM, saved by transformers with a
    tokenizer: its text vocabulary widened to the tiny tokenizer's 400 ids,
    its 256 positions kept (the handler asks for up to 1000 frames, so a
    request runs past the rope table, whose last row both packages read
    there)."""
    import transformers

    from tests.fixtures import make_tiny_tokenizer

    torch.manual_seed(0)
    cfg = transformers.CsmConfig(
        num_codebooks=4, vocab_size=64, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
        max_position_embeddings=256, text_vocab_size=512, rope_scaling=None,
        audio_token_id=450, audio_eos_token_id=451,
        depth_decoder_config=dict(
            num_codebooks=4, vocab_size=64, backbone_hidden_size=64, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
            intermediate_size=48, rope_scaling=None),
        codec_config=dict(
            model_type="mimi", hidden_size=32, num_filters=8, num_residual_layers=1,
            upsampling_ratios=[4, 3], codebook_size=64, codebook_dim=16, num_quantizers=4,
            num_semantic_quantizers=1, vector_quantization_hidden_dimension=16,
            num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2, head_dim=16,
            intermediate_size=32, sliding_window=16, upsample_groups=32),
    )
    transformers.CsmForConditionalGeneration(cfg).eval().save_pretrained(
        str(dirpath), safe_serialization=True)
    make_tiny_tokenizer(str(dirpath))
    return str(dirpath)


def test_main_chooses_csm_by_its_config(tmp_path, monkeypatch):
    """A ``--tts-path`` config without a talker loads CSM with its Mimi codec
    and tokenizer, whose WAV and stream hold crane_tpu's ``CsmTts`` samples;
    a Gemma3n ``--model-path`` beside it keeps its ``TextBackend`` for chat.
    The request's frames run past the backbone's 256 rope positions, and the
    server answers it and the requests after it."""
    from crane_tpu.generation.config import SpeechOptions as RefOptions
    from crane_tpu.models.csm_tts import load_csm as ref_load
    from crane_tpu.sdk.audio import CsmTts as RefTts
    from crane_tpu.tokenizer.autotokenizer import AutoTokenizer as RefTokenizer
    from crane_tpu_torch.models.csm_tts import CsmTtsModel
    from crane_tpu_torch.models.gemma3n import Gemma3nLM
    from crane_tpu_torch.sdk.audio import CsmTts

    csm = _tiny_csm(tmp_path / "csm")
    g3n = _tiny_gemma3n(tmp_path / "g3n")
    seen = _serve_tts(monkeypatch, ["--model-path", g3n, "--tts-path", csm, "--device", "cpu",
                                    "--dtype", "f32", "--max-seq-len", "64"])
    server = seen["server"]
    assert isinstance(server.tts, CsmTts) and isinstance(server.tts.model, CsmTtsModel)
    assert server.engine is None and isinstance(server.text_backend.model, Gemma3nLM)
    assert seen["chat"][0] == 200, seen["chat"]
    ref = RefTts(ref_load(csm, dtype=jnp.float32, with_codec=True),
                 RefTokenizer.from_pretrained(csm)).generate_speech(SPEECH["input"], RefOptions())
    _check_speech(seen, ref, 24000)
    codec = server.tts.model.codec.config
    hop = int(np.prod(codec.upsampling_ratios)) * codec.upsample_stride  # samples a frame
    assert len(ref) // hop > server.tts.model.config.backbone.max_position_embeddings


def test_command_line_serves_speech(ckpt, tts_ckpt, tmp_path):
    """``python -m crane_tpu_torch.serve --model-path <qwen3> --tts-path
    <qwen3_tts> --device cpu`` answers /v1/audio/speech with a WAV of two
    frames and the same samples streamed as PCM; the process is terminated
    at the end; bounded at 60 s."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    log = open(tmp_path / "serve.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "crane_tpu_torch.serve", "--model-path", ckpt, "--tts-path",
         tts_ckpt, "--device", "cpu", "--host", "127.0.0.1", "--port", str(port), "--dtype",
         "f32", "--max-concurrent", "2", "--max-seq-len", "256"],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    try:
        client = PortClient(port)
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()[-4000:]
            assert time.monotonic() < deadline - 10, "the server never answered /health"
            try:
                if client.request("GET", "/health")[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        status, headers, wav = client.request("POST", "/v1/audio/speech", SPEECH)
        assert status == 200 and headers["Content-Type"].startswith("audio/wav"), wav[:200]
        status, _, pcm = client.request("POST", "/v1/audio/speech", {**SPEECH, "stream": True})
        assert status == 200 and len(pcm) == 2 * 2 * 48 and wav[44:] == pcm
    finally:
        proc.terminate()
        try:
            proc.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(5)
        log.close()


def test_server_serves_speech_alone(tts_ckpt):
    """A ``Server`` with a TTS model and no text model (as ``chip_smoke.py``
    builds it): /v1/audio/speech answers a WAV, chat answers 400."""
    from crane_tpu_torch.models.qwen3_tts import load_qwen3_tts
    from crane_tpu_torch.sdk.audio import Qwen3Tts
    from crane_tpu_torch.serve.api import Server, build_app
    from crane_tpu_torch.serve.transport import BackgroundServer

    tts = Qwen3Tts(load_qwen3_tts(tts_ckpt, device="cpu"))
    with BackgroundServer(build_app(Server(None, tts=tts))) as srv:
        client = PortClient(srv.port)
        status, headers, wav = client.request("POST", "/v1/audio/speech", SPEECH)
        assert status == 200 and headers["Content-Type"].startswith("audio/wav")
        assert len(wav) == 44 + 2 * 2 * tts.model.decoder.config.total_upsample
        assert client.request("POST", "/v1/chat/completions", CHAT)[0] == 400
