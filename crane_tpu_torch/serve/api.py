"""OpenAI- and SGLang-compatible HTTP server (port of
``crane_tpu/serve/api.py``).

Reference behavior (crane-serve ``src/{lib.rs,handlers/}``):
endpoints /health, /health_generate, /v1/stats, /v1/models[/id],
/v1/chat/completions, /v1/completions, /tokenize (+/v1), /detokenize, SGLang
/generate, /model_info, /server_info, /flush_cache, /abort_request; SSE chunk
protocol with a role-announce first chunk and optional usage chunk
(handlers/sse.rs:18-110); default sampling temp 0.8 / top_p 0.95 / top_k 40 /
repetition 1.05 (handlers/openai.rs:34-120).

The handlers, their request parsing, JSON bodies, SSE chunks, status codes
and error messages are ``crane_tpu``'s. The HTTP front is asyncio, through
the standard-library transport of :mod:`crane_tpu_torch.serve.transport`
(``crane_tpu`` uses aiohttp, which the machine with the card lacks); the
engine runs on its own thread, bridged by thread-safe queues — the same
async-front/engine-thread split as the reference's tokio + dedicated OS
thread design.
"""

from __future__ import annotations

import asyncio
import threading
import json
import logging
import time
import uuid
from typing import Any, Optional

from crane_tpu_torch.serve import transport as web
from crane_tpu_torch.models.causal_lm import prompt_ids_error
from crane_tpu_torch.serve.engine import InferenceEngine
from crane_tpu_torch.serve.sequence import EngineRequest, FinishReason, SamplingOptions

log = logging.getLogger("crane_tpu_torch.api")


def _sampling_from_payload(p: dict, prefix_defaults=True) -> SamplingOptions:
    temp = p.get("temperature", 0.8)
    return SamplingOptions(
        temperature=float(temp),
        top_k=int(p.get("top_k", 40)),
        top_p=float(p.get("top_p", 0.95)),
        repetition_penalty=float(p.get("repetition_penalty", 1.05)),
        do_sample=bool(p.get("do_sample", temp > 0)),
        seed=int(p.get("seed", 0)),
    )


def _stop_from_payload(p: dict) -> tuple:
    """OpenAI ``stop``: a string or list of up to 4 strings."""
    stop = p.get("stop")
    if stop is None:
        return ()
    if isinstance(stop, str):
        stop = [stop]
    return tuple(s for s in stop if isinstance(s, str) and s)[:4]


class Server:
    def __init__(
        self,
        engine: InferenceEngine | None,
        *,
        model_name: str = "crane-tpu",
        eos_token_ids: tuple[int, ...] = (),
        tts=None,
        asr=None,
        vlm=None,
        text_backend=None,
    ):
        """``engine`` serves CausalLM with continuous batching; models with
        bespoke forwards (Gemma3n) pass ``text_backend`` instead (the
        reference serves every model via ModelBackend + concurrency cap,
        backend.rs:220-223) — chat/completions then route through it. With
        neither, the server serves speech alone (``asr``, ``tts`` or both),
        and a text request answers 400 (crane_tpu requires a text model)."""
        assert (engine is not None or text_backend is not None or asr is not None
                or tts is not None)
        self.engine = engine
        self.text_backend = text_backend
        self.model_name = model_name
        if engine is not None:
            self.eos_token_ids = tuple(eos_token_ids) or tuple(engine.lm.eos_token_ids)
            self.tokenizer = engine.lm.tokenizer
        elif text_backend is not None:
            self.eos_token_ids = tuple(eos_token_ids) or tuple(text_backend.eos_token_ids)
            self.tokenizer = text_backend.tokenizer
        else:
            self.eos_token_ids, self.tokenizer = tuple(eos_token_ids), None
        self.created = int(time.time())
        # multimodal backends run outside the engine with their own serialized
        # executors — the reference's dedicated-thread-per-modality design
        # (crane-serve lib.rs:200-619)
        import concurrent.futures

        self.tts = tts
        self.asr = asr
        self.vlm = vlm
        self._tts_pool = concurrent.futures.ThreadPoolExecutor(1, "tts")
        self._asr_pool = concurrent.futures.ThreadPoolExecutor(1, "asr")
        self._vlm_pool = concurrent.futures.ThreadPoolExecutor(1, "vlm")

    # -- request plumbing ----------------------------------------------------
    async def _stream_responses(self, q):
        loop = asyncio.get_running_loop()
        while True:
            r = await loop.run_in_executor(None, q.get)
            yield r
            if r.finished:
                return

    def _make_request(self, prompt_ids, payload, rid=None) -> EngineRequest:
        """The engine request of a route; a prompt id outside the vocabulary
        (or not an integer) is answered 400 here, before the engine sees
        it."""
        err = prompt_ids_error(prompt_ids, self.engine.lm.config.vocab_size)
        if err:
            raise web.HTTPError(400, err)
        return EngineRequest(
            request_id=rid or f"req-{uuid.uuid4().hex[:16]}",
            prompt_ids=list(prompt_ids),
            max_new_tokens=int(
                payload.get("max_tokens")
                or payload.get("max_completion_tokens")
                or payload.get("max_new_tokens")
                or 512
            ),
            sampling=_sampling_from_payload(payload),
            eos_token_ids=self.eos_token_ids,
            stop_strings=_stop_from_payload(payload),
        )

    # -- misc endpoints ------------------------------------------------------
    async def health(self, request):
        return web.json_response({"status": "ok"})

    async def health_generate(self, request):
        """Deep health check: run one tiny generation through the engine."""
        if self.engine is None:
            return web.json_response(
                {"error": {"message": "endpoint requires the slot engine"}},
                status=400,
            )
        req = EngineRequest(
            request_id=f"health-{uuid.uuid4().hex[:8]}",
            prompt_ids=[1], max_new_tokens=1,
            sampling=SamplingOptions(do_sample=False),
        )
        q = self.engine.submit(req)
        async for r in self._stream_responses(q):
            if r.finished and r.error:
                return web.json_response({"status": "error", "error": r.error}, status=500)
        return web.json_response({"status": "ok"})

    async def stats(self, request):
        if self.engine is None:
            return web.json_response(
                {"error": {"message": "endpoint requires the slot engine"}},
                status=400,
            )
        return web.json_response(
            self.engine.stats.snapshot(
                running=len(self.engine.scheduler.running),
                waiting=len(self.engine.scheduler.waiting),
            )
        )

    async def models(self, request):
        return web.json_response(
            {
                "object": "list",
                "data": [
                    {
                        "id": self.model_name,
                        "object": "model",
                        "created": self.created,
                        "owned_by": "crane-tpu",
                    }
                ],
            }
        )

    async def model_by_id(self, request):
        mid = request.match_info["model_id"]
        if mid != self.model_name:
            return web.json_response({"error": "model not found"}, status=404)
        return web.json_response(
            {"id": mid, "object": "model", "created": self.created, "owned_by": "crane-tpu"}
        )

    def _no_text_model(self):
        """The answer to a text request on a server of speech recognition
        alone, else None."""
        if self.tokenizer is None:
            return web.json_response({"error": {"message": "no text model loaded"}}, status=400)
        return None

    async def tokenize(self, request):
        if (refused := self._no_text_model()) is not None:
            return refused
        p = await request.json()
        text = p.get("text") or p.get("prompt") or ""
        ids = self.tokenizer.encode(text)
        return web.json_response({"tokens": ids, "count": len(ids)})

    async def detokenize(self, request):
        if (refused := self._no_text_model()) is not None:
            return refused
        p = await request.json()
        ids = p.get("tokens") or []
        return web.json_response({"text": self.tokenizer.decode(ids)})

    # -- SGLang-compatible ---------------------------------------------------
    async def model_info(self, request):
        return web.json_response(
            {
                "model_path": self.model_name,
                "tokenizer_path": self.model_name,
                "is_generation": True,
            }
        )

    async def server_info(self, request):
        if self.engine is None:
            return web.json_response(
                {"error": {"message": "endpoint requires the slot engine"}},
                status=400,
            )
        snap = self.engine.stats.snapshot(
            running=len(self.engine.scheduler.running),
            waiting=len(self.engine.scheduler.waiting),
        )
        return web.json_response(
            {
                "model_path": self.model_name,
                "max_num_reqs": self.engine.max_slots,
                "max_seq_len": self.engine.max_seq_len,
                **snap,
            }
        )

    async def flush_cache(self, request):
        if self.engine is None:
            return web.json_response(
                {"error": {"message": "endpoint requires the slot engine"}},
                status=400,
            )
        # static slots: nothing to free while sequences are running — the
        # flushable state is the resident prefixes idle slots keep for
        # cross-request reuse
        self.engine.clear_prefix_cache()
        return web.json_response({"status": "ok", "message": "cache flushed"})

    async def abort_request(self, request):
        if self.engine is None:
            return web.json_response(
                {"error": {"message": "endpoint requires the slot engine"}},
                status=400,
            )
        p = await request.json()
        rid = p.get("rid") or p.get("request_id")
        if not rid:
            return web.json_response({"error": "missing rid"}, status=400)
        self.engine.abort(rid)
        return web.json_response({"status": "ok"})

    async def generate(self, request):
        """SGLang /generate: {text | input_ids, sampling_params, stream}."""
        if self.engine is None:
            return web.json_response(
                {"error": {"message": "endpoint requires the slot engine"}},
                status=400,
            )
        p = await request.json()
        sp = p.get("sampling_params") or {}
        if "input_ids" in p:
            ids = p["input_ids"]
        else:
            ids = self.tokenizer.encode(p.get("text", ""))
        payload = {**sp, "max_tokens": sp.get("max_new_tokens", 128)}
        req = self._make_request(ids, payload, rid=p.get("rid"))
        q = self.engine.submit(req)

        if p.get("stream"):
            resp = web.StreamResponse(
                headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
            )
            await resp.prepare(request)
            text = ""
            async for r in self._stream_responses(q):
                if r.error:
                    break
                if r.text:
                    text += r.text
                    chunk = {"text": text, "meta_info": {"id": req.request_id}}
                    await resp.write(f"data: {json.dumps(chunk)}\n\n".encode())
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp

        text, n_gen, reason, err = "", 0, None, None
        async for r in self._stream_responses(q):
            if r.text:
                text += r.text
            if r.finished:
                n_gen, reason, err = r.n_generated, r.finish_reason, r.error
        if err:
            return web.json_response({"error": err}, status=400)
        return web.json_response(
            {
                "text": text,
                "meta_info": {
                    "id": req.request_id,
                    "prompt_tokens": len(req.prompt_ids),
                    "completion_tokens": n_gen,
                    "finish_reason": {"type": reason.value if reason else None},
                },
            }
        )

    # -- audio endpoints (reference handlers/{tts,asr}.rs) --------------------
    async def audio_speech(self, request):
        """POST /v1/audio/speech: {input, voice?, response_format?} -> WAV."""
        if self.tts is None:
            return web.json_response({"error": "no TTS model loaded"}, status=400)
        p = await request.json()
        text = p.get("input") or p.get("text")
        if not text:
            return web.json_response({"error": "missing 'input'"}, status=400)
        from crane_tpu_torch.audio.pcm import encode_wav
        from crane_tpu_torch.generation.config import SpeechOptions

        opts = SpeechOptions(voice=p.get("voice"), speed=float(p.get("speed", 1.0)))
        loop = asyncio.get_running_loop()
        if p.get("stream") and hasattr(self.tts, "generate_speech_stream"):
            # frame-chunked PCM streaming (reference prepare_streaming /
            # generate_one_frame, qwen3_tts/modeling.rs:1497-1658): audio
            # chunks go out as the talker produces frames
            from crane_tpu_torch.audio.pcm import f32_to_i16

            resp = web.StreamResponse(
                headers={
                    "Content-Type": "audio/pcm",
                    "X-Sample-Rate": str(self.tts.audio_info().sample_rate),
                }
            )
            await resp.prepare(request)
            q: asyncio.Queue = asyncio.Queue()
            cancelled = threading.Event()

            def produce():
                try:
                    for chunk in self.tts.generate_speech_stream(text, opts):
                        if cancelled.is_set():
                            # client gone: stop synthesizing so the
                            # serialized TTS executor frees up (reference
                            # drops the stream on disconnect)
                            return
                        loop.call_soon_threadsafe(
                            q.put_nowait, f32_to_i16(chunk).tobytes()
                        )
                except Exception as e:  # surfaced as stream truncation
                    log.warning("tts stream error: %s", e)
                finally:
                    loop.call_soon_threadsafe(q.put_nowait, None)

            fut = loop.run_in_executor(self._tts_pool, produce)
            try:
                while True:
                    b = await q.get()
                    if b is None:
                        break
                    await resp.write(b)
            except (ConnectionResetError, asyncio.CancelledError):
                cancelled.set()
                raise
            finally:
                cancelled.set()
                await asyncio.shield(fut)
            await resp.write_eof()
            return resp
        try:
            wav = await loop.run_in_executor(
                self._tts_pool, self.tts.generate_speech, text, opts
            )
        except Exception as e:
            return web.json_response({"error": str(e)}, status=400)
        sr = self.tts.audio_info().sample_rate
        fmt = p.get("response_format", "wav")
        if fmt == "pcm":
            from crane_tpu_torch.audio.pcm import f32_to_i16

            body, ctype = f32_to_i16(wav).tobytes(), "audio/pcm"
        else:
            body, ctype = encode_wav(wav, sr), "audio/wav"
        return web.Response(body=body, content_type=ctype)

    async def audio_transcriptions(self, request):
        """POST /v1/audio/transcriptions: multipart 'file' -> {text}."""
        if self.asr is None:
            return web.json_response({"error": "no ASR model loaded"}, status=400)
        data = None
        if request.content_type and "multipart" in request.content_type:
            reader = await request.multipart()
            async for part in reader:
                if part.name == "file":
                    data = await part.read()
        else:
            data = await request.read()
        if not data:
            return web.json_response({"error": "missing audio file"}, status=400)
        from crane_tpu_torch.audio.pcm import decode_wav, resample
        from crane_tpu_torch.generation.config import TranscribeOptions

        try:
            samples, rate = decode_wav(data)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        target = self.asr.input_sample_rate()
        if rate != target:
            samples = resample(samples, rate, target)
        loop = asyncio.get_running_loop()
        transcript = await loop.run_in_executor(
            self._asr_pool, self.asr.transcribe, samples, TranscribeOptions()
        )
        return web.json_response({"text": transcript.text})

    # -- OpenAI chat/completions ---------------------------------------------
    def _render_chat(self, payload: dict) -> str:
        messages = payload["messages"]
        kw = {}
        if "chat_template_kwargs" in payload:
            kw.update(payload["chat_template_kwargs"])
        return self.tokenizer.apply_chat_template(
            messages,
            tools=payload.get("tools"),
            add_generation_prompt=True,
            **kw,
        )

    @staticmethod
    def _has_image_parts(messages) -> bool:
        return any(
            isinstance(m.get("content"), list)
            and any(p.get("type") == "image_url" for p in m["content"])
            for m in messages
        )

    def _decode_image(self, url: str):
        """A ``data:`` image URL -> a PIL image (PIL is imported here only:
        the machine with the card has none)."""
        import base64
        import io

        from PIL import Image

        if url.startswith("data:"):
            b64 = url.split(",", 1)[1]
            return Image.open(io.BytesIO(base64.b64decode(b64)))
        raise ValueError("only data: image URLs are supported (zero-egress server)")

    def _vlm_generate_sync(self, messages, max_tokens, streamer=None):
        """Render a ChatML prompt by hand with N image pads per image
        (reference vlm.rs:311-344), splice, and greedy-decode."""
        from crane_tpu_torch.models.image_processing import preprocess_image

        vc = self.vlm.vision_config
        images, meta = [], []
        for m in messages:
            if not isinstance(m.get("content"), list):
                continue
            for part in m["content"]:
                if part.get("type") == "image_url":
                    img = self._decode_image(part["image_url"]["url"])
                    patches, grid = preprocess_image(
                        img, patch_size=vc.patch_size,
                        merge_size=vc.spatial_merge_size,
                        temporal_patch_size=vc.temporal_patch_size,
                    )
                    images.append((patches, grid))
                    meta.append(grid[0] * (grid[1] // vc.spatial_merge_size)
                                * (grid[2] // vc.spatial_merge_size))
        parts, img_i = [], 0
        for m in messages:
            c = m.get("content")
            if isinstance(c, list):
                text = ""
                for part in c:
                    if part.get("type") == "image_url":
                        text += ("<|vision_start|>" + "<|image_pad|>" * meta[img_i]
                                 + "<|vision_end|>")
                        img_i += 1
                    else:
                        text += part.get("text", "")
            else:
                text = c
            parts.append(f"<|im_start|>{m['role']}\n{text}<|im_end|>\n")
        prompt = "".join(parts) + "<|im_start|>assistant\n"
        ids = self.vlm.tokenizer.encode(prompt)
        from crane_tpu_torch.generation.config import GenerationConfig
        from crane_tpu_torch.generation.streamer import CollectStreamer

        st = streamer or CollectStreamer(self.vlm.tokenizer)
        gen = GenerationConfig.greedy(max_tokens, eos_token_ids=tuple(self.vlm.eos_token_ids))
        n = len(self.vlm.generate(ids, images=images, gen=gen, streamer=st))
        text = st.text if streamer is None else ""
        return text, len(ids), n

    async def _vlm_chat(self, request, payload):
        loop = asyncio.get_running_loop()
        max_tokens = int(payload.get("max_tokens") or 512)
        if payload.get("stream"):
            from crane_tpu_torch.serve.backend import LoopStreamer

            st = LoopStreamer(self.vlm.tokenizer, loop)

            def run():
                try:
                    self._vlm_generate_sync(payload["messages"], max_tokens, st)
                except BaseException as e:  # surfaced to the SSE consumer
                    st.fail(e)

            self._vlm_pool.submit(run)
            return await self._sse_from_streamer(request, f"req-{uuid.uuid4().hex[:16]}", st)
        try:
            text, n_prompt, n_gen = await loop.run_in_executor(
                self._vlm_pool, self._vlm_generate_sync, payload["messages"], max_tokens)
        except Exception as e:
            return web.json_response({"error": {"message": str(e)}}, status=400)
        return web.json_response({
            "id": f"req-{uuid.uuid4().hex[:16]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": "stop",
            }],
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": n_gen,
                "total_tokens": n_prompt + n_gen,
            },
        })

    async def chat_completions(self, request):
        payload = await request.json()
        if self.vlm is not None and self._has_image_parts(payload.get("messages", [])):
            return await self._vlm_chat(request, payload)
        if (refused := self._no_text_model()) is not None:
            return refused
        try:
            prompt = self._render_chat(payload)
        except Exception as e:  # template errors -> 400
            return web.json_response({"error": {"message": str(e)}}, status=400)
        ids = self.tokenizer.encode(prompt)
        if self.engine is None:
            return await self._backend_chat(request, payload, ids)
        req = self._make_request(ids, payload)
        q = self.engine.submit(req)
        if payload.get("stream"):
            return await self._sse_chat(request, req, q, payload)
        return await self._collect_chat(req, q)

    async def _backend_chat(self, request, payload, ids):
        """chat via the capped TextBackend (non-engine models)."""
        max_tokens = int(
            payload.get("max_tokens") or payload.get("max_completion_tokens")
            or payload.get("max_new_tokens") or 512
        )
        rid = f"req-{uuid.uuid4().hex[:16]}"
        if payload.get("stream"):
            st = self.text_backend.generate_stream(ids, max_tokens)
            return await self._sse_from_streamer(request, rid, st)
        text, n_gen = await self.text_backend.generate(ids, max_tokens)
        return web.json_response({
            "id": rid, "object": "chat.completion", "created": int(time.time()),
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": "stop",
            }],
            "usage": {
                "prompt_tokens": len(ids), "completion_tokens": n_gen,
                "total_tokens": len(ids) + n_gen,
            },
        })

    async def _sse_from_streamer(self, request, rid, st):
        """SSE chat deltas from a LoopStreamer (backend / VLM paths)."""
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        await resp.prepare(request)
        base = {
            "id": rid, "object": "chat.completion.chunk",
            "created": int(time.time()), "model": self.model_name,
        }

        def chunk(delta: dict, finish=None) -> bytes:
            c = dict(base, choices=[{"index": 0, "delta": delta, "finish_reason": finish}])
            return b"data: " + json.dumps(c).encode() + b"\n\n"

        try:
            await resp.write(chunk({"role": "assistant", "content": ""}))
            while True:
                item = await st.queue.get()
                if item is None:
                    break
                if isinstance(item, tuple):  # forwarded generation error
                    await resp.write(chunk({"content": f"\n[error: {item[0]}]"}))
                    break
                await resp.write(chunk({"content": item}))
            await resp.write(chunk({}, finish="stop"))
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
        except (ConnectionResetError, asyncio.CancelledError):
            # client gone: stop the producing generate loop so the capped
            # executor frees up instead of decoding to max_tokens
            st.cancel()
            raise
        return resp

    async def completions(self, request):
        if self.engine is None:
            return web.json_response(
                {"error": {"message": "endpoint requires the slot engine"}},
                status=400,
            )
        payload = await request.json()
        prompt = payload.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        ids = self.tokenizer.encode(prompt)
        req = self._make_request(ids, payload)
        q = self.engine.submit(req)

        text, n_gen, reason, err = "", 0, None, None
        async for r in self._stream_responses(q):
            if r.text:
                text += r.text
            if r.finished:
                n_gen, reason, err = r.n_generated, r.finish_reason, r.error
        if err:
            return web.json_response({"error": {"message": err}}, status=400)
        return web.json_response(
            {
                "id": req.request_id,
                "object": "text_completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "text": text,
                        "finish_reason": reason.value if reason else None,
                    }
                ],
                "usage": {
                    "prompt_tokens": len(req.prompt_ids),
                    "completion_tokens": n_gen,
                    "total_tokens": len(req.prompt_ids) + n_gen,
                },
            }
        )

    async def _collect_chat(self, req, q):
        text, n_gen, reason, err = "", 0, None, None
        async for r in self._stream_responses(q):
            if r.text:
                text += r.text
            if r.finished:
                n_gen, reason, err = r.n_generated, r.finish_reason, r.error
        if err:
            return web.json_response({"error": {"message": err}}, status=400)
        return web.json_response(
            {
                "id": req.request_id,
                "object": "chat.completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": reason.value if reason else None,
                    }
                ],
                "usage": {
                    "prompt_tokens": len(req.prompt_ids),
                    "completion_tokens": n_gen,
                    "total_tokens": len(req.prompt_ids) + n_gen,
                },
            }
        )

    async def _sse_chat(self, request, req, q, payload):
        """SSE protocol: role-announce first chunk, content deltas, final
        finish chunk, optional usage chunk, [DONE] (reference sse.rs)."""
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        await resp.prepare(request)
        created = int(time.time())

        def chunk(delta: dict, finish: Optional[str] = None) -> bytes:
            body = {
                "id": req.request_id,
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.model_name,
                "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            }
            return f"data: {json.dumps(body)}\n\n".encode()

        await resp.write(chunk({"role": "assistant"}))
        n_gen, reason = 0, None
        try:
            async for r in self._stream_responses(q):
                if r.text:
                    await resp.write(chunk({"content": r.text}))
                if r.finished:
                    n_gen, reason = r.n_generated, r.finish_reason
        except (ConnectionResetError, asyncio.CancelledError):
            self.engine.abort(req.request_id)
            raise
        await resp.write(chunk({}, finish=reason.value if reason else "stop"))
        if (payload.get("stream_options") or {}).get("include_usage"):
            usage = {
                "id": req.request_id,
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.model_name,
                "choices": [],
                "usage": {
                    "prompt_tokens": len(req.prompt_ids),
                    "completion_tokens": n_gen,
                    "total_tokens": len(req.prompt_ids) + n_gen,
                },
            }
            await resp.write(f"data: {json.dumps(usage)}\n\n".encode())
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp


def build_app(server: Server) -> web.Application:
    app = web.Application(client_max_size=25 * 1024 * 1024)  # 25 MiB, ref lib.rs:676-684
    r = app.router
    r.add_get("/health", server.health)
    r.add_get("/health_generate", server.health_generate)
    r.add_get("/v1/stats", server.stats)
    r.add_get("/v1/models", server.models)
    r.add_get("/v1/models/{model_id}", server.model_by_id)
    r.add_post("/v1/chat/completions", server.chat_completions)
    r.add_post("/v1/completions", server.completions)
    r.add_post("/v1/audio/speech", server.audio_speech)
    r.add_post("/v1/audio/transcriptions", server.audio_transcriptions)
    r.add_post("/tokenize", server.tokenize)
    r.add_post("/v1/tokenize", server.tokenize)
    r.add_post("/detokenize", server.detokenize)
    r.add_post("/v1/detokenize", server.detokenize)
    # SGLang-compatible
    r.add_post("/generate", server.generate)
    r.add_get("/model_info", server.model_info)
    r.add_get("/server_info", server.server_info)
    r.add_post("/flush_cache", server.flush_cache)
    r.add_post("/abort_request", server.abort_request)
    return app


def _load_text_model(args, dtype, quant_bits):
    """(the CausalLM the engine serves, or None; the TextBackend a Gemma3n
    checkpoint is served through, or None) for ``--model-path``."""
    if args.model_path.endswith(".gguf"):
        from crane_tpu_torch.loaders.gguf_model import from_gguf

        return from_gguf(args.model_path, dtype=dtype, device=args.device), None
    from crane_tpu_torch.models.auto import from_pretrained
    from crane_tpu_torch.models.factory import detect_model_type

    if detect_model_type(args.model_path) in ("gemma3n", "gemma3n_text"):
        # bespoke forward (AltUp/PLE/KV-sharing): served via the capped
        # TextBackend instead of the slot engine (backend.rs:220-223)
        from crane_tpu_torch.models.auto import read_eos_ids
        from crane_tpu_torch.models.gemma3n import from_pretrained as g3n
        from crane_tpu_torch.serve.backend import TextBackend
        from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

        model = g3n(args.model_path, dtype=dtype, max_seq=args.max_seq_len, device=args.device)
        return None, TextBackend(model, AutoTokenizer.from_pretrained(args.model_path),
                                 eos_token_ids=read_eos_ids(args.model_path), name="gemma3n")
    return from_pretrained(args.model_path, dtype=dtype, device=args.device,
                           quant_bits=quant_bits), None


def load_asr(path: str, dtype, device):
    """The speech-recognition adapter for the checkpoint at ``path``:
    Qwen3-ASR where its ``model_type`` starts with ``qwen3`` and it has no
    ``talker_config`` (a Qwen3-TTS checkpoint has one), else Moonshine
    (crane_tpu/serve/api.py:896-909)."""
    from crane_tpu_torch.models.auto import load_hf_config
    from crane_tpu_torch.sdk.audio import MoonshineAsr, Qwen3AsrAdapter

    hf = load_hf_config(path)
    if "talker_config" not in hf and hf.get("model_type", "").startswith("qwen3"):
        from crane_tpu_torch.models.qwen3_asr import load_qwen3_asr

        return Qwen3AsrAdapter(load_qwen3_asr(path, dtype=dtype, device=device))
    from crane_tpu_torch.models.moonshine import load_moonshine

    return MoonshineAsr(load_moonshine(path, dtype=dtype, device=device))


def warm_up_asr(asr) -> None:
    """Transcribe one second of silence before serving, so the first
    request does not pay the kernels' and the decode graphs' set-up; a
    failure is logged and serving goes on, as in crane_tpu
    (``serve/api.py:921-938``). crane_tpu's warm-up loop also rebinds the
    name that held its Gemma3n ``TextBackend``; nothing here touches the
    text side."""
    import numpy as np

    from crane_tpu_torch.generation.config import TranscribeOptions

    try:
        t0 = time.time()
        asr.transcribe(np.zeros(16000, np.float32), TranscribeOptions())
        log.info("asr warmup done in %.1fs", time.time() - t0)
    except Exception as e:
        log.warning("asr warmup failed (non-fatal): %s", e)


def load_tts(path: str, dtype, device):
    """The speech-synthesis adapter for the checkpoint at ``path``:
    Qwen3-TTS where its config has a ``talker_config`` (or ``model_type``
    ``qwen3_tts``), else CSM with its Mimi codec and the checkpoint's
    tokenizer (crane_tpu/serve/api.py:880-895)."""
    from crane_tpu_torch.models.auto import load_hf_config
    from crane_tpu_torch.sdk.audio import CsmTts, Qwen3Tts

    hf = load_hf_config(path)
    if "talker_config" in hf or hf.get("model_type") == "qwen3_tts":
        from crane_tpu_torch.models.qwen3_tts import load_qwen3_tts

        return Qwen3Tts(load_qwen3_tts(path, dtype=dtype, device=device))
    from crane_tpu_torch.models.csm_tts import load_csm
    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    return CsmTts(load_csm(path, dtype=dtype, with_codec=True, device=device),
                  AutoTokenizer.from_pretrained(path))


def warm_up_tts(tts) -> None:
    """Synthesize "hi" (two frames at most) before serving, so the first
    request does not pay the kernels' and the frame programs' set-up; a
    failure is logged and serving goes on, as in crane_tpu
    (``serve/api.py:921-932``)."""
    from crane_tpu_torch.generation.config import SpeechOptions

    try:
        t0 = time.time()
        tts.generate_speech("hi", SpeechOptions(max_new_tokens=2))
        log.info("tts warmup done in %.1fs", time.time() - t0)
    except Exception as e:
        log.warning("tts warmup failed (non-fatal): %s", e)


def main(argv=None):
    """``python -m crane_tpu_torch.serve --model-path <dir | file.gguf>``:
    load the model onto ``--device`` (the card by default; ``cpu`` only when
    asked), warm the engine up, start its thread and serve until
    interrupted. A Gemma3n checkpoint is served through ``TextBackend``
    instead of the engine; ``--vlm-path`` adds a Qwen3-VL model for chat
    requests with images; ``--asr-path`` adds a speech-recognition model
    for /v1/audio/transcriptions (Qwen3-ASR for a ``qwen3*`` config without
    a talker, else Moonshine), warmed up on one second of silence;
    ``--tts-path`` adds a speech-synthesis model for /v1/audio/speech
    (Qwen3-TTS for a config with a ``talker_config``, else CSM), warmed up
    on "hi". With ``--asr-path``, ``--model-path`` may be left out: the
    server then serves speech recognition (and synthesis) without a text
    model."""
    import argparse

    import torch

    ap = argparse.ArgumentParser("crane_tpu_torch.serve")
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card (cuda, the default) or, "
                    "when asked, the CPU")
    ap.add_argument("--max-concurrent", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--decode-tokens-per-seq", type=int, default=8)
    ap.add_argument("--preempt-after", type=float, default=30.0,
                    help="seconds a fresh request may starve before the "
                    "longest-running sequence is preempted and requeued "
                    "(<=0 disables)")
    ap.add_argument("--speculative", default=None, choices=[None, "ngram"],
                    help="prompt-lookup speculative decode for greedy "
                    "streams (exact; tokens per weight pass gate it)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request prefix reuse (on by default "
                    "for full-attention models: a new prompt sharing a "
                    "token prefix with a free slot's finished context "
                    "prefills only the unseen suffix — exact, multi-turn "
                    "chats skip re-prefilling the conversation)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="admit prompts longer than this in chunks, with a "
                    "decode block for running sequences interleaved between "
                    "chunks (<=0 = whole-prompt prefill)")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--quant", default=None, choices=[None, "q8", "q4"])
    ap.add_argument("--kv-quant", default=None, choices=[None, "int8", "int4"])
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: Megatron-split weights and KV "
                    "heads over N devices (--device cpu repeats the CPU)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree: the slots split over N groups "
                    "of --tp devices (--max-concurrent must divide by it)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree: shard the KV cache's "
                    "sequence axis over the first N devices (contexts too "
                    "long for one card's memory; composes with --kv-quant)")
    ap.add_argument("--vlm-path", default=None, help="Qwen3-VL checkpoint for image chat")
    ap.add_argument("--tts-path", default=None,
                    help="Qwen3-TTS or CSM checkpoint for /v1/audio/speech")
    ap.add_argument("--asr-path", default=None,
                    help="Qwen3-ASR or Moonshine checkpoint for /v1/audio/transcriptions")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.model_path is None and args.asr_path is None:
        ap.error("--model-path is required unless --asr-path is given")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    quant_bits = {"q8": 8, "q4": 4}.get(args.quant)
    # hub fallback (reference autotokenizer.rs:232-258): --model-path may be
    # a repo id; resolve once so every downstream consumer sees a local dir
    from crane_tpu_torch.utils.hub import resolve_checkpoint

    lm = engine = backend = None
    if args.model_path is not None:
        args.model_path = resolve_checkpoint(args.model_path)
        lm, backend = _load_text_model(args, dtype, quant_bits)
    if lm is not None and (args.tp > 1 or args.dp > 1):
        # tensor/data-parallel serving: weights and KV heads over tp, slot
        # rows over dp; every engine step runs each group's shards
        # (parallel/inference.py). Weights quantized in situ raise, as in
        # crane_tpu.
        if args.sp > 1:
            raise ValueError("--tp/--dp and --sp are mutually exclusive")
        if args.max_concurrent % args.dp:
            raise ValueError(f"--max-concurrent {args.max_concurrent} must divide by --dp "
                             f"{args.dp} (slots shard evenly over the dp axis)")
        from crane_tpu_torch.parallel.inference import shard_lm
        from crane_tpu_torch.parallel.sharding import make_mesh

        n = args.dp * args.tp
        devices = [args.device] * n if lm.device.type == "cpu" else None
        lm = shard_lm(lm, make_mesh(args.dp, args.tp, devices))
    elif lm is not None and args.sp > 1:
        # sequence-parallel serving: KV sequence axis sharded over sp
        # devices — max_seq_len beyond one card's memory (parallel/sequence.py)
        from crane_tpu_torch.parallel.sequence import make_sp_mesh, sp_shard_lm

        devices = [args.device] * args.sp if lm.device.type == "cpu" else None
        lm = sp_shard_lm(lm, make_sp_mesh(args.sp, devices))
    if lm is not None:
        engine = InferenceEngine(
            lm,
            max_slots=args.max_concurrent,
            max_seq_len=args.max_seq_len,
            decode_tokens_per_seq=args.decode_tokens_per_seq,
            kv_quant_bits={"int8": 8, "int4": 4}.get(args.kv_quant),
            preempt_after_s=args.preempt_after if args.preempt_after > 0 else None,
            prefill_chunk=args.prefill_chunk if args.prefill_chunk > 0 else None,
            speculative=args.speculative,
            prefix_cache=not args.no_prefix_cache,
        )
    vlm = None
    if args.vlm_path:
        from crane_tpu_torch.models.qwen3_vl import load_qwen3_vl

        vlm = load_qwen3_vl(args.vlm_path, dtype=dtype, device=args.device)
    tts = load_tts(args.tts_path, dtype, args.device) if args.tts_path else None
    if tts is not None:
        warm_up_tts(tts)
    asr = load_asr(args.asr_path, dtype, args.device) if args.asr_path else None
    if asr is not None:
        warm_up_asr(asr)
    if engine is not None:
        log.info("warming up (kernels and decode-block graphs)...")
        engine.warmup()
        engine.start()
    name = args.model_name or (args.model_path or args.asr_path).rstrip("/").split("/")[-1]
    server = Server(engine, model_name=name, vlm=vlm, tts=tts, asr=asr, text_backend=backend)
    try:
        web.run_app(build_app(server), host=args.host, port=args.port)
    finally:
        if engine is not None:
            engine.stop()


if __name__ == "__main__":
    main()
