"""High-level SDK clients (reference crane/src: ChatClient, LlmClient —
lib.rs:1-24, llm/client.rs, chat/client.rs).

A copy of ``crane_tpu/sdk/client.py`` on the port's ``from_pretrained``,
which loads onto the card unless given ``device="cpu"``."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.generation.streamer import AsyncTextStreamer, CollectStreamer


class LlmClient:
    """Prompt-in/text-out wrapper over a loaded CausalLM + tokenizer."""

    def __init__(self, lm):
        if lm.tokenizer is None:
            raise ValueError("model has no tokenizer attached")
        self.lm = lm

    @classmethod
    def from_pretrained(cls, model_dir: str, **kw) -> "LlmClient":
        from crane_tpu_torch.models.auto import from_pretrained

        return cls(from_pretrained(model_dir, **kw))

    def generate_text(self, prompt: str, gen: GenerationConfig | None = None) -> str:
        ids = self.lm.tokenizer.encode(prompt)
        streamer = CollectStreamer(self.lm.tokenizer)
        self.lm.generate(ids, gen, streamer=streamer)
        return streamer.text

    def chat(
        self,
        messages: list[dict],
        gen: GenerationConfig | None = None,
        *,
        tools: list[dict] | None = None,
        enable_thinking: bool | None = None,
    ) -> str:
        prompt = self.lm.tokenizer.apply_chat_template(
            messages, tools=tools, add_generation_prompt=True,
            enable_thinking=enable_thinking,
        )
        return self.generate_text(prompt, gen)

    def chat_stream(
        self, messages: list[dict], gen: GenerationConfig | None = None, **kw
    ) -> Iterator[str]:
        """Streaming chat: yields text pieces as they decode."""
        import threading

        prompt = self.lm.tokenizer.apply_chat_template(
            messages, add_generation_prompt=True, **kw
        )
        ids = self.lm.tokenizer.encode(prompt)
        streamer = AsyncTextStreamer(self.lm.tokenizer)
        t = threading.Thread(
            target=self.lm.generate, args=(ids, gen), kwargs={"streamer": streamer}
        )
        t.start()
        yield from streamer
        t.join()


class ChatClient:
    """Multi-turn chat with history management (reference chat/client.rs)."""

    def __init__(self, llm: LlmClient, *, system: Optional[str] = None):
        self.llm = llm
        self.history: list[dict] = []
        if system:
            self.history.append({"role": "system", "content": system})

    def send(self, content: str, gen: GenerationConfig | None = None) -> str:
        self.history.append({"role": "user", "content": content})
        reply = self.llm.chat(self.history, gen)
        self.history.append({"role": "assistant", "content": reply})
        return reply

    def clear(self):
        self.history = [m for m in self.history if m["role"] == "system"]
