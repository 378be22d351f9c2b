"""AutoTokenizer: HF tokenizer.json + byte-exact chat templating.

A copy of ``crane_tpu/tokenizer/autotokenizer.py`` (the port imports nothing
of ``crane_tpu``); ``tokenizers`` and ``jinja2`` are imported at first use.

Reference behavior (crane-core ``autotokenizer.rs``): loads
``tokenizer.json`` + ``tokenizer_config.json`` (with ``chat_template.jinja``
fallback), renders chat templates with Python-compat guarantees — Python-style
``tojson`` separators without HTML escaping, ``raise_exception``,
``enable_thinking`` rendered as UNDEFINED when None so template defaults win,
tools passed through for agentic tool calling (:267-463, :500-506).

Here the host language IS Python, so "pycompat" is exact by construction: the
jinja2 environment reproduces transformers' own
(ImmutableSandboxedEnvironment, trim_blocks, lstrip_blocks, loopcontrols,
json.dumps-based tojson) — byte-identical rendering vs HF is the test bar.
GGUF-embedded tokenizers are handled by ``from_gguf`` (loaders/gguf.py builds
the tokenizer object from metadata, mirroring autotokenizer.rs:162-230).
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Optional, Sequence


def _make_jinja_env():
    import jinja2
    from jinja2.ext import loopcontrols
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        # jinja's built-in tojson HTML-escapes; Python/HF semantics do not
        return json.dumps(
            x, ensure_ascii=ensure_ascii, indent=indent,
            separators=separators, sort_keys=sort_keys,
        )

    def strftime_now(format):
        return datetime.now().strftime(format)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True, extensions=[loopcontrols]
    )
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env


def _token_content(t) -> Optional[str]:
    if t is None:
        return None
    if isinstance(t, str):
        return t
    if isinstance(t, dict):
        return t.get("content")
    return None


# Hardcoded Hunyuan chat rendering for checkpoints without a template
# (reference crane-serve/src/chat_template.rs:63-105): BOS, optional system
# text + separator, then user/assistant turns with the assistant tag
# appended for generation. The control tokens use fullwidth bars (U+FF5C)
# and low lines (U+2581) exactly as the checkpoint's vocab spells them.
HUNYUAN_CHAT_TEMPLATE = (
    "<｜hy_begin▁of▁sentence｜>"
    "{% if messages and messages[0].role == 'system' %}"
    "{{ messages[0].content }}<｜hy_place▁holder▁no▁3｜>"
    "{% set loop_messages = messages[1:] %}"
    "{% else %}{% set loop_messages = messages %}{% endif %}"
    "{% for m in loop_messages %}"
    "{% if m.role == 'user' %}<｜hy_User｜>{{ m.content }}"
    "{% elif m.role == 'assistant' %}<｜hy_Assistant｜>{{ m.content }}"
    "<｜hy_place▁holder▁no▁2｜>{% endif %}"
    "{% endfor %}<｜hy_Assistant｜>"
)


class AutoTokenizer:
    """Tokenize / detokenize / chat-template, transformers-compatible."""

    def __init__(
        self,
        tokenizer,
        *,
        chat_template: str | dict | None = None,
        bos_token: str | None = None,
        eos_token: str | None = None,
        pad_token: str | None = None,
        add_bos_token: bool = False,
    ):
        self._tok = tokenizer
        self.chat_template = chat_template
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.pad_token = pad_token
        self.add_bos_token = add_bos_token
        self._env = None
        self._compiled: dict[str, Any] = {}

    # -- loading -------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, model_dir: str) -> "AutoTokenizer":
        """``model_dir`` may be a local directory or a hub repo id — the
        hub fallback mirrors the reference (autotokenizer.rs:232-258)."""
        from tokenizers import Tokenizer

        from crane_tpu_torch.utils.hub import resolve_checkpoint

        model_dir = resolve_checkpoint(model_dir)
        tok_path = os.path.join(model_dir, "tokenizer.json")
        if not os.path.exists(tok_path):
            raise FileNotFoundError(f"{tok_path} not found")
        tok = Tokenizer.from_file(tok_path)

        cfg = {}
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)

        chat_template = cfg.get("chat_template")
        if chat_template is None:
            # chat_template.jinja fallback (reference autotokenizer.rs:122-128)
            jinja_path = os.path.join(model_dir, "chat_template.jinja")
            if os.path.exists(jinja_path):
                with open(jinja_path) as f:
                    chat_template = f.read()
        if chat_template is None:
            # hardcoded Hunyuan fallback for checkpoints that ship no
            # template at all (reference chat_template.rs:63-105)
            model_type = ""
            mcfg_path = os.path.join(model_dir, "config.json")
            if os.path.exists(mcfg_path):
                try:
                    with open(mcfg_path) as f:
                        model_type = str(json.load(f).get("model_type", ""))
                except Exception:
                    pass
            if model_type.startswith("hunyuan"):
                chat_template = HUNYUAN_CHAT_TEMPLATE
        if isinstance(chat_template, list):
            chat_template = {t["name"]: t["template"] for t in chat_template}

        return cls(
            tok,
            chat_template=chat_template,
            bos_token=_token_content(cfg.get("bos_token")),
            eos_token=_token_content(cfg.get("eos_token")),
            pad_token=_token_content(cfg.get("pad_token")),
            add_bos_token=bool(cfg.get("add_bos_token", False)),
        )

    # -- encode / decode -----------------------------------------------------
    def encode(self, text: str, *, add_special_tokens: bool = True) -> list[int]:
        """HF default semantics: plain encode applies special tokens — the
        tokenizer.json post-processor if present, else an explicit BOS when
        tokenizer_config sets ``add_bos_token`` (Llama-style models expect
        it on every prompt). Chat-template renders pass False (the template
        text already contains its specials)."""
        ids = self._tok.encode(text, add_special_tokens=add_special_tokens).ids
        if add_special_tokens and self.add_bos_token and self.bos_token:
            bid = self._tok.token_to_id(self.bos_token)
            if bid is not None and (not ids or ids[0] != bid):
                ids = [bid] + ids
        return ids

    def decode(self, ids: Sequence[int], *, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def id_to_token(self, idx: int) -> Optional[str]:
        return self._tok.id_to_token(idx)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    @property
    def eos_token_id(self) -> Optional[int]:
        if self.eos_token is None:
            return None
        return self.token_to_id(self.eos_token)

    # -- chat templates ------------------------------------------------------
    def _get_template(self, name: str | None = None) -> str:
        t = self.chat_template
        if t is None:
            raise ValueError("tokenizer has no chat template")
        if isinstance(t, dict):
            key = name or "default"
            if key in t:
                return t[key]
            if name is None and len(t) == 1:
                return next(iter(t.values()))
            raise KeyError(f"chat template {key!r} not found")
        return t

    def apply_chat_template(
        self,
        messages: list[dict],
        *,
        tools: list[dict] | None = None,
        documents: list[dict] | None = None,
        add_generation_prompt: bool = True,
        continue_final_message: bool = False,
        enable_thinking: bool | None = None,
        template: str | None = None,
        tokenize: bool = False,
        **extra_kwargs,
    ):
        """Render the chat template. ``enable_thinking=None`` is NOT passed to
        the template at all, so ``is defined`` checks take the template default
        (reference autotokenizer.rs:500-506)."""
        src = template or self._get_template()
        if self._env is None:
            self._env = _make_jinja_env()
        compiled = self._compiled.get(src)
        if compiled is None:
            compiled = self._env.from_string(src)
            self._compiled[src] = compiled

        ctx: dict[str, Any] = dict(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=self.bos_token or "",
            eos_token=self.eos_token or "",
            pad_token=self.pad_token or "",
            **extra_kwargs,
        )
        if tools is not None:
            ctx["tools"] = tools
        if documents is not None:
            ctx["documents"] = documents
        if enable_thinking is not None:
            ctx["enable_thinking"] = enable_thinking
        rendered = compiled.render(**ctx)
        if continue_final_message:
            # trim everything after the final message's content; templates
            # may transform the content (trim filters, list-typed multimodal
            # parts), in which case the rendering is kept as-is rather than
            # crashing (HF raises only for the str-and-absent case; the
            # lenient form is strictly more useful for serving)
            final = messages[-1]["content"]
            if isinstance(final, str) and final:
                idx = rendered.rfind(final)
                if idx < 0 and final.strip():
                    idx = rendered.rfind(final.strip())
                    final = final.strip() if idx >= 0 else final
                if idx >= 0:
                    rendered = rendered[: idx + len(final)]
        if tokenize:
            return self.encode(rendered, add_special_tokens=False)
        return rendered
