"""engine.prefix_reuse_share: the share of prompt tokens the engine took from
a freed slot's resident prefix instead of prefilling them, over the window
(``EngineStats.prefix_tokens_reused`` / ``prompt_tokens``, their change
from the window's start to its close)."""


def read(ctx):
    prompt = ctx.stats.get("prompt_tokens", 0)
    if prompt <= 0:
        return None
    return 100.0 * ctx.stats.get("prefix_tokens_reused", 0) / prompt
