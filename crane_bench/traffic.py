"""The one traffic generator: a mix file's parameters and a run's seed give
each client its sessions.

A mix is closed-loop: each client sends its next request when its last one
has finished, with no think time. A session is one or more turns; turn 1's
prompt is the mix's shared system prompt (if any), a message and a fixed
suffix (a question), and turn k's prompt is turn k-1's prompt, the answer
the engine served for it, and a new message and suffix. A request
generates exactly its drawn answer length (no end-of-sequence token).

The sizes come from the mix's own ``size_seed``, so every run seed serves
the same pool of sessions; the run seed only deals them out to the clients
in another order and draws the token ids. Lengths are log-normal around
their median, rounded and clipped to ``[min, max]``. A session ends before
a turn whose prompt plus the longest answer would not fit the slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Turn:
    message: int  # new prompt tokens of this turn: the message and the suffix
    answer: int   # tokens to generate


@dataclasses.dataclass(frozen=True)
class Session:
    index: int
    greedy: bool
    turns: tuple[Turn, ...]


def engine_flag(mix: dict, flag: str) -> str | None:
    """The value that follows ``flag`` in the mix's engine flags, or None."""
    flags = mix["engine_flags"]
    return flags[flags.index(flag) + 1] if flag in flags else None


def lognormal(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    z = rng.standard_normal(n)
    x = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def session_pool(mix: dict) -> list[Session]:
    """The mix's sessions, the same for every run seed."""
    rng = np.random.default_rng(mix["size_seed"])
    n, k = mix["pool"], mix["turns"]
    messages = lognormal(rng, mix["message"], n * k).reshape(n, k) + mix["suffix"]
    answers = lognormal(rng, mix["answer"], n * k).reshape(n, k)
    slot = int(engine_flag(mix, "--max-seq-len"))
    longest = mix["answer"]["max"]
    every = round(1 / mix["greedy_share"]) if mix["greedy_share"] > 0 else 0
    pool = []
    for i in range(n):
        turns, prompt = [], mix["system_prompt"]
        for j in range(k):
            prompt += int(messages[i, j])
            if prompt + longest + 1 > slot:
                break
            turns.append(Turn(int(messages[i, j]), int(answers[i, j])))
            prompt += int(answers[i, j])
        pool.append(Session(i, every > 0 and i % every == 0, tuple(turns)))
    return pool


def client_sessions(mix: dict, seed: int) -> list[list[Session]]:
    """Client c's sessions, in the order it sends them: the pool dealt out
    in the order the run seed draws."""
    pool = session_pool(mix)
    order = np.random.default_rng([seed, 0]).permutation(len(pool))
    c = mix["clients"]
    return [[pool[j] for j in order[i::c]] for i in range(c)]


def system_prompt_ids(mix: dict, seed: int, vocab: int) -> np.ndarray:
    return np.random.default_rng([seed, 1]).integers(0, vocab, mix["system_prompt"],
                                                     dtype=np.int64)


def id_stream(seed: int, client: int) -> np.random.Generator:
    """The token ids of client ``client``'s messages."""
    return np.random.default_rng([seed, 2, client])
