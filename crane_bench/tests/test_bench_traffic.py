"""The one traffic generator: the same requests for a seed, other requests
for another, and the same pool of sizes for every seed."""

import numpy as np
import pytest

from crane_bench import traffic
from crane_bench.spec import HERE, read_json

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def requests(mix, seed, per_client=3):
    """(client, turn message length, answer, first ids) of each client's
    first sessions, as a client draws them."""
    out = []
    for c, sessions in enumerate(traffic.client_sessions(mix, seed)):
        ids = traffic.id_stream(seed, c)
        for s in sessions[:per_client]:
            for t in s.turns:
                out.append((c, t.message, t.answer, s.greedy,
                            tuple(ids.integers(0, 151936, t.message)[:8])))
    return out


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = read_json(HERE / "traffic" / f"{name}.json")
    assert requests(mix, 2 ** 31 + 7) == requests(mix, 2 ** 31 + 7)
    assert np.array_equal(traffic.system_prompt_ids(mix, 5, 151936),
                          traffic.system_prompt_ids(mix, 5, 151936))


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_requests_same_sizes(name):
    mix = read_json(HERE / "traffic" / f"{name}.json")
    a, b = requests(mix, 11), requests(mix, 12)
    assert a != b
    pool = traffic.session_pool(mix)
    dealt = [sorted(s.index for c in traffic.client_sessions(mix, seed) for s in c)
             for seed in (11, 12)]
    assert dealt[0] == dealt[1] == list(range(len(pool)))


@pytest.mark.parametrize("name", MIXES)
def test_sessions_fit_the_slot(name):
    mix = read_json(HERE / "traffic" / f"{name}.json")
    slot = int(traffic.engine_flag(mix, "--max-seq-len"))
    for s in traffic.session_pool(mix):
        assert s.turns, "every session has a first turn"
        prompt = mix["system_prompt"]
        for t in s.turns:
            prompt += t.message
            assert mix["message"]["min"] + mix["suffix"] <= t.message
            assert t.message <= mix["message"]["max"] + mix["suffix"]
            assert mix["answer"]["min"] <= t.answer <= mix["answer"]["max"]
            assert prompt + mix["answer"]["max"] + 1 <= slot
            prompt += t.answer
    share = np.mean([s.greedy for s in traffic.session_pool(mix)])
    assert abs(share - mix["greedy_share"]) < 0.01
