"""Each roofline's and mfu's work formula against a count by hand at a
small shape."""

import pytest

from crane_bench import peaks, work
from crane_bench.models import qwen3, qwen3_next
from crane_bench.tests.tiny import TINY

QWEN3 = dict(TINY["qwen3"], model_type="qwen3", rms_norm_eps=1e-6, rope_theta=1e6,
             tie_word_embeddings=True)
NEXT = dict(TINY["qwen3_next"], model_type="qwen3_next", full_attention_interval=4,
            layer_types=["linear_attention"] * 3 + ["full_attention"], linear_conv_kernel_dim=4,
            norm_topk_prob=True)


def hand_pairs(start, end):
    return sum(p + 1 for p in range(start, end))


def test_slice_work_reads_the_clients_records():
    from crane_bench.client import Record
    import numpy as np

    r = Record("a", 0, 0, 1, True, np.zeros(10, np.int64), 3, 4)
    r.times = [1.0, 1.1, 1.2, 5.0]
    r.tokens = [1, 2, 3, 4]
    w = work.slice_work([r], 0.5, 2.0)
    assert w.prefills == [(7, 10)]
    assert w.decode_contexts == [11, 12]   # tokens 1 and 2: the forwards at 10 and 11
    assert w.output_tokens == 3


def test_decode_attention_least_time_by_hand():
    w = work.SliceWork(decode_contexts=[5, 9], prefills=[], output_tokens=2)
    # 2 layers x (k and v) x 2 key heads x 16 dims x 2 bytes, per key
    per_key = 2 * 2 * 2 * 16 * 2
    assert work.decode_attention_least_s(qwen3, QWEN3, w) == pytest.approx(
        per_key * 14 / peaks.HBM_BYTES_S)


def test_prefill_attention_least_time_by_hand():
    w = work.SliceWork([], [(3, 7)], 1)
    H, Hkv, D = 4, 2, 16
    flops = 4 * H * D * hand_pairs(3, 7)
    nbytes = 2 * (2 * 4 * H * D + 2 * 7 * Hkv * D)
    per_layer = max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_S)
    assert work.prefill_attention_least_s(qwen3, QWEN3, w) == pytest.approx(2 * per_layer)


def test_gdn_least_time_by_hand():
    w = work.SliceWork([], [(0, 5)], 1)
    Hk, Hv, K, V = 2, 4, 16, 16
    nbytes = 5 * (2 * Hk * K * 2 + 2 * Hv * V * 2 + 2 * Hv * 4) + 2 * Hv * K * V * 4
    flops = 6 * 5 * Hv * K * V
    per_layer = max(nbytes / peaks.HBM_BYTES_S, flops / peaks.TF32_FLOPS)
    assert work.gdn_least_s(qwen3_next, NEXT, w) == pytest.approx(3 * per_layer)


def test_model_flops_by_hand():
    E, H, Hkv, D, I, V = 64, 4, 2, 16, 96, 512
    body = 2 * 2 * (E * H * D + 2 * E * Hkv * D + H * D * E + 3 * E * I)
    assert qwen3.body_flops(QWEN3) == body
    w = work.SliceWork(decode_contexts=[10], prefills=[(0, 3)], output_tokens=2)
    attn = 2 * 4 * H * D
    expect = 2 * (2 * V * E) + body + attn * 10 + 3 * body + attn * hand_pairs(0, 3)
    assert work.model_flops(qwen3, QWEN3, w) == pytest.approx(expect)


def test_moe_counts_only_the_routed_experts():
    E, n, top, I, Is = 64, 8, 2, 32, 32
    a = qwen3_next.body_flops(NEXT)
    b = qwen3_next.body_flops(dict(NEXT, num_experts_per_tok=top + 1))
    assert b - a == pytest.approx(4 * 2 * 3 * E * I)   # 4 layers, one more expert each
    c = qwen3_next.body_flops(dict(NEXT, num_experts=2 * n))
    assert c - a == pytest.approx(4 * 2 * E * n)       # only the router grows
