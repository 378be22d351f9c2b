"""Attention routed by shape: heads the port's kernels do not take (a head
dim outside {64, 128, 256}, or a decode group over 8 query heads per
kv-head) go to the kernels' plain versions, as crane_tpu sends them to
``gqa_attention``, and are counted in ``attention_block.plain_routes``.

On the CPU every wrapper runs its plain version anyway, so these tests hold
the routing itself (the predicate, the counter) and the tokens such configs
give against crane_tpu; ``tests/test_torch_cuda.py`` runs the same configs
on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crane_tpu.generation.config import GenerationConfig as JGenerationConfig
from crane_tpu.models import init as jinit
from crane_tpu.models.causal_lm import CausalLM as JLM
from crane_tpu.models.modules import transformer as jtf
from crane_tpu_torch.generation.config import GenerationConfig
from crane_tpu_torch.models.causal_lm import CausalLM as TLM
from crane_tpu_torch.models.modules import transformer as ttf
from crane_tpu_torch.ops.cuda import ATTENTION_KINDS, attention_kernel_takes
from crane_tpu_torch.parallel.sequence import make_sp_mesh, sp_shard_lm
from crane_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)

# (head_dim, query heads, kv heads) -> kinds the kernels take
SHAPES = {
    "qwen3": ((128, 16, 8), {"decode", "prefill", "chunk"}),
    "qwen3.5": ((256, 8, 2), {"decode", "prefill", "chunk"}),
    "head_dim 96": ((96, 4, 2), set()),
    "16 on 1": ((128, 16, 1), {"prefill", "chunk"}),
    "8 on 1": ((64, 8, 1), {"decode", "prefill", "chunk"}),
    "head_dim 32": ((32, 4, 2), set()),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_attention_kernel_takes(name):
    (D, Hq, Hkv), kinds = SHAPES[name]
    assert {k for k in ATTENTION_KINDS if attention_kernel_takes(k, D, Hq, Hkv)} == kinds
    with pytest.raises(ValueError, match="kind"):
        attention_kernel_takes("encode", D, Hq, Hkv)


# tiny llama-like configs whose heads the kernels do not take: head_dim 96
# (hidden 128 over 4 heads of 96), and 16 query heads on one kv-head of 64
ROUTED = {
    "head_dim 96": (dict(qk_norm=False, num_heads=4, num_kv_heads=2, head_dim=96),
                    {"decode", "prefill", "chunk"}),
    "16 on 1": (dict(qk_norm=False, num_heads=16, num_kv_heads=1, head_dim=64), {"decode"}),
}


def _pair(name):
    jcfg = dataclasses.replace(jinit.QWEN3_TINY, max_position_embeddings=512, **ROUTED[name][0])
    jp = jinit.init_params(jcfg, seed=11, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, jp, JLM(jcfg, jp, dtype=jnp.float32), TLM(tcfg, params_from_jax(jp),
                                                                dtype=torch.float32)


def _reset_routes():
    for kind in ATTENTION_KINDS:
        ttf.attention_block.plain_routes[kind] = 0


@pytest.mark.parametrize("name", list(ROUTED))
def test_routed_config_generates_crane_tpu_tokens(name):
    """generate (a fresh prefill and decode) gives crane_tpu's greedy
    tokens; the attention calls whose kernels do not take the heads went to
    the plain versions, and only those."""
    _, _, _, jl, tl = _pair(name)
    prompt = list(np.random.default_rng(3).integers(1, 500, 40))
    _reset_routes()
    assert tl.generate(prompt, GenerationConfig.greedy(16)) == \
        jl.generate(prompt, JGenerationConfig.greedy(16))
    routed = {k for k, n in ttf.attention_block.plain_routes.items() if n}
    assert routed == ROUTED[name][1] - {"chunk"}  # generate runs no continuation chunk


@pytest.mark.parametrize("name", list(ROUTED))
def test_routed_config_chunk_and_decode_match_crane_tpu(name):
    """A fresh prefill, a continuation chunk over the cache and a decode
    step, each against crane_tpu's forward_hidden on the same weights."""
    jcfg, tcfg, jp, _, tl = _pair(name)
    rng = np.random.default_rng(5)
    jrope, trope = jtf.make_rope_tables(jcfg), ttf.make_rope_tables(tcfg)
    jc, tc = jtf.make_cache(jcfg, 2, 48, jnp.float32), ttf.make_cache(tcfg, 2, 48, torch.float32)
    _reset_routes()
    for toks, start, kw in ((rng.integers(1, 500, (2, 20)), 0, {"read_cache": False}),
                            (rng.integers(1, 500, (2, 12)), 20, {}),
                            (rng.integers(1, 500, (2, 1)), np.array([32, 32], np.int32), {})):
        toks = toks.astype(np.int32)
        jh, jc = jtf.forward_hidden(jcfg, jp, jnp.asarray(toks), jc,
                                    jnp.asarray(start, jnp.int32), jrope, **kw)
        tpos = torch.tensor(start) if isinstance(start, np.ndarray) else start
        th, tc = ttf.forward_hidden(tcfg, tl.params, torch.tensor(toks), tc, tpos, trope, **kw)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    layers = tcfg.num_layers
    assert ttf.attention_block.plain_routes == {
        k: layers if k in ROUTED[name][1] else 0 for k in ATTENTION_KINDS}


@pytest.mark.parametrize("name", list(ROUTED))
def test_routed_config_under_sp_matches_unsharded(name):
    """Sequence parallelism sends the slabs of such heads to the with-stats
    plain versions: four slabs give the unsharded port's tokens."""
    _, _, _, _, tl = _pair(name)
    slm = sp_shard_lm(tl, make_sp_mesh(4, ["cpu"] * 4))
    prompt = list(np.random.default_rng(9).integers(1, 500, 30))
    expected = tl.generate(prompt, GenerationConfig.greedy(10))
    _reset_routes()
    assert slm.generate(prompt, GenerationConfig.greedy(10)) == expected
    assert ttf.attention_block.plain_routes["decode"] > 0
