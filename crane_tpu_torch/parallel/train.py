"""The training step, unsharded or over a dp x tp mesh.

Port of ``crane_tpu/parallel/train.py``. The forward is the inference
forward (``forward_hidden``) over a throwaway float32 cache sized to the
sequence, so training and serving share one model implementation. Two
things differ from serving:

- attention goes to its plain version, by argument
  (``plain_attention=True``, counted in ``attention_block.plain_routes``):
  the kernels write their outputs through raw pointers and have no
  backward, and every wrapper refuses an input that requires grad. This is
  the XLA path crane_tpu trains through (its Pallas attention has no
  differentiation rule either);
- each layer runs under ``torch.utils.checkpoint`` (``remat``), as under
  ``jax.checkpoint``; the recompute writes the throwaway cache a second
  time, with the same values.

Over a mesh (:class:`~crane_tpu_torch.parallel.sharding.ShardedParams`)
every position holds its own copy of its weights. After the backward pass
each weight's gradient is the sum over its copies (the dp all-reduce, and
over tp for a replicated weight each shard used), the optimizer steps
group 0's weights, and the result is copied to the other copies.

    params = shard_params(cfg, params, make_mesh(dp=2, tp=2))
    optimizer = torch.optim.AdamW(train_parameters(params), lr=1e-4, weight_decay=1e-4)
    step = make_train_step(cfg, optimizer)
    loss = step(params, rope, tokens)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crane_tpu_torch.models.modules.transformer import (
    TransformerConfig,
    forward_hidden,
    lm_logits,
    make_cache,
)
from crane_tpu_torch.parallel.sharding import ShardedParams, get, leaves


def next_token_loss(cfg: TransformerConfig, params, rope: dict, tokens: torch.Tensor, *,
                    remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens [B, S]`` (on the model's
    device) under ``params``, plain or sharded."""
    from crane_tpu_torch.parallel.inference import make_sharded_cache

    B, S = tokens.shape
    if isinstance(params, ShardedParams):
        cache = make_sharded_cache(cfg, params.mesh, B, S, torch.float32)
    else:
        cache = make_cache(cfg, B, S, torch.float32, device=tokens.device)
    hidden, _ = forward_hidden(cfg, params, tokens, cache, 0, rope, remat=remat,
                               plain_attention=True)
    logits = lm_logits(cfg, params, hidden)  # [B, S, V] float32
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    return nll.mean()


def _copies(params: ShardedParams) -> list:
    """(master, other copies) of every logical weight: a split leaf's master
    is group 0's shard and its copies the other groups' same shard; a
    replicated leaf's master is shard (0, 0) and its copies every other
    position's."""
    out = []
    trees = params.trees
    for t, tree in enumerate(trees[0]):
        for path, master in leaves(tree):
            if params.split[path]:
                others = [get(row[t], path) for row in trees[1:]]
            elif t == 0:
                others = [get(tr, path) for g, row in enumerate(trees)
                          for u, tr in enumerate(row) if (g, u) != (0, 0)]
            else:
                continue
            out.append((master, others))
    return out


def train_parameters(params) -> list:
    """The tensors an optimizer steps, each set to require grad: every leaf
    of a plain tree; of a sharded one, each weight's master (its copies
    require grad too, and their gradients add into the master's)."""
    if isinstance(params, ShardedParams):
        pairs = _copies(params)
        for master, others in pairs:
            for x in [master] + others:
                x.requires_grad_(True)
        return [master for master, _ in pairs]
    tensors = [x for _, x in leaves(params)]
    for x in tensors:
        x.requires_grad_(True)
    return tensors


@torch.no_grad()
def reduce_grads(params: ShardedParams) -> None:
    """Each master's gradient becomes the sum of its copies' (float32, on
    the master's device); the copies' gradients are dropped."""
    for master, others in _copies(params):
        grads = [x.grad for x in [master] + others if x.grad is not None]
        if not grads:
            continue
        total = grads[0].float()
        for gr in grads[1:]:
            total = total + gr.to(master.device, torch.float32)
        master.grad = total.to(master.dtype)
        for x in others:
            x.grad = None


@torch.no_grad()
def broadcast(params: ShardedParams) -> None:
    """Copy every master's values to its copies."""
    for master, others in _copies(params):
        for x in others:
            x.copy_(master.to(x.device))


def make_train_step(cfg: TransformerConfig, optimizer: torch.optim.Optimizer):
    """``train_step(params, rope, tokens) -> loss``: one optimizer step on
    the next-token loss. ``optimizer`` steps :func:`train_parameters`
    (params)`. crane_tpu's ``optax.adamw(1e-4)`` is
    ``torch.optim.AdamW(..., lr=1e-4, weight_decay=1e-4)``: torch's default
    decay is 0.01."""

    def train_step(params, rope: dict, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = next_token_loss(cfg, params, rope, tokens)
        loss.backward()
        if isinstance(params, ShardedParams):
            reduce_grads(params)
        optimizer.step()
        if isinstance(params, ShardedParams):
            broadcast(params)
        return loss.detach()

    return train_step
