"""GGUF -> crane_tpu_torch model + tokenizer construction (port of
``crane_tpu/loaders/gguf_model.py``).

Reference behavior: arch auto-detect from the ``general.architecture`` header
(model_factory.rs:144-304), quantized layers built from GGUF content
(hunyuan_dense/modeling.rs:13-78), and the embedded tokenizer rebuilt from
``tokenizer.ggml.*`` metadata incl. chat template (autotokenizer.rs:162-230,
utils/tokenizer_utils.rs).

Quantized q8_0/q4_0 tensors can be kept quantized: they become the port's
blockwise :class:`~crane_tpu_torch.ops.linear.QuantizedWeight` (one float32
scale per 32 input rows), which ``linear`` runs as a per-block product in
float32, the route the reference also takes outside any kernel. k-quants and
float tensors are dequantized to the compute dtype. The file is parsed and
dequantized on the host in numpy; the tensors then move to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from crane_tpu_torch.loaders.gguf import (
    GGML_Q4_0,
    GGML_Q8_0,
    GGUFReader,
)
from crane_tpu_torch.models.modules.gdn_layer import GdnConfig
from crane_tpu_torch.models.modules.transformer import TransformerConfig
from crane_tpu_torch.ops.linear import QuantizedWeight
from crane_tpu_torch.utils.device import default_device


def config_from_gguf(r: GGUFReader) -> TransformerConfig:
    arch = r.architecture
    if arch in ("qwen35", "qwen3next", "qwen3_next"):
        return _hybrid_config_from_gguf(r)
    if arch not in ("qwen3", "qwen2", "llama", "hunyuan-dense", "hunyuan_dense"):
        raise ValueError(f"unsupported GGUF architecture {arch!r}")
    heads = r.field("attention.head_count")
    head_dim = r.field("attention.key_length") or (
        r.field("embedding_length") // heads
    )
    n_vocab = len(r.metadata.get("tokenizer.ggml.tokens", [])) or r.field("vocab_size")
    return TransformerConfig(
        vocab_size=n_vocab,
        hidden_size=r.field("embedding_length"),
        num_layers=r.field("block_count"),
        num_heads=heads,
        num_kv_heads=r.field("attention.head_count_kv", heads),
        head_dim=head_dim,
        intermediate_size=r.field("feed_forward_length"),
        rms_norm_eps=r.field("attention.layer_norm_rms_epsilon", 1e-6),
        rope_theta=r.field("rope.freq_base", 10000.0),
        max_position_embeddings=r.field("context_length", 32768),
        qk_norm="blk.0.attn_q_norm.weight" in r.tensors,
        attn_bias="blk.0.attn_q.bias" in r.tensors,
        tie_word_embeddings="output.weight" not in r.tensors,
    )


def _hybrid_config_from_gguf(r: GGUFReader) -> TransformerConfig:
    """llama.cpp qwen35 layout (reference qwen3_5/model.rs:180-285): GDN dims
    live under ssm.* keys, layer types come from tensor presence, the output
    gate from the q projection width, vocab from the embedding shape."""
    head_dim = r.field("attention.key_length")
    n_layers = r.field("block_count")
    heads = r.field("attention.head_count")
    num_v_heads = r.field("ssm.time_step_rank")
    inner = r.field("ssm.inner_size")
    layer_types = tuple(
        "gdn" if f"blk.{i}.ssm_a" in r.tensors else "full" for i in range(n_layers)
    )
    first_full = layer_types.index("full") if "full" in layer_types else 0
    q_rows = r.tensors[f"blk.{first_full}.attn_q.weight"].shape[1]
    rot_dim = r.field("rope.dimension_count", head_dim // 4)
    return TransformerConfig(
        vocab_size=r.tensors["token_embd.weight"].shape[1],
        hidden_size=r.field("embedding_length"),
        num_layers=n_layers,
        num_heads=heads,
        num_kv_heads=r.field("attention.head_count_kv"),
        head_dim=head_dim,
        intermediate_size=r.field("feed_forward_length"),
        rms_norm_eps=r.field("attention.layer_norm_rms_epsilon", 1e-6),
        rope_theta=r.field("rope.freq_base", 10_000_000.0),
        max_position_embeddings=r.field("context_length", 262_144),
        qk_norm=True,
        norm_weight_offset=1.0,
        attn_output_gate=(q_rows == 2 * heads * head_dim),
        partial_rotary_factor=rot_dim / head_dim,
        layer_types=layer_types,
        gdn=GdnConfig(
            num_v_heads=num_v_heads,
            num_k_heads=r.field("ssm.group_count"),
            head_k_dim=r.field("ssm.state_size"),
            head_v_dim=inner // num_v_heads,
            conv_kernel=r.field("ssm.conv_kernel", 4),
        ),
        tie_word_embeddings="output.weight" not in r.tensors,
    )


def _chunked_to_interleaved_perm(n_k: int, v_per_group: int) -> np.ndarray:
    """Value-head permutation: interleaved index (kh*vg + rep) <- chunked
    index (rep*Hk + kh). llama.cpp orders GDN value heads chunked; the compute
    path is interleaved-only, so weights are permuted losslessly at load
    (reference VHeadOrder::Chunked hazard, ops/gdn/config.rs:13-22)."""
    perm = np.empty(n_k * v_per_group, np.int64)
    for kh in range(n_k):
        for rep in range(v_per_group):
            perm[kh * v_per_group + rep] = rep * n_k + kh
    return perm


def _tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    """A numpy array -> a contiguous tensor of ``dtype`` on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)


def _load_linear(r: GGUFReader, name: str, dtype, keep_quant: bool, device):
    """GGUF matrix (stored [out, in] row-major) -> [in, out] weight."""
    ti = r.tensors[name]
    if keep_quant and ti.ggml_type in (GGML_Q8_0, GGML_Q4_0):
        ti, raw = r.raw_tensor(name)
        in_dim = ti.shape[0]  # ggml ne0 = input dim
        out_dim = ti.n_elements // in_dim
        nb = in_dim // 32
        blocks = np.frombuffer(bytes(raw), np.uint8).reshape(out_dim, nb, -1)
        d = blocks[:, :, :2].reshape(out_dim, nb, 2).copy().view(np.float16)
        scales = d.astype(np.float32).reshape(out_dim, nb).T  # [in/32, out]
        if ti.ggml_type == GGML_Q8_0:
            codes = blocks[:, :, 2:].copy().view(np.int8).reshape(out_dim, in_dim)
        else:  # q4_0: nibbles - 8, elems 0..15 low, 16..31 high
            qs = blocks[:, :, 2:]
            lo = (qs & 0x0F).astype(np.int8) - 8
            hi = (qs >> 4).astype(np.int8) - 8
            codes = np.concatenate([lo, hi], axis=2).reshape(out_dim, in_dim)
        return QuantizedWeight(
            codes=_tensor(codes.T, torch.int8, device),  # [in, out]
            scales=_tensor(scales, torch.float32, device),
            block=32,
            bits=8 if ti.ggml_type == GGML_Q8_0 else 4,
        )
    return _tensor(r.tensor(name).T, dtype, device)


def map_gguf_weights(
    cfg: TransformerConfig, r: GGUFReader, dtype=torch.bfloat16, *, keep_quant: bool = True,
    device=None,
) -> dict:
    """The port's parameter tree from a GGUF file, on ``device`` (by default
    the card, and with no card an error unless ``device="cpu"`` is given)."""
    device = default_device(device)
    hybrid = cfg.gdn is not None
    # hybrid GGUFs fold the unit offset into every block norm
    # (Qwen35RmsNorm::from_folded); the runtime adds +1, so unfold here
    unfold = (lambda w: w - 1.0) if hybrid else (lambda w: w)

    def a(n):
        return _tensor(r.tensor(n), dtype, device)

    def an(n):
        return _tensor(unfold(r.tensor(n)), dtype, device)

    def lin(n):
        return _load_linear(r, n, dtype, keep_quant, device)

    layers = []
    for i in range(cfg.num_layers):
        b = f"blk.{i}."
        mlp = {
            "gate": lin(b + "ffn_gate.weight"),
            "up": lin(b + "ffn_up.weight"),
            "down": lin(b + "ffn_down.weight"),
        }
        post_ln = an(b + ("post_attention_norm.weight" if hybrid else "ffn_norm.weight"))
        if hybrid and cfg.layer_type(i) == "gdn":
            layers.append({
                "gdn": _map_gguf_gdn(cfg, r, b, dtype, device),
                "mlp": mlp,
                "input_ln": an(b + "attn_norm.weight"),
                "post_ln": post_ln,
            })
            continue
        attn = {
            "wq": lin(b + "attn_q.weight"),
            "wk": lin(b + "attn_k.weight"),
            "wv": lin(b + "attn_v.weight"),
            "wo": lin(b + "attn_output.weight"),
        }
        if cfg.attn_bias:
            attn["bq"] = a(b + "attn_q.bias")
            attn["bk"] = a(b + "attn_k.bias")
            attn["bv"] = a(b + "attn_v.bias")
        if cfg.qk_norm:
            attn["q_norm"] = an(b + "attn_q_norm.weight")
            attn["k_norm"] = an(b + "attn_k_norm.weight")
        layers.append({
            "attn": attn,
            "mlp": mlp,
            "input_ln": an(b + "attn_norm.weight"),
            "post_ln": post_ln,
        })
    params = {
        "embed": a("token_embd.weight"),
        "layers": tuple(layers),
        "final_norm": an("output_norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        # lm_head stays unquantized-friendly: dequantize (reference never
        # quantizes a tied head, qwen3_5/model.rs:116-121)
        params["lm_head"] = _tensor(r.tensor("output.weight").T, dtype, device)
    return params


def _map_gguf_gdn(cfg: TransformerConfig, r: GGUFReader, b: str, dtype, device) -> dict:
    """GDN layer from the llama.cpp qwen35 layout: split projections
    (attn_qkv / attn_gate / ssm_beta / ssm_alpha), 2-D ssm_conv1d, ssm_a
    (A_log), ssm_dt.bias, ssm_norm, ssm_out — with the CHUNKED value-head
    order permuted to HF interleaved so the single compute path applies
    (projections dequantized: the permutation must cross quant blocks)."""
    g = cfg.gdn
    vg = g.v_per_group
    K, V, kd, vd = g.head_k_dim, g.head_v_dim, g.key_dim, g.value_dim
    perm = _chunked_to_interleaved_perm(g.num_k_heads, vg)

    def perm_cols_headwise(w, offset, head_dim):
        # w [in, out]: permute per-head column blocks of `head_dim`
        blocks = w[:, offset : offset + g.num_v_heads * head_dim]
        blocks = blocks.reshape(w.shape[0], g.num_v_heads, head_dim)[:, perm]
        return np.concatenate(
            [w[:, :offset], blocks.reshape(w.shape[0], -1), w[:, offset + g.num_v_heads * head_dim :]],
            axis=1,
        )

    qkv = r.tensor(b + "attn_qkv.weight").T  # [in, 2*kd + vd]
    qkv = perm_cols_headwise(qkv, 2 * kd, V)
    z = r.tensor(b + "attn_gate.weight").T
    z = perm_cols_headwise(z, 0, V)
    beta = r.tensor(b + "ssm_beta.weight").T[:, perm]
    alpha = r.tensor(b + "ssm_alpha.weight").T[:, perm]
    out = r.tensor(b + "ssm_out.weight").T  # [vd, hidden]
    out = out.reshape(g.num_v_heads, V, -1)[perm].reshape(vd, -1)
    conv = r.tensor(b + "ssm_conv1d.weight")  # [conv_dim, kernel]
    v_rows = conv[2 * kd :].reshape(g.num_v_heads, V, -1)[perm].reshape(vd, -1)
    conv = np.concatenate([conv[: 2 * kd], v_rows], axis=0)

    # fuse the split projections into HF's k-head-major qkvz / ba column
    # layout (per k-head: [q K | k K | v vg*V | z vg*V]) so GGUF hybrids
    # take the SAME fused compute path as safetensors checkpoints
    Hk = g.num_k_heads
    qkvz_blocks, ba_blocks = [], []
    for h in range(Hk):
        qkvz_blocks += [
            qkv[:, h * K : (h + 1) * K],                         # q_h
            qkv[:, kd + h * K : kd + (h + 1) * K],               # k_h
            qkv[:, 2 * kd + h * vg * V : 2 * kd + (h + 1) * vg * V],  # v group
            z[:, h * vg * V : (h + 1) * vg * V],                 # z group
        ]
        ba_blocks += [
            beta[:, h * vg : (h + 1) * vg],
            alpha[:, h * vg : (h + 1) * vg],
        ]
    qkvz = np.concatenate(qkvz_blocks, axis=1)
    ba = np.concatenate(ba_blocks, axis=1)
    return {
        "in_proj_qkvz": _tensor(qkvz, dtype, device),
        "in_proj_ba": _tensor(ba, dtype, device),
        "conv_w": _tensor(conv, torch.float32, device),
        "dt_bias": _tensor(r.tensor(b + "ssm_dt.bias")[perm], torch.float32, device),
        "A_log": _tensor(r.tensor(b + "ssm_a")[perm], torch.float32, device),
        "norm": _tensor(r.tensor(b + "ssm_norm.weight"), dtype, device),
        "out_proj": _tensor(out, dtype, device),
    }


def tokenizer_from_gguf(r: GGUFReader):
    """Rebuild an AutoTokenizer from tokenizer.ggml.* metadata (needs the
    ``tokenizers`` package, imported here only)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    from crane_tpu_torch.tokenizer.autotokenizer import AutoTokenizer

    tokens = r.metadata["tokenizer.ggml.tokens"]
    model_kind = r.metadata.get("tokenizer.ggml.model", "gpt2")
    if model_kind == "llama":
        # sentencepiece vocab: per-token scores instead of merges,
        # U+2581-prefixed word starts, <0xNN> byte-fallback tokens — a
        # ByteLevel BPE over this vocab tokenizes to garbage ids
        scores = r.metadata.get("tokenizer.ggml.scores", [0.0] * len(tokens))
        uni = models.Unigram(
            vocab=[(t, float(s)) for t, s in zip(tokens, scores)],
            unk_id=int(r.metadata.get("tokenizer.ggml.unknown_token_id", 0)),
            byte_fallback=True,
        )
        tok = Tokenizer(uni)
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first"
        )
        tok.decoder = decoders.Sequence([
            decoders.Replace("▁", " "),
            decoders.ByteFallback(),
            decoders.Fuse(),
            decoders.Strip(content=" ", left=1),
        ])
    else:  # gpt2-style byte-level BPE (qwen/gemma/hunyuan GGUFs)
        merges = r.metadata.get("tokenizer.ggml.merges", [])
        vocab = {t: i for i, t in enumerate(tokens)}
        merge_pairs = [tuple(m.split(" ", 1)) for m in merges]
        bpe = models.BPE(
            vocab=vocab, merges=merge_pairs, fuse_unk=False, byte_fallback=False
        )
        tok = Tokenizer(bpe)
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()

    ttypes = r.metadata.get("tokenizer.ggml.token_type", [])
    special = [
        t for t, tt in zip(tokens, ttypes) if tt == 3  # CONTROL
    ]
    if special:
        from tokenizers import AddedToken

        tok.add_special_tokens([AddedToken(t, special=True) for t in special])

    def tok_at(key):
        idx = r.metadata.get(f"tokenizer.ggml.{key}")
        return tokens[idx] if idx is not None and idx < len(tokens) else None

    return AutoTokenizer(
        tok,
        chat_template=r.metadata.get("tokenizer.chat_template"),
        bos_token=tok_at("bos_token_id"),
        eos_token=tok_at("eos_token_id"),
        add_bos_token=bool(r.metadata.get("tokenizer.ggml.add_bos_token", False)),
    )


def from_gguf(path: str, *, dtype=torch.bfloat16, keep_quant: bool = True, device=None):
    """Load a CausalLM from a GGUF file (config + weights + tokenizer) onto
    ``device``: by default the card, and with no card an error unless
    ``device="cpu"`` is given. The tokenizer is ``None`` where the file
    embeds none or the ``tokenizers`` package is missing."""
    from crane_tpu_torch.models.causal_lm import CausalLM

    device = default_device(device)
    r = GGUFReader(path)
    cfg = config_from_gguf(r)
    params = map_gguf_weights(cfg, r, dtype, keep_quant=keep_quant, device=device)
    try:
        tokenizer = tokenizer_from_gguf(r)
    except Exception:
        tokenizer = None
    eos = r.metadata.get("tokenizer.ggml.eos_token_id")
    eos_ids = (eos,) if eos is not None else ()
    return CausalLM(cfg, params, tokenizer=tokenizer, eos_token_ids=eos_ids, dtype=dtype)
