"""Eager ONNX graph evaluator (forward only).

The counterpart of the reference's vendored evaluator
(crane-core/src/onnx/eval.rs): the op set below mirrors what its production
graphs use (Kokoro-82M TTS, PaddleOCR v6 det/rec, Silero). Execution is
eager numpy on the host — these graphs are dynamic-shaped (duration-dependent
length regulation, variable crops) and small; the reference runs them on CPU
too ("faster than real time on CPU alone", README.md:80). Convolutions go
through im2col + BLAS matmuls.

Use: ``sess = Session(wire.read_file(path)); outs = sess.run({name: arr})``.

A copy of ``crane_tpu/onnx/session.py``: the port imports nothing of ``crane_tpu``.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import erf as _erf

from crane_tpu_torch.onnx.wire import Graph, Model, Node


def _attr(node: Node, name: str, default=None):
    return node.attrs.get(name, default)


def _pair(v, rank):
    return list(v) if v is not None else [0] * rank


# ── convolution helpers (im2col) ────────────────────────────────────────────


def _im2col(x, kshape, strides, pads, dilations):
    """x ``[N, C, *S]`` -> (cols ``[N, C*prod(K), *Sout]``, out_shape)."""
    rank = len(kshape)
    pad_width = [(0, 0), (0, 0)] + [
        (pads[i], pads[rank + i]) for i in range(rank)
    ]
    x = np.pad(x, pad_width)
    N, C = x.shape[:2]
    spatial = x.shape[2:]
    out = [
        (spatial[i] - dilations[i] * (kshape[i] - 1) - 1) // strides[i] + 1
        for i in range(rank)
    ]
    if rank == 1:
        (K,), (s,), (d,) = kshape, strides, dilations
        idx = np.arange(out[0])[:, None] * s + np.arange(K)[None, :] * d
        cols = x[:, :, idx]  # [N, C, So, K]
        return cols.transpose(0, 1, 3, 2).reshape(N, C * K, out[0]), out
    if rank == 2:
        (Kh, Kw), (sh, sw), (dh, dw) = kshape, strides, dilations
        i0 = np.arange(out[0])[:, None] * sh + np.arange(Kh)[None, :] * dh
        j0 = np.arange(out[1])[:, None] * sw + np.arange(Kw)[None, :] * dw
        cols = x[:, :, i0[:, None, :, None], j0[None, :, None, :]]
        # -> [N, C, Ho, Wo, Kh, Kw]
        cols = cols.transpose(0, 1, 4, 5, 2, 3).reshape(
            N, C * Kh * Kw, out[0] * out[1]
        )
        return cols, out
    raise ValueError(f"conv rank {rank} unsupported")


def _auto_pads(node, x, w, strides, dilations):
    rank = w.ndim - 2
    pads = _attr(node, "pads")
    auto = (_attr(node, "auto_pad", b"NOTSET") or b"NOTSET").decode()
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = []
        tail = []
        for i in range(rank):
            in_s = x.shape[2 + i]
            out_s = -(-in_s // strides[i])
            total = max(
                0,
                (out_s - 1) * strides[i]
                + (w.shape[2 + i] - 1) * dilations[i] + 1 - in_s,
            )
            lo = total // 2 if auto == "SAME_UPPER" else -(-total // 2)
            pads.append(lo)
            tail.append(total - lo)
        pads += tail
    return _pair(pads, 2 * rank)


def op_conv(node: Node, x, w, b=None):
    rank = w.ndim - 2
    strides = _attr(node, "strides") or [1] * rank
    dilations = _attr(node, "dilations") or [1] * rank
    groups = _attr(node, "group", 1)
    pads = _auto_pads(node, x, w, strides, dilations)
    M = w.shape[0]
    N, C = x.shape[:2]
    cg, mg = C // groups, M // groups
    outs = []
    for g in range(groups):
        cols, out_sp = _im2col(
            x[:, g * cg : (g + 1) * cg], w.shape[2:], strides, pads, dilations
        )
        wg = w[g * mg : (g + 1) * mg].reshape(mg, -1)
        outs.append(np.matmul(wg, cols))  # [N, mg, prod(out)]
    y = np.concatenate(outs, axis=1).reshape(N, M, *out_sp)
    if b is not None:
        y = y + b.reshape(1, -1, *([1] * rank))
    return y.astype(x.dtype)


def op_conv_transpose(node: Node, x, w, b=None):
    """Gradient-of-conv formulation: zero-stuff by stride, then convolve with
    the flipped kernel. w ``[C, M/g, *K]``."""
    rank = w.ndim - 2
    strides = _attr(node, "strides") or [1] * rank
    dilations = _attr(node, "dilations") or [1] * rank
    groups = _attr(node, "group", 1)
    pads = _pair(_attr(node, "pads"), 2 * rank)
    out_pad = _attr(node, "output_padding") or [0] * rank
    N, C = x.shape[:2]
    cg = C // groups
    mg = w.shape[1]

    # zero-stuff input
    sp = x.shape[2:]
    stuffed_shape = [N, C] + [
        (sp[i] - 1) * strides[i] + 1 + out_pad[i] for i in range(rank)
    ]
    xs = np.zeros(stuffed_shape, x.dtype)
    sl = tuple([slice(None), slice(None)] + [slice(None, None, strides[i]) for i in range(rank)])
    xs[tuple([slice(None), slice(None)] + [
        slice(0, (sp[i] - 1) * strides[i] + 1, strides[i]) for i in range(rank)
    ])] = x
    del sl

    # full conv with flipped kernel; effective pad = dilation*(k-1) - pad
    kflip = np.flip(w, axis=tuple(range(2, 2 + rank)))
    outs = []
    for g in range(groups):
        wg = kflip[g * cg : (g + 1) * cg]  # [cg, mg, *K]
        wg = wg.transpose(1, 0, *range(2, 2 + rank))  # [mg, cg, *K]
        eff_pads = [
            dilations[i] * (w.shape[2 + i] - 1) - pads[i] for i in range(rank)
        ] + [
            dilations[i] * (w.shape[2 + i] - 1) - pads[rank + i]
            for i in range(rank)
        ]
        cols, out_sp = _im2col(
            xs[:, g * cg : (g + 1) * cg], w.shape[2:], [1] * rank, eff_pads,
            dilations,
        )
        outs.append(np.matmul(wg.reshape(mg, -1), cols).reshape(N, mg, *out_sp))
    y = np.concatenate(outs, axis=1)
    if b is not None:
        y = y + b.reshape(1, -1, *([1] * rank))
    return y.astype(x.dtype)


# ── pooling ─────────────────────────────────────────────────────────────────


def _pool(node: Node, x, reducer, pad_value, count_include_pad=False):
    kshape = _attr(node, "kernel_shape")
    rank = len(kshape)
    strides = _attr(node, "strides") or [1] * rank
    dilations = _attr(node, "dilations") or [1] * rank
    pads = _auto_pads_pool(node, x, kshape, strides, dilations)
    N, C = x.shape[:2]
    xp = np.pad(
        x, [(0, 0), (0, 0)] + [(pads[i], pads[rank + i]) for i in range(rank)],
        constant_values=pad_value,
    )
    cols, out_sp = _im2col(
        xp.reshape(N * C, 1, *xp.shape[2:]), kshape, strides,
        [0] * (2 * rank), dilations,
    )
    y = reducer(cols.reshape(N, C, int(np.prod(kshape)), -1))
    if count_include_pad is False and reducer is _mean_reducer:
        ones = np.ones((1, 1) + x.shape[2:], x.dtype)
        op = np.pad(
            ones,
            [(0, 0), (0, 0)] + [(pads[i], pads[rank + i]) for i in range(rank)],
        )
        cnt, _ = _im2col(op, kshape, strides, [0] * (2 * rank), dilations)
        denom = cnt.reshape(1, 1, int(np.prod(kshape)), -1).sum(2)
        y = y * int(np.prod(kshape)) / np.maximum(denom, 1)
    return y.reshape(N, C, *out_sp).astype(x.dtype)


def _auto_pads_pool(node, x, kshape, strides, dilations):
    rank = len(kshape)
    pads = _attr(node, "pads")
    auto = (_attr(node, "auto_pad", b"NOTSET") or b"NOTSET").decode()
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads, tail = [], []
        for i in range(rank):
            in_s = x.shape[2 + i]
            out_s = -(-in_s // strides[i])
            total = max(0, (out_s - 1) * strides[i] + kshape[i] - in_s)
            lo = total // 2 if auto == "SAME_UPPER" else -(-total // 2)
            pads.append(lo)
            tail.append(total - lo)
        pads += tail
    pads = _pair(pads, 2 * rank)
    if _attr(node, "ceil_mode", 0):
        for i in range(rank):
            in_s = x.shape[2 + i] + pads[i] + pads[rank + i]
            eff_k = dilations[i] * (kshape[i] - 1) + 1
            rem = (in_s - eff_k) % strides[i]
            if rem:
                pads[rank + i] += strides[i] - rem
    return pads


def _mean_reducer(cols):
    return cols.mean(axis=2)


# ── recurrent cells ─────────────────────────────────────────────────────────


def _concat(ins, axis):
    """Drop omitted ('') inputs and zero-size operands (whose non-axis dims
    may legally mismatch, e.g. out of Loop/If branches) — unless everything
    is empty, in which case concatenate the empties as-is."""
    ops = [np.asarray(i) for i in ins if i is not None]
    nonempty = [o for o in ops if o.size]
    return np.concatenate(nonempty or ops, axis=axis)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _lstm_direction(x, w, r, b, h0, c0, seq_lens=None, reverse=False):
    """x [T,B,I]; w [4H,I]; r [4H,H]; b [8H]; ONNX gate order i,o,f,c."""
    T, B, _ = x.shape
    H = r.shape[1]
    wb, rb = (b[: 4 * H], b[4 * H :]) if b is not None else (0.0, 0.0)
    gates_x = x @ w.T + wb  # [T, B, 4H]
    h, c = h0.copy(), c0.copy()
    ys = np.zeros((T, B, H), x.dtype)
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        g = gates_x[t] + h @ r.T + rb
        i = _sigmoid(g[:, :H])
        o = _sigmoid(g[:, H : 2 * H])
        f = _sigmoid(g[:, 2 * H : 3 * H])
        ct = np.tanh(g[:, 3 * H :])
        c_new = f * c + i * ct
        h_new = o * np.tanh(c_new)
        if seq_lens is not None:
            # rows past their length FREEZE state (so the returned h/c is
            # the last valid step's — and for the reverse direction the
            # frozen h0 makes the recurrence effectively start at len-1)
            # while their Y output is zero, per the ONNX spec
            alive = (t < seq_lens)[:, None]
            h = np.where(alive, h_new, h)
            c = np.where(alive, c_new, c)
            ys[t] = np.where(alive, h_new, 0.0)
        else:
            h, c = h_new, c_new
            ys[t] = h
    return ys, h, c


def op_lstm(node: Node, x, w, r, b=None, seq_lens=None, h0=None, c0=None):
    H = _attr(node, "hidden_size")
    direction = (_attr(node, "direction", b"forward") or b"forward").decode()
    nd = 2 if direction == "bidirectional" else 1
    T, B, _ = x.shape
    h0 = np.zeros((nd, B, H), x.dtype) if h0 is None else h0
    c0 = np.zeros((nd, B, H), x.dtype) if c0 is None else c0
    ys, hs, cs = [], [], []
    for d in range(nd):
        rev = direction == "reverse" or d == 1
        y, h, c = _lstm_direction(
            x, w[d], r[d], b[d] if b is not None else None, h0[d], c0[d],
            seq_lens, reverse=rev,
        )
        ys.append(y)
        hs.append(h)
        cs.append(c)
    Y = np.stack(ys, axis=1)  # [T, nd, B, H]
    return Y, np.stack(hs), np.stack(cs)


def _gru_direction(node, x, w, r, b, h0, seq_lens=None, reverse=False):
    """ONNX gate order z, r, h."""
    T, B, _ = x.shape
    H = r.shape[1]
    lbr = _attr(node, "linear_before_reset", 0)
    wb, rb = (b[: 3 * H], b[3 * H :]) if b is not None else (
        np.zeros(3 * H, x.dtype), np.zeros(3 * H, x.dtype))
    gx = x @ w.T + wb
    h = h0.copy()
    ys = np.zeros((T, B, H), x.dtype)
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        gh = h @ r.T
        z = _sigmoid(gx[t, :, :H] + gh[:, :H] + rb[:H])
        rr = _sigmoid(gx[t, :, H : 2 * H] + gh[:, H : 2 * H] + rb[H : 2 * H])
        if lbr:
            hh = np.tanh(gx[t, :, 2 * H :] + rr * (gh[:, 2 * H :] + rb[2 * H :]))
        else:
            hh = np.tanh(gx[t, :, 2 * H :] + (rr * h) @ r[2 * H :].T + rb[2 * H :])
        h_new = (1 - z) * hh + z * h
        if seq_lens is not None:
            alive = (t < seq_lens)[:, None]  # freeze state, zero Y (spec)
            h = np.where(alive, h_new, h)
            ys[t] = np.where(alive, h_new, 0.0)
        else:
            h = h_new
            ys[t] = h
    return ys, h


def op_gru(node: Node, x, w, r, b=None, seq_lens=None, h0=None):
    H = _attr(node, "hidden_size")
    direction = (_attr(node, "direction", b"forward") or b"forward").decode()
    nd = 2 if direction == "bidirectional" else 1
    T, B, _ = x.shape
    h0 = np.zeros((nd, B, H), x.dtype) if h0 is None else h0
    ys, hs = [], []
    for d in range(nd):
        rev = direction == "reverse" or d == 1
        y, h = _gru_direction(
            node, x, w[d], r[d], b[d] if b is not None else None, h0[d],
            seq_lens, reverse=rev,
        )
        ys.append(y)
        hs.append(h)
    return np.stack(ys, axis=1), np.stack(hs)


def op_rnn(node: Node, x, w, r, b=None, seq_lens=None, h0=None):
    H = _attr(node, "hidden_size")
    direction = (_attr(node, "direction", b"forward") or b"forward").decode()
    nd = 2 if direction == "bidirectional" else 1
    T, B, _ = x.shape
    h0 = np.zeros((nd, B, H), x.dtype) if h0 is None else h0
    ys, hs = [], []
    for d in range(nd):
        rev = direction == "reverse" or d == 1
        wb, rb = (b[d][:H], b[d][H:]) if b is not None else (0.0, 0.0)
        h = h0[d].copy()
        y = np.zeros((T, B, H), x.dtype)
        steps = range(T - 1, -1, -1) if rev else range(T)
        for t in steps:
            h_new = np.tanh(x[t] @ w[d].T + wb + h @ r[d].T + rb)
            if seq_lens is not None:
                alive = (t < seq_lens)[:, None]  # freeze state, zero Y
                h = np.where(alive, h_new, h)
                y[t] = np.where(alive, h_new, 0.0)
            else:
                h = h_new
                y[t] = h
        ys.append(y)
        hs.append(h)
    return np.stack(ys, axis=1), np.stack(hs)


# ── resize ──────────────────────────────────────────────────────────────────


def op_resize(node: Node, x, roi=None, scales=None, sizes=None):
    mode = (_attr(node, "mode", b"nearest") or b"nearest").decode()
    ctm = (
        _attr(node, "coordinate_transformation_mode", b"half_pixel")
        or b"half_pixel"
    ).decode()
    nearest_mode = (
        _attr(node, "nearest_mode", b"round_prefer_floor") or b"round_prefer_floor"
    ).decode()
    in_shape = np.asarray(x.shape, np.float64)
    if sizes is not None and sizes.size:
        out_shape = np.asarray(sizes, np.int64)
        scales = out_shape / in_shape
    else:
        scales = np.asarray(scales, np.float64)
        out_shape = np.floor(in_shape * scales).astype(np.int64)

    def src_coord(dst, scale, in_s, out_s):
        if ctm == "align_corners":
            return dst * (in_s - 1) / max(out_s - 1, 1)
        if ctm == "asymmetric":
            return dst / scale
        if ctm == "pytorch_half_pixel":
            return (dst + 0.5) / scale - 0.5 if out_s > 1 else np.zeros_like(dst)
        return (dst + 0.5) / scale - 0.5  # half_pixel

    grids = []
    for ax in range(x.ndim):
        dst = np.arange(out_shape[ax], dtype=np.float64)
        grids.append(src_coord(dst, scales[ax], x.shape[ax], out_shape[ax]))

    if mode == "nearest":
        idxs = []
        for ax, g in enumerate(grids):
            if nearest_mode == "floor":
                gi = np.floor(g)
            elif nearest_mode == "ceil":
                gi = np.ceil(g)
            elif nearest_mode == "round_prefer_ceil":
                gi = np.floor(g + 0.5)
            else:  # round_prefer_floor
                gi = np.ceil(g - 0.5)
            idxs.append(np.clip(gi, 0, x.shape[ax] - 1).astype(np.int64))
        return x[np.ix_(*idxs)]

    # (bi)linear over the trailing axes whose scale != 1
    y = x.astype(np.float64)
    for ax, g in enumerate(grids):
        if x.shape[ax] == out_shape[ax] and np.allclose(g, np.arange(x.shape[ax])):
            continue
        g = np.clip(g, 0, x.shape[ax] - 1)
        lo = np.floor(g).astype(np.int64)
        hi = np.minimum(lo + 1, x.shape[ax] - 1)
        w_hi = (g - lo).reshape([-1 if a == ax else 1 for a in range(x.ndim)])
        y = np.take(y, lo, axis=ax) * (1 - w_hi) + np.take(y, hi, axis=ax) * w_hi
    return y.astype(x.dtype)


# ── STFT ────────────────────────────────────────────────────────────────────


def op_stft(node: Node, signal, frame_step, window=None, frame_length=None):
    onesided = _attr(node, "onesided", 1)
    x = signal
    if x.ndim == 3:  # [B, T, 1]
        x = x[..., 0]
    step = int(np.asarray(frame_step).reshape(()))
    if frame_length is not None:
        flen = int(np.asarray(frame_length).reshape(()))
    else:
        flen = window.shape[0]
    if window is None:
        window = np.ones(flen, np.float32)
    B, T = x.shape
    n_frames = (T - flen) // step + 1
    idx = np.arange(n_frames)[:, None] * step + np.arange(flen)[None, :]
    frames = x[:, idx] * window[None, None, :]
    spec = np.fft.rfft(frames, n=flen) if onesided else np.fft.fft(frames, n=flen)
    return np.stack([spec.real, spec.imag], axis=-1).astype(np.float32)


# ── session ─────────────────────────────────────────────────────────────────


def _axes(node, env, inputs, idx, attr="axes"):
    """axes as attr (opset<13) or optional input (opset>=13)."""
    if attr in node.attrs:
        return list(node.attrs[attr])
    if len(inputs) > idx and node.inputs[idx]:
        return list(np.asarray(inputs[idx]).reshape(-1).astype(np.int64))
    return None


class Session:
    """Evaluate a parsed Model eagerly. Op semantics follow the ONNX spec at
    the opsets the reference's production graphs use (11-18)."""

    def __init__(self, model: Model, *, optimize: bool = True):
        self.model = model
        self.graph = model.graph
        self.report = None
        if optimize:
            # conservative graph simplification at build time (reference:
            # onnx/optimizer/mod.rs — constant folding, alias/dead-node
            # elimination, atan2 + Snake pattern fusion); folding evaluates
            # with this session's own _eval, so values are identical
            from crane_tpu_torch.onnx.optimizer import optimize as _optimize

            self.report = _optimize(
                self.graph, lambda node, ins: self._eval(node, ins, {})
            )

    @property
    def input_names(self) -> list:
        return list(self.graph.inputs)

    @property
    def output_names(self) -> list:
        return list(self.graph.outputs)

    def run(self, feeds: dict) -> dict:
        env = dict(self.graph.initializers)
        env.update({k: np.asarray(v) for k, v in feeds.items()})
        self._run_nodes(self.graph, env)
        return {n: env[n] for n in self.graph.outputs}

    def _run_nodes(self, graph: Graph, env: dict):
        for node in graph.nodes:
            ins = [env[n] if n else None for n in node.inputs]
            outs = self._eval(node, ins, env)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val

    # -- dispatcher ----------------------------------------------------------
    def _eval(self, node: Node, ins: list, env: dict):
        t = node.op_type
        a = node.attrs
        x = ins[0] if ins else None

        # elementwise / simple
        simple = {
            "Add": lambda: ins[0] + ins[1],
            "Sub": lambda: ins[0] - ins[1],
            "Mul": lambda: ins[0] * ins[1],
            "Div": lambda: (
                ins[0] // ins[1]
                if np.issubdtype(np.asarray(ins[0]).dtype, np.integer)
                and np.issubdtype(np.asarray(ins[1]).dtype, np.integer)
                else ins[0] / ins[1]
            ),
            "Pow": lambda: np.power(ins[0].astype(np.float64), ins[1]).astype(ins[0].dtype)
            if np.issubdtype(np.asarray(ins[0]).dtype, np.integer)
            else np.power(ins[0], ins[1].astype(ins[0].dtype)),
            "Sqrt": lambda: np.sqrt(x),
            "Reciprocal": lambda: (1.0 / x).astype(np.asarray(x).dtype),
            "Exp": lambda: np.exp(x),
            "Log": lambda: np.log(x),
            "Abs": lambda: np.abs(x),
            "Neg": lambda: -x,
            "Ceil": lambda: np.ceil(x),
            "Floor": lambda: np.floor(x),
            "Round": lambda: np.round(x),  # half-to-even, per spec
            "Sign": lambda: np.sign(x),
            "Sin": lambda: np.sin(x),
            "Cos": lambda: np.cos(x),
            "Atan": lambda: np.arctan(x),
            # produced by the optimizer's atan2-decomposition fusion; no
            # NaN at (0,0) unlike the Div->Atan->Where subgraph it replaces
            "Atan2": lambda: np.arctan2(ins[0], ins[1]),
            "Erf": lambda: _erf(x).astype(np.asarray(x).dtype),
            "Sigmoid": lambda: _sigmoid(x),
            "Tanh": lambda: np.tanh(x),
            "Relu": lambda: np.maximum(x, 0),
            "LeakyRelu": lambda: np.where(x >= 0, x, x * a.get("alpha", 0.01)).astype(x.dtype),
            "PRelu": lambda: np.where(x >= 0, x, x * ins[1]).astype(x.dtype),
            "Selu": lambda: (
                a.get("gamma", 1.0507009873554805)
                * np.where(x > 0, x, a.get("alpha", 1.6732632423543772) * (np.exp(x) - 1))
            ).astype(x.dtype),
            "Gelu": lambda: (
                0.5 * x * (1 + np.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x**3)))
                if (a.get("approximate", b"none") or b"none") == b"tanh"
                else 0.5 * x * (1 + _erf(x / math.sqrt(2)))
            ).astype(x.dtype),
            "HardSigmoid": lambda: np.clip(
                a.get("alpha", 0.2) * x + a.get("beta", 0.5), 0, 1
            ).astype(x.dtype),
            "HardSwish": lambda: (x * np.clip(x / 6 + 0.5, 0, 1)).astype(x.dtype),
            "Snake": lambda: (x + np.sin(ins[1] * x) ** 2 / ins[1]).astype(x.dtype),
            "Equal": lambda: ins[0] == ins[1],
            "Greater": lambda: ins[0] > ins[1],
            "GreaterOrEqual": lambda: ins[0] >= ins[1],
            "Less": lambda: ins[0] < ins[1],
            "LessOrEqual": lambda: ins[0] <= ins[1],
            "And": lambda: ins[0] & ins[1],
            "Or": lambda: ins[0] | ins[1],
            "Xor": lambda: ins[0] ^ ins[1],
            "Not": lambda: ~np.asarray(x, bool),
            "Min": lambda: _variadic(np.minimum, ins),
            "Max": lambda: _variadic(np.maximum, ins),
            "Sum": lambda: _variadic(np.add, ins),
            "Mod": lambda: (
                np.fmod(ins[0], ins[1]) if a.get("fmod", 0) else np.mod(ins[0], ins[1])
            ),
            "Where": lambda: np.where(ins[0], ins[1], ins[2]),
            "Identity": lambda: x,
            # inference mode: pass-through; the optional mask output is all
            # ones (nothing dropped)
            "Dropout": lambda: (
                (x, np.ones(np.shape(x), np.bool_))
                if len(node.outputs) > 1 else x
            ),
            "Shape": lambda: np.asarray(
                x.shape[a.get("start", 0): a["end"] if "end" in a else None],
                np.int64,
            ),
            "Size": lambda: np.asarray(x.size, np.int64),
            "Reshape": lambda: _reshape(x, ins[1], a.get("allowzero", 0)),
            "Flatten": lambda: x.reshape(
                int(np.prod(x.shape[: a.get("axis", 1)] or (1,))), -1
            ),
            "Transpose": lambda: np.transpose(x, a.get("perm")),
            "Concat": lambda: _concat(ins, a["axis"]),
            "Expand": lambda: x * np.ones(
                np.broadcast_shapes(x.shape, tuple(np.asarray(ins[1], np.int64))),
                dtype=x.dtype,
            ) if x.dtype != np.bool_ else np.broadcast_to(
                x, np.broadcast_shapes(x.shape, tuple(np.asarray(ins[1], np.int64)))
            ).copy(),
            "Tile": lambda: np.tile(x, np.asarray(ins[1], np.int64)),
            "Range": lambda: np.arange(
                np.asarray(ins[0]).item(), np.asarray(ins[1]).item(),
                np.asarray(ins[2]).item(),
                dtype=np.asarray(ins[0]).dtype,
            ),
            "NonZero": lambda: np.asarray(np.nonzero(x), np.int64),
            "Trilu": lambda: (
                np.triu(x, int(np.asarray(ins[1]).item()) if len(ins) > 1 and ins[1] is not None else 0)
                if a.get("upper", 1)
                else np.tril(x, int(np.asarray(ins[1]).item()) if len(ins) > 1 and ins[1] is not None else 0)
            ),
            "CumSum": lambda: _cumsum(x, ins[1], a.get("exclusive", 0), a.get("reverse", 0)),
            "MatMul": lambda: np.matmul(ins[0], ins[1]),
            "GlobalAveragePool": lambda: x.mean(
                axis=tuple(range(2, x.ndim)), keepdims=True
            ).astype(x.dtype),
        }
        if t in simple:
            return simple[t]()

        if t == "Constant":
            for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
                if key in a:
                    v = a[key]
                    if key == "value_int":
                        return np.asarray(v, np.int64)
                    if key == "value_ints":
                        return np.asarray(v, np.int64)
                    if key == "value_float":
                        return np.asarray(v, np.float32)
                    if key == "value_floats":
                        return np.asarray(v, np.float32)
                    return v
            raise ValueError("Constant without value")
        if t == "ConstantOfShape":
            val = a.get("value", np.zeros(1, np.float32))
            return np.full(tuple(np.asarray(x, np.int64)), np.asarray(val).reshape(-1)[0])
        if t == "Cast":
            return x.astype(_DT[a["to"]])
        if t == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("min")
            hi = ins[2] if len(ins) > 2 and ins[2] is not None else a.get("max")
            return np.clip(x, lo, hi)
        if t == "Gemm":
            y = np.matmul(
                x.T if a.get("transA") else x,
                ins[1].T if a.get("transB") else ins[1],
            ) * a.get("alpha", 1.0)
            if len(ins) > 2 and ins[2] is not None:
                y = y + a.get("beta", 1.0) * ins[2]
            return y.astype(x.dtype)
        if t == "Conv":
            return op_conv(node, *ins)
        if t == "ConvTranspose":
            return op_conv_transpose(node, *ins)
        if t == "MaxPool":
            return _pool(node, x, lambda c: c.max(axis=2), -np.inf)
        if t == "AveragePool":
            return _pool(
                node, x, _mean_reducer, 0.0,
                count_include_pad=bool(a.get("count_include_pad", 0)),
            )
        if t == "BatchNormalization":
            scale, bias, mean, var = ins[1:5]
            sh = (1, -1) + (1,) * (x.ndim - 2)
            eps = a.get("epsilon", 1e-5)
            return (
                (x - mean.reshape(sh)) / np.sqrt(var.reshape(sh) + eps)
                * scale.reshape(sh) + bias.reshape(sh)
            ).astype(x.dtype)
        if t == "InstanceNormalization":
            scale, bias = ins[1], ins[2]
            ax = tuple(range(2, x.ndim))
            mu = x.mean(axis=ax, keepdims=True)
            var = x.var(axis=ax, keepdims=True)
            sh = (1, -1) + (1,) * (x.ndim - 2)
            return (
                (x - mu) / np.sqrt(var + a.get("epsilon", 1e-5))
                * scale.reshape(sh) + bias.reshape(sh)
            ).astype(x.dtype)
        if t == "LayerNormalization":
            axis = a.get("axis", -1)
            axes = tuple(range(axis % x.ndim, x.ndim))
            mu = x.mean(axis=axes, keepdims=True)
            var = x.var(axis=axes, keepdims=True)
            y = (x - mu) / np.sqrt(var + a.get("epsilon", 1e-5))
            y = y * ins[1]
            if len(ins) > 2 and ins[2] is not None:
                y = y + ins[2]
            return y.astype(x.dtype)
        if t in ("Softmax", "LogSoftmax"):
            axis = a.get("axis", -1)
            m = x.max(axis=axis, keepdims=True)
            e = np.exp(x - m)
            s = e.sum(axis=axis, keepdims=True)
            return (np.log(e / s) if t == "LogSoftmax" else e / s).astype(x.dtype)
        if t == "Gather":
            return np.take(x, np.asarray(ins[1], np.int64), axis=a.get("axis", 0))
        if t == "GatherElements":
            return np.take_along_axis(x, np.asarray(ins[1], np.int64), axis=a.get("axis", 0))
        if t == "ScatterND":
            data = x.copy()
            indices = np.asarray(ins[1], np.int64)
            updates = ins[2]
            idx = indices.reshape(-1, indices.shape[-1])
            upd = updates.reshape(idx.shape[0], *data.shape[indices.shape[-1]:])
            for i in range(idx.shape[0]):
                data[tuple(idx[i])] = upd[i]
            return data
        if t == "OneHot":
            depth = int(np.asarray(ins[1]).reshape(-1)[0])
            off, on = np.asarray(ins[2]).reshape(-1)
            axis = a.get("axis", -1)
            idx = np.asarray(x, np.int64) % depth
            eye = np.where(np.arange(depth)[None] == idx.reshape(-1, 1), on, off)
            out = eye.reshape(*x.shape, depth)
            return np.moveaxis(out, -1, axis % (x.ndim + 1))
        if t == "Slice":
            return _slice(node, ins)
        if t == "Split":
            axis = a.get("axis", 0)
            if "split" in a:
                sizes = list(a["split"])
            elif len(ins) > 1 and ins[1] is not None:
                sizes = list(np.asarray(ins[1], np.int64))
            else:
                n = a.get("num_outputs", len(node.outputs))
                # spec: equal chunks of ceil(d/n), only the LAST is smaller
                d = x.shape[axis]
                q = -(-d // n)
                sizes = [q] * (n - 1) + [d - q * (n - 1)]
            return tuple(np.split(x, np.cumsum(sizes)[:-1], axis=axis))
        if t == "Squeeze":
            axes = _axes(node, env, ins, 1)
            if axes is None:
                return np.squeeze(x)
            return np.squeeze(x, axis=tuple(int(ax) for ax in axes))
        if t == "Unsqueeze":
            axes = _axes(node, env, ins, 1)
            y = x
            for ax in sorted(int(v) % (x.ndim + len(axes)) for v in axes):
                y = np.expand_dims(y, ax)
            return y
        if t == "Pad":
            return _pad(node, ins)
        if t in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd"):
            axes = _axes(node, env, ins, 1)
            keep = bool(a.get("keepdims", 1))
            if axes is None and a.get("noop_with_empty_axes", 0):
                return x
            fn = {"ReduceMean": np.mean, "ReduceSum": np.sum,
                  "ReduceMax": np.max, "ReduceMin": np.min,
                  "ReduceProd": np.prod}[t]
            return fn(
                x, axis=tuple(int(v) for v in axes) if axes is not None else None,
                keepdims=keep,
            ).astype(x.dtype)
        if t in ("ArgMax", "ArgMin"):
            fn = np.argmax if t == "ArgMax" else np.argmin
            axis = a.get("axis", 0)
            y = fn(x, axis=axis)
            if a.get("keepdims", 1):
                y = np.expand_dims(y, axis)
            return y.astype(np.int64)
        if t == "Resize":
            return op_resize(node, *ins)
        if t == "LSTM":
            return op_lstm(node, *ins)
        if t == "GRU":
            return op_gru(node, *ins)
        if t == "RNN":
            return op_rnn(node, *ins)
        if t == "STFT":
            return op_stft(node, *ins)
        if t == "If":
            sub = self.model.__class__(
                graph=a["then_branch" if np.asarray(x).reshape(()) else "else_branch"]
            )
            subenv = dict(env)
            subenv.update(sub.graph.initializers)
            self._run_nodes(sub.graph, subenv)
            return tuple(subenv[n] for n in sub.graph.outputs)
        raise NotImplementedError(f"ONNX op {t} (node {node.name!r})")


def _variadic(fn, ins):
    y = ins[0]
    for v in ins[1:]:
        y = fn(y, v)
    return y


def _reshape(x, shape, allowzero):
    shape = list(np.asarray(shape, np.int64))
    if not allowzero:
        shape = [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]
    return x.reshape(shape)


def _cumsum(x, axis, exclusive, reverse):
    ax = int(np.asarray(axis).reshape(()))
    y = np.flip(x, ax) if reverse else x
    y = np.cumsum(y, axis=ax)
    if exclusive:
        y = np.roll(y, 1, axis=ax)
        sl = [slice(None)] * y.ndim
        sl[ax] = 0
        y[tuple(sl)] = 0
    return np.flip(y, ax) if reverse else y


def _slice(node: Node, ins):
    x = ins[0]
    if "starts" in node.attrs:  # opset < 10
        starts = list(node.attrs["starts"])
        ends = list(node.attrs["ends"])
        axes = list(node.attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = list(np.asarray(ins[1], np.int64))
        ends = list(np.asarray(ins[2], np.int64))
        axes = (
            list(np.asarray(ins[3], np.int64))
            if len(ins) > 3 and ins[3] is not None else list(range(len(starts)))
        )
        steps = (
            list(np.asarray(ins[4], np.int64))
            if len(ins) > 4 and ins[4] is not None else [1] * len(starts)
        )
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % x.ndim
        INT_MAX = np.iinfo(np.int64).max
        en = None if en >= INT_MAX else int(en)
        en2 = None if (sp < 0 and en is not None and en < -x.shape[ax]) else en
        sl[ax] = slice(int(st), en2, int(sp))
    return x[tuple(sl)]


def _pad(node: Node, ins):
    x = ins[0]
    mode = (node.attrs.get("mode", b"constant") or b"constant").decode()
    if "pads" in node.attrs:
        pads = list(node.attrs["pads"])
        cval = node.attrs.get("value", 0.0)
    else:
        pads = list(np.asarray(ins[1], np.int64))
        cval = (
            np.asarray(ins[2]).reshape(-1)[0]
            if len(ins) > 2 and ins[2] is not None else 0.0
        )
    rank = x.ndim
    axes = (
        list(np.asarray(ins[3], np.int64))
        if len(ins) > 3 and ins[3] is not None else list(range(rank))
    )
    pw = [(0, 0)] * rank
    for i, ax in enumerate(axes):
        pw[int(ax) % rank] = (int(pads[i]), int(pads[i + len(axes)]))
    if mode == "constant":
        return np.pad(x, pw, constant_values=cval)
    np_mode = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}[mode]
    return np.pad(x, pw, mode=np_mode)


_DT = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
