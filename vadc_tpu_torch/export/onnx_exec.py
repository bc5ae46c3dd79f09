# Copy of vadc_tpu/export/onnx_exec.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""A minimal numpy executor for the official Silero ONNX graphs.

This is the behavior-level parity oracle the extractor approach alone cannot
provide: it *runs* the actual official .onnx graph (the thing the reference
executes through onnxruntime, onnx_helpers.c:532-549) so tests can assert
the JAX forward matches the executed model rather than re-extracted weights.
It deliberately has no dependency beyond numpy — the graph/node/attribute
parsing comes from onnx_extract.parse_model.

Covered ops are exactly the union used by the official Silero v3/v4/v5
exports (Conv, LSTM, MatMul, Softmax, Pad, Slice, If, ...). Anything else
raises UnsupportedOnnxOp with the op name, mirroring the loud-failure style
of the reference's ORT error macro (onnx_helpers.h:5-14).

ONNX semantics implemented to spec where Silero relies on them:
 - LSTM gate order is i,o,f,c (NOT PyTorch's i,f,g,o); weights W/R are
   [num_dirs, 4H, *] and biases are Wb|Rb concatenated [num_dirs, 8H].
 - Reshape treats 0 as "copy input dim" and -1 as inferred.
 - Pad takes the [x1_begin.., x1_end..] layout with constant/reflect modes.
 - If executes the named then/else branch in the enclosing scope (outer
   names are visible inside the branch, per ONNX scoping rules).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vadc_tpu_torch.export.onnx_extract import OnnxGraph, OnnxNode, parse_model


class OnnxExecError(ValueError):
    """One-line diagnosis of a graph-execution failure: which node, which
    op, and what went wrong — never a bare numpy/KeyError traceback.
    Mirrors the loud single-line failure style of the reference's ORT
    error macro (onnx_helpers.h:5-14)."""


class UnsupportedOnnxOp(OnnxExecError, NotImplementedError):
    """Also an OnnxExecError (ValueError) so the CLI's one-line error
    handler catches it — a re-exported graph with an op outside the
    implemented set must diagnose, never traceback mid-stream."""


_CAST_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
}


def _node_id(node: OnnxNode, index: int) -> str:
    label = f" '{node.name}'" if node.name else ""
    outs = [o for o in node.outputs if o]
    to = f" -> {outs[0]}" if outs else ""
    return f"node #{index} {node.op_type}{label}{to}"


def _sigmoid(x: np.ndarray) -> np.ndarray:
    # numerically-stable split form (exp of non-positive args only)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _conv(x: np.ndarray, w: np.ndarray, b: np.ndarray | None, attrs: dict) -> np.ndarray:
    """Grouped N-D cross-correlation for the 1-D convs Silero uses.

    x: [B, C_in, L], w: [C_out, C_in/g, K]. Implemented as im2col + one
    matmul per group — the same STFT-as-conv framing the reference uses
    (stft.c:15-224), generalized.
    """
    kernel = attrs.get("kernel_shape") or list(w.shape[2:])
    if len(kernel) != 1:
        raise UnsupportedOnnxOp(f"Conv with kernel_shape {kernel}")
    (k,) = kernel
    strides = attrs.get("strides") or [1]
    dilations = attrs.get("dilations") or [1]
    if dilations != [1]:
        raise UnsupportedOnnxOp(f"Conv dilation {dilations}")
    pads = attrs.get("pads") or [0, 0]
    group = int(attrs.get("group") or 1)
    (stride,) = strides
    pl, pr = pads
    b_dim, c_in, length = x.shape
    c_out = w.shape[0]
    if pl or pr:
        x = np.pad(x, ((0, 0), (0, 0), (pl, pr)))
    out_len = (x.shape[2] - k) // stride + 1
    # frames: [B, C_in, out_len, K]
    idx = np.arange(out_len)[:, None] * stride + np.arange(k)[None, :]
    frames = x[:, :, idx]
    cg_in = c_in // group
    cg_out = c_out // group
    out = np.empty((b_dim, c_out, out_len), dtype=np.float32)
    for g in range(group):
        fg = frames[:, g * cg_in : (g + 1) * cg_in]  # [B, cg_in, O, K]
        wg = w[g * cg_out : (g + 1) * cg_out]  # [cg_out, cg_in, K]
        out[:, g * cg_out : (g + 1) * cg_out] = np.einsum(
            "bcok,dck->bdo", fg, wg, optimize=True
        )
    if b is not None:
        out += b[None, :, None]
    return out


def _lstm(node: OnnxNode, vals: list) -> list[np.ndarray]:
    """ONNX LSTM, forward direction, default activations (f=Sigmoid,
    g=Tanh, h=Tanh). Gate order i,o,f,c per the ONNX operator spec."""
    x, w, r = vals[0], vals[1], vals[2]
    bias = vals[3] if len(vals) > 3 and vals[3] is not None else None
    h0 = vals[5] if len(vals) > 5 and vals[5] is not None else None
    c0 = vals[6] if len(vals) > 6 and vals[6] is not None else None
    if node.attrs.get("direction") not in (None, "forward"):
        raise UnsupportedOnnxOp(f"LSTM direction {node.attrs['direction']}")
    hidden = int(node.attrs.get("hidden_size") or r.shape[2])
    seq, batch, _ = x.shape
    w0, r0 = w[0], r[0]  # [4H, I], [4H, H]
    wb = bias[0, : 4 * hidden] if bias is not None else 0.0
    rb = bias[0, 4 * hidden :] if bias is not None else 0.0
    h = (h0[0] if h0 is not None else np.zeros((batch, hidden))).astype(np.float32)
    c = (c0[0] if c0 is not None else np.zeros((batch, hidden))).astype(np.float32)
    ys = np.empty((seq, 1, batch, hidden), dtype=np.float32)
    # hoist the input projection out of the time loop (one big matmul)
    xw = x @ w0.T + wb  # [T, B, 4H]
    for t in range(seq):
        gates = xw[t] + h @ r0.T + rb
        i = _sigmoid(gates[:, 0 * hidden : 1 * hidden])
        o = _sigmoid(gates[:, 1 * hidden : 2 * hidden])
        f = _sigmoid(gates[:, 2 * hidden : 3 * hidden])
        g = np.tanh(gates[:, 3 * hidden : 4 * hidden])
        c = f * c + i * g
        h = o * np.tanh(c)
        ys[t, 0] = h
    return [ys, h[None], c[None]]


def _slice(vals: list, attrs: dict) -> np.ndarray:
    data = vals[0]
    if len(vals) > 1:  # opset >= 10: starts/ends/axes/steps as inputs
        starts = np.atleast_1d(vals[1]).astype(np.int64)
        ends = np.atleast_1d(vals[2]).astype(np.int64)
        axes = (
            np.atleast_1d(vals[3]).astype(np.int64)
            if len(vals) > 3 and vals[3] is not None
            else np.arange(len(starts))
        )
        steps = (
            np.atleast_1d(vals[4]).astype(np.int64)
            if len(vals) > 4 and vals[4] is not None
            else np.ones(len(starts), np.int64)
        )
    else:  # opset 1: attributes
        starts = np.asarray(attrs["starts"], np.int64)
        ends = np.asarray(attrs["ends"], np.int64)
        axes = np.asarray(attrs.get("axes") or np.arange(len(starts)), np.int64)
        steps = np.ones(len(starts), np.int64)
    sl = [slice(None)] * data.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = int(a) % data.ndim
        # ONNX clamps out-of-range starts/ends (INT64_MAX is the idiom)
        dim = data.shape[a]
        s, e, st = int(s), int(e), int(st)
        s = max(-dim, min(dim, s))
        e = max(-dim - 1, min(dim, e))
        sl[a] = slice(s, e, st) if st != 1 else slice(s, e)
    return data[tuple(sl)]


def _pad(vals: list, attrs: dict) -> np.ndarray:
    data = vals[0]
    if len(vals) > 1 and vals[1] is not None:  # opset >= 11
        pads = np.asarray(vals[1], np.int64)
        cval = float(vals[2]) if len(vals) > 2 and vals[2] is not None else 0.0
    else:
        pads = np.asarray(attrs["pads"], np.int64)
        cval = float(attrs.get("value") or 0.0)
    n = data.ndim
    pairs = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    mode = attrs.get("mode") or "constant"
    if mode == "constant":
        return np.pad(data, pairs, constant_values=cval)
    if mode == "reflect":
        return np.pad(data, pairs, mode="reflect")
    if mode == "edge":
        return np.pad(data, pairs, mode="edge")
    raise UnsupportedOnnxOp(f"Pad mode {mode}")


def _reshape(data: np.ndarray, shape: np.ndarray) -> np.ndarray:
    shape = [int(s) for s in np.atleast_1d(shape)]
    shape = [data.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return data.reshape(shape)


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def _reduce_mean(vals: list, attrs: dict) -> np.ndarray:
    data = vals[0]
    if "axes" in attrs and attrs["axes"] is not None:
        axes = tuple(int(a) for a in np.atleast_1d(attrs["axes"]))
    elif len(vals) > 1 and vals[1] is not None:  # opset >= 18
        axes = tuple(int(a) for a in np.atleast_1d(vals[1]))
    else:
        axes = None
    keep = bool(attrs.get("keepdims", 1))
    return np.mean(data, axis=axes, keepdims=keep, dtype=np.float32)


def _axes_arg(vals: list, attrs: dict) -> tuple[int, ...] | None:
    if "axes" in attrs and attrs["axes"] is not None:
        return tuple(int(a) for a in np.atleast_1d(attrs["axes"]))
    if len(vals) > 1 and vals[1] is not None:
        return tuple(int(a) for a in np.atleast_1d(vals[1]))
    return None


class OnnxExecutor:
    """Execute a parsed ONNX graph on numpy feeds.

    >>> ex = OnnxExecutor.from_path("silero_vad_v3.onnx")
    >>> out = ex.run({"input": audio, "h0": h, "c0": c})
    """

    def __init__(self, graph: OnnxGraph):
        self.graph = graph
        init = set(graph.all_initializers())
        # old opsets list initializers as graph inputs too; real feeds are
        # the declared inputs that are not initializers
        self.input_names = [n for n in graph.inputs if n not in init]
        self.output_names = list(graph.outputs)

    @classmethod
    def from_path(cls, path: str | Path) -> "OnnxExecutor":
        return cls(parse_model(path))

    def run(self, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        missing = [n for n in self.input_names if n not in feeds]
        if missing:
            raise OnnxExecError(
                f"missing feeds for graph inputs {missing} "
                f"(declared inputs: {self.input_names})"
            )
        env: dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in feeds.items()
        }
        self._run_graph(self.graph, env)
        absent = [n for n in self.output_names if n not in env]
        if absent:
            raise OnnxExecError(
                f"graph declares outputs {absent} that no node produced "
                "(producer node dropped or output renamed)"
            )
        return {name: env[name] for name in self.output_names}

    def _run_graph(self, graph: OnnxGraph, env: dict) -> None:
        for name, arr in graph.initializers.items():
            env.setdefault(name, arr)
        for i, node in enumerate(graph.nodes):
            undefined = [t for t in node.inputs if t and t not in env]
            if undefined:
                raise OnnxExecError(
                    f"{_node_id(node, i)}: undefined input tensor(s) "
                    f"{undefined} — producer dropped, or a tensor was renamed"
                )
            try:
                self._run_node(node, env)
            except (OnnxExecError, UnsupportedOnnxOp):
                raise
            except Exception as e:  # numpy shape/dtype/index errors etc.
                cause = " ".join(str(e).split()) or type(e).__name__
                raise OnnxExecError(f"{_node_id(node, i)}: {cause}") from e

    # ---- node dispatch -------------------------------------------------
    def _run_node(self, node: OnnxNode, env: dict) -> None:
        op = node.op_type
        vals = [env[i] if i else None for i in node.inputs]
        a = node.attrs
        if op == "Constant":
            out = a.get("value")
            if out is None:
                raise UnsupportedOnnxOp("Constant without tensor value")
        elif op == "Identity":
            out = vals[0]
        elif op == "Shape":
            out = np.asarray(vals[0].shape, np.int64)
        elif op == "Cast":
            out = vals[0].astype(_CAST_DTYPES[int(a["to"])])
        elif op == "Gather":
            out = np.take(vals[0], vals[1].astype(np.int64), axis=int(a.get("axis") or 0))
        elif op == "Unsqueeze":
            axes = _axes_arg(vals, a)
            out = vals[0]
            # ONNX spec: axes (positive or negative) index the OUTPUT rank
            # r_in + len(axes); insert in ascending resolved order
            r_out = out.ndim + len(axes)
            for ax in sorted(ax % r_out for ax in axes):
                out = np.expand_dims(out, ax)
        elif op == "Squeeze":
            axes = _axes_arg(vals, a)
            out = np.squeeze(vals[0], axis=axes)
        elif op == "Concat":
            out = np.concatenate([v for v in vals if v is not None], axis=int(a["axis"]))
        elif op == "Reshape":
            out = _reshape(vals[0], vals[1])
        elif op == "Transpose":
            out = np.transpose(vals[0], a.get("perm") or None)
        elif op == "Slice":
            out = _slice(vals, a)
        elif op == "ConstantOfShape":
            fill = a.get("value")
            shape = tuple(int(s) for s in np.atleast_1d(vals[0]))
            if fill is None:
                out = np.zeros(shape, np.float32)
            else:
                fill = np.asarray(fill)
                out = np.full(shape, fill.ravel()[0], dtype=fill.dtype)
        elif op == "Pad":
            out = _pad(vals, a)
        elif op == "Add":
            out = vals[0] + vals[1]
        elif op == "Sub":
            out = vals[0] - vals[1]
        elif op == "Mul":
            out = vals[0] * vals[1]
        elif op == "Div":
            x, y = vals[0], vals[1]
            if np.issubdtype(np.asarray(x).dtype, np.integer) and np.issubdtype(
                np.asarray(y).dtype, np.integer
            ):
                # ONNX integer Div rounds toward zero (C semantics), not floor
                out = (np.sign(x) * np.sign(y)) * (np.abs(x) // np.abs(y))
            else:
                out = x / y
        elif op == "Pow":
            out = np.power(vals[0], vals[1])
        elif op == "Sqrt":
            out = np.sqrt(vals[0])
        elif op == "Log":
            out = np.log(vals[0])
        elif op == "Neg":
            out = -vals[0]
        elif op == "Relu":
            out = np.maximum(vals[0], 0)
        elif op == "Sigmoid":
            out = _sigmoid(vals[0].astype(np.float32))
        elif op == "Tanh":
            out = np.tanh(vals[0])
        elif op == "Equal":
            out = np.equal(vals[0], vals[1])
        elif op == "Greater":
            out = np.greater(vals[0], vals[1])
        elif op == "Less":
            out = np.less(vals[0], vals[1])
        elif op == "Not":
            out = np.logical_not(vals[0])
        elif op == "Where":
            out = np.where(vals[0], vals[1], vals[2])
        elif op == "Softmax":
            out = _softmax(vals[0], int(a.get("axis", -1)))
        elif op == "MatMul":
            out = np.matmul(vals[0], vals[1])
        elif op == "Gemm":
            # .get(k, 1.0), NOT `or 1.0`: an explicit alpha/beta of 0.0 is
            # legal ONNX (beta=0 means "ignore C") and must not read as 1.0
            alpha = float(a.get("alpha", 1.0))
            beta = float(a.get("beta", 1.0))
            x = vals[0].T if a.get("transA") else vals[0]
            w = vals[1].T if a.get("transB") else vals[1]
            out = alpha * (x @ w)
            if len(vals) > 2 and vals[2] is not None:
                out = out + beta * vals[2]
        elif op == "ReduceMean":
            out = _reduce_mean(vals, a)
        elif op == "GlobalAveragePool":
            spatial = tuple(range(2, vals[0].ndim))
            out = np.mean(vals[0], axis=spatial, keepdims=True, dtype=np.float32)
        elif op == "Conv":
            out = _conv(
                vals[0].astype(np.float32),
                vals[1].astype(np.float32),
                vals[2].astype(np.float32) if len(vals) > 2 and vals[2] is not None else None,
                a,
            )
        elif op == "LSTM":
            outs = _lstm(node, vals)
            for name, arr in zip(node.outputs, outs):
                if name:
                    env[name] = arr
            return
        elif op == "If":
            cond = bool(np.asarray(vals[0]).ravel()[0])
            branch = a["then_branch"] if cond else a["else_branch"]
            # ONNX scoping: the branch sees the enclosing scope; run it in a
            # copy so branch-local names don't leak, then bind its declared
            # outputs to the If node's outputs
            scope = dict(env)
            self._run_graph(branch, scope)
            for name, bname in zip(node.outputs, branch.outputs):
                if name:
                    env[name] = scope[bname]
            return
        elif op == "Expand":
            out = np.broadcast_to(
                vals[0], np.broadcast_shapes(vals[0].shape, tuple(int(s) for s in vals[1]))
            ).copy()
        elif op == "Range":
            out = np.arange(
                np.asarray(vals[0]).item(),
                np.asarray(vals[1]).item(),
                np.asarray(vals[2]).item(),
            )
        elif op == "Clip":
            lo = vals[1] if len(vals) > 1 and vals[1] is not None else a.get("min")
            hi = vals[2] if len(vals) > 2 and vals[2] is not None else a.get("max")
            out = np.clip(vals[0], lo, hi)
        elif op == "ReduceMax":
            axes = _axes_arg(vals, a)
            out = np.max(vals[0], axis=axes, keepdims=bool(a.get("keepdims", 1)))
        elif op == "ReduceSum":
            axes = _axes_arg(vals, a)
            out = np.sum(vals[0], axis=axes, keepdims=bool(a.get("keepdims", 1)))
        else:
            raise UnsupportedOnnxOp(op)
        env[node.outputs[0]] = out


def run_silero_onnx(
    path: str | Path,
    audio: np.ndarray,
    state: tuple[np.ndarray, np.ndarray] | None = None,
    sample_rate: int | None = None,
    executor: "OnnxExecutor | None" = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convenience wrapper: run one batch through an official Silero .onnx.

    Returns (output, hn, cn). Feeds are auto-named from the graph's declared
    inputs: `input` (audio), optional `sr`/`sample_rate` scalar, and the
    state pair (h0/c0, h/c, or a fused `state`). The same role the
    reference's ort_create_tensors + ort_run pair plays
    (onnx_helpers.c:412-549)."""
    ex = executor if executor is not None else OnnxExecutor.from_path(path)
    names = ex.input_names
    feeds: dict[str, np.ndarray] = {}
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    feeds[names[0]] = audio
    state_names = [n for n in names[1:] if n not in ("sr", "sample_rate")]
    sr_names = [n for n in names[1:] if n in ("sr", "sample_rate")]
    if sr_names:
        feeds[sr_names[0]] = np.asarray(sample_rate or 16000, np.int64)
    if len(state_names) == 2:
        if state is None:
            # v3/v4: h/c are [2, B, 64]
            state = (
                np.zeros((2, audio.shape[0], 64), np.float32),
                np.zeros((2, audio.shape[0], 64), np.float32),
            )
        feeds[state_names[0]] = np.asarray(state[0], np.float32)
        feeds[state_names[1]] = np.asarray(state[1], np.float32)
    elif len(state_names) == 1:
        # v5: fused state [2, B, 128]
        if state is None:
            fused = np.zeros((2, audio.shape[0], 128), np.float32)
        else:
            fused = np.stack([np.asarray(s)[0] for s in state])
        feeds[state_names[0]] = np.asarray(fused, np.float32)
    outs = ex.run(feeds)
    out_vals = [outs[n] for n in ex.output_names]
    if len(out_vals) == 2:  # v5: output + fused state
        return out_vals[0], out_vals[1][0:1], out_vals[1][1:2]
    return out_vals[0], out_vals[1], out_vals[2]
