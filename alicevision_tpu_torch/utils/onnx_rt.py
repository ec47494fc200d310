"""From-scratch ONNX model loading + PyTorch execution (no onnxruntime, no
protobuf library).

Port of `alicevision_tpu/utils/onnx_rt.py`. The reference runs its
segmentation / sphere-detection networks through an ONNX Runtime session
(ref: src/aliceVision/segmentation/segmentation.hpp:119-120
createSession/tiled inference; sphereDetection/sphereDetection.cpp ONNX
forward). This module implements the needed slice natively:

  * a protobuf WIRE-FORMAT reader for `ModelProto` (varint +
    length-delimited decoding against the fixed onnx.proto field numbers —
    no .proto compilation, no protobuf runtime), plus the symmetric writer
    that authors `.onnx` files (copied: the same bytes as the JAX
    package's);
  * an executor that binds each graph node to a PyTorch op on an explicit
    device. The initializers move to the device once per model. Values
    that only constants and shapes feed (`Shape`, `Gather` on shapes, the
    operands of `Reshape` / `Slice` / `Squeeze` / `Unsqueeze` / `Resize` /
    `Pad`) stay host numpy, as the JAX executor folds them; an op all of
    whose inputs are such values is folded on the host.

Supported ops cover segmentation-style CNNs: Conv, ConvTranspose,
BatchNormalization, Relu/LeakyRelu/Sigmoid/Tanh/Softmax/Clip, MaxPool/
AveragePool/GlobalAveragePool, Add/Sub/Mul/Div/Pow/Sqrt/Exp/Neg, MatMul/
Gemm, Concat/Reshape/Transpose/Flatten/Squeeze/Unsqueeze/Identity/Dropout/
Cast, Resize/Upsample (nearest, linear, cubic), Pad (constant, reflect,
edge), ArgMax, ReduceMean/ReduceSum/ReduceMax, Constant/ConstantOfShape/
Shape/Gather/Slice. Any other op raises `NotImplementedError` naming it.

Each op computes what the JAX executor computes, where PyTorch's defaults
differ: `auto_pad` SAME pads are computed here (SAME_LOWER is taken as
SAME_UPPER, as there); pools pad explicitly (-inf for the max) and the
average divides by the valid count unless `count_include_pad`; `Resize`
follows `jax.image.resize` — a half-pixel nearest, linear and cubic
kernels that antialias when they downsample, and Keys' cubic with
a = -0.5 (ROADMAP §3). Float64 constants compute in float32, as the JAX
executor's do; an explicit `Cast` to float64 gives float64.

Two of the JAX executor's faults follow the ONNX spec here (ROADMAP §3):
the pools' `strides` default to 1, not to `kernel_shape`, and a scalar
TensorProto (no dims) is a 0-d array, not shape (1,).
"""

from __future__ import annotations

import operator
import struct

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            v, i = _read_varint(buf, i)
        elif wire == _WIRE_I64:
            v = buf[i:i + 8]
            i += 8
        elif wire == _WIRE_LEN:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == _WIRE_I32:
            v = buf[i:i + 4]
            i += 4
        else:  # pragma: no cover - groups are not used by onnx
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _collect(buf: bytes) -> dict:
    out: dict = {}
    for field, wire, v in _fields(buf):
        out.setdefault(field, []).append((wire, v))
    return out


def _svint(v: int) -> int:
    """Two's-complement interpretation of a 64-bit varint."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(entries) -> list[int]:
    vals = []
    for wire, v in entries:
        if wire == _WIRE_VARINT:
            vals.append(_svint(v))
        else:  # packed
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                vals.append(_svint(x))
    return vals


def _packed_floats(entries) -> list[float]:
    vals = []
    for wire, v in entries:
        if wire == _WIRE_I32:
            vals.append(struct.unpack("<f", v)[0])
        else:  # packed
            vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
    return vals


_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
            7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    f = _collect(buf)
    dims = _packed_varints(f.get(1, []))
    dt = _packed_varints(f.get(2, [0]))[0]
    name = f[8][0][1].decode() if 8 in f else ""
    np_dt = _DTYPES.get(dt, np.float32)
    if 9 in f:  # raw_data
        arr = np.frombuffer(f[9][0][1], dtype=np_dt)
    elif 4 in f:  # float_data
        arr = np.asarray(_packed_floats(f[4]), np.float32)
    elif 7 in f:  # int64_data
        arr = np.asarray(_packed_varints(f[7]), np.int64)
    elif 5 in f:  # int32_data
        arr = np.asarray(_packed_varints(f[5]), np.int32).astype(np_dt)
    elif 10 in f:  # double_data
        arr = np.asarray(
            [struct.unpack("<d", w[1])[0] if w[0] == _WIRE_I64 else 0.0
             for w in f[10]], np.float64)
    else:
        arr = np.zeros(0, np_dt)
    # an empty dims list is a scalar: a 0-d array, as the ONNX spec reads it
    # (the JAX package returns shape (1,), ROADMAP §3)
    return name, arr.reshape(dims) if dims or arr.size == 1 else arr


def _parse_attr(buf: bytes) -> tuple[str, object]:
    f = _collect(buf)
    name = f[1][0][1].decode()
    if 2 in f:  # f
        return name, struct.unpack("<f", f[2][0][1])[0]
    if 3 in f:  # i
        return name, _svint(f[3][0][1])
    if 4 in f:  # s
        return name, f[4][0][1].decode()
    if 5 in f:  # t
        return name, _parse_tensor(f[5][0][1])[1]
    if 7 in f:  # floats
        return name, _packed_floats(f[7])
    if 8 in f:  # ints
        return name, _packed_varints(f[8])
    if 9 in f:  # strings
        return name, [w[1].decode() for w in f[9]]
    return name, None


class Node:
    __slots__ = ("op", "inputs", "outputs", "attrs", "name")

    def __init__(self, op, inputs, outputs, attrs, name=""):
        self.op, self.inputs, self.outputs = op, inputs, outputs
        self.attrs, self.name = attrs, name

    def __repr__(self):
        return f"Node({self.op}, {self.inputs} -> {self.outputs})"


def _parse_node(buf: bytes) -> Node:
    f = _collect(buf)
    return Node(
        op=f[4][0][1].decode() if 4 in f else "",
        inputs=[w[1].decode() for w in f.get(1, [])],
        outputs=[w[1].decode() for w in f.get(2, [])],
        attrs=dict(_parse_attr(w[1]) for w in f.get(5, [])),
        name=f[3][0][1].decode() if 3 in f else "",
    )


def _parse_value_info(buf: bytes) -> tuple[str, list]:
    f = _collect(buf)
    name = f[1][0][1].decode()
    shape: list = []
    if 2 in f:  # TypeProto
        tf = _collect(f[2][0][1])
        if 1 in tf:  # tensor_type
            tt = _collect(tf[1][0][1])
            if 2 in tt:  # shape
                sh = _collect(tt[2][0][1])
                for _, dbuf in sh.get(1, []):
                    df = _collect(dbuf)
                    if 1 in df:
                        shape.append(_svint(df[1][0][1]))
                    else:
                        shape.append(None)  # dim_param (symbolic)
    return name, shape


class OnnxGraph:
    def __init__(self, nodes, initializers, inputs, outputs, name=""):
        self.nodes = nodes
        self.initializers = initializers  # name -> np.ndarray
        self.inputs = inputs  # [(name, shape)]
        self.outputs = outputs
        self.name = name


def parse_model(data: bytes) -> OnnxGraph:
    """Parse serialized ModelProto bytes into an OnnxGraph."""
    f = _collect(data)
    if 7 not in f:
        raise ValueError("no GraphProto in model")
    g = _collect(f[7][0][1])
    inits = dict(_parse_tensor(w[1]) for w in g.get(5, []))
    inputs = [_parse_value_info(w[1]) for w in g.get(11, [])]
    outputs = [_parse_value_info(w[1]) for w in g.get(12, [])]
    nodes = [_parse_node(w[1]) for w in g.get(1, [])]
    name = g[2][0][1].decode() if 2 in g else ""
    # graph inputs include initializers in some exporters; keep only true
    # runtime inputs
    inputs = [(n, s) for n, s in inputs if n not in inits]
    return OnnxGraph(nodes, inits, inputs, outputs, name)


def load_model(path: str) -> OnnxGraph:
    with open(path, "rb") as fh:
        return parse_model(fh.read())


# ---------------------------------------------------------------------------
# protobuf writer (used by tests to author real .onnx files)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(payload)) + payload


def _vi(field: int, value: int) -> bytes:
    return _tag(field, _WIRE_VARINT) + _varint(value)


def _f32(field: int, value: float) -> bytes:
    return _tag(field, _WIRE_I32) + struct.pack("<f", value)


_DT_CODES = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
             np.dtype(np.int8): 3, np.dtype(np.int32): 6,
             np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
             np.dtype(np.float16): 10, np.dtype(np.float64): 11}


def make_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b"".join(_vi(1, int(d)) for d in arr.shape)
    out += _vi(2, _DT_CODES[arr.dtype])
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def _attr(name: str, value) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, float):
        out += _f32(2, value) + _vi(20, 1)  # FLOAT
    elif isinstance(value, (bool, int, np.integer)):
        out += _vi(3, int(value)) + _vi(20, 2)  # INT
    elif isinstance(value, str):
        out += _ld(4, value.encode()) + _vi(20, 3)  # STRING
    elif isinstance(value, np.ndarray):
        out += _ld(5, make_tensor("", value)) + _vi(20, 4)  # TENSOR
    elif isinstance(value, (list, tuple)) and value and isinstance(
            value[0], float):
        out += b"".join(_f32(7, v) for v in value) + _vi(20, 6)  # FLOATS
    elif isinstance(value, (list, tuple)):
        out += b"".join(_vi(8, int(v)) for v in value) + _vi(20, 7)  # INTS
    else:  # pragma: no cover
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def make_node(op: str, inputs, outputs, **attrs) -> bytes:
    out = b"".join(_ld(1, s.encode()) for s in inputs)
    out += b"".join(_ld(2, s.encode()) for s in outputs)
    out += _ld(4, op.encode())
    out += b"".join(_ld(5, _attr(k, v)) for k, v in attrs.items())
    return out


def _value_info(name: str, shape) -> bytes:
    dims = b"".join(_ld(1, _vi(1, int(d))) for d in shape)
    tensor_type = _vi(1, 1) + _ld(2, dims)  # elem_type=FLOAT, shape
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor_type))


def make_model(nodes, inputs, outputs, initializers=None,
               graph_name: str = "g", opset: int = 13) -> bytes:
    """Serialize a ModelProto: nodes = [make_node(...)], inputs/outputs =
    [(name, shape)], initializers = {name: np.ndarray}."""
    g = b"".join(_ld(1, n) for n in nodes)
    g += _ld(2, graph_name.encode())
    for name, arr in (initializers or {}).items():
        g += _ld(5, make_tensor(name, arr))
    for name, shape in inputs:
        g += _ld(11, _value_info(name, shape))
    for name, shape in outputs:
        g += _ld(12, _value_info(name, shape))
    m = _vi(1, 8)  # ir_version
    m += _ld(2, b"alicevision_tpu")  # producer
    m += _ld(7, g)
    m += _ld(8, _vi(2, opset))  # opset_import { version }
    return m


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _pairs(pads, nd):
    """ONNX pads [b1..bn, e1..en] -> ((b1, e1), ...) for nd spatial dims."""
    if not pads:
        return ((0, 0),) * nd
    half = len(pads) // 2
    return tuple((int(pads[i]), int(pads[i + half])) for i in range(half))


def _same_pads(in_sizes, kernel, strides, dilations):
    """`lax.padtype_to_pads(..., "SAME")` over the dilated window: the total
    padding that gives ceil(n / stride) outputs, its odd pixel at the end."""
    out = []
    for n, k, s, d in zip(in_sizes, kernel, strides, dilations):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _pad_spatial(x, pads, value=0.0):
    """Pad the trailing len(pads) dims of x by ((lo, hi), ...)."""
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(x, op, ks, strides, pads, count_include_pad):
    """MaxPool / AveragePool as `lax.reduce_window` over explicit pads: the
    max pads with -inf; the average is the window sum over the window's
    size, or over its count of unpadded pixels."""
    one_d = len(ks) == 1
    if one_d:  # as a 2-D pool over a unit dim
        x, ks, strides, pads = x.unsqueeze(-2), (1,) + ks, (1,) + strides, ((0, 0),) + pads
    n = len(ks)
    if op == "MaxPool":
        y = _MAX_POOL[n](_pad_spatial(x, pads, float("-inf")), ks, strides)
    else:
        y = _AVG_POOL[n](_pad_spatial(x, pads), ks, strides, divisor_override=1)
        if count_include_pad:
            y = y / float(np.prod(ks))
        else:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
            y = y / _AVG_POOL[n](_pad_spatial(ones, pads), ks, strides, divisor_override=1)
    return y.squeeze(-2) if one_d else y


def _resize_weights(m: int, n: int, method: str) -> np.ndarray:
    """(m, n) float32 interpolation weights of `jax.image.resize` along one
    axis (its `compute_weight_mat`, antialiased): half-pixel sample
    positions, the kernel widened by the downsampling factor, each column
    normalized, columns of samples outside the input zeroed."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.0) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) / kernel_scale
    if method == "linear":
        w = np.maximum(f32(0.0), f32(1.0) - x)
    else:  # Keys' cubic convolution, a = -0.5
        w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
        w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
        w = np.where(x >= 2.0, f32(0.0), w)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize(x: torch.Tensor, sizes, mode: str) -> torch.Tensor:
    """`jax.image.resize(x, sizes, method)` with the ONNX mode names:
    nearest is half-pixel (torch's `nearest-exact`), linear and cubic are
    separable weight matrices applied along each dim whose size changes."""
    for d, (m, n) in enumerate(zip(x.shape, sizes)):
        m, n = int(m), int(n)
        if m == n:
            continue
        if mode == "nearest":
            f32 = np.float32
            src = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n)).astype(np.int64)
            x = x.index_select(d, torch.as_tensor(src, device=x.device))
        else:
            w = torch.as_tensor(_resize_weights(m, n, mode), device=x.device).to(x.dtype)
            x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x


def _index_along(x: torch.Tensor, dim: int, idx: np.ndarray) -> torch.Tensor:
    return x.index_select(dim, torch.as_tensor(np.array(idx, np.int64), device=x.device))


_CAST = {1: torch.float32, 6: torch.int32, 7: torch.int64, 9: torch.bool, 11: torch.float64}
_BINARY = {"Add": operator.add, "Sub": operator.sub, "Mul": operator.mul, "Div": operator.truediv,
           "Pow": torch.pow}


def _to_tensor(v: np.ndarray, device) -> torch.Tensor:
    """A host value as a tensor; float64 computes in float32, as the JAX
    executor's constants do."""
    v = np.asarray(v)
    if v.dtype == np.float64:
        v = v.astype(np.float32)
    return torch.from_numpy(np.array(v)).to(device)


class OnnxModel:
    """Executable ONNX model: parses once, runs node by node on `device`.

    Call with positional arrays (numpy or tensors) matching the graph inputs,
    or by name; NCHW layouts follow the ONNX spec. Returns the single output
    tensor on the device, or a tuple when the graph declares several."""

    def __init__(self, model: OnnxGraph | bytes | str, device="cuda"):
        if isinstance(model, (bytes, bytearray)):
            model = parse_model(bytes(model))
        elif isinstance(model, str):
            model = load_model(model)
        self.graph = model
        self.device = resolve_device(device)
        # the weights move to the device once; Constant nodes' values once used
        self._on_device = {k: _to_tensor(v, self.device) for k, v in model.initializers.items()}
        self._static = set(model.initializers) | {o for nd in model.nodes if nd.op == "Constant" for o in nd.outputs}

    @property
    def input_names(self):
        return [n for n, _ in self.graph.inputs]

    @property
    def output_names(self):
        return [n for n, _ in self.graph.outputs]

    def __call__(self, *args, **feeds):
        named = dict(zip(self.input_names, args))
        named.update(feeds)
        vals = {}
        for n in self.input_names:
            v = named[n]
            vals[n] = v.to(self.device) if isinstance(v, torch.Tensor) else _to_tensor(v, self.device)
        with torch.inference_mode():
            out = self._run(vals)
        return out if len(self.graph.outputs) > 1 else out[0]

    def _run(self, inputs: dict) -> tuple:
        dev = self.device
        env: dict = {"": None}
        env.update(self.graph.initializers)  # host values; their device copies in _on_device
        env.update(inputs)
        uploaded: dict = {}

        def on(name, where):
            """The value `name` as a tensor on `where`."""
            v = env[name]
            if v is None or isinstance(v, torch.Tensor):
                return v
            if where != dev:
                return _to_tensor(v, where)
            if name in self._static:
                if name not in self._on_device:
                    self._on_device[name] = _to_tensor(v, dev)
                return self._on_device[name]
            if name not in uploaded:
                uploaded[name] = _to_tensor(v, dev)
            return uploaded[name]

        for nd in self.graph.nodes:
            host = all(not isinstance(env[i], torch.Tensor) for i in nd.inputs)
            where = torch.device("cpu") if host else dev
            if nd.op == "Shape":
                y = np.asarray(env[nd.inputs[0]].shape, np.int64)
            else:
                y = self._node(nd, lambda i, w=where: on(nd.inputs[i], w), env)
            outs = y if isinstance(y, tuple) else (y,)
            for name, val in zip(nd.outputs, outs):
                if host and isinstance(val, torch.Tensor):
                    val = val.numpy()  # folded on the host
                env[name] = val
        return tuple(env[n] if isinstance(env[n], torch.Tensor) else on(n, dev) for n in self.output_names)

    @staticmethod
    def _node(nd, arg, env):
        """One node: `arg(i)` is input i as a tensor (None when absent)."""
        a, op, ins = nd.attrs, nd.op, nd.inputs

        def given(i):
            return i < len(ins) and ins[i] != ""

        def const(i):
            """A shape-carrying operand: an initializer or a folded value,
            never runtime data."""
            v = env[ins[i]]
            if isinstance(v, torch.Tensor):
                raise ValueError(f"data-dependent shape input '{ins[i]}' is not supported")
            return np.asarray(v)

        def ints(i):
            return [int(s) for s in const(i).reshape(-1)]

        if op in ("Conv", "ConvTranspose"):
            x, w = arg(0), arg(1)
            nsp = w.ndim - 2
            strides = tuple(int(s) for s in a.get("strides", (1,) * nsp))
            dil = tuple(int(d) for d in a.get("dilations", (1,) * nsp))
            group = int(a.get("group", 1))
            pads = _pairs(a.get("pads"), nsp)
            same = a.get("auto_pad", "NOTSET") in ("SAME_UPPER", "SAME_LOWER")
            bias = arg(2) if given(2) else None
            if op == "Conv":
                if same:
                    pads = _same_pads(x.shape[2:], w.shape[2:], strides, dil)
                if all(lo == hi for lo, hi in pads):
                    return _CONV[nsp](x, w, bias, strides, tuple(lo for lo, _ in pads), dil, group)
                return _CONV[nsp](_pad_spatial(x, pads), w, bias, strides, 0, dil, group)
            # ConvTranspose: the full transposed conv, output_padding appended
            # at the end, then the pads cropped
            if same:
                pads = ((0, 0),) * nsp
            y = _CONV_T[nsp](x, w, None, strides, 0, 0, group, dil)
            y = _pad_spatial(y, tuple((0, int(p)) for p in a.get("output_padding", (0,) * nsp)))
            y = y[(slice(None), slice(None)) + tuple(
                slice(lo, y.shape[2 + k] - hi) for k, (lo, hi) in enumerate(pads))]
            return y if bias is None else y + bias.reshape((1, -1) + (1,) * nsp)
        if op == "BatchNormalization":
            x, scale, bias, mean, var = (arg(i) for i in range(5))
            sh = (1, -1) + (1,) * (x.ndim - 2)
            eps = a.get("epsilon", 1e-5)
            return (x - mean.reshape(sh)) * (scale.reshape(sh) * torch.rsqrt(var.reshape(sh) + eps)) \
                + bias.reshape(sh)
        if op == "Relu":
            return torch.relu(arg(0))
        if op == "LeakyRelu":
            x = arg(0)
            return torch.where(x >= 0, x, a.get("alpha", 0.01) * x)
        if op == "Sigmoid":
            return torch.sigmoid(arg(0))
        if op == "Tanh":
            return torch.tanh(arg(0))
        if op == "Softmax":
            return torch.softmax(arg(0), dim=int(a.get("axis", -1)))
        if op == "Clip":
            y = arg(0)
            lo = arg(1) if given(1) else a.get("min")
            hi = arg(2) if given(2) else a.get("max")
            if lo is not None:
                y = torch.maximum(y, lo.to(y.dtype)) if isinstance(lo, torch.Tensor) else torch.clamp(y, min=lo)
            if hi is not None:
                y = torch.minimum(y, hi.to(y.dtype)) if isinstance(hi, torch.Tensor) else torch.clamp(y, max=hi)
            return y
        if op in ("MaxPool", "AveragePool"):
            ks = tuple(int(k) for k in a["kernel_shape"])
            nsp = len(ks)
            # the ONNX spec's default stride is 1 (the JAX executor takes
            # kernel_shape, ROADMAP §3)
            strides = tuple(int(s) for s in a.get("strides", (1,) * nsp))
            return _pool(arg(0), op, ks, strides, _pairs(a.get("pads"), nsp), a.get("count_include_pad", 0))
        if op == "GlobalAveragePool":
            x = arg(0)
            return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)
        if op in _BINARY:
            return _BINARY[op](arg(0), arg(1))
        if op == "Sqrt":
            return torch.sqrt(arg(0))
        if op == "Exp":
            return torch.exp(arg(0))
        if op == "Neg":
            return -arg(0)
        if op == "MatMul":
            return torch.matmul(arg(0), arg(1))
        if op == "Gemm":
            A, B = arg(0), arg(1)
            A = A.permute(*reversed(range(A.ndim))) if a.get("transA", 0) else A
            B = B.permute(*reversed(range(B.ndim))) if a.get("transB", 0) else B
            y = a.get("alpha", 1.0) * (A @ B)
            return y + a.get("beta", 1.0) * arg(2) if given(2) else y
        if op == "Concat":
            return torch.cat([arg(i) for i in range(len(ins))], dim=int(a["axis"]))
        if op == "Reshape":
            x = arg(0)
            shape = [x.shape[k] if s == 0 else s for k, s in enumerate(ints(1))]
            return x.reshape(shape)
        if op == "Transpose":
            x = arg(0)
            perm = a.get("perm") or list(range(x.ndim))[::-1]
            return x.permute(*[int(p) for p in perm])
        if op == "Flatten":
            x = arg(0)
            ax = int(a.get("axis", 1))
            return x.reshape(int(np.prod(x.shape[:ax])), -1)
        if op == "Squeeze":
            x = arg(0)
            axes = ints(1) if given(1) else a.get("axes")
            return x.squeeze(tuple(int(v) for v in axes)) if axes else x.squeeze()
        if op == "Unsqueeze":
            y = arg(0)
            for ax in sorted(ints(1) if given(1) else [int(v) for v in a["axes"]]):
                y = y.unsqueeze(ax)
            return y
        if op in ("Identity", "Dropout"):
            return arg(0)
        if op == "Cast":
            to = int(a["to"])
            if to not in _CAST:
                raise NotImplementedError(f"ONNX Cast to type {to} not supported")
            return arg(0).to(_CAST[to])
        if op in ("Resize", "Upsample"):
            x = arg(0)
            if op == "Upsample":
                scales = a.get("scales") or const(1).tolist()
                sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
            elif given(3):
                sizes = ints(3)
            else:
                sizes = [int(round(d * s)) for d, s in zip(x.shape, const(2).reshape(-1).tolist())]
            mode = a.get("mode", "nearest")
            if mode not in ("nearest", "linear", "cubic"):
                raise NotImplementedError(f"ONNX Resize mode {mode} not supported")
            return _resize(x, sizes, mode)
        if op == "Pad":
            x = arg(0)
            pads = ints(1) if given(1) else [int(p) for p in a["pads"]]
            half = len(pads) // 2
            widths = [(pads[k], pads[k + half]) for k in range(half)]
            mode = a.get("mode", "constant")
            if mode == "constant":
                cval = float(const(2).reshape(-1)[0]) if given(2) else 0.0
                return _pad_spatial(x, widths, cval)
            if mode not in ("reflect", "edge"):
                raise NotImplementedError(f"ONNX Pad mode {mode} not supported")
            for d, (lo, hi) in enumerate(widths):
                if lo or hi:
                    x = _index_along(x, d, np.pad(np.arange(x.shape[d]), (lo, hi), mode=mode))
            return x
        if op == "ArgMax":
            ax = int(a.get("axis", 0))
            return torch.argmax(arg(0), dim=ax, keepdim=bool(a.get("keepdims", 1)))
        if op in ("ReduceMean", "ReduceSum", "ReduceMax"):
            x = arg(0)
            axes = a.get("axes")
            if axes is None and given(1):
                axes = ints(1)
            dims = tuple(int(v) for v in axes) if axes else tuple(range(x.ndim))
            fn = {"ReduceMean": torch.mean, "ReduceSum": torch.sum, "ReduceMax": torch.amax}[op]
            return fn(x, dim=dims, keepdim=bool(a.get("keepdims", 1)))
        if op == "Constant":
            return np.asarray(a.get("value"))
        if op == "ConstantOfShape":
            val = a.get("value")
            v0 = float(np.asarray(val).reshape(-1)[0]) if val is not None else 0.0
            return np.full(ints(0), v0, np.float32)
        if op == "Gather":
            x, idx = arg(0), arg(1).to(torch.int64)
            ax = int(a.get("axis", 0)) % x.ndim
            idx = torch.where(idx < 0, idx + x.shape[ax], idx)
            y = x.index_select(ax, idx.reshape(-1))
            return y.reshape(tuple(x.shape[:ax]) + tuple(idx.shape) + tuple(x.shape[ax + 1:]))
        if op == "Slice":
            x = arg(0)
            starts, ends = ints(1), ints(2)
            axes = ints(3) if given(3) else list(range(len(starts)))
            steps = ints(4) if given(4) else [1] * len(starts)
            for s0, e0, ax, st in zip(starts, ends, axes, steps):
                sl = slice(s0, None if e0 >= 2**31 else e0, st)
                ax = ax % x.ndim
                if st > 0:
                    x = x[(slice(None),) * ax + (sl,)]
                else:
                    x = _index_along(x, ax, np.arange(x.shape[ax])[sl])
            return x
        raise NotImplementedError(f"ONNX op {op} not supported")
