"""The port's ONNX executor (`alicevision_tpu_torch/utils/onnx_rt.py`)
against the JAX package's, on the CPU.

The wire format is a copy: the port's `make_model` writes the JAX writer's
bytes and each parser reads the other's files. Every op of the executor
runs in small graphs (at most 64x64, a few channels) through both
executors on the same seeded inputs, each family as one multi-output graph
so that JAX compiles it once; the outputs agree within 1e-5.

Left out of the parity cases, and held to the ONNX spec with numpy as the
oracle instead (ROADMAP §3): the pools' `strides` default (the JAX
executor takes `kernel_shape`, the spec 1) and scalar TensorProtos (JAX
parses shape (1,), the spec a 0-d array). A `Cast` to float64 computes in
float64 here and in float32 in the JAX executor (no x64), so its parity
holds the values, not the dtype.
"""

import numpy as np
import pytest
import torch

from alicevision_tpu.utils import onnx_rt as jrt
from alicevision_tpu_torch.utils import onnx_rt as trt

torch.set_num_threads(1)

ATOL = 1e-5
RNG = np.random.RandomState(0)


def _r(*shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def _n(op, ins, outs, **kw):
    return trt.make_node(op, ins, outs, **kw)


def _family_conv():
    x = _r(1, 4, 20, 22)
    inits = {"w3": _r(6, 4, 3, 3), "b6": _r(6), "wg": _r(6, 2, 3, 3), "w5": _r(6, 4, 5, 5),
             "wt": _r(4, 3, 3, 3), "bt": _r(3), "w1d": _r(3, 4, 3), "scale": _r(4, lo=0.5, hi=1.5),
             "bias": _r(4), "mean": _r(4, lo=-0.1, hi=0.1), "var": _r(4, lo=0.5, hi=1.5)}
    nodes = [
        _n("Conv", ["x", "w3", "b6"], ["conv_pads_bias"], pads=[1, 1, 1, 1]),
        _n("Conv", ["x", "w3"], ["conv_asym_stride"], pads=[0, 1, 2, 1], strides=[2, 1]),
        _n("Conv", ["x", "w5"], ["conv_dilated"], pads=[2, 3, 2, 3], dilations=[2, 1]),
        _n("Conv", ["x", "wg", "b6"], ["conv_group"], group=2, pads=[1, 1, 1, 1]),
        _n("Conv", ["x", "w5"], ["conv_same_upper_stride2"], auto_pad="SAME_UPPER", strides=[2, 2]),
        _n("Conv", ["x", "w3"], ["conv_same_lower"], auto_pad="SAME_LOWER", strides=[3, 2]),
        _n("ConvTranspose", ["x", "wt", "bt"], ["convt_stride2"], strides=[2, 2]),
        _n("ConvTranspose", ["x", "wt"], ["convt_pads_opad"], strides=[2, 3], pads=[1, 0, 1, 2],
           output_padding=[1, 1]),
        _n("ConvTranspose", ["x", "wt"], ["convt_dilated"], dilations=[2, 2], pads=[1, 1, 1, 1]),
        _n("BatchNormalization", ["x", "scale", "bias", "mean", "var"], ["batchnorm"], epsilon=1e-3),
        _n("Reshape", ["x", "shp1d"], ["x1d"]),
        _n("Conv", ["x1d", "w1d"], ["conv_1d"], pads=[1, 2], strides=[2]),
    ]
    inits["shp1d"] = np.asarray([1, 4, 440], np.int64)
    outs = ["conv_pads_bias", "conv_asym_stride", "conv_dilated", "conv_group", "conv_same_upper_stride2",
            "conv_same_lower", "convt_stride2", "convt_pads_opad", "convt_dilated", "batchnorm", "conv_1d"]
    return nodes, inits, {"x": x}, outs


def _family_pool_activation():
    x = _r(2, 3, 17, 19)
    nodes = [
        _n("MaxPool", ["x"], ["maxpool_asym"], kernel_shape=[3, 2], strides=[2, 1], pads=[1, 0, 0, 1]),
        _n("MaxPool", ["x"], ["maxpool_stride2"], kernel_shape=[2, 2], strides=[2, 2]),
        _n("AveragePool", ["x"], ["avgpool_exclude_pad"], kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
        _n("AveragePool", ["x"], ["avgpool_include_pad"], kernel_shape=[3, 3], strides=[1, 2], pads=[1, 0, 1, 2],
           count_include_pad=1),
        _n("GlobalAveragePool", ["x"], ["global_avgpool"]),
        _n("Relu", ["x"], ["relu"]),
        _n("LeakyRelu", ["x"], ["leaky_relu"], alpha=0.2),
        _n("Sigmoid", ["x"], ["sigmoid"]),
        _n("Tanh", ["x"], ["tanh"]),
        _n("Softmax", ["x"], ["softmax_default_axis"]),
        _n("Softmax", ["x"], ["softmax_axis1"], axis=1),
        _n("Clip", ["x", "lo", "hi"], ["clip_inputs"]),
        _n("Clip", ["x", "", "hi"], ["clip_max_only"]),
        _n("ArgMax", ["x"], ["argmax"], axis=1),
        _n("ArgMax", ["x"], ["argmax_flat"], axis=3, keepdims=0),
        _n("ReduceMean", ["x"], ["reduce_mean"], axes=[2, 3]),
        _n("ReduceSum", ["x", "ax1"], ["reduce_sum_input_axes"], keepdims=0),
        _n("ReduceMax", ["x"], ["reduce_max_all"]),
    ]
    inits = {"lo": np.asarray([-0.25], np.float32), "hi": np.asarray([0.5], np.float32),
             "ax1": np.asarray([1], np.int64)}
    outs = [
        "maxpool_asym", "maxpool_stride2", "avgpool_exclude_pad", "avgpool_include_pad", "global_avgpool", "relu",
        "leaky_relu", "sigmoid", "tanh", "softmax_default_axis", "softmax_axis1", "clip_inputs", "clip_max_only",
        "argmax", "argmax_flat", "reduce_mean", "reduce_sum_input_axes", "reduce_max_all"]
    return nodes, inits, {"x": x}, outs


def _family_arith_shape():
    x, y = _r(2, 3, 8, 6), _r(3, 1, 6, lo=0.5, hi=2.0)
    m, k = _r(5, 7), _r(7, 4)
    nodes = [
        _n("Add", ["x", "y"], ["add_broadcast"]),
        _n("Sub", ["x", "y"], ["sub"]),
        _n("Mul", ["x", "y"], ["mul"]),
        _n("Div", ["x", "y"], ["div"]),
        _n("Pow", ["y", "two"], ["pow"]),
        _n("Sqrt", ["y"], ["sqrt"]),
        _n("Exp", ["x"], ["exp"]),
        _n("Neg", ["x"], ["neg"]),
        _n("MatMul", ["m", "k"], ["matmul"]),
        _n("Gemm", ["m", "k", "gb"], ["gemm"], alpha=0.5, beta=2.0),
        _n("Gemm", ["k", "m", "gb5"], ["gemm_trans"], transA=1, transB=1),
        _n("Concat", ["x", "x"], ["concat"], axis=1),
        _n("Reshape", ["x", "shp"], ["reshape_zero_minus1"]),
        _n("Transpose", ["x"], ["transpose_perm"], perm=[0, 2, 3, 1]),
        _n("Transpose", ["x"], ["transpose_default"]),
        _n("Flatten", ["x"], ["flatten"], axis=2),
        _n("Unsqueeze", ["x", "uax"], ["unsqueeze_input"]),
        _n("Unsqueeze", ["x"], ["unsqueeze_attr"], axes=[0, 5]),
        _n("Squeeze", ["unsqueeze_attr"], ["squeeze_attr"], axes=[0, 5]),
        _n("Squeeze", ["unsqueeze_input", "uax"], ["squeeze_input"]),
        _n("Identity", ["x"], ["identity"]),
        _n("Dropout", ["x"], ["dropout"]),
        _n("Cast", ["x"], ["cast_int32"], to=6),
        _n("Cast", ["x"], ["cast_float64"], to=11),
        _n("Shape", ["x"], ["shape"]),
        _n("Slice", ["shape", "h0", "h1"], ["hw"]),
        _n("Reshape", ["flatten", "shape"], ["reshape_from_shape"]),
        _n("Gather", ["x", "gidx"], ["gather_data"], axis=2),
        _n("Slice", ["x", "s0", "s1", "sax", "sst"], ["slice_steps"]),
        _n("Slice", ["x", "r0", "r1", "rax", "rst"], ["slice_negative_step"]),
        _n("Slice", ["x", "e0", "e1"], ["slice_open_end"]),
        _n("Constant", [], ["cvec"], value=np.asarray([[0.5, -1.0, 2.0, 0.25, 3.0, 1.0]] * 8, np.float32)),
        _n("ConstantOfShape", ["hw"], ["const_of_shape"], value=np.asarray([1.5], np.float32)),
        _n("Add", ["const_of_shape", "cvec"], ["constant_of_shape_plus"]),
        _n("Mul", ["x", "cvec"], ["constant_mul"]),
        _n("Pad", ["x", "pads"], ["pad_constant"], mode="constant"),
        _n("Pad", ["x", "pads", "pval"], ["pad_constant_value"]),
        _n("Pad", ["x", "pads"], ["pad_reflect"], mode="reflect"),
        _n("Pad", ["x", "pads"], ["pad_edge"], mode="edge"),
    ]
    inits = {"y": y, "m": m, "k": k, "two": np.asarray([2.0], np.float32), "gb": _r(1, 4), "gb5": _r(1, 5),
             "shp": np.asarray([0, -1, 6], np.int64), "uax": np.asarray([1, 4], np.int64),
             "gidx": np.asarray([2, 3], np.int64), "h0": np.asarray([2], np.int64), "h1": np.asarray([4], np.int64),
             "s0": np.asarray([1, 0], np.int64), "s1": np.asarray([8, 5], np.int64), "sax": np.asarray([2, 3], np.int64),
             "sst": np.asarray([2, 2], np.int64), "r0": np.asarray([-1], np.int64), "r1": np.asarray([-100], np.int64),
             "rax": np.asarray([3], np.int64), "rst": np.asarray([-2], np.int64), "e0": np.asarray([0, 2], np.int64),
             "e1": np.asarray([2**40, 5], np.int64), "pads": np.asarray([0, 0, 2, 1, 0, 1, 1, 3], np.int64),
             "pval": np.asarray([0.75], np.float32)}
    outs = ["add_broadcast", "sub", "mul", "div", "pow", "sqrt", "exp", "neg", "matmul", "gemm", "gemm_trans", "concat",
            "reshape_zero_minus1", "transpose_perm", "transpose_default", "flatten", "unsqueeze_input",
            "unsqueeze_attr", "squeeze_attr", "squeeze_input", "identity", "dropout", "cast_int32", "cast_float64",
            "reshape_from_shape", "gather_data", "slice_steps", "slice_negative_step", "slice_open_end",
            "constant_of_shape_plus", "constant_mul", "pad_constant", "pad_constant_value", "pad_reflect",
            "pad_edge"]
    return nodes, inits, {"x": x}, outs


def _family_resize():
    x = _r(1, 2, 12, 16)
    nodes = [
        _n("Resize", ["x", "", "up"], ["resize_nearest_up"], mode="nearest"),
        _n("Resize", ["x", "", "", "down_sizes"], ["resize_nearest_down"], mode="nearest"),
        _n("Resize", ["x", "", "up"], ["resize_linear_up"], mode="linear"),
        _n("Resize", ["x", "", "", "down_sizes"], ["resize_linear_down_antialias"], mode="linear"),
        _n("Resize", ["x", "", "", "odd_sizes"], ["resize_linear_odd"], mode="linear"),
        _n("Resize", ["x", "", "up"], ["resize_cubic_up_keys"], mode="cubic"),
        _n("Resize", ["x", "", "", "down_sizes"], ["resize_cubic_down_keys"], mode="cubic"),
        _n("Upsample", ["x", "up"], ["upsample_input_scales"], mode="nearest"),
        _n("Upsample", ["x"], ["upsample_attr_scales"], mode="linear", scales=[1.0, 1.0, 2.0, 1.5]),
    ]
    inits = {"up": np.asarray([1.0, 1.0, 2.0, 3.0], np.float32),
             "down_sizes": np.asarray([1, 2, 5, 7], np.int64), "odd_sizes": np.asarray([1, 2, 19, 9], np.int64)}
    outs = ["resize_nearest_up", "resize_nearest_down", "resize_linear_up", "resize_linear_down_antialias",
            "resize_linear_odd", "resize_cubic_up_keys", "resize_cubic_down_keys", "upsample_input_scales",
            "upsample_attr_scales"]
    return nodes, inits, {"x": x}, outs


FAMILIES = {"conv": _family_conv, "pool_activation": _family_pool_activation, "arith_shape": _family_arith_shape,
            "resize": _family_resize}


def _build(family):
    nodes, inits, feeds, outs = FAMILIES[family]()
    data = trt.make_model(nodes, [(k, v.shape) for k, v in feeds.items()], [(o, ()) for o in outs], inits)
    return data, feeds, outs


@pytest.fixture(scope="module")
def runs():
    """Each family through both executors, once."""
    out = {}
    for family in FAMILIES:
        data, feeds, names = _build(family)
        want = jrt.OnnxModel(data)(**feeds)
        got = trt.OnnxModel(data, device="cpu")(**feeds)
        out[family] = {n: (np.asarray(w), g.numpy()) for n, w, g in zip(names, want, got)}
    return out


CASES = [(f, o) for f in FAMILIES for o in FAMILIES[f]()[3]]


@pytest.mark.parametrize("family,output", CASES, ids=[f"{f}-{o}" for f, o in CASES])
def test_op_matches_jax(runs, family, output):
    want, got = runs[family][output]
    assert got.shape == want.shape, (got.shape, want.shape)
    if output == "cast_float64":  # float64 here, float32 in the JAX executor (no x64)
        assert got.dtype == np.float64
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), atol=ATOL, rtol=0)


def test_wire_format_bytes_and_cross_parse():
    nodes, inits, feeds, outs = _family_conv()
    attrs = _n("Constant", [], ["c"], value=np.arange(6, dtype=np.int64).reshape(2, 3), f=0.25, i=-3,
               s="text", fs=[0.5, 1.5], ints=[1, -2, 3])
    args = ([jrt.make_node("Relu", ["x"], ["y"])] + [attrs], [("x", (1, 4, 20, 22))], [("y", (1, 4, 20, 22))],
            {**inits, "i8": np.arange(4, dtype=np.int8), "u8": np.arange(3, dtype=np.uint8),
             "b": np.asarray([True, False]), "f16": np.ones(2, np.float16), "f64": np.linspace(0, 1, 3)})
    port, ref = trt.make_model(*args, graph_name="fam", opset=17), jrt.make_model(*args, graph_name="fam", opset=17)
    assert port == ref
    for parse in (trt.parse_model, jrt.parse_model):
        g = parse(port)
        assert g.name == "fam" and [n.op for n in g.nodes] == ["Relu", "Constant"]
        assert g.inputs == [("x", [1, 4, 20, 22])] and g.outputs[0][0] == "y"
        a = g.nodes[1].attrs
        assert (a["i"], a["s"], a["fs"], a["ints"]) == (-3, "text", [0.5, 1.5], [1, -2, 3])
        assert abs(a["f"] - 0.25) < 1e-12 and np.array_equal(a["value"], np.arange(6).reshape(2, 3))
        for k, v in args[3].items():
            assert g.initializers[k].dtype == v.dtype and np.array_equal(g.initializers[k], v), k
    model = _build("conv")[0]
    for a, b in zip(jrt.parse_model(model).nodes, trt.parse_model(model).nodes):
        assert (a.op, a.inputs, a.outputs, a.attrs) == (b.op, b.inputs, b.outputs, b.attrs)


def _scalar_model(x_shape) -> bytes:
    """Gather(x, k, axis=1) with k an int64 scalar TensorProto written with
    no dims, as exporters write scalars (`make_tensor` writes a 0-d array
    with dims [1], numpy's `ascontiguousarray`)."""
    k = trt._vi(2, 7) + trt._ld(8, b"k") + trt._ld(9, np.asarray(2, np.int64).tobytes())
    data = trt.make_model([_n("Gather", ["x", "k"], ["y"], axis=1)], [("x", x_shape)], [("y", (3,))])
    graph = trt._collect(data)[7][0][1] + trt._ld(5, k)
    return trt._vi(1, 8) + trt._ld(2, b"alicevision_tpu") + trt._ld(7, graph) + trt._ld(8, trt._vi(2, 13))


def test_scalar_tensor_follows_spec():
    """A TensorProto with no dims is a 0-d array (the spec); the JAX parser
    gives shape (1,) (ROADMAP §3), so a Gather by a scalar index keeps the
    gathered axis there and drops it here, as numpy does."""
    x = _r(3, 4)
    data = _scalar_model(x.shape)
    assert trt.parse_model(data).initializers["k"].shape == ()
    assert jrt.parse_model(data).initializers["k"].shape == (1,)  # the divergence
    got = trt.OnnxModel(data, device="cpu")(x).numpy()
    np.testing.assert_array_equal(got, np.take(x, np.asarray(2), axis=1))
    assert got.shape == (3,) and np.asarray(jrt.OnnxModel(data)(x)).shape == (3, 1)


@pytest.mark.parametrize("op", ["MaxPool", "AveragePool"])
def test_pool_strides_default_to_one(op):
    """Without a `strides` attribute a pool steps by 1 (the spec); the JAX
    executor steps by kernel_shape (ROADMAP §3)."""
    x = _r(1, 2, 9, 11)
    data = trt.make_model([_n(op, ["x"], ["y"], kernel_shape=[3, 2])], [("x", x.shape)], [("y", ())])
    got = trt.OnnxModel(data, device="cpu")(x).numpy()
    win = np.lib.stride_tricks.sliding_window_view(x, (3, 2), axis=(2, 3))
    want = win.max(axis=(-2, -1)) if op == "MaxPool" else win.mean(axis=(-2, -1))
    assert got.shape == (1, 2, 7, 10)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.asarray(jrt.OnnxModel(data)(x)).shape == (1, 2, 3, 5)  # the divergence


def test_shape_chains_fold_on_the_host():
    """Shape -> Gather -> Concat -> Reshape and a Resize to sizes taken from
    a Shape, as exporters write them: the port folds them on the host
    (numpy as the oracle); the JAX executor traces Gather and Concat and
    cannot fold them under jit."""
    x = _r(1, 3, 8, 6)
    nodes = [_n("Shape", ["x"], ["s"]), _n("Gather", ["s", "i"], ["hw"]), _n("Mul", ["hw", "two"], ["hw2"]),
             _n("Slice", ["s", "z", "two"], ["nc"]), _n("Concat", ["nc", "hw2"], ["sizes"], axis=0),
             _n("Resize", ["x", "", "", "sizes"], ["up"], mode="nearest"),
             _n("Concat", ["hw", "k"], ["flat_shape"], axis=0), _n("Reshape", ["x", "flat_shape"], ["y"])]
    inits = {"i": np.asarray([2, 3], np.int64), "two": np.asarray([2], np.int64), "z": np.asarray([0], np.int64),
             "k": np.asarray([-1], np.int64)}
    data = trt.make_model(nodes, [("x", x.shape)], [("up", ()), ("y", ())], inits)
    up, y = trt.OnnxModel(data, device="cpu")(x)
    np.testing.assert_array_equal(up.numpy(), x.repeat(2, axis=2).repeat(2, axis=3))
    np.testing.assert_array_equal(y.numpy(), x.reshape(8, 6, -1))


def test_unknown_op_and_data_dependent_shape_raise():
    data = trt.make_model([_n("NonexistentOp", ["x"], ["y"])], [("x", (2, 2))], [("y", (2, 2))])
    with pytest.raises(NotImplementedError, match="NonexistentOp"):
        trt.OnnxModel(data, device="cpu")(np.zeros((2, 2), np.float32))
    data = trt.make_model([_n("Cast", ["s"], ["si"], to=7), _n("Reshape", ["x", "si"], ["y"])],
                          [("x", (2, 2)), ("s", (2,))], [("y", (4,))])
    with pytest.raises(ValueError, match="data-dependent"):
        trt.OnnxModel(data, device="cpu")(np.zeros((2, 2), np.float32), np.asarray([4.0, 1.0], np.float32))


def test_weights_move_once_and_device_is_required():
    data, feeds, _ = _build("conv")
    net = trt.OnnxModel(data, device="cpu")
    before = dict(net._on_device)
    net(**feeds)
    net(**feeds)
    assert all(net._on_device[k] is v for k, v in before.items())
    assert set(before) == set(trt.parse_model(data).initializers)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trt.OnnxModel(data)


@pytest.mark.cuda
def test_card_matches_cpu(runs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs the executor on the card)")
    for family in FAMILIES:
        data, feeds, names = _build(family)
        got = trt.OnnxModel(data, device="cuda")(**feeds)
        for n, g in zip(names, got):
            assert g.is_cuda
            np.testing.assert_allclose(g.cpu().numpy().astype(np.float64), runs[family][n][1].astype(np.float64),
                                       atol=1e-4, rtol=0)
