"""Caffe model files written by hand, for the importer's tests and for
``chip_smoke.py``'s Caffe checks: a minimal protobuf wire-format writer (no
protobuf library; the writer of tests/test_import_caffe.py), the tiny net of
that test, and a CALC-shaped net made from a seed.

Numpy only: ``chip_smoke.py`` loads this file by path on a machine without
JAX.

The CALC-shaped net has the layer types of the reference's CALC model
(reference deeplcd.h:33): a 1x1x120x160 input, Convolution, ReLU, Pooling
(MAX, Caffe's ceil mode) and across-channel LRN layers, and a last blob of
4 x 14 x 19 = 1064 values, the reference's descriptor length.
"""

import os
import struct

import numpy as np

# --- minimal protobuf writer -------------------------------------------------


def _varint(x: int) -> bytes:
    out = b""
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint((fnum << 3) | wtype)


def _ld(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _vint(fnum: int, val: int) -> bytes:
    return _tag(fnum, 0) + _varint(val)


def _f32(fnum: int, val: float) -> bytes:
    return _tag(fnum, 5) + struct.pack("<f", val)


def _string(fnum: int, s: str) -> bytes:
    return _ld(fnum, s.encode())


def _blob(arr: np.ndarray) -> bytes:
    shape = b"".join(_vint(1, d) for d in arr.shape)
    data = _tag(5, 2) + _varint(arr.size * 4) + arr.astype("<f4").tobytes()
    return _ld(7, shape) + data


def _layer(name, ltype, bottom, top, payload=b""):
    return _ld(100, _string(1, name) + _string(2, ltype) + _string(3, bottom) + _string(4, top)
               + payload)


def _conv_layer(name, bottom, top, W, b, stride=1, pad=0):
    conv_param = _vint(1, W.shape[0]) + _vint(4, W.shape[2]) + _vint(6, stride)
    if pad:
        conv_param += _vint(3, pad)
    return _layer(name, "Convolution", bottom, top,
                  _ld(7, _blob(W)) + _ld(7, _blob(b)) + _ld(106, conv_param))


def _relu_layer(name, bottom, top):
    return _layer(name, "ReLU", bottom, top)


def _pool_layer(name, bottom, top, k, s, method=0, pad=0, global_pooling=False):
    param = _vint(1, method) + _vint(2, k) + _vint(3, s)
    param += (_vint(4, pad) if pad else b"") + (_vint(12, 1) if global_pooling else b"")
    return _layer(name, "Pooling", bottom, top, _ld(103, param))


def _ip_layer(name, bottom, top, W, b):
    return _layer(name, "InnerProduct", bottom, top,
                  _ld(7, _blob(W)) + _ld(7, _blob(b)) + _ld(117, _vint(1, W.shape[0])))


def _lrn_layer(name, bottom, top, local_size, alpha, beta):
    return _layer(name, "LRN", bottom, top, _ld(118, _vint(1, local_size) + _f32(2, alpha)
                                                + _f32(3, beta)))


# --- the tiny net of tests/test_import_caffe.py ------------------------------


def tiny_net(rng):
    """(caffemodel bytes, (conv W, conv b, ip W, ip b), an (8, 10) input)."""
    H, W_ = 8, 10
    Wc = rng.standard_normal((2, 1, 3, 3)).astype(np.float32)
    bc = rng.standard_normal(2).astype(np.float32)
    # after conv s2 p1: 4x5; after pool k2 s2 (ceil): 2x3
    Wip = rng.standard_normal((5, 2 * 2 * 3)).astype(np.float32)
    bip = rng.standard_normal(5).astype(np.float32)
    net_bytes = (
        _string(1, "tiny")
        + _string(3, "X")
        + b"".join(_vint(4, d) for d in (1, 1, H, W_))
        + _conv_layer("conv1", "X", "conv1", Wc, bc, stride=2, pad=1)
        + _relu_layer("relu1", "conv1", "conv1r")
        + _pool_layer("pool1", "conv1r", "pool1", k=2, s=2)
        + _ip_layer("descr", "pool1", "descriptor", Wip, bip)
    )
    x = rng.standard_normal((H, W_)).astype(np.float32)
    return net_bytes, (Wc, bc, Wip, bip), x


TINY_PROTOTXT = """
name: "tiny"
input: "X"
input_shape { dim: 1 dim: 1 dim: 8 dim: 10 }
layer {
  name: "conv1"
  type: "Convolution"
  bottom: "X"
  top: "conv1"
  convolution_param { num_output: 2 kernel_size: 3 stride: 2 pad: 1 }
}
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1r" }
layer {
  name: "pool1"
  type: "Pooling"
  bottom: "conv1r"
  top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 }
}
layer {
  name: "descr"
  type: "InnerProduct"
  bottom: "pool1"
  top: "descriptor"
  inner_product_param { num_output: 5 }
}
"""

# --- a CALC-shaped net --------------------------------------------------------

# (name, type, bottom, top, params): 120x160 -> conv1 k5 s2 58x78 -> pool1
# k3 s2 29x39 -> conv2 k4 s1 p1 28x38 -> pool2 k3 s2 14x19 -> conv3 k3 s1 p1
# 4x14x19 = 1064.
CALC_LAYERS = (
    ("conv1", "Convolution", "data", "conv1", dict(num_output=64, kernel_size=5, stride=2, pad=0)),
    ("relu1", "ReLU", "conv1", "conv1", {}),
    ("pool1", "Pooling", "conv1", "pool1", dict(pool=0, kernel_size=3, stride=2)),
    ("norm1", "LRN", "pool1", "norm1", dict(local_size=5, alpha=1e-4, beta=0.75)),
    ("conv2", "Convolution", "norm1", "conv2", dict(num_output=128, kernel_size=4, stride=1, pad=1)),
    ("relu2", "ReLU", "conv2", "conv2", {}),
    ("pool2", "Pooling", "conv2", "pool2", dict(pool=0, kernel_size=3, stride=2)),
    ("norm2", "LRN", "pool2", "norm2", dict(local_size=5, alpha=1e-4, beta=0.75)),
    ("conv3", "Convolution", "norm2", "conv3", dict(num_output=4, kernel_size=3, stride=1, pad=1)),
    ("flat", "Flatten", "conv3", "descriptor", {}),
)
CALC_INPUT = (1, 1, 120, 160)


def calc_shaped_net(seed: int):
    """(caffemodel bytes, deploy.prototxt text) of the CALC-shaped net with
    weights drawn from ``seed`` (He-scaled normal, small biases)."""
    rng = np.random.default_rng(seed)
    body = [_string(1, "calc_shaped"), _string(3, "data"),
            _ld(8, b"".join(_vint(1, d) for d in CALC_INPUT))]
    text = ['name: "calc_shaped"', 'input: "data"',
            "input_shape { " + " ".join(f"dim: {d}" for d in CALC_INPUT) + " }"]
    c_in = 1
    for name, ltype, bottom, top, p in CALC_LAYERS:
        head = f'layer {{ name: "{name}" type: "{ltype}" bottom: "{bottom}" top: "{top}"'
        if ltype == "Convolution":
            k, o = p["kernel_size"], p["num_output"]
            W = (rng.standard_normal((o, c_in, k, k)) * np.sqrt(2.0 / (c_in * k * k))
                 ).astype(np.float32)
            b = (0.01 * rng.standard_normal(o)).astype(np.float32)
            body.append(_conv_layer(name, bottom, top, W, b, stride=p["stride"], pad=p["pad"]))
            text.append(f"{head} convolution_param {{ num_output: {o} kernel_size: {k} "
                        f"stride: {p['stride']} pad: {p['pad']} }} }}")
            c_in = o
        elif ltype == "Pooling":
            body.append(_pool_layer(name, bottom, top, p["kernel_size"], p["stride"], p["pool"]))
            text.append(f"{head} pooling_param {{ pool: MAX kernel_size: {p['kernel_size']} "
                        f"stride: {p['stride']} }} }}")
        elif ltype == "LRN":
            body.append(_lrn_layer(name, bottom, top, p["local_size"], p["alpha"], p["beta"]))
            text.append(f"{head} lrn_param {{ local_size: {p['local_size']} alpha: {p['alpha']} "
                        f"beta: {p['beta']} }} }}")
        else:
            body.append(_layer(name, ltype, bottom, top))
            text.append(head + " }")
    return b"".join(body), "\n".join(text) + "\n"


def write_calc_shaped(directory: str, seed: int):
    """Write the CALC-shaped net's deploy.prototxt and calc.caffemodel into
    ``directory``; returns their paths."""
    net_bytes, text = calc_shaped_net(seed)
    proto, model = (os.path.join(directory, f) for f in ("deploy.prototxt", "calc.caffemodel"))
    with open(proto, "w") as fh:
        fh.write(text)
    with open(model, "wb") as fh:
        fh.write(net_bytes)
    return proto, model
