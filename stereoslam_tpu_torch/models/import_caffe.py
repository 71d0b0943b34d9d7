"""Import the reference's trained CALC Caffe model without Caffe (port of
``stereoslam_tpu/models/import_caffe.py``).

The reference loads ``calc_model/deploy.prototxt`` + ``calc_model/calc.caffemodel``
through Caffe (reference include/myslam/deeplcd.h:33, src/deeplcd.cpp:21-29).
This module reads those files directly:

1. a minimal protobuf *wire-format* parser (no caffe.proto, no protoc) that
   extracts layer names, types, params and weight blobs from the binary
   ``.caffemodel`` (a serialized ``NetParameter``),
2. a text-format ``deploy.prototxt`` parser for the layer graph, and
3. :class:`CaffeNetRunner`, an ``nn.Module`` that evaluates the parsed net
   with Caffe's shape semantics (Convolution, ReLU, Sigmoid, TanH, Pooling
   MAX/AVE with Caffe's ceil-mode output size, InnerProduct, across-channel
   LRN, Flatten/Reshape, Dropout, Power, Input), in Caffe's own layouts.

Sections 1 and 2 are host-side numpy code, copied from the JAX package
unchanged (``tests/test_torch_copies.py`` holds them equal).  Convolutions
run as ``torch.nn.functional.conv2d`` in float32 (TF32 is off package-wide).

Typical use::

    net = CaffeNetRunner.from_files("deploy.prototxt", "calc.caffemodel")
    descr = net.descriptor(image_120x160)        # (1064,) unit-norm float32

or through the loop-closing facade::

    model = DescriptorModel.from_caffe("deploy.prototxt", "calc.caffemodel")
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# 1. Generic protobuf wire parser
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def parse_message(data) -> Dict[int, list]:
    """Parse protobuf wire format into {field_number: [raw values]}.

    Length-delimited fields are returned as ``memoryview`` (caller decides:
    nested message, string, or packed scalars); varints as int; fixed32/64 as
    raw 4/8-byte values.
    """
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    pos, end = 0, len(buf)
    fields: Dict[int, list] = {}
    while pos < end:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} (field {fnum})")
        fields.setdefault(fnum, []).append(val)
    return fields


def _packed_floats(values: list) -> np.ndarray:
    """Decode repeated float (field may be packed or repeated fixed32)."""
    chunks = []
    for v in values:
        if isinstance(v, (bytes, memoryview)):
            chunks.append(np.frombuffer(bytes(v), dtype="<f4"))
        else:  # non-packed varint can't encode float; ignore
            raise ValueError("unexpected varint in float field")
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _packed_varints(values: list) -> List[int]:
    out: List[int] = []
    for v in values:
        if isinstance(v, (bytes, memoryview)):
            buf = memoryview(v)
            pos = 0
            while pos < len(buf):
                x, pos = _read_varint(buf, pos)
                out.append(x)
        else:
            out.append(int(v))
    return out


# --- caffe.proto field numbers (NetParameter and friends) -----------------
# NetParameter: name=1, layers(V1)=2, input=3, input_dim=4, layer=100,
#               input_shape=8
# LayerParameter: name=1, type=2(str), bottom=3, top=4, blobs=7,
#   convolution_param=106, pooling_param=103, inner_product_param=117,
#   lrn_param=118
# V1LayerParameter: bottom=2, top=3, name=4, type=5(enum), blobs=6,
#   convolution_param=10, pooling_param=19, inner_product_param=17,
#   lrn_param=18
# BlobProto: num=1, channels=2, height=3, width=4, data=5, shape=7
# BlobShape: dim=1 (repeated int64)

_V1_TYPE_NAMES = {
    4: "Convolution", 18: "ReLU", 17: "Pooling", 14: "InnerProduct",
    15: "LRN", 19: "Sigmoid", 23: "TanH", 8: "Flatten", 6: "Dropout",
    5: "Data", 39: "Deconvolution", 3: "Concat", 33: "Slice",
}


def _parse_blob(raw) -> np.ndarray:
    f = parse_message(raw)
    data = _packed_floats(f.get(5, []))
    if 7 in f:  # new-style shape
        dims = _packed_varints(parse_message(f[7][0]).get(1, []))
    else:  # legacy num/channels/height/width
        dims = [int(f.get(k, [1])[0]) for k in (1, 2, 3, 4)]
        while len(dims) > 1 and dims[0] == 1:
            dims = dims[1:]
    if dims and int(np.prod(dims)) == data.size:
        return data.reshape(dims)
    return data


def _first_int(f: Dict[int, list], num: int, default: int) -> int:
    vals = _packed_varints(f.get(num, []))
    return int(vals[0]) if vals else default


def _spatial_pair(f: Dict[int, list], square_num: int, h_num: int, w_num: int,
                  default: int) -> Tuple[int, int]:
    """Caffe params come as repeated square values or explicit _h/_w."""
    sq = _packed_varints(f.get(square_num, []))
    if sq:
        if len(sq) == 1:
            return int(sq[0]), int(sq[0])
        return int(sq[0]), int(sq[1])
    h = _first_int(f, h_num, default)
    w = _first_int(f, w_num, default)
    return h, w


@dataclass
class LayerSpec:
    name: str
    type: str
    bottoms: List[str] = field(default_factory=list)
    tops: List[str] = field(default_factory=list)
    blobs: List[np.ndarray] = field(default_factory=list)
    # Convolution / Pooling geometry
    num_output: int = 0
    kernel: Tuple[int, int] = (0, 0)
    stride: Tuple[int, int] = (1, 1)
    pad: Tuple[int, int] = (0, 0)
    pool_method: int = 0      # 0 MAX, 1 AVE
    global_pooling: bool = False
    bias_term: bool = True
    # LRN
    lrn_local_size: int = 5
    lrn_alpha: float = 1.0
    lrn_beta: float = 0.75


def _parse_layer(raw, v1: bool) -> LayerSpec:
    f = parse_message(raw)
    if v1:
        name = bytes(f.get(4, [b""])[0]).decode()
        type_enum = _first_int(f, 5, 0)
        ltype = _V1_TYPE_NAMES.get(type_enum, f"V1_{type_enum}")
        bottoms = [bytes(x).decode() for x in f.get(2, [])]
        tops = [bytes(x).decode() for x in f.get(3, [])]
        blobs = [_parse_blob(x) for x in f.get(6, [])]
        conv_f, pool_f, ip_f, lrn_f = 10, 19, 17, 18
    else:
        name = bytes(f.get(1, [b""])[0]).decode()
        ltype = bytes(f.get(2, [b""])[0]).decode()
        bottoms = [bytes(x).decode() for x in f.get(3, [])]
        tops = [bytes(x).decode() for x in f.get(4, [])]
        blobs = [_parse_blob(x) for x in f.get(7, [])]
        conv_f, pool_f, ip_f, lrn_f = 106, 103, 117, 118

    spec = LayerSpec(name=name, type=ltype, bottoms=bottoms, tops=tops, blobs=blobs)

    if ltype in ("Convolution", "Deconvolution") and conv_f in f:
        c = parse_message(f[conv_f][0])
        # ConvolutionParameter: num_output=1, bias_term=2, pad=3, kernel_size=4,
        # stride=6, pad_h=9, pad_w=10, kernel_h=11, kernel_w=12, stride_h=13,
        # stride_w=14
        spec.num_output = _first_int(c, 1, 0)
        spec.bias_term = bool(_first_int(c, 2, 1))
        spec.pad = _spatial_pair(c, 3, 9, 10, 0)
        spec.kernel = _spatial_pair(c, 4, 11, 12, 0)
        spec.stride = _spatial_pair(c, 6, 13, 14, 1)
    elif ltype == "Pooling" and pool_f in f:
        p = parse_message(f[pool_f][0])
        # PoolingParameter: pool=1, kernel_size=2, stride=3, pad=4, kernel_h=5,
        # kernel_w=6, stride_h=7, stride_w=8, pad_h=9, pad_w=10,
        # global_pooling=12
        spec.pool_method = _first_int(p, 1, 0)
        spec.kernel = _spatial_pair(p, 2, 5, 6, 0)
        spec.stride = _spatial_pair(p, 3, 7, 8, 1)
        spec.pad = _spatial_pair(p, 4, 9, 10, 0)
        spec.global_pooling = bool(_first_int(p, 12, 0))
    elif ltype == "InnerProduct" and ip_f in f:
        i = parse_message(f[ip_f][0])
        spec.num_output = _first_int(i, 1, 0)
        spec.bias_term = bool(_first_int(i, 2, 1))
    elif ltype == "LRN" and lrn_f in f:
        l = parse_message(f[lrn_f][0])
        spec.lrn_local_size = _first_int(l, 1, 5)
        if 2 in l:
            spec.lrn_alpha = struct.unpack("<f", bytes(l[2][0]))[0]
        if 3 in l:
            spec.lrn_beta = struct.unpack("<f", bytes(l[3][0]))[0]
    return spec


@dataclass
class CaffeNet:
    name: str
    inputs: List[str]
    input_shape: List[int]              # NCHW
    layers: List[LayerSpec]


def load_caffemodel(path: str) -> CaffeNet:
    """Parse a binary ``.caffemodel`` (serialized NetParameter)."""
    with open(path, "rb") as fh:
        data = fh.read()
    f = parse_message(data)
    name = bytes(f.get(1, [b""])[0]).decode()
    inputs = [bytes(x).decode() for x in f.get(3, [])]
    input_dim = _packed_varints(f.get(4, []))
    if 8 in f:
        input_dim = _packed_varints(parse_message(f[8][0]).get(1, []))
    layers = [_parse_layer(x, v1=False) for x in f.get(100, [])]
    layers += [_parse_layer(x, v1=True) for x in f.get(2, [])]
    return CaffeNet(name=name, inputs=inputs, input_shape=list(input_dim), layers=layers)


# ---------------------------------------------------------------------------
# 2. deploy.prototxt (protobuf text format) parser
# ---------------------------------------------------------------------------


def _tokenize_prototxt(text: str) -> List[str]:
    out: List[str] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        line = line.replace("{", " { ").replace("}", " } ").replace(":", ": ")
        out.extend(line.split())
    return out


def _parse_block(tokens: List[str], pos: int) -> Tuple[dict, int]:
    """Parse tokens into nested {key: [values-or-dicts]} until '}' or end."""
    obj: dict = {}
    while pos < len(tokens):
        tok = tokens[pos]
        if tok == "}":
            return obj, pos + 1
        key = tok.rstrip(":")
        pos += 1
        if pos < len(tokens) and tokens[pos] == "{":
            sub, pos = _parse_block(tokens, pos + 1)
            obj.setdefault(key, []).append(sub)
        else:
            val = tokens[pos]
            pos += 1
            obj.setdefault(key, []).append(val.strip('"'))
    return obj, pos


def parse_prototxt(path: str) -> dict:
    with open(path) as fh:
        tokens = _tokenize_prototxt(fh.read())
    obj, _ = _parse_block(tokens, 0)
    return obj


def _proto_int(d: dict, key: str, default: int) -> int:
    return int(d[key][0]) if key in d else default


def _proto_pair(d: dict, key: str, default: int) -> Tuple[int, int]:
    if key in d:
        vals = [int(v) for v in d[key]]
        return (vals[0], vals[0]) if len(vals) == 1 else (vals[0], vals[1])
    h = _proto_int(d, key + "_h", default)
    w = _proto_int(d, key + "_w", default)
    return h, w


def _spec_from_prototxt(layer: dict) -> LayerSpec:
    spec = LayerSpec(
        name=layer.get("name", [""])[0],
        type=layer.get("type", [""])[0],
        bottoms=list(layer.get("bottom", [])),
        tops=list(layer.get("top", [])),
    )
    if spec.type.isupper() and spec.type not in ("LRN", "RELU", "TANH"):
        # old text files may use enum-style types e.g. CONVOLUTION
        spec.type = spec.type.capitalize()
    if "convolution_param" in layer:
        c = layer["convolution_param"][0]
        spec.num_output = _proto_int(c, "num_output", 0)
        spec.kernel = _proto_pair(c, "kernel_size", 0)
        spec.stride = _proto_pair(c, "stride", 1)
        spec.pad = _proto_pair(c, "pad", 0)
        spec.bias_term = c.get("bias_term", ["true"])[0] != "false"
    if "pooling_param" in layer:
        p = layer["pooling_param"][0]
        spec.pool_method = {"MAX": 0, "AVE": 1, "0": 0, "1": 1}.get(
            p.get("pool", ["MAX"])[0], 0
        )
        spec.kernel = _proto_pair(p, "kernel_size", 0)
        spec.stride = _proto_pair(p, "stride", 1)
        spec.pad = _proto_pair(p, "pad", 0)
        spec.global_pooling = p.get("global_pooling", ["false"])[0] == "true"
    if "inner_product_param" in layer:
        i = layer["inner_product_param"][0]
        spec.num_output = _proto_int(i, "num_output", 0)
        spec.bias_term = i.get("bias_term", ["true"])[0] != "false"
    if "lrn_param" in layer:
        l = layer["lrn_param"][0]
        spec.lrn_local_size = _proto_int(l, "local_size", 5)
        spec.lrn_alpha = float(l.get("alpha", ["1.0"])[0])
        spec.lrn_beta = float(l.get("beta", ["0.75"])[0])
    return spec


def load_prototxt_net(path: str) -> CaffeNet:
    obj = parse_prototxt(path)
    name = obj.get("name", [""])[0]
    inputs = list(obj.get("input", []))
    if "input_shape" in obj:
        shape = [int(d) for d in obj["input_shape"][0].get("dim", [])]
    else:
        shape = [int(d) for d in obj.get("input_dim", [])]
    layers = [_spec_from_prototxt(l) for l in obj.get("layer", obj.get("layers", []))]
    return CaffeNet(name=name, inputs=inputs, input_shape=shape, layers=layers)


# ---------------------------------------------------------------------------
# 3. Forward evaluator with Caffe shape semantics
# ---------------------------------------------------------------------------


def _caffe_pool_out(in_sz: int, k: int, s: int, p: int) -> int:
    """Caffe pooling output size: ceil mode, clipped so the last window
    starts inside the padded input (caffe pooling_layer.cpp)."""
    out = int(math.ceil((in_sz + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= in_sz + p:
        out -= 1
    return out


class CaffeNetRunner(nn.Module):
    """Forward evaluation of a parsed Caffe net.

    Weights stay in Caffe's native layouts (conv: OIHW; InnerProduct:
    (out, in) over the NCHW-flattened input) as buffers of the module, so
    ``.to(device)`` moves them, and evaluation runs in NCHW: every blob is
    in Caffe's order, and the flattened descriptor blob is directly
    comparable to the reference's (reference src/deeplcd.cpp:80-90 copies
    the blob and L2-normalizes it).  Unsupported layer types raise
    ``NotImplementedError`` at construction.
    """

    SUPPORTED = {
        "Convolution", "ReLU", "Sigmoid", "TanH", "Pooling", "InnerProduct",
        "LRN", "Flatten", "Dropout", "Reshape", "Power", "Input",
    }

    def __init__(self, net: CaffeNet, weights: Optional[CaffeNet] = None):
        super().__init__()
        self.net = net
        if weights is not None:
            by_name = {l.name: l for l in weights.layers}
            for l in self.net.layers:
                if l.name in by_name and by_name[l.name].blobs:
                    l.blobs = by_name[l.name].blobs
        if not self.net.inputs:
            # allow nets whose input comes as an "Input" layer
            for l in self.net.layers:
                if l.type == "Input" and l.tops:
                    self.net.inputs = [l.tops[0]]
        if not self.net.input_shape and weights is not None and weights.input_shape:
            self.net.input_shape = weights.input_shape
        unsupported = [l.type for l in self.net.layers if l.type not in self.SUPPORTED]
        if unsupported:
            raise NotImplementedError(
                f"caffe layer types not supported: {sorted(set(unsupported))}")
        for i, spec in enumerate(self.net.layers):
            for j, blob in enumerate(spec.blobs):
                self.register_buffer(f"blob_{i}_{j}",
                                     torch.from_numpy(np.array(blob, dtype=np.float32)))

    @classmethod
    def from_files(cls, prototxt: str, caffemodel: str) -> "CaffeNetRunner":
        return cls(load_prototxt_net(prototxt), load_caffemodel(caffemodel))

    def _blob(self, i: int, j: int) -> torch.Tensor:
        return getattr(self, f"blob_{i}_{j}")

    # -- single-layer forward ------------------------------------------------
    def _layer_forward(self, i: int, spec: LayerSpec, x: torch.Tensor) -> torch.Tensor:
        t = spec.type
        has_bias = spec.bias_term and len(spec.blobs) > 1
        if t == "ReLU":
            return torch.clamp(x, min=0.0)
        if t == "Sigmoid":
            return torch.sigmoid(x)
        if t == "TanH":
            return torch.tanh(x)
        if t in ("Dropout", "Input", "Power"):
            return x  # deploy-time identity (Power with defaults)
        if t in ("Flatten", "Reshape"):
            return x.reshape(x.shape[0], -1)
        if t == "Convolution":
            return F.conv2d(x, self._blob(i, 0), self._blob(i, 1).reshape(-1) if has_bias else None,
                            stride=spec.stride, padding=spec.pad)
        if t == "Pooling":
            if spec.global_pooling:
                return (torch.amax(x, dim=(2, 3), keepdim=True) if spec.pool_method == 0
                        else x.mean(dim=(2, 3), keepdim=True))
            h, w = x.shape[-2:]
            (kh, kw), (sh, sw), (ph, pw) = spec.kernel, spec.stride, spec.pad
            oh = _caffe_pool_out(h, kh, sh, ph)
            ow = _caffe_pool_out(w, kw, sw, pw)
            # pad enough on the high side for ceil-mode windows
            hi_h = max(0, (oh - 1) * sh + kh - h - ph)
            hi_w = max(0, (ow - 1) * sw + kw - w - pw)
            if spec.pool_method == 0:  # MAX: pad with -inf
                xp = F.pad(x, (pw, hi_w, ph, hi_h), value=-math.inf)
                y = F.max_pool2d(xp, (kh, kw), (sh, sw))
            else:  # AVE: caffe divides by the kernel area, zero padding included
                xp = F.pad(x, (pw, hi_w, ph, hi_h))
                y = F.avg_pool2d(xp, (kh, kw), (sh, sw))
            return y[:, :, :oh, :ow]
        if t == "InnerProduct":
            W = self._blob(i, 0)
            y = x.reshape(x.shape[0], -1) @ W.reshape(W.shape[0], -1).T
            if has_bias:
                y = y + self._blob(i, 1).reshape(1, -1)
            return y
        if t == "LRN":
            # across-channel LRN: x / (1 + alpha/n * sum(x^2 over window))^beta
            n = spec.lrn_local_size
            sqp = F.pad(x * x, (0, 0, 0, 0, n // 2, n // 2))
            c = x.shape[1]
            ssum = sum(sqp[:, k:k + c] for k in range(n))
            return x / (1.0 + spec.lrn_alpha / n * ssum) ** spec.lrn_beta
        raise NotImplementedError(t)

    # -- whole-net forward ---------------------------------------------------
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Run the net on an NCHW input ((H, W) and (N, H, W) are widened);
        returns every named blob."""
        if x.dim() == 2:
            x = x[None, None]
        elif x.dim() == 3:
            x = x[:, None]
        x = x.to(torch.float32)
        blobs: Dict[str, torch.Tensor] = {}
        if self.net.inputs:
            blobs[self.net.inputs[0]] = x
        for i, spec in enumerate(self.net.layers):
            if spec.type == "Input":
                blobs[spec.tops[0]] = x
                continue
            inp = blobs[spec.bottoms[0]] if spec.bottoms else x
            blobs[spec.tops[0] if spec.tops else spec.name] = self._layer_forward(i, spec, inp)
        return blobs

    def descriptor(self, img: torch.Tensor) -> torch.Tensor:
        """L2-normalized descriptor (deeplcd.cpp:80-91) of a preprocessed
        image ((120, 160) float in [0, 1], or a batch): the ``descriptor``
        blob, else the last blob produced, flattened."""
        squeeze = img.dim() == 2
        with torch.no_grad():
            blobs = self.forward(img)
            last = self.net.layers[-1]
            d = blobs["descriptor"] if "descriptor" in blobs else blobs[(last.tops or [last.name])[0]]
            d = d.reshape(d.shape[0], -1).to(torch.float32)
            d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
        return d[0] if squeeze else d
