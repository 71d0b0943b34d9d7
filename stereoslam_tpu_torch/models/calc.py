"""Whole-image loop-closure descriptors, the "DeepLCD" role (port of
``stereoslam_tpu/models/calc.py``; reference src/deeplcd.cpp:43-91: blur,
resize to 160x120, forward pass, 1064-d L2-normalized descriptor, dot-product
similarity).

- :class:`CalcEncoder`: the CALC-style convolutional encoder as an
  ``nn.Module``, for trained weights (the JAX package's shipped
  ``calc_weights.npz`` loads through :func:`load_params_npz`).
- :func:`hog_descriptor`: the deterministic HOG -> fixed random projection
  (numpy seed 893741) with the same interface, dimension and metric.

Both give unit-norm (1064,) float32 vectors.  They run in float32; the
package pins TF32 off for matmuls and cuDNN, because the 0.94/0.92 decision
thresholds sit about 0.01 from the revisit similarities.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoslam_tpu_torch.ops.image import gaussian_blur, resize_bilinear

DESCRIPTOR_DIM = 1064
INPUT_HW = (120, 160)  # rows, cols — deeplcd.cpp:50 resizes to (160, 120) WxH

# The JAX package's trained weights (f16 npz, flattened "params/<layer>/<name>"
# keys), read by path: the port carries no copy of the file.
DEFAULT_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "stereoslam_tpu", "models", "calc_weights.npz")


def preprocess(img: torch.Tensor) -> torch.Tensor:
    """Anti-aliased blur (sigma = the per-axis downscale factor) + resize to
    the CALC input size, scaled to [0, 1]."""
    h, w = img.shape[-2:]
    sy, sx = max(1.0, h / INPUT_HW[0]), max(1.0, w / INPUT_HW[1])
    img = gaussian_blur(img, sigma=sy, radius=int(math.ceil(2.5 * sy)),
                        sigma_x=sx, radius_x=int(math.ceil(2.5 * sx)))
    return resize_bilinear(img, INPUT_HW) / 255.0


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax 'SAME' padding of an NCHW tensor: out = ceil(n / s), and the
    total padding splits with the smaller half before (asymmetric at s = 2)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


# The std of a unit normal truncated to [-2, 2]: Flax's ``lecun_normal``
# divides by it so that the truncated draw keeps variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax's default kernel init in place: a normal truncated at two of its
    standard deviations, with std ``1 / sqrt(fan_in) / 0.8796`` (so the
    values' own std is ``1 / sqrt(fan_in)``), drawn on the CPU from
    ``generator`` so that a seed gives the same weights on any device."""
    draw = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        weight.copy_(draw * (1.0 / math.sqrt(fan_in) / _TRUNC_STD))
    return weight


def _out_hw(hw: Tuple[int, int]) -> Tuple[int, int]:
    """Spatial size after the two stride-2 'SAME' convolutions."""
    def half(n: int) -> int:
        return -(-n // 2)
    return tuple(half(half(n)) for n in hw)


class CalcEncoder(nn.Module):
    """conv1(64, 5x5, s2) -> relu -> conv2(128, 4x4, s2) -> relu ->
    conv3(4, 3x3, s1) -> NHWC flatten -> proj(1064, no bias) -> L2 norm.
    ``input_hw`` fixes the projection's input width (4800 at 120x160)."""

    def __init__(self, input_hw: Tuple[int, int] = INPUT_HW):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 5, stride=2)
        self.conv2 = nn.Conv2d(64, 128, 4, stride=2)
        self.conv3 = nn.Conv2d(128, 4, 3, stride=1)
        oh, ow = _out_hw(input_hw)
        self.proj = nn.Linear(oh * ow * 4, DESCRIPTOR_DIM, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "CalcEncoder":
        """Flax's init of the same module: ``lecun_normal`` kernels (fan-in
        kh * kw * in for a convolution), zero biases; layers drawn in order."""
        for conv in (self.conv1, self.conv2, self.conv3):
            lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
            nn.init.zeros_(conv.bias)
        lecun_normal_(self.proj.weight, self.proj.in_features, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(H, W) or (B, H, W) float32 -> (1064,) or (B, 1064) unit vectors."""
        squeeze = x.dim() == 2
        x = (x[None] if squeeze else x)[:, None].to(torch.float32)
        x = F.relu(self.conv1(_same_pad(x, 5, 2)))
        x = F.relu(self.conv2(_same_pad(x, 4, 2)))
        x = self.conv3(_same_pad(x, 3, 1))
        x = self.proj(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-8)
        return x[0] if squeeze else x


# ---------------------------------------------------------------------------
# Deterministic HOG-projection descriptor
# ---------------------------------------------------------------------------

_N_BINS = 8
_POOL = 8    # pooled grid: 8 x 10 cells over the 120x160 input
_SMOOTH_SIGMA = 6.0  # orientation-channel smoothing (px) — viewpoint tolerance


@functools.lru_cache(maxsize=1)
def _projection_matrix() -> np.ndarray:
    """Fixed random projection (640 -> 1064), JL-style."""
    hog_dim = _POOL * (_POOL * INPUT_HW[1] // INPUT_HW[0]) * _N_BINS
    rng = np.random.default_rng(893741)
    P = rng.standard_normal((hog_dim, DESCRIPTOR_DIM)).astype(np.float32)
    P /= math.sqrt(hog_dim)
    return P


@functools.lru_cache(maxsize=4)
def _projection_on(device: torch.device) -> torch.Tensor:
    """The projection, copied to a device once."""
    return torch.from_numpy(_projection_matrix()).to(device)


def hog_features(img_pre: torch.Tensor) -> torch.Tensor:
    """Smoothed orientation-channel HOG over the (120, 160) input: gradient
    energy soft-assigned to 8 unsigned-orientation channels, each channel
    Gaussian-smoothed, average-pooled to 8x10 cells, L2-normalized per cell.
    Returns the (640,) feature in (cell row, cell column, bin) order; leading
    dims of ``img_pre`` are a batch."""
    h, w = img_pre.shape[-2:]
    lead = img_pre.shape[:-2]
    zc = torch.zeros_like(img_pre[..., :1])
    zr = torch.zeros_like(img_pre[..., :1, :])
    gx = torch.cat([zc, (img_pre[..., 2:] - img_pre[..., :-2]) * 0.5, zc], dim=-1)
    gy = torch.cat([zr, (img_pre[..., 2:, :] - img_pre[..., :-2, :]) * 0.5, zr], dim=-2)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ang = torch.remainder(torch.atan2(gy, gx), math.pi)       # unsigned, [0, pi)
    pos = ang / math.pi * _N_BINS
    fl = torch.floor(pos)
    b0 = fl.long() % _N_BINS
    b1 = (b0 + 1) % _N_BINS
    w1 = pos - fl
    bins = torch.arange(_N_BINS, device=img_pre.device)
    channels = mag[..., None] * ((b0[..., None] == bins) * (1.0 - w1)[..., None]
                                 + (b1[..., None] == bins) * w1[..., None])
    smoothed = gaussian_blur(channels.movedim(-1, -3), sigma=_SMOOTH_SIGMA, radius=9)
    ch, cw = _POOL, _POOL * w // h
    ph, pw = h // ch, w // cw
    pooled = smoothed[..., : ch * ph, : cw * pw].reshape(
        lead + (_N_BINS, ch, ph, cw, pw)).mean(dim=(-3, -1))
    pooled = pooled.movedim(-3, -1)                             # (..., ch, cw, bins)
    pooled = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-6)
    return pooled.reshape(lead + (-1,))


def hog_descriptor(img: torch.Tensor) -> torch.Tensor:
    """Deterministic 1064-d unit-norm whole-image descriptor."""
    d = hog_features(preprocess(img)) @ _projection_on(img.device)
    return d / torch.clamp(torch.linalg.norm(d), min=1e-8)


def similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot-product similarity (deeplcd.cpp:35-39)."""
    return (a * b).sum(-1)


def load_params_npz(path: str) -> dict:
    """A Flax-layout variables dict (nested, float32 numpy leaves) from a
    flat "a/b/kernel" npz such as the JAX package's ``calc_weights.npz``."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key].astype(np.float32)
    return out


def save_params_npz(path: str, params: dict) -> None:
    """Write a Flax-layout variables dict (nested, numpy or torch leaves) as
    the flat "a/b/kernel" float16 npz that both packages' ``load_params_npz``
    read (the layout of the shipped ``calc_weights.npz``)."""
    flat: dict = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                flat["/".join(prefix + (k,))] = np.asarray(v, np.float16)

    walk(params, ())
    np.savez_compressed(path, **flat)


@functools.lru_cache(maxsize=1)
def load_default_params() -> Optional[dict]:
    """The shipped trained CALC weights, or None where the file is absent."""
    return load_params_npz(DEFAULT_WEIGHTS) if os.path.exists(DEFAULT_WEIGHTS) else None


class DescriptorModel:
    """The whole-image descriptor of the loop closer:

    - ``params``: a Flax-layout variables dict, for the trained
      :class:`CalcEncoder`;
    - ``caffe_net``: a :class:`~stereoslam_tpu_torch.models.import_caffe.CaffeNetRunner`
      (use :meth:`from_caffe`), the reference's own deploy.prototxt /
      calc.caffemodel imported without Caffe;
    - neither: the deterministic HOG projection.

    :meth:`default` is what the pipeline ships: the JAX package's trained
    weights when present, else HOG.  The network follows the device of the
    image it is called on."""

    def __init__(self, params: Optional[dict] = None, caffe_net=None):
        self.params = params
        self._caffe = caffe_net
        self._encoder = None
        if params is not None:
            from stereoslam_tpu_torch.bridge import calc_params_from_flax

            self._encoder = CalcEncoder().eval()
            self._encoder.load_state_dict(calc_params_from_flax(params))

    @classmethod
    def default(cls) -> "DescriptorModel":
        return cls(params=load_default_params())

    @classmethod
    def from_caffe(cls, prototxt: str, caffemodel: str) -> "DescriptorModel":
        """The reference's trained CALC model files, read directly
        (reference deeplcd.h:33); a missing file raises ``FileNotFoundError``."""
        from stereoslam_tpu_torch.models.import_caffe import CaffeNetRunner

        return cls(caffe_net=CaffeNetRunner.from_files(prototxt, caffemodel).eval())

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if self._caffe is not None:
            if next(self._caffe.buffers(), img).device != img.device:
                self._caffe = self._caffe.to(img.device)
            return self._caffe.descriptor(preprocess(img))
        if self._encoder is None:
            return hog_descriptor(img)
        if self._encoder.proj.weight.device != img.device:
            self._encoder = self._encoder.to(img.device)
        with torch.no_grad():
            return self._encoder(preprocess(img))
