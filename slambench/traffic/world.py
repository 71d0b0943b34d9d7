"""The ray-cast city circuit: a frozen copy of the renderer of
``stereoslam_tpu_torch/utils/world.py`` (scene, texture, sensor noise, the
rounded-rectangle centerline and its corner speed profile), the benchmark's
traffic generator.  A closed city-block circuit of textured building
facades over a textured ground plane, rendered on the card in batches of
frames, with exact ground-truth poses.

The texture hash and the sensor noise are integer arithmetic on uint32
values held in int64 tensors masked to 32 bits; the noise is
``jax.random.normal``'s Threefry-2x32 draw with XLA's single-precision
``erfinv``, so a frame is the same on every device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF


class Quads(NamedTuple):
    """A batch of textured rectangles (the whole scene geometry), host numpy."""

    p0: np.ndarray        # (Q, 3) f32 corner (world)
    eu: np.ndarray        # (Q, 3) f32 first edge vector (length = width, m)
    ev: np.ndarray        # (Q, 3) f32 second edge vector (length = height, m)
    salt: np.ndarray      # (Q,) uint32 texture seed
    base: np.ndarray      # (Q,) f32 base brightness (0..255)
    contrast: np.ndarray  # (Q,) f32 fbm contrast amplitude
    blotch: np.ndarray    # (Q,) f32 blotch contrast amplitude
    freq: np.ndarray      # (Q,) f32 fbm base frequency (cycles/m)
    bfreq: np.ndarray     # (Q,) f32 blotch frequency (cycles/m)


@dataclasses.dataclass
class WorldScene:
    quads: Quads
    # Trajectory support (host side)
    centerline: np.ndarray    # (S, 2) path points (x, z)
    perimeter: float


# ---------------------------------------------------------------------------
# Procedural texture (hash noise, analytic anti-aliasing)
# ---------------------------------------------------------------------------


def _signed(c: int) -> int:
    """A uint32 constant as the int64 value congruent to it mod 2**32 with
    the least magnitude (< 2**31): ``x * _signed(c)`` cannot overflow for any
    uint32 ``x``, and its low 32 bits are those of ``x * c``."""
    return c - (1 << 32) if c >= (1 << 31) else c


_H_IX, _H_IY, _H_SALT = _signed(0x9E3779B1), _signed(0x85EBCA77), _signed(0xC2B2AE3D)
_H_MIX1, _H_MIX2 = 0x2C1B3C6D, 0x297A2D39  # below 2**30: products stay under 2**62


def _hash01(ix: torch.Tensor, iy: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Deterministic lattice hash -> [0, 1) float32.  ``ix``, ``iy``: integer
    tensors (negative cells wrap to uint32 as in JAX's ``astype``); ``salt``:
    int64 holding uint32 values."""
    h = ((ix.to(torch.int64) & _M32) * _H_IX
         ^ (iy.to(torch.int64) & _M32) * _H_IY
         ^ (salt & _M32) * _H_SALT) & _M32
    h = ((h ^ (h >> 15)) * _H_MIX1) & _M32
    h = ((h ^ (h >> 12)) * _H_MIX2) & _M32
    h = h ^ (h >> 15)
    return (h & 0xFFFFFF).to(torch.float32) * (1.0 / float(0x1000000))


def _value_noise(u: torch.Tensor, v: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Smoothstep-interpolated value noise on the unit lattice (C1: LK needs
    continuous gradients)."""
    iu, iv = torch.floor(u), torch.floor(v)
    fu, fv = u - iu, v - iv
    su = fu * fu * (3.0 - 2.0 * fu)
    sv = fv * fv * (3.0 - 2.0 * fv)
    iu = iu.to(torch.int64)
    iv = iv.to(torch.int64)
    n00 = _hash01(iu, iv, salt)
    n10 = _hash01(iu + 1, iv, salt)
    n01 = _hash01(iu, iv + 1, salt)
    n11 = _hash01(iu + 1, iv + 1, salt)
    return (n00 * (1 - su) + n10 * su) * (1 - sv) + (n01 * (1 - su) + n11 * su) * sv


_N_OCTAVES = 6


def _fbm(u, v, salt, freq, footprint):
    """Multi-octave value noise with analytic anti-aliasing: octave k fades
    out once its wavelength falls under ~2 pixel footprints (Nyquist)."""
    val = torch.zeros_like(u)
    wsum = torch.zeros_like(u)
    f = freq
    amp = 1.0
    for k in range(_N_OCTAVES):
        fade = torch.clamp(2.0 - 4.0 * footprint * f, 0.0, 1.0)
        val = val + amp * fade * _value_noise(u * f, v * f, (salt + (977 * k + 1)) & _M32)
        wsum = wsum + amp
        f = f * 2.1
        amp = amp * 0.55
    return val / torch.clamp(wsum, min=1e-6)


def _blotch(u, v, salt, freq, footprint):
    """Soft-thresholded noise: high-contrast curved regions whose boundaries
    give FAST corners; edge width grows with footprint (anti-aliased)."""
    n = _value_noise(u * freq, v * freq, (salt + 7919) & _M32)
    n = 0.6 * n + 0.4 * _value_noise(u * freq * 2.7, v * freq * 2.7, (salt + 104729) & _M32)
    edge = torch.clamp(0.8 * footprint * freq, 0.02, 0.45)
    return torch.clamp((n - 0.55 + edge) / (2.0 * edge), 0.0, 1.0)


def _speckle(u, v, salt, freq, footprint):
    """Sparse high-threshold dots (gravel / stones / bricks): isolated
    blob-like corners that FAST responds to strongly.  Signed output in
    [-1, 1]; amplitude fades with footprint like the finest fbm octave."""
    n = _value_noise(u * freq, v * freq, (salt + 55001) & _M32)
    m = _value_noise(u * freq * 1.31 + 17.0, v * freq * 1.31, (salt + 77003) & _M32)
    edge = torch.clamp(1.2 * footprint * freq, 0.04, 0.5)
    bright = torch.clamp((n - 0.72 + edge) / (2.0 * edge), 0.0, 1.0)
    dark = torch.clamp((m - 0.72 + edge) / (2.0 * edge), 0.0, 1.0)
    fade = torch.clamp(2.0 - 4.0 * footprint * freq, 0.0, 1.0)
    return fade * (bright - dark)


# ---------------------------------------------------------------------------
# Sensor noise: jax.random.normal from raw Threefry keys
# ---------------------------------------------------------------------------


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


# XLA's single-precision erfinv (Giles): a degree-8 polynomial in
# w = -log1p(-x^2) - 2.5 for w < 5, else in sqrt(w) - 3; highest power first.
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, torch.full_like(x, _ERFINV_CENTRAL[0]),
                    torch.full_like(x, _ERFINV_TAIL[0]))
    for c_central, c_tail in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = torch.where(central, torch.full_like(x, c_central), torch.full_like(x, c_tail)) + p * w
    return p * x


_UNIFORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal_from_keys(keys, h: int, w: int, device=None) -> torch.Tensor:
    """``jax.random.normal(key, (h, w))`` for each raw Threefry key of
    ``keys`` ((B, 2) uint32 key data, as :func:`prng_keys` makes), as a
    (B, h, w) float32 tensor on ``device`` (the keys' device by default)."""
    if not torch.is_tensor(keys):
        keys = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))
    keys = keys.to(device=device or keys.device, dtype=torch.int64) & _M32
    idx = torch.arange(h * w, dtype=torch.int64, device=keys.device)
    x0, x1 = _threefry2x32(keys[:, 0:1], keys[:, 1:2], (idx >> 32)[None], (idx & _M32)[None])
    bits = x0 ^ x1
    # Top 23 bits as the mantissa of a float in [1, 2), minus 1: [0, 1).
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    lo = torch.tensor(_UNIFORM_LO, dtype=torch.float32, device=keys.device)
    u = torch.maximum(lo, f * (1.0 - lo) + lo)
    return (_SQRT2 * _erfinv_f32(u)).reshape(-1, h, w)


def prng_keys(seeds) -> np.ndarray:
    """Vectorized host-side PRNG keys (threefry key = [0, seed] u32), as the
    JAX package builds them."""
    seeds = np.asarray(seeds, np.uint64) & np.uint64(0xFFFFFFFF)
    out = np.zeros(seeds.shape + (2,), np.uint32)
    out[..., 1] = seeds.astype(np.uint32)
    return out


# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------


class _DeviceQuads(NamedTuple):
    p0: torch.Tensor      # (Q, 3) f32
    eu: torch.Tensor
    ev: torch.Tensor
    n: torch.Tensor       # (Q, 3) unit normal
    lu2: torch.Tensor     # (Q,) |eu|^2
    lv2: torch.Tensor
    params: torch.Tensor  # (Q, 5) f32: base, contrast, blotch, freq, bfreq
    salt: torch.Tensor    # (Q,) int64 holding uint32


def _quads_on(quads: Quads, device) -> _DeviceQuads:
    f32 = dict(dtype=torch.float32, device=device)
    p0, eu, ev = (torch.as_tensor(np.asarray(x, np.float32), **f32)
                  for x in (quads.p0, quads.eu, quads.ev))
    lu2 = (eu * eu).sum(-1)
    lv2 = (ev * ev).sum(-1)
    n = torch.linalg.cross(eu, ev)
    n = n / torch.clamp(torch.sqrt((n * n).sum(-1, keepdim=True)), min=1e-9)
    params = torch.as_tensor(np.stack([np.asarray(getattr(quads, k), np.float32) for k in
                                       ("base", "contrast", "blotch", "freq", "bfreq")], 1),
                             **f32)
    salt = torch.as_tensor(np.asarray(quads.salt, np.uint32).astype(np.int64), device=device)
    return _DeviceQuads(p0, eu, ev, n, lu2, lv2, params, salt)


def _sky(h: int, device) -> torch.Tensor:
    """``jnp.linspace(205, 160, h)`` in float32, evaluated as JAX does."""
    step = torch.arange(h - 1, dtype=torch.float32, device=device) / float(h - 1)
    out = 205.0 * (1 - step) + 160.0 * step
    return torch.cat([out, torch.full((1,), 160.0, dtype=torch.float32, device=device)])


def render_frames(
    T_wc: torch.Tensor,
    quads,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    h: int,
    w: int,
    cam_offset_x: float = 0.0,
    noise_keys=None,
    noise_sigma: float = 1.5,
    return_depth: bool = False,
):
    """Ray-cast a batch of camera views.  ``T_wc``: (B, 4, 4) float32 on the
    device to render on.  Returns (B, h, w) float32 in [0, 255] (and the
    exact per-pixel camera z-depth, +inf on sky, with ``return_depth``).

    ``cam_offset_x``: camera-center offset along camera +x (the stereo right
    camera sits at +baseline).  ``noise_keys``: (B, 2) raw Threefry keys;
    each frame gets ``noise_sigma * jax.random.normal(key, (h, w))``.
    """
    dev = T_wc.device
    q = quads if isinstance(quads, _DeviceQuads) else _quads_on(quads, dev)
    T_wc = T_wc.to(torch.float32)
    B = T_wc.shape[0]
    R_wc = T_wc[:, :3, :3]
    c = T_wc[:, :3, 3] + R_wc[:, :, 0] * cam_offset_x                   # (B, 3)

    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 - cy) / fy
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - cx) / fx
    dirs_c = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                          torch.ones((h, w), dtype=torch.float32, device=dev)], -1)
    d = torch.matmul(dirs_c.reshape(1, h * w, 3), R_wc.transpose(1, 2))  # (B, P, 3) world rays
    inv_dnorm = 1.0 / torch.sqrt((d * d).sum(-1))

    # Per (frame, quad) scalars: n.(p0 - c), (c - p0).eu, (c - p0).ev.
    oc = c[:, None, :] - q.p0[None]                                      # (B, Q, 3)
    num = (q.n[None] * -oc).sum(-1)
    oc_eu = (oc * q.eu[None]).sum(-1)
    oc_ev = (oc * q.ev[None]).sum(-1)
    # One (B, P, 3) x (3, 3) product per quad gives d.n, d.eu, d.ev.
    axes = torch.stack([q.n, q.eu, q.ev], -1)                            # (Q, 3, 3)
    sqrt_lu2, sqrt_lv2 = torch.sqrt(q.lu2), torch.sqrt(q.lv2)

    P = h * w
    best_t = torch.full((B, P), 1e9, dtype=torch.float32, device=dev)
    idx = torch.full((B, P), -1, dtype=torch.int64, device=dev)
    best_a = torch.zeros((B, P), dtype=torch.float32, device=dev)
    best_b = torch.zeros_like(best_a)
    best_cos = torch.ones_like(best_a)
    for i in range(q.p0.shape[0]):
        proj = torch.matmul(d, axes[i])                                  # (B, P, 3)
        denom, du, dv = proj.unbind(-1)
        adenom = denom.abs()
        nonzero = adenom > 1e-7
        safe = torch.where(nonzero, denom, torch.full_like(denom, 1e-7))
        t = num[:, i, None] / safe
        a = (oc_eu[:, i, None] + t * du) / q.lu2[i]
        b = (oc_ev[:, i, None] + t * dv) / q.lv2[i]
        better = ((a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0) & (t > 0.2) & nonzero
                  & (t < best_t))
        best_t = torch.where(better, t, best_t)
        idx = torch.where(better, torch.full_like(idx, i), idx)
        best_a = torch.where(better, a * sqrt_lu2[i], best_a)
        best_b = torch.where(better, b * sqrt_lv2[i], best_b)
        best_cos = torch.where(better, adenom * inv_dnorm, best_cos)

    hit = idx >= 0
    gi = idx.clamp(min=0)
    base, contrast, blotch_amp, freq, bfreq = q.params[gi].unbind(-1)
    salt = q.salt[gi]

    # Pixel footprint on the surface (m/px): range / focal, stretched by
    # obliquity (capped: grazing surfaces just go low-frequency).
    dist = best_t / torch.clamp(inv_dnorm, min=1e-6)
    footprint = dist / fx / torch.clamp(best_cos, min=0.25)
    footprint = torch.where(hit, footprint, torch.ones_like(footprint))

    tex = _fbm(best_a, best_b, salt, freq, footprint)
    blo = _blotch(best_a, best_b, salt, bfreq, footprint)
    spk = _speckle(best_a, best_b, salt, freq * 4.0, footprint)
    surf = (base + contrast * (tex - 0.5) * 2.0 + blotch_amp * (blo - 0.5)
            + (0.45 * contrast + 18.0) * spk)

    # Sky: smooth vertical gradient (featureless, like overcast sky).
    vgrad = _sky(h, dev)[:, None].expand(h, w).reshape(1, P)
    img = torch.where(hit, surf, vgrad)

    # Mild distance fade (atmospheric contrast loss).
    fade = torch.where(hit, torch.exp(-best_t / 400.0), torch.ones_like(best_t))
    img = img * fade + (1.0 - fade) * 170.0

    img = torch.clamp(img, 0.0, 255.0)
    if noise_keys is not None:
        img = img + noise_sigma * normal_from_keys(noise_keys, h, w, dev).reshape(B, P)
        img = torch.clamp(img, 0.0, 255.0)
    img = img.reshape(B, h, w)
    if return_depth:
        # Ray param t IS the camera z-depth: camera-frame ray dirs have z=1.
        depth = torch.where(hit, best_t, torch.full_like(best_t, float("inf")))
        return img, depth.reshape(B, h, w)
    return img


# ---------------------------------------------------------------------------
# Scene construction: a closed city-block circuit
# ---------------------------------------------------------------------------

_GROUND_Y = 1.65      # camera height above ground (KITTI-like), y points down
_WALL_TOP_Y = -4.5    # building tops


def _facade_row(
    x0z0: np.ndarray,
    x1z1: np.ndarray,
    rng: np.random.Generator,
    setback_dir: np.ndarray,
    max_setback: float,
    quads: list,
) -> None:
    """Split the facade line x0z0->x1z1 into textured segments with random
    depth setbacks (vertical contrast edges between segments = trackable
    structure), plus a darker backdrop wall closing the gaps."""
    x0z0 = np.asarray(x0z0, np.float64)
    x1z1 = np.asarray(x1z1, np.float64)
    length = float(np.linalg.norm(x1z1 - x0z0))
    u = (x1z1 - x0z0) / max(length, 1e-9)
    s = 0.0
    while s < length - 1.0:
        seg = float(min(rng.uniform(5.0, 12.0), length - s))
        sb = float(rng.uniform(0.0, max_setback))
        a0 = x0z0 + u * s + setback_dir * sb
        p0 = np.array([a0[0], _GROUND_Y, a0[1]])
        eu = np.array([u[0] * seg, 0.0, u[1] * seg])
        ev = np.array([0.0, _WALL_TOP_Y - _GROUND_Y, 0.0])
        quads.append(
            dict(
                p0=p0, eu=eu, ev=ev,
                salt=int(rng.integers(1, 2**31)),
                base=float(rng.uniform(70.0, 160.0)),
                contrast=float(rng.uniform(35.0, 75.0)),
                blotch=float(rng.uniform(45.0, 105.0)),
                freq=float(rng.uniform(0.35, 0.9)),
                bfreq=float(rng.uniform(0.15, 0.45)),
            )
        )
        s += seg
    # Backdrop wall slightly behind the deepest setback.
    a0 = x0z0 + setback_dir * (max_setback + 0.8)
    p0 = np.array([a0[0], _GROUND_Y, a0[1]])
    eu = np.array([u[0] * length, 0.0, u[1] * length])
    ev = np.array([0.0, _WALL_TOP_Y - _GROUND_Y, 0.0])
    quads.append(
        dict(
            p0=p0, eu=eu, ev=ev,
            salt=int(rng.integers(1, 2**31)),
            base=float(rng.uniform(50.0, 90.0)),
            contrast=float(rng.uniform(15.0, 30.0)),
            blotch=float(rng.uniform(10.0, 30.0)),
            freq=float(rng.uniform(0.3, 0.6)),
            bfreq=float(rng.uniform(0.1, 0.3)),
        )
    )


def make_city_circuit(
    length: float = 90.0,
    width: float = 50.0,
    street_half: float = 5.0,
    corner_radius: float = 14.0,
    seed: int = 0,
) -> WorldScene:
    """Build a rectangular street circuit: textured ground plane, building
    facades lining both sides of every street (inner block + outer ring),
    each facade split into salt-distinct segments."""
    rng = np.random.default_rng(seed)
    quads: list = []

    L, W, s = length, width, street_half
    # Ground plane (one big quad).
    pad = 12.0
    quads.append(
        dict(
            p0=np.array([-s - pad, _GROUND_Y, -s - pad]),
            eu=np.array([L + 2 * (s + pad), 0.0, 0.0]),
            ev=np.array([0.0, 0.0, W + 2 * (s + pad)]),
            salt=int(rng.integers(1, 2**31)),
            base=95.0,
            contrast=45.0,
            blotch=35.0,
            freq=1.4,
            bfreq=0.6,
        )
    )

    # Inner block facades (facing outward into the street).  Corners of the
    # inner block: (s, s) .. (L - s, W - s) in (x, z).
    inner = [
        (np.array([s, s]), np.array([L - s, s]), np.array([0.0, -1.0])),
        (np.array([L - s, s]), np.array([L - s, W - s]), np.array([1.0, 0.0])),
        (np.array([L - s, W - s]), np.array([s, W - s]), np.array([0.0, 1.0])),
        (np.array([s, W - s]), np.array([s, s]), np.array([-1.0, 0.0])),
    ]
    # setback goes INTO the block (away from the street) = -normal
    for a, b, n in inner:
        _facade_row(a, b, rng, -n, 2.0, quads)

    # Outer ring facades (facing inward).  Ring at distance s outside the
    # centerline rectangle (0,0)..(L,W).
    outer = [
        (np.array([-s, -s]), np.array([L + s, -s]), np.array([0.0, 1.0])),
        (np.array([L + s, -s]), np.array([L + s, W + s]), np.array([-1.0, 0.0])),
        (np.array([L + s, W + s]), np.array([-s, W + s]), np.array([0.0, -1.0])),
        (np.array([-s, W + s]), np.array([-s, -s]), np.array([1.0, 0.0])),
    ]
    for a, b, n in outer:
        _facade_row(a, b, rng, -n, 2.5, quads)

    # Pad to a fixed quad count (duplicates of the ground quad: equal-t
    # duplicate hits never win the strict `t < best_t` test).
    _PAD_TO = 128
    if len(quads) > _PAD_TO:
        raise ValueError(f"scene has {len(quads)} quads > pad bound {_PAD_TO}")
    quads = quads + [quads[0]] * (_PAD_TO - len(quads))

    q = Quads(
        p0=np.stack([x["p0"] for x in quads]).astype(np.float32),
        eu=np.stack([x["eu"] for x in quads]).astype(np.float32),
        ev=np.stack([x["ev"] for x in quads]).astype(np.float32),
        salt=np.array([x["salt"] for x in quads]).astype(np.uint32),
        base=np.array([x["base"] for x in quads]).astype(np.float32),
        contrast=np.array([x["contrast"] for x in quads]).astype(np.float32),
        blotch=np.array([x["blotch"] for x in quads]).astype(np.float32),
        freq=np.array([x["freq"] for x in quads]).astype(np.float32),
        bfreq=np.array([x["bfreq"] for x in quads]).astype(np.float32),
    )

    r = corner_radius
    perimeter = 2 * (L - 2 * r) + 2 * (W - 2 * r) + 2 * np.pi * r
    return WorldScene(quads=q, centerline=np.array([[0.0, 0.0]]), perimeter=float(perimeter))


def _rounded_rect_pose(s: np.ndarray, L: float, W: float, r: float):
    """Position (x, z) and heading (hx, hz) at arc length s along the
    rounded-rectangle centerline (0,0)-(L,0)-(L,W)-(0,W), starting at (r, 0)
    heading +x."""
    seg_lens = [
        L - 2 * r,            # straight along z=0, +x
        np.pi * r / 2,        # corner at (L-r, r)
        W - 2 * r,            # straight along x=L, +z
        np.pi * r / 2,        # corner at (L-r, W-r)
        L - 2 * r,            # straight along z=W, -x
        np.pi * r / 2,        # corner at (r, W-r)
        W - 2 * r,            # straight along x=0, -z
        np.pi * r / 2,        # corner at (r, r)
    ]
    P = sum(seg_lens)
    s = np.mod(s, P)

    pos = np.zeros((len(np.atleast_1d(s)), 2))
    head = np.zeros_like(pos)
    s = np.atleast_1d(s)
    acc = 0.0
    done = np.zeros(len(s), bool)
    for k, sl in enumerate(seg_lens):
        m = (~done) & (s < acc + sl + 1e-9)
        u = s[m] - acc
        if k == 0:
            pos[m] = np.stack([r + u, np.zeros_like(u)], 1)
            head[m] = [1.0, 0.0]
        elif k == 1:
            th = u / r
            pos[m] = np.stack([L - r + r * np.sin(th), r - r * np.cos(th)], 1)
            head[m] = np.stack([np.cos(th), np.sin(th)], 1)
        elif k == 2:
            pos[m] = np.stack([np.full_like(u, L), r + u], 1)
            head[m] = [0.0, 1.0]
        elif k == 3:
            th = u / r
            pos[m] = np.stack([L - r + r * np.cos(th), W - r + r * np.sin(th)], 1)
            head[m] = np.stack([-np.sin(th), np.cos(th)], 1)
        elif k == 4:
            pos[m] = np.stack([L - r - u, np.full_like(u, W)], 1)
            head[m] = [-1.0, 0.0]
        elif k == 5:
            th = u / r
            pos[m] = np.stack([r - r * np.sin(th), W - r + r * np.cos(th)], 1)
            head[m] = np.stack([-np.cos(th), -np.sin(th)], 1)
        elif k == 6:
            pos[m] = np.stack([np.zeros_like(u), W - r - u], 1)
            head[m] = [0.0, -1.0]
        else:
            th = u / r
            pos[m] = np.stack([r - r * np.cos(th), r - r * np.sin(th)], 1)
            head[m] = np.stack([np.sin(th), -np.cos(th)], 1)
        done |= m
        acc += sl
    return pos, head


def _corner_speed(s: np.ndarray, L: float, W: float, r: float, slow: float, ramp: float):
    """Speed factor along the circuit: ``slow`` inside corner arcs, ramping
    back to 1 within ``ramp`` meters: drivers brake for turns, and it keeps
    the per-frame yaw rate at realistic (KITTI-like) levels."""
    seg = [L - 2 * r, np.pi * r / 2, W - 2 * r, np.pi * r / 2,
           L - 2 * r, np.pi * r / 2, W - 2 * r, np.pi * r / 2]
    P = sum(seg)
    s = np.mod(s, P)
    bounds = np.cumsum([0.0] + seg)
    f = np.ones_like(s)
    for k in (1, 3, 5, 7):  # arc segments
        a0, a1 = bounds[k], bounds[k + 1]
        d = np.maximum.reduce([a0 - s, s - a1, np.zeros_like(s)])
        d = np.minimum(d, P - d)  # circular distance
        f = np.minimum(f, slow + (1.0 - slow) * np.clip(d / ramp, 0.0, 1.0))
    return f


