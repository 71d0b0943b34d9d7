"""Self-supervised training of the CALC loop-closure encoder (port of
``stereoslam_tpu/models/train_calc.py``).

CALC (the network behind the reference's DeepLCD, reference src/deeplcd.cpp)
is a convolutional autoencoder trained to reconstruct the HOG features of an
image from a randomly warped view of it; that objective makes its bottleneck
descriptor viewpoint-tolerant.  ``train_encoder`` is that objective alone;
``train_encoder_pairs`` adds in-batch InfoNCE and absolute hinges on
real-parallax (anchor, revisit) pairs rendered by ``render_corpus_pairs``.

The arithmetic is the JAX package's:

- the decoder head computes in bfloat16 (inputs, weights and biases cast
  inside ``forward``; float32 master parameters);
- ``train_encoder`` steps with Adam, ``train_encoder_pairs`` with AdamW
  whose decay applies to every parameter, scaled by the learning rate, as
  ``optax.adamw``;
- the batch indices are the JAX package's numpy draws from ``seed``;
- every random augmentation of a step is an argument of the loss
  (:class:`Augment`): JAX draws them from ``jax.random`` keys, which a
  ``torch.Generator`` cannot reproduce, so the loop draws them with
  :func:`draw_augment` (same ranges) and the tests replay JAX's;
- the init is Flax's (``lecun_normal`` kernels, zero biases), drawn on the
  CPU from ``seed`` so that a seed gives the same start on any device.

Trained encoder parameters come back in the Flax layout as numpy
(``{"params": {"conv1": {"kernel", "bias"}, ...}}``), which
``calc.DescriptorModel``, ``calc.save_params_npz`` and the JAX package take.
The entry points run on the card unless the caller passes ``device="cpu"``;
with no card they raise.  Usage::

    from stereoslam_tpu_torch.models.train_calc import render_corpus_pairs, train_encoder_pairs
    A, B = render_corpus_pairs(n_places=512)
    params, history = train_encoder_pairs(A, B, steps=3000)
    model = calc.DescriptorModel(params)
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stereoslam_tpu_torch.bridge import (
    calc_params_from_flax,
    calc_params_to_flax,
    decoder_params_from_flax,
)
from stereoslam_tpu_torch.models import calc
from stereoslam_tpu_torch.ops.image import bilinear_sample

# hog_features' length: 8 x 10 cells of 8 orientation bins.
HOG_DIM = calc._POOL * (calc._POOL * calc.INPUT_HW[1] // calc.INPUT_HW[0]) * calc._N_BINS

Images = Union[np.ndarray, torch.Tensor, Sequence[Union[np.ndarray, torch.Tensor]]]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CALC training runs on the card by default and no CUDA device is "
                           "available: pass device='cpu' to run on the CPU")
    return dev


class _Decoder(nn.Module):
    """Projection head mapping the descriptor to HOG feature space (training
    only): Dense(1024), relu, Dense(hog_dim), each in bfloat16 with the dot's
    output rounded before its bias is added, as Flax's ``Dense(dtype=bf16)``."""

    def __init__(self, hog_dim: int = HOG_DIM):
        super().__init__()
        self.dense0 = nn.Linear(calc.DESCRIPTOR_DIM, 1024)
        self.dense1 = nn.Linear(1024, hog_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "_Decoder":
        for layer in (self.dense0, self.dense1):
            calc.lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)
        return self

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        bf = torch.bfloat16
        x = z.to(bf)
        x = F.relu(x @ self.dense0.weight.to(bf).t() + self.dense0.bias.to(bf))
        x = x @ self.dense1.weight.to(bf).t() + self.dense1.bias.to(bf)
        return x.to(torch.float32)


def _random_warp(img: torch.Tensor, angle: torch.Tensor, scale: torch.Tensor,
                 shift_px: torch.Tensor) -> torch.Tensor:
    """Rotation + scale + translation about the image centre, bilinear, of a
    batch ``img`` (B, H, W): ``angle`` (B,) rad, ``scale`` (B,), ``shift_px``
    (B, 2) pixels (x, y)."""
    h, w = img.shape[-2:]
    c = (torch.cos(angle) * scale)[:, None, None]
    s = (torch.sin(angle) * scale)[:, None, None]
    cx, cy = w / 2.0, h / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    src_x = c * xs + s * ys + cx + shift_px[:, 0, None, None]
    src_y = -s * xs + c * ys + cy + shift_px[:, 1, None, None]
    return bilinear_sample(img, torch.stack([src_x, src_y], dim=-1))


def _photometric(img: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Gain and bias on a batch of [0, 1] images (exposure change between
    visits), clipped to [0, 1.2]; ``gain``, ``bias`` (B,)."""
    return torch.clamp(img * gain[:, None, None] + bias[:, None, None], 0.0, 1.2)


class Augment(NamedTuple):
    """Every per-sample draw of one step, V views a sample: V = 1 for
    ``train_encoder`` (the warp of the reconstruction input), V = 3 for
    ``train_encoder_pairs`` in the order (reconstruction input, anchor,
    revisit), whose JAX keys are (kw, kwa, kwb) for the warps and (kw, ka,
    kb) for the photometric draws.  ``angle``, ``scale``, ``gain``, ``bias``
    (B, V); ``shift`` (B, V, 2) in pixels; ``gain``/``bias`` None for V = 1."""

    angle: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    gain: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None

    def view(self, img: torch.Tensor, v: int) -> torch.Tensor:
        """View ``v`` of a batch: its warp, then its photometric draw."""
        out = _random_warp(img, self.angle[:, v], self.scale[:, v], self.shift[:, v])
        return out if self.gain is None else _photometric(out, self.gain[:, v], self.bias[:, v])

    def to(self, device) -> "Augment":
        return Augment(*(None if x is None else x.to(device) for x in self))


def draw_augment(generator: torch.Generator, batch: int, hw: Tuple[int, int] = calc.INPUT_HW,
                 pairs: bool = True) -> Augment:
    """One step's draws from ``generator`` on its device, in the JAX
    package's ranges: angle +-0.15 rad, scale 0.9-1.1, shift +-0.08 of (w, h);
    with ``pairs``, three views and gain 0.75-1.3, bias +-0.08."""
    v = 3 if pairs else 1
    h, w = hw

    def uniform(lo, hi, *shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return u * (hi - lo) + lo

    angle = uniform(-0.15, 0.15, batch, v)
    scale = uniform(0.9, 1.1, batch, v)
    frac = uniform(-0.08, 0.08, batch, v, 2)
    shift = torch.stack([frac[..., 0] * w, frac[..., 1] * h], dim=-1)
    if not pairs:
        return Augment(angle, scale, shift)
    return Augment(angle, scale, shift, uniform(0.75, 1.3, batch, v), uniform(-0.08, 0.08, batch, v))


def recon_loss(enc: nn.Module, dec: nn.Module, imgs: torch.Tensor, aug: Augment) -> torch.Tensor:
    """The CALC objective: MSE between dec(enc(warp(img))) and hog(img)."""
    pred = dec(enc(aug.view(imgs, 0)))
    return torch.mean((pred - calc.hog_features(imgs)) ** 2)


def pair_loss(enc: nn.Module, dec: nn.Module, a: torch.Tensor, b: torch.Tensor, aug: Augment,
              contrastive_weight: float = 0.5, temperature: float = 0.07,
              margin_pos: float = 0.965, margin_neg: float = 0.55, hinge_weight: float = 4.0):
    """``train_encoder_pairs``' loss on a batch of preprocessed pairs:
    returns ``(total, (recon, contrast, hinge))``.  The three views go
    through the encoder as one batch."""
    n = a.shape[0]
    z = enc(torch.cat([aug.view(a, 0), aug.view(a, 1), aug.view(b, 2)]))
    zw, za, zb = z[:n], z[n:2 * n], z[2 * n:]
    recon = torch.mean((dec(zw) - calc.hog_features(a)) ** 2)
    S = za @ zb.T                                   # (B, B) unit-norm similarities
    labels = torch.arange(n, device=a.device)
    logits = S / temperature
    contrast = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    off = ~torch.eye(n, dtype=torch.bool, device=a.device)
    hinge = (torch.mean(F.relu(margin_pos - torch.diagonal(S)))
             + torch.mean(F.relu(torch.where(off, S, torch.full_like(S, -1.0)) - margin_neg)))
    total = recon + contrastive_weight * contrast + hinge_weight * hinge
    return total, (recon, contrast, hinge)


def pair_step(enc: nn.Module, dec: nn.Module, opt: torch.optim.Optimizer, a: torch.Tensor,
              b: torch.Tensor, aug: Augment, **loss_kw):
    """One optimizer step of ``pair_loss``; returns its ``(total, aux)`` from
    before the update, on the device."""
    total, aux = pair_loss(enc, dec, a, b, aug, **loss_kw)
    opt.zero_grad(set_to_none=True)
    total.backward()
    opt.step()
    return total.detach(), tuple(x.detach() for x in aux)


def init_modules(seed: int = 0, device="cuda", init: Optional[Dict] = None):
    """The encoder and decoder to train, on ``device`` (the card unless the
    caller asks for ``"cpu"``): Flax's init drawn on the CPU from ``seed``,
    or ``init`` (``{"enc": ..., "dec": ...}`` Flax variables, e.g. the JAX
    package's own init carried across)."""
    enc, dec = calc.CalcEncoder(), _Decoder()
    if init is None:
        g = torch.Generator().manual_seed(seed)
        enc.reset_parameters(g)
        dec.reset_parameters(g)
    else:
        enc.load_state_dict(calc_params_from_flax(init["enc"]))
        dec.load_state_dict(decoder_params_from_flax(init["dec"]))
    return enc.to(device), dec.to(device)


def preprocess_corpus(A: Images, device="cuda") -> torch.Tensor:
    """Blur + resize a corpus (an array, a tensor, or a list of them at any
    resolutions) to the network input size: one (N, 120, 160) float32
    tensor on ``device``."""
    dev = _device(device)
    groups = list(A) if isinstance(A, (list, tuple)) else [A]
    out = []
    for g in groups:
        g = g if torch.is_tensor(g) else torch.from_numpy(np.asarray(g, np.float32))
        g = g.to(device=dev, dtype=torch.float32)
        out += [calc.preprocess(g[lo:lo + 64]) for lo in range(0, len(g), 64)]
    return torch.cat(out)


def _indices(draws: List[np.ndarray], dev) -> torch.Tensor:
    """Every step's batch indices in one copy: (steps, batch) on ``dev``."""
    return torch.from_numpy(np.stack(draws).astype(np.int64)).to(dev)


def train_encoder(
    images: Images,
    steps: int = 1000,
    batch: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    device="cuda",
    *,
    init: Optional[Dict] = None,
    augment: Optional[Callable[[int], Augment]] = None,
) -> Tuple[Dict, List[float]]:
    """Train the CALC encoder on (N, H, W) grayscale images with the CALC
    objective alone: descriptor(warp(image)) must predict hog(image).

    ``init`` starts from given Flax variables (see :func:`init_modules`);
    ``augment(step)`` replaces the step's draws.  Returns (encoder params in
    the Flax layout, the loss at every 50th step and the last)."""
    dev = _device(device)
    enc, dec = init_modules(seed, dev, init)
    opt = torch.optim.Adam(list(enc.parameters()) + list(dec.parameters()), lr=lr)
    corpus = preprocess_corpus(images, dev)
    rng = np.random.default_rng(seed)
    idx = _indices([rng.integers(0, len(corpus), batch) for _ in range(steps)], dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    history: List[float] = []
    for i in range(steps):
        imgs = corpus.index_select(0, idx[i])
        aug = augment(i) if augment is not None else draw_augment(gen, batch, pairs=False)
        loss = recon_loss(enc, dec, imgs, aug)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 50 == 0 or i == steps - 1:
            history.append(float(loss.detach()))
    return calc_params_to_flax(enc.state_dict()), history


def train_encoder_pairs(
    A: Images,
    B: Images,
    steps: int = 3000,
    batch: int = 64,
    lr: float = 1e-3,
    seed: int = 0,
    contrastive_weight: float = 0.5,
    temperature: float = 0.07,
    margin_pos: float = 0.965,
    margin_neg: float = 0.55,
    hinge_weight: float = 4.0,
    weight_decay: float = 1e-4,
    log_every: int = 100,
    verbose: bool = False,
    probe_fn: Optional[Callable[[nn.Module], float]] = None,
    probe_every: int = 500,
    device="cuda",
    *,
    init: Optional[Dict] = None,
    augment: Optional[Callable[[int], Augment]] = None,
) -> Tuple[Dict, List[Tuple[float, float, float, float]]]:
    """Train the CALC encoder on real-parallax (anchor, revisit) pairs:
    HOG reconstruction of a warped anchor, in-batch InfoNCE both ways on
    independently warped and photometrically jittered anchors and revisits,
    and absolute hinges pinning revisits above ``margin_pos`` and different
    places below ``margin_neg`` (:func:`pair_loss`), with AdamW.

    ``A``/``B`` may be lists of corpora at different resolutions.
    ``probe_fn(encoder)`` scores the port's ``CalcEncoder`` being trained
    (under ``torch.no_grad``; it must not change it) every ``probe_every``
    steps and at the last; the best-scoring encoder is the one returned.
    Returns (encoder params in the Flax layout, history of (total, recon,
    contrast, hinge) at every ``log_every``-th step and the last).  The loss
    stays on the device between log steps."""
    dev = _device(device)
    enc, dec = init_modules(seed, dev, init)
    opt = torch.optim.AdamW(list(enc.parameters()) + list(dec.parameters()), lr=lr,
                            weight_decay=weight_decay)
    corpA, corpB = preprocess_corpus(A, dev), preprocess_corpus(B, dev)
    n = len(corpA)
    rng = np.random.default_rng(seed)
    idx = _indices([rng.choice(n, batch, replace=False) for _ in range(steps)], dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loss_kw = dict(contrastive_weight=contrastive_weight, temperature=temperature,
                   margin_pos=margin_pos, margin_neg=margin_neg, hinge_weight=hinge_weight)
    history: List[Tuple[float, float, float, float]] = []
    best_score, best = -np.inf, None
    for i in range(steps):
        a, b = corpA.index_select(0, idx[i]), corpB.index_select(0, idx[i])
        aug = augment(i) if augment is not None else draw_augment(gen, batch)
        total, aux = pair_step(enc, dec, opt, a, b, aug, **loss_kw)
        if i % log_every == 0 or i == steps - 1:
            rec = tuple(torch.stack([total, *aux]).tolist())
            history.append(rec)
            if verbose:
                print(f"step {i}: total {rec[0]:.4f} recon {rec[1]:.4f} "
                      f"contrast {rec[2]:.4f} hinge {rec[3]:.4f}", flush=True)
        if probe_fn is not None and ((i + 1) % probe_every == 0 or i == steps - 1):
            with torch.no_grad():
                score = float(probe_fn(enc))
            if verbose:
                print(f"step {i}: probe {score:.4f}{' (best)' if score > best_score else ''}",
                      flush=True)
            if score > best_score:
                best_score = score
                best = {k: v.detach().clone() for k, v in enc.state_dict().items()}
    return calc_params_to_flax(best if best is not None else enc.state_dict()), history


def _jittered_pose(
    T: np.ndarray,
    rng: np.random.Generator,
    trans: Tuple[float, float, float] = (1.8, 0.4, 1.0),
    yaw: float = 0.35,
    pitch: float = 0.06,
) -> np.ndarray:
    """Random viewpoint perturbation of a T_wc pose (real-parallax jitter)."""
    T = T.copy()
    d = rng.uniform(-1.0, 1.0, 3) * np.asarray(trans)
    T[:3, 3] += T[:3, :3] @ d
    ya = rng.uniform(-yaw, yaw)
    pa = rng.uniform(-pitch, pitch)
    cy_, sy_ = np.cos(ya), np.sin(ya)
    cp_, sp_ = np.cos(pa), np.sin(pa)
    Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    Rx = np.array([[1, 0, 0], [0, cp_, -sp_], [0, sp_, cp_]])
    T[:3, :3] = T[:3, :3] @ (Ry @ Rx)
    return T


def render_corpus_pairs(
    n_places: int = 512,
    h: int = 240,
    w: int = 376,
    fx: float = 320.0,
    n_scenes: int = 8,
    seed: int = 0,
    noise_sigma: float = 1.5,
    revisit_trans: Tuple[float, float, float] = (1.0, 0.15, 1.5),
    revisit_yaw: float = 0.12,
    tiny_frac: float = 0.5,
    tiny_trans: Tuple[float, float, float] = (0.3, 0.05, 0.4),
    tiny_yaw: float = 0.03,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (anchor, revisit) view pairs of the same places under
    independent viewpoint jitter (real parallax, which warps cannot make)
    from ``n_scenes`` procedural city scenes, on ``device``.  The scenes,
    poses and noise keys are the JAX package's numpy draws from ``seed``
    (scene seeds 70001 + 131 seed + s, a band disjoint from the tests' and
    evaluation worlds' seeds); half of the revisits sit at lap-revisit
    offsets (``tiny_*``).  Returns two (n, h, w) float32 tensors A, B:
    (A[i], B[i]) is a revisit, (A[i], B[j != i]) a hard negative."""
    from stereoslam_tpu_torch.utils.world import (
        circuit_poses,
        make_city_circuit,
        prng_keys,
        render_frames_batched,
    )

    dev = _device(device)
    rng = np.random.default_rng(seed)
    per_scene = n_places // n_scenes
    A = torch.empty((per_scene * n_scenes, h, w), dtype=torch.float32, device=dev)
    B = torch.empty_like(A)
    i = 0
    for s in range(n_scenes):
        L = float(rng.uniform(70.0, 110.0))
        Wd = float(rng.uniform(40.0, 60.0))
        scene = make_city_circuit(L, Wd, seed=70001 + seed * 131 + s)
        starts = rng.uniform(0.0, scene.perimeter, per_scene)
        Tas, Tbs, kas, kbs = [], [], [], []
        for k in range(per_scene):
            T0 = circuit_poses(1, 0.8, L, Wd, 14.0, start=float(starts[k]))[0]
            Ta = _jittered_pose(T0, rng)
            Tas.append(Ta)
            if rng.uniform() < tiny_frac:
                Tbs.append(_jittered_pose(Ta, rng, trans=tiny_trans, yaw=tiny_yaw))
            else:
                Tbs.append(_jittered_pose(Ta, rng, trans=revisit_trans, yaw=revisit_yaw))
            kas.append(prng_keys(seed * 7919 + 2 * (i + k)))
            kbs.append(prng_keys(seed * 7919 + 2 * (i + k) + 1))
        common = dict(quads=scene.quads, fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0, h=h, w=w,
                      noise_sigma=noise_sigma, device=dev)
        A[i:i + per_scene] = render_frames_batched(np.stack(Tas), noise_keys=np.stack(kas), **common)
        B[i:i + per_scene] = render_frames_batched(np.stack(Tbs), noise_keys=np.stack(kbs), **common)
        i += per_scene
    return A, B


def _numpy_tree(params):
    if isinstance(params, dict):
        return {k: _numpy_tree(v) for k, v in params.items()}
    return params.detach().cpu().numpy() if isinstance(params, torch.Tensor) else np.asarray(params)


def save_params(path: str, params) -> None:
    """Pickle a Flax-layout params dict as nested numpy arrays, the file the
    JAX package's ``save_params`` writes and its ``load_params`` reads."""
    with open(path, "wb") as f:
        pickle.dump(_numpy_tree(params), f)


def load_params(path: str):
    """A params pickle written by either package's ``save_params`` (only
    files this project wrote: unpickling runs code), as nested numpy."""
    with open(path, "rb") as f:
        return _numpy_tree(pickle.load(f))
