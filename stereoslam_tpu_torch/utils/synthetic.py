"""Synthetic stereo sequences with exact ground truth.

The reference repo has no tests and validates against saved KITTI runs
(reference result/trajectory.txt — see SURVEY.md §4).  This module gives the
new framework something stronger: procedurally generated stereo sequences
(textured 3D blob field + smooth camera trajectory) with exact ground-truth
poses, so frontend/backend/loop-closure are testable end-to-end — including
loop closures, by driving the camera in a closed circuit — without any
dataset dependency.

numpy-only copy of ``stereoslam_tpu/utils/synthetic.py`` (whose module
imports jax); ``tests/test_torch_copies.py`` holds the two bit-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticSequence:
    left: np.ndarray       # (T, H, W) float32
    right: np.ndarray      # (T, H, W) float32
    T_cw: np.ndarray       # (T, 4, 4) ground-truth world->camera poses
    timestamps: np.ndarray  # (T,)
    baseline: float
    fx: float
    fy: float
    cx: float
    cy: float


def _splat_points(
    img: np.ndarray, uv: np.ndarray, depth: np.ndarray, intensity: np.ndarray, size: np.ndarray
) -> None:
    """Draw soft radial blobs (painter's algorithm by depth, far first).

    Sub-pixel-consistent rendering matters: hard-edged uniform squares are
    self-similar (LK locks onto the wrong one) and alias under viewpoint
    change.  Each blob gets a radial profile whose peak encodes its identity,
    evaluated at true sub-pixel position.
    """
    h, w = img.shape
    order = np.argsort(-depth)
    for i in order:
        u, v = uv[i]
        if depth[i] <= 2.0:  # near-cull: a blob sweeping past the camera
            continue         # would occlude half the image
        s = float(np.clip(size[i] / depth[i], 2.0, 18.0))
        r = int(np.ceil(s))
        u0, v0 = int(np.floor(u)) - r, int(np.floor(v)) - r
        u1, v1 = u0 + 2 * r + 1, v0 + 2 * r + 1
        if u1 < 0 or v1 < 0 or u0 >= w or v0 >= h:
            continue
        uu0, vv0 = max(u0, 0), max(v0, 0)
        uu1, vv1 = min(u1, w), min(v1, h)
        ys = np.arange(vv0, vv1)[:, None]
        xs = np.arange(uu0, uu1)[None, :]
        d2 = ((xs - u) ** 2 + (ys - v) ** 2) / (0.35 * s * s + 1e-6)
        profile = np.exp(-d2)
        patch = img[vv0:vv1, uu0:uu1]
        img[vv0:vv1, uu0:uu1] = np.where(
            profile > 0.02, (1 - profile) * patch + profile * intensity[i], patch
        )


def generate_sequence(
    n_frames: int = 60,
    h: int = 240,
    w: int = 376,
    fx: float = 320.0,
    baseline: float = 0.54,
    n_points: int = 900,
    trajectory: str = "forward",
    speed: float = 0.35,
    seed: int = 0,
    yaw_rate: float = 0.0,
    loop_frames: int = 0,
) -> SyntheticSequence:
    """Render a stereo sequence through a field of textured blobs.

    trajectory:
      - "forward": mostly straight motion with gentle curvature (VO case).
      - "loop": closed circuit returning to the start (loop-closure case).
    """
    rng = np.random.default_rng(seed)
    cx, cy = w / 2.0, h / 2.0
    fy = fx

    # World: blob field in a long corridor (or ring) around the trajectory.
    loop_frames = loop_frames or n_frames
    if trajectory == "loop":
        # Blob annulus around the circular trajectory (circle centre at
        # (radius, 0, 0) in x/z — see the pose construction below).
        # Angular density + intensity vary around the ring: a perfectly
        # uniform annulus is rotationally self-similar, which makes place
        # recognition ill-posed by construction.
        radius = speed * loop_frames / (2 * np.pi)
        mix = rng.integers(0, 4, n_points)
        centers = np.array([0.3, 1.9, 3.4, 5.1])
        spreads = np.array([0.5, 0.9, 0.4, 1.1])
        ang = np.mod(rng.normal(centers[mix], spreads[mix]), 2 * np.pi)
        rad = radius + rng.uniform(2.0, 18.0, n_points) * np.sign(rng.standard_normal(n_points))
        pts = np.stack(
            [radius - rad * np.cos(ang), rng.uniform(-3.0, 3.0, n_points), rad * np.sin(ang)],
            axis=1,
        )
    else:
        length = speed * n_frames + 60.0
        pts = np.stack(
            [
                rng.uniform(-30.0, 30.0, n_points),
                rng.uniform(-8.0, 8.0, n_points),
                rng.uniform(-5.0, length, n_points),
            ],
            axis=1,
        )
    if trajectory != "loop":
        # Keep a clear corridor so blobs don't engulf the camera.
        lateral = np.abs(pts[:, 0])
        pts = pts[(lateral > 1.2) | (np.abs(pts[:, 1]) > 1.2)]
    n_pts = len(pts)
    intensity = rng.uniform(60, 255, n_pts)
    size = rng.uniform(60.0, 160.0, n_pts)  # projected size ~ size/depth px

    # Camera trajectory (world->camera poses). Camera looks +z.
    T_wc_list = []
    pos = np.zeros(3)
    yaw = 0.0
    for t in range(n_frames):
        if trajectory == "loop":
            # Circle closing after ``loop_frames`` frames; n_frames beyond
            # that revisits the start of the circuit.
            radius = speed * loop_frames / (2 * np.pi)
            yaw = 2 * np.pi * t / loop_frames
            # d(pos)/d(yaw) ∝ (sin yaw, 0, cos yaw) == the camera heading below.
            pos = np.array([radius * (1.0 - np.cos(yaw)), 0.0, radius * np.sin(yaw)])
        else:
            if t > 0:  # frame 0 sits at the origin (identity pose)
                yaw += yaw_rate
                pos = pos + speed * np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # camera z axis into world
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = pos
        T_wc_list.append(T_wc)

    lefts, rights, poses = [], [], []
    for T_wc in T_wc_list:
        T_cw = np.linalg.inv(T_wc)
        for cam, store in ((0.0, lefts), (baseline, rights)):
            # Right camera at +baseline along camera x (point moves by -b).
            p_c = (T_cw[:3, :3] @ pts.T).T + T_cw[:3, 3]
            p_c = p_c - np.array([cam, 0.0, 0.0])
            z = p_c[:, 2]
            vis = z > 0.5
            uv = np.stack(
                [fx * p_c[:, 0] / np.maximum(z, 0.5) + cx, fy * p_c[:, 1] / np.maximum(z, 0.5) + cy],
                axis=1,
            )
            img = np.full((h, w), 30.0, np.float32)
            # mild horizontal gradient for ambient texture
            img += np.linspace(0, 20, w, dtype=np.float32)[None, :]
            _splat_points(img, uv[vis], z[vis], intensity[vis], size[vis])
            store.append(img)
        poses.append(T_cw)

    return SyntheticSequence(
        left=np.stack(lefts),
        right=np.stack(rights),
        T_cw=np.stack(poses).astype(np.float32),
        timestamps=np.arange(n_frames, dtype=np.float64) * 0.1,
        baseline=baseline,
        fx=fx,
        fy=fy,
        cx=cx,
        cy=cy,
    )
