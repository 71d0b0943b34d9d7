"""The drive generator: one closed lap of the city circuit, rendered on the
card and staged as uint8 stereo pairs, then driven lap after lap by one
vehicle or by a fleet.

A lap's frames follow the circuit's centerline at ``step`` metres a frame,
slowed in the corners (``corner_slow``, ramped over ``slow_ramp`` metres):
the speed profile of the renderer's ``circuit_poses``.  The step is
adjusted, by bisection, so that ``n`` such steps end exactly where the lap
began: frame ``n`` would be frame 0, so driving the lap again is a vehicle
circling the same route, and a program faster than the window never runs
out of frames.  ``n`` is the number of frames at the nominal step.

A lap is a fixed recording, as a KITTI sequence is: the scene (the
configuration's ``scene_seed``), the sensor noise of every frame (its
``noise_seed``, drawn as the canonical world's ``generate_world_sequence``
draws it) and where the drive starts (the cell's ``start``, a fraction of
the lap) are the same in every run, so every run does the same work.  A
run's seed picks what the correctness check samples (``check.py``).  A
fleet of B vehicles starts at B offsets ``n / B`` frames apart.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.traffic import world as W

_CHUNK_PIXELS = 128 * 240 * 376  # pixels rendered per batch: temporaries of some tens of MB each


class Lap(NamedTuple):
    frames: torch.Tensor  # (n, 2, H, W) uint8 on the card: left, right
    T_cw: np.ndarray      # (n, 4, 4) float64 ground-truth poses


def _speed(s: float, world: dict) -> float:
    return float(W._corner_speed(np.array([s]), world["length"], world["width"],
                                 world["corner_radius"], world["corner_slow"],
                                 world["slow_ramp"])[0])


def perimeter(world: dict) -> float:
    L, Wd, r = world["length"], world["width"], world["corner_radius"]
    return 2 * (L - 2 * r) + 2 * (Wd - 2 * r) + 2 * np.pi * r


def _walk(step: float, n: int, world: dict) -> np.ndarray:
    """Arc length of each of ``n + 1`` frames from 0 at ``step`` metres a
    frame under the corner speed profile."""
    s = np.empty(n + 1)
    cur = 0.0
    for t in range(n + 1):
        s[t] = cur
        cur += step * _speed(cur, world)
    return s


def closing_step(world: dict):
    """(step, n): the number of frames of a lap at the nominal step, and the
    step at which ``n`` frames end exactly where the lap began."""
    P = perimeter(world)
    step = world["step"]
    n, cur = 0, 0.0
    while cur < P:
        cur += step * _speed(cur, world)
        n += 1
    lo, hi = 0.5 * step, 1.5 * step
    for _ in range(80):  # the end point grows with the step: bisect it onto P
        mid = 0.5 * (lo + hi)
        if _walk(mid, n, world)[-1] < P:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi), n


def lap_arc(world: dict) -> np.ndarray:
    """Arc length (n,) of the frames of one closed lap."""
    step, n = closing_step(world)
    return _walk(step, n, world)[:-1]


def lap_poses(world: dict) -> np.ndarray:
    """(n, 4, 4) T_wc of one closed lap, as ``circuit_poses`` builds them."""
    s = lap_arc(world)
    pos2, head2 = W._rounded_rect_pose(s, world["length"], world["width"],
                                       world["corner_radius"])
    T = np.tile(np.eye(4), (len(s), 1, 1))
    yaw = np.arctan2(head2[:, 0], head2[:, 1])
    c, sn = np.cos(yaw), np.sin(yaw)
    T[:, 0, 0], T[:, 0, 2], T[:, 2, 0], T[:, 2, 2] = c, sn, -sn, c
    T[:, 0, 3], T[:, 2, 3] = pos2[:, 0], pos2[:, 1]
    return T


def render_lap(camera: dict, world: dict, device) -> Lap:
    """Render one closed lap on ``device``: both cameras, uint8."""
    h, w = camera["height"], camera["width"]
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    T_wc = lap_poses(world)
    n = len(T_wc)
    base = world["noise_seed"] * 1000003
    scene = W.make_city_circuit(world["length"], world["width"], street_half=world["street_half"],
                                seed=world["scene_seed"], corner_radius=world["corner_radius"])
    q = W._quads_on(scene.quads, device)
    frames = torch.empty((n, 2, h, w), dtype=torch.uint8, device=device)
    chunk = max(1, _CHUNK_PIXELS // (h * w))
    for side, offset in ((0, 0.0), (1, camera["baseline"])):
        keys = W.prng_keys(base + 2 * np.arange(n) + side)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            Tb = torch.as_tensor(T_wc[lo:hi].astype(np.float32), device=device)
            img = W.render_frames(Tb, q, fx, fy, cx, cy, h, w, cam_offset_x=offset,
                                  noise_keys=keys[lo:hi], noise_sigma=world["noise_sigma"])
            frames[lo:hi, side] = img.to(torch.uint8)
    return Lap(frames=frames, T_cw=np.linalg.inv(T_wc))


def stream_starts(lap: Lap, streams: int, start: float = 0.0):
    """The lap frame each of ``streams`` vehicles starts at: the first at
    the fraction ``start`` of the lap, the others ``n / streams`` apart."""
    n = len(lap.T_cw)
    first = int(start * n)
    return [(first + (b * n) // streams) % n for b in range(streams)]
