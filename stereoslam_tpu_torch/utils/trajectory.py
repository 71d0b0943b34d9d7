"""Trajectory + loop-edge export/import in the reference's formats.

numpy-only port of ``stereoslam_tpu/utils/trajectory.py``: lines of
``kf_id timestamp tx ty tz qx qy qz qw`` with poses as T_wc = inv(T_cw)
(reference src/system.cpp:153-178), and two lines per loop edge
(system.cpp:187-224).  The quaternion conversion runs in float32 like the
JAX original, so both write identical files.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def to_quaternion(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> unit quaternion [qx, qy, qz, qw], float32 math
    (mirrors ``ops/se3.py`` ``to_quaternion``: largest-pivot extraction)."""
    R = np.asarray(R, np.float32)
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    trace = m00 + m11 + m22
    one, half, four = np.float32(1), np.float32(0.5), np.float32(4)

    def _s(x):
        return np.sqrt(np.maximum(x, np.float32(1e-12)))

    pivots = [trace, m00, m11, m22]
    choice = int(np.argmax(pivots))
    if choice == 0:
        qw = half * _s(one + trace)
        q = [(R[2, 1] - R[1, 2]) / (four * qw), (R[0, 2] - R[2, 0]) / (four * qw),
             (R[1, 0] - R[0, 1]) / (four * qw), qw]
    elif choice == 1:
        qx = half * _s(one + m00 - m11 - m22)
        q = [qx, (R[0, 1] + R[1, 0]) / (four * qx), (R[0, 2] + R[2, 0]) / (four * qx),
             (R[2, 1] - R[1, 2]) / (four * qx)]
    elif choice == 2:
        qy = half * _s(one - m00 + m11 - m22)
        q = [(R[0, 1] + R[1, 0]) / (four * qy), qy, (R[1, 2] + R[2, 1]) / (four * qy),
             (R[0, 2] - R[2, 0]) / (four * qy)]
    else:
        qz = half * _s(one - m00 - m11 + m22)
        q = [(R[0, 2] + R[2, 0]) / (four * qz), (R[1, 2] + R[2, 1]) / (four * qz), qz,
             (R[1, 0] - R[0, 1]) / (four * qz)]
    q = np.asarray(q, np.float32)
    return q / np.linalg.norm(q)


def from_quaternion(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Quaternion [qx, qy, qz, qw] + translation -> (4, 4) float32."""
    q = np.asarray(q, np.float32)
    x, y, z, w = q / np.linalg.norm(q)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    T[:3, 3] = np.asarray(t, np.float32)
    return T


def _pose_to_line(kf_id: int, ts: float, T_cw: np.ndarray) -> str:
    T_wc = np.linalg.inv(T_cw.astype(np.float64))
    t = T_wc[:3, 3]
    q = to_quaternion(T_wc[:3, :3].astype(np.float32))
    return (
        f"{kf_id} {ts:.6f} "
        f"{t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
    )


def save_trajectory(
    path: str,
    kf_ids: Sequence[int],
    timestamps: Sequence[float],
    T_cw: np.ndarray,
) -> None:
    """Write keyframe trajectory sorted by KF id (system.cpp:158-176)."""
    order = np.argsort(np.asarray(kf_ids))
    with open(path, "w") as f:
        for i in order:
            f.write(_pose_to_line(int(kf_ids[i]), float(timestamps[i]), T_cw[i]) + "\n")


def save_loop_edges(
    path: str,
    edges: Sequence[Tuple[int, int]],
    kf_ids: Sequence[int],
    timestamps: Sequence[float],
    T_cw: np.ndarray,
) -> None:
    """Write loop edges: for each (current, loop) pair, the two KF pose lines
    (system.cpp:203-220)."""
    id_to_row = {int(k): i for i, k in enumerate(kf_ids)}
    with open(path, "w") as f:
        for cur, loop in edges:
            for k in (cur, loop):
                i = id_to_row[int(k)]
                f.write(_pose_to_line(int(k), float(timestamps[i]), T_cw[i]) + "\n")


def load_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a reference-format trajectory file.

    Returns (kf_ids (N,), timestamps (N,), T_wc (N, 4, 4)).
    """
    ids: List[int] = []
    ts: List[float] = []
    poses: List[np.ndarray] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 9:
                continue
            ids.append(int(float(parts[0])))
            ts.append(float(parts[1]))
            t = np.array([float(x) for x in parts[2:5]])
            q = np.array([float(x) for x in parts[5:9]], dtype=np.float32)
            poses.append(from_quaternion(q, t).astype(np.float64))
    return np.asarray(ids), np.asarray(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))
