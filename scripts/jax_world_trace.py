#!/usr/bin/env python
"""Frame-by-frame traces of the JAX package's world evaluation, in the format
of ``scripts/torch_world_trace.py``, so that ``torch_world_trace.py compare``
can hold the reference's run against the port's on the very same frames.

The frames come from ``torch_world_trace.py render`` (the canonical circuit
rendered once on the CPU, as uint8).  The JAX package's ``run_world_eval``
drives them (loop ON, then the loop-OFF baseline) on the CPU; after every
frame the trace keeps the online pose (``current_pose``), the tracked and
inlier counts and the keyframe count.  On a CPU the JAX facade reads every
frame back at once (``readback_lag`` 0), so the pose after a frame is that
frame's.

``steps`` holds single steps instead of whole runs: the JAX facade (loop
closing off) drives the first frames, and before each frame its state is
bridged into the port, which takes the same frame with ``frontend.frame_step``
(no BA); the result is held to the JAX facade's after the frame with
tests/test_torch_frontend.py's tolerances (inliers within 2, the other counts
equal, ``T_rk`` within 1e-4, track validity agreeing on 99%, median track
difference under 1e-3 px).  On a keyframe frame the port's keyframe map then
goes through the port's windowed BA and the JAX package's float32 BA, and
their window keyframe centres are held within
tests/test_torch_eval_world.py's 0.5 m of each other, with the port's damping
floor (ops/schur.py) and with JAX's.

Usage:
  python scripts/torch_world_trace.py render frames.npz
  python scripts/jax_world_trace.py run frames.npz --out jax.npz   # tens of minutes on a CPU
  python scripts/torch_world_trace.py compare jax.npz port.npz
  python scripts/jax_world_trace.py steps frames.npz --frames 40   # a few minutes on a CPU
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(frames: str, out: str, n_frames: int = 0) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import stereoslam_tpu  # noqa: F401  (pins float32 matmul precision)
    from stereoslam_tpu import eval as E
    from stereoslam_tpu.core import system as S
    from stereoslam_tpu.utils.world import WorldSequence

    z = np.load(frames)
    baseline, fx, fy, cx, cy = (float(v) for v in z["camera"])
    n = n_frames or len(z["left"])
    seq = WorldSequence(left=z["left"][:n], right=z["right"][:n], T_cw=z["T_cw"][:n],
                        timestamps=z["timestamps"][:n], baseline=baseline, fx=fx, fy=fy,
                        cx=cx, cy=cy)
    traces = []

    class Traced(S.StereoSlam):
        """The facade with a trace entry after every frame it accepts."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self._trace = {"pose": [], "tracked": [], "inliers": [], "n_kf": []}
            traces.append(self._trace)

        def process_staged(self, lr, ts):
            ok = super().process_staged(lr, ts)
            if ok:
                tr = self._trace
                tr["pose"].append(np.asarray(self.current_pose()))
                tr["tracked"].append(self.metrics["num_tracked"][-1]
                                     if self.metrics["num_tracked"] else -1)
                tr["inliers"].append(self.metrics["num_inliers"][-1]
                                     if self.metrics["num_inliers"] else -1)
                tr["n_kf"].append(int(self.map.n_kf))
            return ok

    S.StereoSlam = Traced  # run_world_eval imports the facade from the module at call time
    t0 = time.perf_counter()
    rec = E.run_world_eval(n_frames=n, seq=seq, readback_lag=0)
    rec["device"] = f"jax {jax.__version__} cpu"
    rec["wall_s"] = round(time.perf_counter() - t0, 1)
    arrays = {f"{name}_{k}": np.asarray(v) for name, tr in zip(("on", "off"), traces)
              for k, v in tr.items()}
    np.savez(out, record=json.dumps(rec), T_cw=seq.T_cw, **arrays)
    print(json.dumps(rec), flush=True)


def _np_tree(nt):
    return {k: (_np_tree(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in nt._asdict().items()}


def _stereo_flips(fs2, m, left, right, intr_l, intr_r, pcfg, jcfg, keyframe: bool):
    """Where the port's landmark count differs from JAX's on a keyframe or
    replenish frame: the stereo matcher of both packages on the same tracks
    (after the keyframe's detection) and pyramids, and each feature whose
    landmark gate comes out differently, with the values the gates read."""
    import jax.numpy as jnp

    from stereoslam_tpu.core import frontend as jfrontend
    from stereoslam_tpu.core.state import TrackState as JTrackState
    from stereoslam_tpu.ops import camera as jcam
    from stereoslam_tpu.ops import lk as jlk
    from stereoslam_tpu.ops import triangulate as jtri
    from stereoslam_tpu_torch.core import frontend as pfrontend
    from stereoslam_tpu_torch.ops import camera as pcam
    from stereoslam_tpu_torch.ops import lk as plk
    from stereoslam_tpu_torch.ops import triangulate as ptri
    from stereoslam_tpu_torch.ops.image import build_lk_pyramid

    t = pcfg.tracking
    tracks = fs2.tracks
    detect_diff = 0
    if keyframe:
        tracks = pfrontend._detect_and_fill(tracks, left, pcfg.features.n_new_features, pcfg)
        # The keyframe's detection in both packages from the same tracks.
        jt = jfrontend._detect_and_fill(
            JTrackState(*(jnp.asarray(x.numpy()) for x in fs2.tracks)), jnp.asarray(left.numpy()),
            jcfg.features.n_new_features, jcfg)
        vj, vp = np.asarray(jt.valid), tracks.valid.numpy()
        moved = np.abs(np.asarray(jt.xy) - tracks.xy.numpy()).max(1) > 1e-3
        detect_diff = int((vj != vp).sum() + (moved & vj & vp).sum())
    depth = min(t.lk_stereo_levels or t.lk_levels,
                pfrontend._max_pyramid_depth(*left.shape, t.lk_window))
    pl = pfrontend._extend_pyramid(build_lk_pyramid(left, t.lk_levels), depth)
    pr = pfrontend._extend_pyramid(build_lk_pyramid(right, t.lk_levels), depth)
    kw = dict(window=t.lk_window, iters=t.lk_iters, eps=t.lk_eps)
    fp = plk.pyramidal_lk(pl, pr, tracks.xy, tracks.xy, **kw)
    xy = jnp.asarray(tracks.xy.numpy())
    fj = jlk.pyramidal_lk([jnp.asarray(x.numpy()) for x in pl],
                          [jnp.asarray(x.numpy()) for x in pr], xy, xy, **kw)
    # Each package triangulates its own matches (the same points, where the
    # matchers agree) with its own eigensolver.
    T_cw = fs2.T_rk @ pfrontend._ref_kf_pose(fs2, m)
    T_rc = pcam.stereo_right_pose(pcfg.camera.baseline) @ T_cw
    p_p, ok_p = ptri.triangulate_stereo(tracks.xy, fp.points, T_cw, T_rc, intr_l, intr_r)
    ji = [jcam.Intrinsics.create(*i) for i in (intr_l, intr_r)]
    p_j, ok_j = jtri.triangulate_stereo(xy, fj.points, jnp.asarray(T_cw.numpy()),
                                        jnp.asarray(T_rc.numpy()), *ji)
    cand = (tracks.valid & (tracks.lm_idx < 0)).numpy()
    out = []
    for i in np.nonzero(cand)[0]:
        sp, sj = bool(fp.status[i]), bool(np.asarray(fj.status)[i])
        dp = float(tracks.xy[i, 0] - fp.points[i, 0])
        dj = float(np.asarray(xy)[i, 0] - np.asarray(fj.points)[i, 0])
        zp = float((T_cw[2, :3] @ p_p[i] + T_cw[2, 3]))
        zj = float(np.asarray(T_cw[2, :3].numpy(), np.float32) @ np.asarray(p_j)[i] + T_cw[2, 3])
        dyp = abs(float(tracks.xy[i, 1] - fp.points[i, 1]))
        dyj = abs(float(np.asarray(xy)[i, 1] - np.asarray(fj.points)[i, 1]))
        gp = (sp and dp >= t.stereo_min_disparity and bool(ok_p[i]) and dyp <= t.stereo_max_dy
              and zp <= t.max_landmark_depth)
        gj = (sj and dj >= t.stereo_min_disparity and bool(np.asarray(ok_j)[i])
              and dyj <= t.stereo_max_dy and zj <= t.max_landmark_depth)
        if gp != gj or sp != sj:
            # The degeneracy gate's ratio s0 / s1 (< 1e-2 passes) of the
            # port's match, in float64.
            pn = [pcam.pixel2camera(x[i].double(), intr) for x, intr in
                  ((tracks.xy, intr_l), (fp.points, intr_r))]
            A = np.concatenate([np.stack([pn_[0].item() * P[2] - P[0], pn_[1].item() * P[2] - P[1]])
                                for pn_, P in zip(pn, (T_cw.double().numpy()[:3],
                                                       T_rc.double().numpy()[:3]))])
            sv = np.linalg.svd(A, compute_uv=False)
            out.append({"feature": int(i), "status (port, jax)": (sp, sj),
                        "triangulated (port, jax)": (bool(ok_p[i]), bool(np.asarray(ok_j)[i])),
                        "disparity (port, jax)": (round(dp, 4), round(dj, 4)),
                        "depth m (port, jax)": (round(zp, 3), round(zj, 3)),
                        "s0/s1 float64": float(f"{sv[3] / sv[2]:.4g}"),
                        "|d point| px": round(float(np.linalg.norm(
                            fp.points[i].numpy() - np.asarray(fj.points)[i])), 5)})
    return out, int(cand.sum()), detect_diff


def _pose_costs(tracks, m_np, ref_kf, T_rks, fx, fy, cx, cy, chi2_threshold):
    """The pose LM's robust cost (Huber on chi2, float64) of each relative
    pose over the frame's linked, usable tracks: where two poses differ in a
    direction the points barely observe, their costs agree."""
    xy = tracks.xy.numpy().astype(np.float64)
    idx = tracks.lm_idx.numpy()
    use = tracks.valid.numpy() & (idx >= 0)
    use &= m_np["lm_valid"][np.maximum(idx, 0)] & ~m_np["lm_outlier"][np.maximum(idx, 0)]
    p = m_np["lm_pos"][idx[use]].astype(np.float64)
    T_ref = m_np["kf_T_cw"][ref_kf].astype(np.float64)
    out = []
    for T_rk in T_rks:
        T = np.asarray(T_rk, np.float64) @ T_ref
        pc = p @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1)
        chi2 = ((uv - xy[use]) ** 2).sum(1)
        d2 = chi2_threshold
        out.append(float(np.minimum(chi2, d2 + np.sqrt(d2 * chi2)).sum()))
    return out, int(use.sum())


def steps(frames: str, n_frames: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import stereoslam_tpu  # noqa: F401  (pins float32 matmul precision)
    from stereoslam_tpu import config as jconfig
    from stereoslam_tpu.core import backend as jbackend
    from stereoslam_tpu.core.state import MapState as JMapState
    from stereoslam_tpu.core.system import StereoSlam as JaxSlam
    from stereoslam_tpu.ops.camera import Intrinsics as JIntr
    from stereoslam_tpu_torch import bridge
    from stereoslam_tpu_torch import config as pconfig
    from stereoslam_tpu_torch.core import backend as pbackend
    from stereoslam_tpu_torch.core import frontend as pfrontend
    from stereoslam_tpu_torch.ops import schur

    z = np.load(frames)
    baseline, fx, fy, cx, cy = (float(v) for v in z["camera"])
    h, w = z["left"].shape[1:]

    def cfg_of(mod):
        cam = mod.CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, fx_right=fx, fy_right=fy,
                               cx_right=cx, cy_right=cy, bf=fx * baseline)
        return mod.SlamConfig(camera=cam, image_height=h, image_width=w).scaled_for_resolution()

    jcfg, pcfg = cfg_of(jconfig), cfg_of(pconfig)
    jintr = JIntr.create(fx, fy, cx, cy)
    intr_l, intr_r = bridge.intrinsics_from_config(pcfg)
    jax_ba = jax.jit(lambda m: jbackend.optimize_active_map(m, jintr, jcfg))
    slam = JaxSlam(jcfg, enable_loop=False, readback_lag=0)
    lr0 = (z["left"][0], z["right"][0], float(z["timestamps"][0]))
    assert slam.process_frame(*lr0)
    worst = {"inliers": 0, "T_rk": 0.0, "valid": 1.0, "track_px": 0.0, "ba_m": 0.0,
             "ba_m_jax_floor": 0.0}
    beyond = []
    T_wc = np.linalg.inv(z["T_cw"].astype(np.float64))
    for t in range(1, n_frames):
        fs_np, m_np = _np_tree(slam.fs), _np_tree(slam.map)
        pyr_np = [np.asarray(p) for p in slam._pyr_prev]
        if not slam.process_frame(z["left"][t], z["right"][t], float(z["timestamps"][t])):
            print(f"frame {t}: the JAX facade is LOST", flush=True)
            break
        fs_j, m_j = _np_tree(slam.fs), _np_tree(slam.map)
        lr = torch.from_numpy(np.stack([z["left"][t], z["right"][t]]))
        fs_p, m_p, _, counts = pfrontend.frame_step(
            lr[0].float(), lambda: lr[1].float(), bridge.pyramid_from_numpy(pyr_np, "cpu"),
            bridge.frontend_state_from_numpy(fs_np, "cpu"),
            bridge.map_state_from_numpy(m_np, "cpu"), intr_l, intr_r, pcfg.camera.baseline,
            torch.tensor(float(z["timestamps"][t]), dtype=torch.float32), pcfg)
        c = counts.numpy()
        d_inl = abs(int(c[0]) - slam.metrics["num_inliers"][-1])
        pairs = {"tracked": (int(c[1]), slam.metrics["num_tracked"][-1]),
                 "n_kf": (int(m_p.n_kf), int(m_j["n_kf"])), "n_lm": (int(m_p.n_lm), int(m_j["n_lm"]))}
        same_counts = all(a == b for a, b in pairs.values())
        d_T = float(np.abs(fs_p.T_rk.numpy() - fs_j["T_rk"]).max())
        vp, vj = fs_p.tracks.valid.numpy(), fs_j["tracks"]["valid"]
        agree = float((vp == vj).mean())
        both = vp & vj
        med = float(np.median(np.linalg.norm(fs_p.tracks.xy.numpy()[both]
                                             - fs_j["tracks"]["xy"][both], axis=1)))
        line = (f"frame {t}: inliers port {int(c[0])} jax {slam.metrics['num_inliers'][-1]}, "
                f"counts {'equal' if same_counts else f'DIFFER (port, jax) {pairs}'}, "
                f"|d T_rk| {d_T:.2e}, valid "
                f"agree {agree:.3f}, median |d track| {med:.2e} px")
        worst.update(inliers=max(worst["inliers"], d_inl), T_rk=max(worst["T_rk"], d_T),
                     valid=min(worst["valid"], agree), track_px=max(worst["track_px"], med))
        off = d_inl > 2 or not same_counts or d_T > 1e-4 or agree < 0.99 or med > 1e-3
        if d_T > 1e-4:
            costs, n_pts = _pose_costs(fs_p.tracks, m_np, int(fs_j["ref_kf"]),
                                       (fs_p.T_rk.numpy(), fs_j["T_rk"]), fx, fy, cx, cy,
                                       pcfg.tracking.chi2_threshold)
            line += (f"; robust pose cost (float64) over {n_pts} points: port {costs[0]:.4f}, "
                     f"jax {costs[1]:.4f}")
        if int(m_p.n_kf) > int(m_np["n_kf"]):
            # One windowed BA from the same keyframe map: the port's (float64,
            # with and without its damping floor) and JAX's float32.
            win = m_p.active_kf.numpy()
            win = win[win >= 0]
            mj = jax_ba(JMapState(**{k: jnp.asarray(v) for k, v in
                                     bridge.map_state_to_numpy(m_p).items()}))
            cj = np.linalg.inv(np.asarray(mj.kf_T_cw, np.float64)[win])[:, :3, 3]
            dists = []
            for floor in (None, 1e-8):
                schur.DAMPING_FLOOR = floor
                mp = pbackend.optimize_active_map(m_p, intr_l, pcfg)
                schur.DAMPING_FLOOR = None
                cp = np.linalg.inv(mp.kf_T_cw.numpy().astype(np.float64)[win])[:, :3, 3]
                dists.append(float(np.linalg.norm(cp - cj, axis=1).max()))
            fid = m_p.kf_frame_id.numpy()[win]
            gt = (np.linalg.inv(T_wc[0]) @ T_wc[fid])[:, :3, 3]
            line += (f"; keyframe {int(m_p.n_kf) - 1}, window {win.tolist()}: BA window centres "
                     f"port against JAX {dists[0]:.3f} m (JAX's floor: {dists[1]:.3f} m), JAX "
                     f"against ground truth {np.linalg.norm(cj - gt, axis=1).max():.3f} m")
            worst.update(ba_m=max(worst["ba_m"], dists[0]),
                         ba_m_jax_floor=max(worst["ba_m_jax_floor"], dists[1]))
            off |= dists[0] > 0.5
        if pairs["n_lm"][0] != pairs["n_lm"][1]:
            fs2, _, _ = pfrontend.track_frame(
                lr[0].float(), bridge.pyramid_from_numpy(pyr_np, "cpu"),
                bridge.frontend_state_from_numpy(fs_np, "cpu"),
                bridge.map_state_from_numpy(m_np, "cpu"), intr_l, pcfg)
            flips, n_cand, n_det = _stereo_flips(
                fs2, bridge.map_state_from_numpy(m_np, "cpu"), lr[0].float(), lr[1].float(),
                intr_l, intr_r, pcfg, jcfg, keyframe=int(m_p.n_kf) > int(m_np["n_kf"]))
            line += (f"; keyframe detection slots that differ: {n_det}; stereo matcher on the "
                     f"same {n_cand} candidates, gates that differ: {flips}")
        if off:
            beyond.append(t)
        print(line + ("  BEYOND TOLERANCE" if off else ""), flush=True)
    print(json.dumps({"frames": n_frames, "worst": worst, "beyond_tolerance": beyond}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("frames", help="frames file written by torch_world_trace.py render")
    r.add_argument("--out", required=True)
    r.add_argument("--frames", type=int, default=0, dest="n_frames",
                   help="the first N frames only (default: all)")
    s = sub.add_parser("steps")
    s.add_argument("frames", help="frames file written by torch_world_trace.py render")
    s.add_argument("--frames", type=int, default=40, dest="n_frames")
    args = ap.parse_args()
    if args.cmd == "run":
        run(args.frames, args.out, args.n_frames)
    else:
        steps(args.frames, args.n_frames)


if __name__ == "__main__":
    main()
