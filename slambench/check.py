"""Whether what the timed path produced is correct: the program's outputs
at sampled frames and BAs of the window, against the plain reference
(``slambench/reference/``), once the window has closed.

A SLAM run cannot be recomputed from its frames alone: every frame carries
the state of all the frames before it, and two correct implementations part
after a few frames (float rounding, amplified by the chaotic feedback of
tracking).  So the reference follows the program one step at a time, from
the program's own state before that step:

- **the tracked frame** (K1 ``lk_pyramid``, the pose LM): at sampled
  keyframe-free frames, the state the frame read (its tracks, its pose
  relative to the reference keyframe, its velocity, the landmarks and
  keyframe poses) is copied before the call and the state it wrote after;
  the reference tracks the frame again from the benchmark's own two images
  and compares the pose (``track_pose_gap_m``: the camera centres' distance).
  In the fleet, every live stream of a sampled step that served no keyframe;
- **the windowed BA**: at sampled BAs of the window, the map fields the BA
  read and the poses and landmarks it wrote; the reference solves the same
  window in float64 and compares the window's camera centres
  (``ba_pose_gap_m``) and the landmarks it moved (``ba_point_gap_m``);
- **stereo triangulation and the keyframe insert** (``StereoSlam`` only):
  the new landmarks of the keyframe whose BA was sampled, as the BA read
  them, against the reference's stereo LK on the benchmark's own right
  image and its triangulation at the inserted pose (``tri_gap``: the median
  distance over the depth).

``Sampler`` draws the samples from the run's seed.  The compared numbers and
their limits are the cell's (``check.limits`` of its workload file); the
others are printed as information.  ``control=True`` also computes each
number for the control, the reference in the precision below the stated
one: TF32 for the float32 frame path, float32 for the float64 BA.
"""

from __future__ import annotations

import math
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from slambench.reference import ba as ref_ba
from slambench.reference import lk as ref_lk
from slambench.reference import se3 as ref_se3
from slambench.reference.camera import Intrinsics, stereo_right_pose
from slambench.reference.image import build_lk_pyramid
from slambench.reference.track import TrackIn, max_pyramid_depth, track
from slambench.reference.triangulate import triangulate_stereo

TRACK_MAP_FIELDS = ("lm_pos", "lm_valid", "lm_outlier", "kf_T_cw")
BA_OUT_FIELDS = ("kf_T_cw", "lm_pos")


class _Pool:
    """Copies made into buffers allocated before the window, so that a
    sample allocates no device memory (a ``cudaMalloc`` stalls the card)
    inside it; a copy with no buffer left allocates."""

    def __init__(self):
        self.free = defaultdict(list)

    @staticmethod
    def _key(x):
        return tuple(x.shape), x.dtype, x.device

    def reserve(self, x, n: int) -> None:
        self.free[self._key(x)].extend(torch.empty_like(x) for _ in range(n))

    def copy(self, x):
        free = self.free.get(self._key(x))
        return free.pop().copy_(x) if free else x.detach().clone()


class _BASpy:
    """Stands in the facade's place of its BA callable (``map -> map``),
    passes every call through, and keeps the sampled calls' input fields
    and output poses and landmarks."""

    def __init__(self, real, sampler: "Sampler"):
        self._real, self._sampler = real, sampler

    def __call__(self, m):
        s = self._sampler
        take = s.draw_ba()
        inp = {f: s.pool.copy(getattr(m, f)) for f in ref_ba.BAMap._fields} if take else None
        out = self._real(m)
        if take:
            s.ba.append(dict(inp=inp, out={f: s.pool.copy(getattr(out, f)) for f in BA_OUT_FIELDS},
                             frame=s.frame_lap))
        return out

    def __getattr__(self, name):
        return getattr(self._real, name)


class Sampler:
    def __init__(self, run):
        chk = run.cell["check"]
        self.run = run
        rng = np.random.default_rng([int(run.seed) % (1 << 63), 7])
        # Which calls of the window are sampled: ``track_samples`` of its
        # first ``track_span`` frames (or fleet steps), ``ba_samples`` of its
        # first ``ba_span`` BAs, drawn from the seed.  A drawn frame that
        # makes a keyframe or replenishes passes its draw to the next frame.
        self.track_at = set(rng.choice(chk["track_span"], chk["track_samples"], replace=False))
        self.ba_at = set(rng.choice(chk["ba_span"], chk["ba_samples"], replace=False))
        self.tracked: List[dict] = []
        self.ba: List[dict] = []
        self.frames_seen = self.bas_seen = self.track_due = 0
        self.pool = _Pool()
        self.window_open = False
        self._take_next = False
        self.frame_lap: Optional[int] = None  # the lap frame of the frame in the call

    def attach_ba(self, facade) -> None:
        if not hasattr(facade, "_ba"):
            raise AttributeError(f"{type(facade).__name__} has no BA callable (_ba) to sample")
        facade._ba = _BASpy(facade._ba, self)

    def open(self, fs, maps, batched: bool) -> None:
        """Open the window, the buffers of its samples allocated first:
        ``fs`` and ``maps`` are the facade's state (``batched``: with a
        leading batch, whose BA runs on one stream's map)."""
        chk = self.run.cell["check"]
        for x in self._snapshot(fs, maps).values():
            self.pool.reserve(x, chk["track_samples"])
        for x in (fs.T_rk, fs.ref_kf):
            self.pool.reserve(x, chk["track_samples"])
        for f in ref_ba.BAMap._fields:
            x = getattr(maps, f)
            self.pool.reserve(x[0] if batched else x, chk["ba_samples"])
        self.window_open = True

    def close(self) -> None:
        self.window_open = False

    def take_next_ba(self, lap_index: int) -> None:
        """Sample the next BA whatever the window: the initialization's, whose
        new landmarks are the start that every later step builds on."""
        self._take_next, self.frame_lap = True, lap_index

    def draw_ba(self) -> bool:
        if self._take_next:
            self._take_next = False
            return True
        if not self.window_open:
            return False
        self.bas_seen += 1
        return self.bas_seen - 1 in self.ba_at

    def _draw_track(self) -> bool:
        self.frames_seen += 1
        self.track_due += self.frames_seen - 1 in self.track_at
        return self.track_due > 0

    def _snapshot(self, fs, map_state) -> dict:
        """The state a tracked frame reads (``map_state``: the maps, with a
        leading batch in the fleet)."""
        c = self.pool.copy
        return dict(xy=c(fs.tracks.xy), lm_idx=c(fs.tracks.lm_idx), valid=c(fs.tracks.valid),
                    T_rk=c(fs.T_rk), T_vel=c(fs.T_vel), ref_kf=c(fs.ref_kf),
                    **{f: c(getattr(map_state, f)) for f in TRACK_MAP_FIELDS})

    # -- StereoSlam -----------------------------------------------------
    def before_frame(self, slam, k: int, lap_index: int):
        self.frame_lap = lap_index
        return self._snapshot(slam.fs, slam.map) if self._draw_track() else None

    def after_frame(self, slam, pre: dict, prev_lap: int, cur_lap: int) -> None:
        """A drawn frame that made neither keyframe nor replenishment."""
        self.track_due -= 1
        self.tracked.append(dict(pre=pre, prev=prev_lap, cur=cur_lap,
                                 T_rk=self.pool.copy(slam.fs.T_rk)))

    # -- MultiSeqVO -----------------------------------------------------
    def before_step(self, vo, k: int):
        return self._snapshot(vo.fs, vo.maps) if self._draw_track() else None

    def after_step(self, vo, pre: dict, prev_lap: List[int], cur_lap: List[int]) -> None:
        self.track_due -= 1
        fs = vo.fs
        self.tracked.append(dict(pre=pre, prev=prev_lap, cur=cur_lap, T_rk=self.pool.copy(fs.T_rk),
                                 ref_kf=self.pool.copy(fs.ref_kf), alive=vo.alive.copy()))


@contextmanager
def _tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _centre(T: torch.Tensor) -> np.ndarray:
    T = T.detach().double().cpu().numpy()
    return -T[..., :3, :3].swapaxes(-1, -2) @ T[..., :3, 3:4]


def _intr(config: dict) -> Intrinsics:
    c = config["slam"]["camera"]
    return Intrinsics.create(c["fx"], c["fy"], c["cx"], c["cy"])


def _track_ref(s: dict, b: Optional[int], prev_u8, cur_u8, config, control: bool):
    pick = (lambda x: x) if b is None else (lambda x: x[b])
    inp = TrackIn(xy=pick(s["xy"]), lm_idx=pick(s["lm_idx"]), valid=pick(s["valid"]),
                  T_rk=pick(s["T_rk"]), T_vel=pick(s["T_vel"]), ref_kf=int(pick(s["ref_kf"])),
                  lm_pos=pick(s["lm_pos"]), lm_valid=pick(s["lm_valid"]),
                  lm_outlier=pick(s["lm_outlier"]), kf_T_cw=pick(s["kf_T_cw"]))
    slam = config["slam"]
    with _tf32(control):
        return track(inp, prev_u8, cur_u8, _intr(config), slam["tracking"], slam["features"])


def tracked_gaps(run, control: bool = False) -> Dict[str, List[float]]:
    """Per compared tracked frame: the camera centres' distance (m) between
    the program's pose and the reference's.  With ``control`` the same
    between the control and the reference."""
    frames = run.lap.frames
    out = {"track_pose_gap_m": []}
    for smp in run.samples["tracked"]:
        pre = smp["pre"]
        batched = isinstance(smp["prev"], list)
        for b in (range(len(smp["prev"])) if batched else [None]):
            if batched and (not smp["alive"][b] or int(smp["ref_kf"][b]) != int(pre["ref_kf"][b])):
                continue  # a stream lost, or served a keyframe in this step
            prev_i = smp["prev"][b] if batched else smp["prev"]
            cur_i = smp["cur"][b] if batched else smp["cur"]
            ref = _track_ref(pre, b, frames[prev_i, 0], frames[cur_i, 0], run.config, False)
            if control:
                T = _track_ref(pre, b, frames[prev_i, 0], frames[cur_i, 0], run.config, True).T_rk
            else:
                T = smp["T_rk"] if b is None else smp["T_rk"][b]
            out["track_pose_gap_m"].append(float(np.linalg.norm(_centre(T) - _centre(ref.T_rk))))
    return out


def ba_gaps(run, control: bool = False) -> Dict[str, List[float]]:
    """Per sampled BA: the largest distance (m) between the program's and the
    reference's camera centres over the window, and between the landmarks
    either moved.  With ``control`` the same between the control (a float32
    solve) and the reference."""
    backend = run.config["slam"]["backend"]
    intr = _intr(run.config)
    out = {"ba_pose_gap_m": [], "ba_point_gap_m": []}
    for smp in run.samples["ba"]:
        inp = ref_ba.BAMap(**smp["inp"])
        ref = ref_ba.optimize_active_map(inp, intr, backend, torch.float64)
        got = (ref_ba.optimize_active_map(inp, intr, backend, torch.float32) if control
               else smp["out"])
        kf = inp.active_kf[inp.active_kf >= 0].long()
        cg = np.linalg.norm(_centre(got["kf_T_cw"][kf]) - _centre(ref["kf_T_cw"][kf]), axis=1)
        moved = ((ref["lm_pos"] != inp.lm_pos) | (got["lm_pos"] != inp.lm_pos)).any(-1)
        pg = (got["lm_pos"][moved].double() - ref["lm_pos"][moved].double()).norm(dim=-1)
        out["ba_pose_gap_m"].append(float(cg.max()) if cg.size else 0.0)
        out["ba_point_gap_m"].append(float(pg.max()) if pg.numel() else 0.0)
    return out


def tri_gaps(run, control: bool = False) -> Dict[str, List[float]]:
    """Per sampled BA of ``StereoSlam`` whose newest keyframe made
    landmarks: the median, over those landmarks, of the distance between the
    program's position (as the BA read it) and the reference's
    triangulation, over the reference's depth."""
    out = {"tri_gap": []}
    if run.config["system"] != "StereoSlam":
        return out
    slam = run.config["slam"]
    t = slam["tracking"]
    intr = _intr(run.config)
    baseline = slam["camera"]["bf"] / slam["camera"]["fx"]
    for smp in run.samples["ba"]:
        inp = ref_ba.BAMap(**smp["inp"])
        kf = int(inp.active_kf.max())
        new = (inp.lm_first_kf == kf) & inp.lm_valid
        feat_lm = inp.kf_feat_lm[kf]
        sel = (feat_lm >= 0) & new[feat_lm.clamp(min=0).long()] & inp.kf_feat_valid[kf]
        if not bool(sel.any()) or smp["frame"] is None:
            continue
        lr = run.lap.frames[smp["frame"]].to(torch.float32)
        depth = min(t["lk_stereo_levels"] or t["lk_levels"],
                    max_pyramid_depth(*lr.shape[-2:], t["lk_window"]))
        with _tf32(control):
            xy = inp.kf_feat_xy[kf][sel]
            flow = ref_lk.pyramidal_lk(build_lk_pyramid(lr[0], depth),
                                       build_lk_pyramid(lr[1], depth), xy, xy,
                                       window=t["lk_window"], iters=t["lk_iters"], eps=t["lk_eps"])
            T_cw = inp.kf_T_cw[kf]
            T_rc = stereo_right_pose(baseline, device=T_cw.device) @ T_cw
            p_ref, _ = triangulate_stereo(xy, flow.points, T_cw, T_rc, intr, intr)
        p_got = inp.lm_pos[feat_lm[sel].long()]
        z = ref_se3.act(T_cw, p_ref)[..., 2].abs().clamp(min=1e-3)
        ok = flow.status
        if bool(ok.any()):
            out["tri_gap"].append(float(((p_got - p_ref).norm(dim=-1) / z)[ok].median()))
    return out


def evaluate(run, limits: Dict[str, float], control: bool = False) -> dict:
    """Every number (the largest over the samples), the compared ones
    beside their limits, and ``correct``.  With ``control`` also the
    control's numbers."""
    readings = {**tracked_gaps(run), **ba_gaps(run), **tri_gaps(run)}
    numbers = {k: (max(v) if v else None) for k, v in readings.items()}
    counts = {k: len(v) for k, v in readings.items()}
    compared = {}
    correct = True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct &= ok
        compared[name] = {"value": value, "limit": limit, "samples": counts.get(name, 0)}
    result = dict(correct=bool(correct), compared=compared, numbers=numbers, samples=counts)
    if control:
        ctl = {**tracked_gaps(run, True), **ba_gaps(run, True), **tri_gaps(run, True)}
        result["control"] = {k: (max(v) if v else None) for k, v in ctl.items()}
    return result
