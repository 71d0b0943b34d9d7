"""Typed configuration for the stereo SLAM pipeline (PyTorch port).

A field-for-field copy of ``stereoslam_tpu/config.py``: the JAX package
cannot be imported where JAX is not installed (its ``__init__`` imports
jax), so the port carries its own copy.  ``tests/test_torch_copies.py``
holds the two equal on every shipped config file.

Replaces the reference's stringly-typed singleton over ``cv::FileStorage``
(reference include/myslam/config.h:14-20, src/config.cpp:5-16) with frozen
dataclasses carrying defaults and validation.  The reference silently returns
zero for any missing key — a failure mode we explicitly avoid: unknown keys
warn, missing keys fall back to a documented default, and invalid values raise.

The loader understands the reference's OpenCV-YAML config files directly
(e.g. reference config/stereo/gray/KITTI00-02.yaml), so a user of the
reference can point this framework at their existing config unchanged.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole stereo camera (reference src/camera.cpp:9-48, system.cpp:101-146)."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    # Right-camera intrinsics (identical on KITTI; kept for generality).
    fx_right: float = 718.856
    fy_right: float = 718.856
    cx_right: float = 607.1928
    cy_right: float = 185.2157
    # Radial/tangential distortion (left, right).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k1_right: float = 0.0
    k2_right: float = 0.0
    p1_right: float = 0.0
    p2_right: float = 0.0
    need_undistortion: bool = False
    # Stereo baseline times fx (reference "Camera.bf"). baseline = bf / fx.
    bf: float = 386.1448
    fps: float = -1.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    def validate(self) -> None:
        if self.fx <= 0 or self.fy <= 0:
            raise ValueError(f"focal lengths must be positive: fx={self.fx} fy={self.fy}")
        if self.bf <= 0:
            raise ValueError(f"Camera.bf (baseline*fx) must be positive: {self.bf}")


@dataclass(frozen=True)
class FeatureConfig:
    """ORB extraction + tracking-quality thresholds.

    Mirrors reference config KITTI00-02.yaml:47-66 and the frontend status
    machine thresholds (reference src/frontend.cpp:21-39, 97-109).
    """

    num_features_init_good: int = 100   # min inliers to accept stereo init
    num_features_tracking_good: int = 50
    num_features_tracking_bad: int = 10
    n_init_features: int = 300          # ORB features at init
    n_new_features: int = 100           # new features per keyframe
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Fixed-shape capacities (TPU-native additions; must dominate the counts above).
    max_features: int = 400             # feature slots per frame
    cell_size: int = 16                 # grid cell for spatially-uniform detection
    edge_margin: int = 20               # border kept clear of keypoints (BRIEF patch)

    def validate(self) -> None:
        if self.max_features < self.n_init_features:
            raise ValueError("max_features must be >= n_init_features")
        if not (1.0 < self.scale_factor < 2.0):
            raise ValueError(f"scale_factor out of range: {self.scale_factor}")
        if self.n_levels < 1 or self.n_levels > 12:
            raise ValueError(f"n_levels out of range: {self.n_levels}")


@dataclass(frozen=True)
class TrackingConfig:
    """LK flow + pose-only optimization (reference src/frontend.cpp:127-276)."""

    lk_window: int = 11        # cv::Size(11, 11), frontend.cpp:150
    # Pyramid depth.  The reference uses maxLevel=3 -> 4 levels
    # (frontend.cpp:150) because OpenCV LK starts from scratch; here LK is
    # seeded with map-reprojection priors and backed by the rescue re-track,
    # so the 4th (coarsest) level's large-motion insurance is redundant: a
    # 7-seed canonical-world ensemble measured lk_levels=3 statistically
    # neutral on ATE (mean 1.59 vs 1.44 m, paired diffs scatter around
    # zero, 4/4 loop edges every seed, zero LOST —
    # scripts/SWEEP_SEEDS_AB.json) while cutting the fused frame program
    # ~29% (chain 134 vs 104 FPS at KITTI res; every pyramidal-LK pass —
    # temporal, stereo, replenish, forward-backward — shrinks with it).
    lk_levels: int = 3
    # Stereo-matching pyramid depth (FindFeaturesInRight + init +
    # replenish, frontend.cpp:335-379/451-488).  Stereo LK seeds at ZERO
    # disparity, so near landmarks (disparity up to ~90 px at the canonical
    # camera) need the coarse levels that reprojection-seeded temporal
    # tracking no longer pays for — 3 shared levels lost the near field and
    # broke the blob-world loop test (ATE 0.67 -> 7.75, r5).  Cost lands on
    # keyframe/replenish frames only.  0 = follow lk_levels.
    lk_stereo_levels: int = 4
    # Iteration cap per level.  The reference's OpenCV call uses 30
    # (frontend.cpp:150); here LK is seeded with map-reprojection priors and
    # runs an early-exit convergence loop, and 20 measured BOTH faster
    # (~+15 FPS end-to-end on v5e at KITTI res) and more accurate on the
    # canonical world circuit (ATE 0.72 vs 0.90 m — the extra iterations let
    # marginal low-texture windows creep onto lookalike minima that the
    # forward-backward gate then narrowly passes).
    lk_iters: int = 20
    lk_eps: float = 0.01
    pose_rounds: int = 4       # outlier re-classification rounds, frontend.cpp:218
    pose_iters: int = 10       # LM iterations per round
    chi2_threshold: float = 5.991
    # Stereo triangulation quality gates (TPU-native addition: the reference
    # triangulates every LK stereo match, frontend.cpp:451-488, which lets
    # low-disparity matches inject landmarks with unbounded depth error).
    stereo_min_disparity: float = 1.0   # pixels
    stereo_max_dy: float = 1.5          # rectified epipolar violation, pixels
    max_landmark_depth: float = 80.0    # meters
    # Forward-backward LK consistency threshold (px) for temporal tracking;
    # rejects ghost locks from reprojection-biased seeds. 0 disables.
    # 2.0 px keeps sub-pixel-honest tracks on photometrically realistic
    # imagery while still killing ghost locks (1.0 px measurably rejects
    # good tracks on perspective-correct texture and worsens ATE ~3x).
    lk_forward_backward: float = 2.0
    # Pyramid levels used by the backward (consistency) pass; 0 = all.  A
    # ghost lock disagrees with the true motion by many pixels, which the
    # finest levels expose without paying the full coarse-to-fine sweep
    # twice (ops/lk.py pyramidal_lk).
    lk_fb_levels: int = 0
    # Iteration cap for the backward (consistency) pass.  The round trip only
    # has to land in the right basin, not converge to sub-pixel precision —
    # the r5 knob probe measured the FB pass at ~2.5 ms/frame of the 5.1 ms
    # LK budget at KITTI res, so its cap is tunable separately.
    lk_fb_iters: int = 10
    # Rescue LK pass seeded at the previous positions, fired (device-side
    # cond) only when more than this fraction of valid tracks failed the
    # seeded pass — i.e. when the constant-velocity prior misled (corner
    # entries).  0 disables.
    lk_retry_fail_frac: float = 0.2
    # Second (DEEP) rescue pass: when the prev-position rescue still leaves
    # more than lk_retry_fail_frac of the valid tracks failed, re-track the
    # survivors-to-be with the pyramid extended by this many extra coarse
    # levels (capped so no level falls under 2 LK windows).  This restores
    # the reference's maxLevel=3 large-motion catch range EXACTLY where it
    # is needed — fast turns at high resolution, where per-frame flow
    # exceeds the 3-level range (r5: the KITTI-res world circuit went LOST
    # at a corner under lk_levels=3; the straight-line steady state never
    # fires either cond and keeps the 29% chain-time win).  0 disables.
    lk_rescue_extra_levels: int = 1
    # Trigger fraction for the DEEP pass, deliberately harder than the
    # shallow rescue's: the deep re-track's coarse levels cost accuracy on
    # tracks the shallow pyramid could have handled, so it should fire only
    # on catastrophic prior failure (most of the frame lost — the LOST
    # precursor), not on routine corner-entry spikes.
    lk_deep_rescue_frac: float = 0.5
    # Pose trust region (frontend.py track_step): reject an LM pose that is
    # BOTH weak (inliers < tracking_good) and further than
    # factor*|log(T_vel)| + min from the motion prediction; dead-reckon that
    # frame instead.  Breaks the wild-pose -> poisoned-keyframe death
    # spiral at corner entries.  factor 0 disables.
    pose_trust_factor: float = 3.0
    pose_trust_min: float = 0.5
    # Unlink a feature<->landmark link only when its final chi2 exceeds
    # unlink_chi2_factor * chi2_threshold (counting/status still use the
    # reference's threshold).  1.0 = reference parity (unlink at the
    # counting bar, frontend.cpp:255-270).  Values > 1 keep borderline
    # links alive; measured on the world circuit the retained links block
    # slot re-triangulation and do NOT raise the inlier pool, so parity
    # ships.
    unlink_chi2_factor: float = 1.0
    # Mid-stream landmark replenishment (TPU-native; the reference only
    # triangulates on keyframes): on a GOOD frame with fewer inliers than
    # this, stereo-match + triangulate the alive-but-unlinked track pool
    # in-program — keyframes then fire on genuine detection need, closing
    # the keyframe-rate gap vs the reference (~16% on KITTI 00).  0 disables.
    replenish_min_inliers: int = 80
    # Skip when the unlinked pool is small: each replenish converts the
    # whole pool, so a high floor makes replenishes rare-but-effective
    # (the drained pool is its own cooldown) instead of firing a stereo
    # pass every sagging frame.
    replenish_min_pool: int = 40
    # Maximum frames between keyframes.  The reference's only KF trigger is
    # "tracking got weak" (frontend.cpp:111-119) — with mid-stream
    # replenishment tracking can stay strong indefinitely, which would
    # starve the BA window, the loop database (database_min_size=50 KFs
    # gates detection) and the pose graph.  A motion-clock trigger restores
    # the reference's effective KF cadence (~6 frames on KITTI 00,
    # result/trajectory.txt: 742/4541).  0 disables.
    kf_max_interval: int = 7
    # Minimum frames between keyframes (throttles a BAD->KF-every-frame
    # stretch; measured on the world circuit it trades drift for outright
    # LOST, so it ships disabled).  0 disables.
    kf_min_interval: int = 0


@dataclass(frozen=True)
class MapConfig:
    """Global + active map capacities (reference src/map.cpp, map.h:74-79)."""

    active_window: int = 7            # Map.activeMap.size, KITTI00-02.yaml:73
    min_kf_distance: float = 0.2      # eviction near-threshold, map.cpp:96
    # Fixed device-array capacities (TPU-native).
    max_keyframes: int = 1536
    max_landmarks: int = 131072
    max_active_landmarks: int = 2048  # compacted landmark slots for windowed BA

    def validate(self) -> None:
        if self.active_window < 2:
            raise ValueError("active_window must be >= 2")


@dataclass(frozen=True)
class BackendConfig:
    """Sliding-window BA (reference src/backend.cpp:126-269)."""

    # The reference's 5-round x 10-iteration ceiling (backend.cpp:213),
    # kept verbatim.  Both loops carry convergence early exits
    # (ops/schur.py) so converged problems stop far earlier — but the r5
    # cap experiments showed the CEILING itself is load-bearing on sparse
    # scenes: capping to 3x8 degraded the blob forward course 0.045 ->
    # 0.616 m, and 4x10 (bit-equal to 5x10 there) broke the blob loop
    # course outright — each world sits on a different knife edge, and
    # only the full reference budget passes every acceptance world.  The
    # textured canonical circuit is cap-insensitive (0.7-1.0 m either
    # way, within its seed-ensemble chaos band, SWEEP_SEEDS_AB.json), so
    # the ~0.5 ms/frame the caps saved there is not worth non-parity.
    ba_rounds: int = 5
    ba_iters: int = 10
    chi2_threshold: float = 5.991
    min_inlier_ratio: float = 0.5
    # Pin the oldest window KF as the gauge anchor.  The reference relies
    # solely on landmarks first-observed outside the window (backend.cpp:
    # 175-177), which leaves the gauge free early in a run; fixing the oldest
    # pose removes that drift without changing the converged solution.
    fix_oldest_kf: bool = True
    # Busy-coalescing (backend.cpp:74-103): the reference backend THREAD
    # collapses map-update signals that arrive while an optimization is
    # still running — at its measured BA wall time (tens of ms ≈ several
    # frames at 100 FPS) keyframes created during that window never get an
    # optimization of their own.  On a single serialized device stream the
    # same semantics become a minimum spacing, in frames, between inline
    # BA runs: a keyframe younger than this since the last BA'd keyframe
    # skips its BA (the next one that clears the spacing runs it).
    # 0 disables (BA at every keyframe).
    ba_min_frame_spacing: int = 5


@dataclass(frozen=True)
class LoopClosingConfig:
    """Deep loop detection + correction (reference src/loopclosing.cpp)."""

    similarity_high: float = 0.94       # KITTI00-02.yaml:79
    similarity_low: float = 0.92        # KITTI00-02.yaml:80
    max_above_low: int = 3              # loopclosing.cpp:140-149
    database_min_size: int = 50         # KITTI00-02.yaml:88
    id_gap: int = 20                    # skip recent KFs, loopclosing.cpp:133
    min_matches: int = 10               # loopclosing.cpp:198
    min_inliers: int = 10               # loopclosing.cpp:279
    correction_threshold: float = 1.0   # pose-error norm gating correction, loopclosing.cpp:284-289
    insertion_cooldown: int = 5         # KFs skipped after a closed loop, loopclosing.cpp:674-679
    # --- correction guard rails (TPU-native additions; VERDICT r2 #3).  The
    # reference applies any verified correction unconditionally
    # (loopclosing.cpp:437-459) and relies on its descriptor+ORB stack being
    # discriminative enough; here a marginal verification must not be able
    # to rewrite the whole map:
    # 1. pose-inlier RATIO on top of the absolute count (a 10/200 verify is
    #    no verify);
    min_inlier_ratio: float = 0.35
    # 2. correction magnitude must be explainable as accumulated odometry
    #    drift: |log(T_cur . T_corrected^-1)| <= min(frac * odometry_distance,
    #    cap) + abs.  The cap matters on long runs: by lap 3 of the
    #    endurance circuit the odometry term alone allowed ~128 m, and a
    #    4.9 m mis-verified correction passed and killed tracking
    #    (r5 scripts/diag_endurance.py);
    max_correction_frac: float = 0.25
    max_correction_abs: float = 1.5
    max_correction_cap: float = 12.0
    # 3. post-PGO consistency: mean squared sequential-edge residual after
    #    optimization must stay below this, else the whole correction
    #    (fusion + PGO) rolls back atomically.  0.02 = ~0.14 rad/m per-edge
    #    residual — an order beyond any sane converged graph.
    max_post_pgo_edge_residual: float = 0.02
    # Global pose-graph optimization budget for corrections.  A loop closure
    # fixes both chain ends (active window at corrected poses, loop KF + KF0
    # at old poses) and asks CG to propagate the correction through every
    # free vertex between them; a K-vertex chain needs O(K) CG iterations
    # (condition number ~K^2 under Jacobi), so the windowed-BA budget the
    # round-2 code reused (20x64) left the graph unconverged — which the
    # rollback gate then correctly refused.  (The reference gives g2o 20 LM
    # iterations with a DIRECT sparse solver, loopclosing.cpp:605-606 —
    # exact linear solves need no such budget.)
    pgo_gn_iters: int = 30
    pgo_cg_iters: int = 512
    descriptor_dim: int = 1064          # DeepLCD DescrVector, deeplcd.h:25
    descriptor_image_hw: tuple = (120, 160)  # resize target, deeplcd.cpp:43-52
    pnp_ransac_iters: int = 128
    pnp_ransac_threshold: float = 5.991
    show_result: bool = False
    # Optional: paths to the reference's trained CALC model files
    # (calc_model/deploy.prototxt + calc.caffemodel, reference deeplcd.h:33).
    # When set, the whole-image descriptor runs those exact weights via
    # models/import_caffe (no Caffe needed); otherwise the HOG default.
    caffe_prototxt: str = ""
    caffe_weights: str = ""


@dataclass(frozen=True)
class ViewerConfig:
    """Offline/optional visualization (replaces reference src/viewer.cpp)."""

    show: bool = False
    keyframe_size: float = 0.1
    point_size: float = 2.0


@dataclass(frozen=True)
class ParallelConfig:
    """Multi-chip sharding (new capability; the reference is single-process)."""

    data_axis: str = "data"       # multi-sequence batch axis
    model_axis: str = "model"     # landmark/descriptor-block sharding axis
    dp_size: int = 1
    mp_size: int = 1


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    map: MapConfig = field(default_factory=MapConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    loop: LoopClosingConfig = field(default_factory=LoopClosingConfig)
    viewer: ViewerConfig = field(default_factory=ViewerConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    image_height: int = 376
    image_width: int = 1241

    def validate(self) -> "SlamConfig":
        self.camera.validate()
        self.features.validate()
        self.map.validate()
        return self

    def replace(self, **kwargs: Any) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)

    def scaled_for_resolution(self, ref_width: int = 376) -> "SlamConfig":
        """Scale the pixel-denominated tracking/detection knobs to this
        config's image width.

        The shipped defaults are tuned at 376-px width (the canonical world
        circuit; they also hold at KITTI's 1241 because the FEATURE scale —
        texture, disparity per meter — grows with focal length there).  At
        reduced resolutions the same pixel constants cover a multiple of
        the field-of-view angle they were tuned for: at 120x188 an 11-px LK
        window integrates 2x the scene, 16-px detection cells leave only ~45
        interior cells for a 300-feature budget (starving spatial
        distribution), a 20-px border discards 1/3 of the image rows, and a
        1-px disparity floor rejects the same physical depth range that
        passes at full resolution.  (VERDICT r4 next-round #5: the reference
        tracks multiple resolutions with one parameter set per camera —
        frontend.cpp — because those constants arrive from its per-camera
        YAML; this helper is that per-camera adaptation, computed.)

        Returns self unchanged when the width is at or above the reference
        tuning width (upscaling the windows was measured neutral-to-harmful:
        KITTI runs at the 376-tuned constants, BASELINE.md).
        """
        f = self.image_width / float(ref_width)
        if f >= 1.0:
            return self

        import math

        # r5 half-res sweeps (scripts/SWEEP_LOWRES_CFG.json): shrinking the
        # LK window with resolution LOST accuracy every round (less signal
        # per window on already-degraded texture), so the window stays at
        # its tuned size; what must scale are the geometric constants
        # (cell/border/disparity, linear in f) and the status/replenish
        # COUNT thresholds (sqrt(f): the trackable-feature pool shrinks
        # sub-linearly with pixel count) — 50/80 at full width maps to
        # 35/57 at half, the measured winner (mean ATE 6.3 vs 10-17 for
        # the alternatives at equal keyframe rate ~0.35).
        sf = math.sqrt(f)
        tr = dataclasses.replace(
            self.tracking,
            stereo_min_disparity=self.tracking.stereo_min_disparity * f,
            replenish_min_inliers=(
                round(self.tracking.replenish_min_inliers * sf)
                if self.tracking.replenish_min_inliers else 0
            ),
        )
        fe = dataclasses.replace(
            self.features,
            cell_size=max(8, round(self.features.cell_size * f)),
            # BRIEF samples within a ~16-px patch radius; the detection
            # border may shrink with resolution but never below that.
            edge_margin=max(12, round(self.features.edge_margin * f)),
            num_features_tracking_good=max(
                self.features.num_features_tracking_bad + 5,
                round(self.features.num_features_tracking_good * sf),
            ),
        )
        return dataclasses.replace(self, tracking=tr, features=fe)


# ---------------------------------------------------------------------------
# OpenCV-YAML loader (reference-compatible config files)
# ---------------------------------------------------------------------------

# Map from reference YAML keys (KITTI00-02.yaml) to (section, field) pairs.
_REFERENCE_KEYMAP: Dict[str, tuple] = {
    "Camera.left.fx": ("camera", "fx"),
    "Camera.left.fy": ("camera", "fy"),
    "Camera.left.cx": ("camera", "cx"),
    "Camera.left.cy": ("camera", "cy"),
    "Camera.right.fx": ("camera", "fx_right"),
    "Camera.right.fy": ("camera", "fy_right"),
    "Camera.right.cx": ("camera", "cx_right"),
    "Camera.right.cy": ("camera", "cy_right"),
    "Camera.left.k1": ("camera", "k1"),
    "Camera.left.k2": ("camera", "k2"),
    "Camera.left.p1": ("camera", "p1"),
    "Camera.left.p2": ("camera", "p2"),
    "Camera.right.k1": ("camera", "k1_right"),
    "Camera.right.k2": ("camera", "k2_right"),
    "Camera.right.p1": ("camera", "p1_right"),
    "Camera.right.p2": ("camera", "p2_right"),
    "Camera.bNeedUndistortion": ("camera", "need_undistortion"),
    "Camera.bf": ("camera", "bf"),
    "Camera.fps": ("camera", "fps"),
    "numFeatures.initGood": ("features", "num_features_init_good"),
    "numFeatures.trackingGood": ("features", "num_features_tracking_good"),
    "numFeatures.trackingBad": ("features", "num_features_tracking_bad"),
    "ORBextractor.nInitFeatures": ("features", "n_init_features"),
    "ORBextractor.nNewFeatures": ("features", "n_new_features"),
    "ORBextractor.scaleFactor": ("features", "scale_factor"),
    "ORBextractor.nLevels": ("features", "n_levels"),
    "ORBextractor.iniThFAST": ("features", "ini_th_fast"),
    "ORBextractor.minThFAST": ("features", "min_th_fast"),
    "Map.activeMap.size": ("map", "active_window"),
    "LCD.similarityScoreThreshold.high": ("loop", "similarity_high"),
    "LCD.similarityScoreThreshold.low": ("loop", "similarity_low"),
    "LCD.nDatabaseMinSize": ("loop", "database_min_size"),
    "LoopClosing.bShowResult": ("loop", "show_result"),
    "Viewer.bShow": ("viewer", "show"),
    "Viewer.KeyFrameSize": ("viewer", "keyframe_size"),
    "Viewer.PointSize": ("viewer", "point_size"),
}

_IGNORED_PREFIXES = ("Viewer.",)  # pangolin-specific knobs with no equivalent here

_LINE_RE = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(\S.*?)\s*$")


def parse_opencv_yaml(text: str) -> Dict[str, Any]:
    """Parse a flat OpenCV ``key: value`` YAML document into a dict."""
    out: Dict[str, Any] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        if line.strip().startswith("%"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        key, raw = m.group(1), m.group(2)
        try:
            val: Any = int(raw)
        except ValueError:
            try:
                val = float(raw)
            except ValueError:
                val = raw
        out[key] = val
    return out


def load_config(path: str, warn_unknown: bool = True) -> SlamConfig:
    """Load a :class:`SlamConfig` from a reference-style OpenCV YAML file."""
    with open(path, "r") as f:
        kv = parse_opencv_yaml(f.read())

    sections: Dict[str, Dict[str, Any]] = {}
    for key, val in kv.items():
        if key in _REFERENCE_KEYMAP:
            section, fname = _REFERENCE_KEYMAP[key]
            if fname.startswith("need_") or fname == "show" or fname == "show_result":
                val = bool(val)
            sections.setdefault(section, {})[fname] = val
        elif warn_unknown and not key.startswith(_IGNORED_PREFIXES):
            import logging

            logging.getLogger(__name__).warning("unknown config key ignored: %s", key)

    cfg = SlamConfig()
    replacements: Dict[str, Any] = {}
    for section, fields in sections.items():
        replacements[section] = dataclasses.replace(getattr(cfg, section), **fields)
    return cfg.replace(**replacements).validate()
