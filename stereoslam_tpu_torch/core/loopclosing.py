"""Deep loop closing: descriptor extraction, detection, verification,
correction and global pose-graph optimization (port of
``stereoslam_tpu/core/loopclosing.py``; reference src/loopclosing.cpp).

Four stages driven by the host:

1. ``process_keyframe`` — whole-image descriptor + pyramid-expanded ORB
   descriptors of the new KF (loopclosing.cpp:83-121).
2. detect — dot-product scan over the KF database with the
   similarity / suspect-count / id-gap rules (124-161).
3. verify — Hamming matching with class-id dedup (167-203), PnP-RANSAC and
   pose-only refinement (208-433), loop-edge registration.
4. correct — active-map re-alignment, landmark merge (466-533) and global
   pose-graph optimization with landmark re-anchoring (537-646), rolled back
   as a whole when the optimized graph is less consistent than before.

Each stage's decision scalars come home packed in one small float32 tensor,
read with one host read; the cooldown and database size are mirrored on the
host.  Random minimal sets for PnP come from the closer's own
``torch.Generator`` (seeded 7).  With a ``mesh`` (``parallel/mesh.py``) the
detection scan and the pose-graph optimization are the sharded ones of
``parallel/dist_lcd.py`` and ``parallel/dist_pgo.py``, over the mesh's model
axis, as in the JAX package.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import NamedTuple, Optional, Tuple

import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core.state import LoopState, MapState, TrackState, drop_add, drop_set
from stereoslam_tpu_torch.models import calc
from stereoslam_tpu_torch.ops import se3
from stereoslam_tpu_torch.ops.camera import Intrinsics, world2camera, world2pixel
from stereoslam_tpu_torch.ops.hamming import BIG, match_descriptors, segment_min
from stereoslam_tpu_torch.ops.lm import optimize_pose
from stereoslam_tpu_torch.ops.orb import pyramid_orb
from stereoslam_tpu_torch.ops.pgo import PoseGraph, optimize_pose_graph
from stereoslam_tpu_torch.ops.pnp import draw_minimal_sets, pnp_ransac
from stereoslam_tpu_torch.parallel.dist_lcd import sharded_descriptor_search
from stereoslam_tpu_torch.parallel.dist_pgo import optimize_pose_graph_sharded

log = logging.getLogger(__name__)


class DetectResult(NamedTuple):
    found: torch.Tensor      # () bool
    loop_kf: torch.Tensor    # () int64
    max_score: torch.Tensor  # () float32


class VerifyResult(NamedTuple):
    verified: torch.Tensor         # () bool — loop confirmed (sets the cooldown)
    need_correct: torch.Tensor     # () bool — pose error above the threshold
    T_corrected: torch.Tensor      # (4, 4) corrected current-KF pose
    match_loop_feat: torch.Tensor  # (N,) int32 — per current feature, matched loop feature or -1
    num_inliers: torch.Tensor      # () int32


def _pack(*scalars) -> torch.Tensor:
    """Decision scalars stacked into one float32 vector: one host read."""
    return torch.stack([torch.as_tensor(s).to(torch.float32).reshape(()) for s in scalars])


def _set_row(x: torch.Tensor, i: int, v) -> torch.Tensor:
    """``x.at[i].set(v)``: a new tensor, ``x`` untouched."""
    out = x.clone()
    out[i] = v
    return out


def _select(pred: torch.Tensor, a: MapState, b: MapState) -> MapState:
    """Field-wise ``a`` where the scalar ``pred`` else ``b``: the correction's
    apply-or-rollback decided on the device."""
    return MapState(*(torch.where(pred.reshape((1,) * x.dim()), x, y) for x, y in zip(a, b)))


def post_correction_unlink(tracks: TrackState, T_rk: torch.Tensor, ref_kf: torch.Tensor,
                           map_state: MapState, intr: Intrinsics, max_px: float = 50.0):
    """Drop feature<->landmark links that a loop correction left grossly
    inconsistent with the current camera: every linked landmark is
    re-projected under the corrected pose and unlinked beyond ``max_px`` or
    behind the camera (the reference's outlier unlink, frontend.cpp:255-270,
    applied at correction time).  Returns (tracks', number unlinked)."""
    ref = ref_kf.long()
    eye = torch.eye(4, dtype=torch.float32, device=T_rk.device)
    T_kf = torch.where(ref >= 0, map_state.kf_T_cw[ref.clamp(min=0)], eye)
    T_cw = T_rk @ T_kf
    safe = tracks.lm_idx.long().clamp(min=0)
    pos = map_state.lm_pos[safe]
    usable = (tracks.lm_idx >= 0) & map_state.lm_valid[safe] & ~map_state.lm_outlier[safe]
    err = torch.linalg.norm(world2pixel(pos, T_cw, intr) - tracks.xy, dim=-1)
    z = world2camera(pos, T_cw)[..., 2]
    bad = tracks.valid & usable & ((err > max_px) | (z <= 0.0))
    lm_idx = torch.where(bad, torch.full_like(tracks.lm_idx, -1), tracks.lm_idx)
    return tracks._replace(lm_idx=lm_idx), bad.to(torch.int32).sum()


class LoopCloser:
    """Host-side owner of the loop-closing stages for one device.

    ``descriptor_model``: the whole-image descriptor (default: the
    reference's Caffe model files where ``cfg.loop.caffe_weights`` is set,
    else the shipped trained CALC weights when present, else HOG).  Setting
    ``stage_times`` makes each stage end with a device synchronize and
    append its host wall time to ``self.times[stage]``; PGO iteration counts go to
    ``self.times["pgo_gn"]`` / ``["pgo_cg"]`` either way.  ``mesh``: a
    ``DeviceMesh`` over which the database search and the pose graph are
    sharded (its "model" dimension); every rank runs the same closer on the
    same state.
    """

    def __init__(self, cfg: SlamConfig, intr: Intrinsics, device, descriptor_model=None,
                 mesh=None):
        self.cfg = cfg
        self.intr = intr
        self.device = torch.device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a closer on {self.device}")
        self.mesh = mesh
        if descriptor_model is not None:
            self.model = descriptor_model       # tests pin the HOG surrogate this way
        elif cfg.loop.caffe_weights:
            # The reference's own calc_model files (deploy.prototxt +
            # calc.caffemodel, reference deeplcd.h:33), read without Caffe.
            self.model = calc.DescriptorModel.from_caffe(cfg.loop.caffe_prototxt,
                                                         cfg.loop.caffe_weights)
        else:
            self.model = calc.DescriptorModel.default()
        self.generator = torch.Generator(device=self.device).manual_seed(7)
        self.stage_times = False
        self.times = defaultdict(list)
        self._last_remap: Optional[torch.Tensor] = None
        # Host mirrors of the cooldown and the database size, both driven by
        # host control flow; LoopState keeps the canonical copies.
        self._host_last_closed: Optional[int] = None
        self._host_db_size: int = 0

    @contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.stage_times:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.times[name].append(time.perf_counter() - t0)

    def sync_host_counters(self, loop: LoopState) -> None:
        """Re-seed the host-side decision counters from a state."""
        self._host_last_closed = int(loop.last_closed_kf)
        self._host_db_size = int(loop.db_valid.sum())

    def draw_sets(self, valid: torch.Tensor):
        """The PnP minimal sets of one verification."""
        return draw_minimal_sets(valid, self.generator, self.cfg.loop.pnp_ransac_iters)

    # ------------------------------------------------------------------
    def _process_impl(self, map_state: MapState, loop: LoopState, img: torch.Tensor,
                      kf_id: int) -> LoopState:
        deep = self.model(img)
        orb = pyramid_orb(img, map_state.kf_feat_xy[kf_id], map_state.kf_feat_valid[kf_id], self.cfg)
        return loop._replace(
            deep_db=_set_row(loop.deep_db, kf_id, deep),
            orb_desc=_set_row(loop.orb_desc, kf_id, orb.desc),
            orb_xy=_set_row(loop.orb_xy, kf_id, orb.xy),
            orb_class=_set_row(loop.orb_class, kf_id, orb.cls),
            orb_valid=_set_row(loop.orb_valid, kf_id, orb.valid),
        )

    def process_keyframe(self, map_state: MapState, loop: LoopState, img: torch.Tensor,
                         kf_id: int) -> LoopState:
        """Descriptors of a new KF from its (H, W) float32 left image
        (ProcessNewKF).  The KFs of the cooldown after a closed loop are
        skipped (loopclosing.cpp:674-679)."""
        if self._host_last_closed is None:
            self.sync_host_counters(loop)
        if int(kf_id) - self._host_last_closed <= self.cfg.loop.insertion_cooldown:
            return loop
        with self._stage("process_keyframe"):
            return self._process_impl(map_state, loop, img, int(kf_id))

    # ------------------------------------------------------------------
    def _detect_impl(self, loop: LoopState, kf_id: int):
        cfg = self.cfg.loop
        if self.mesh is not None:
            # The row-sharded scan over the mesh (parallel/dist_lcd.py).
            res = sharded_descriptor_search(loop.deep_db, loop.db_valid, loop.deep_db[kf_id],
                                            kf_id - cfg.id_gap + 1, cfg.similarity_low, self.mesh)
            found = (res.best_score >= cfg.similarity_high) & (res.n_suspect <= cfg.max_above_low)
            det = DetectResult(found=found, loop_kf=res.best_id.long(), max_score=res.best_score)
            return det, _pack(det.found, det.loop_kf, det.max_score)
        scores = loop.deep_db @ loop.deep_db[kf_id]      # (K,) the whole linear scan
        ids = torch.arange(scores.shape[0], device=scores.device)
        eligible = loop.db_valid & ((kf_id - ids) >= cfg.id_gap)
        scores = torch.where(eligible, scores, torch.full_like(scores, -1.0))
        best = torch.argmax(scores)
        max_score = scores[best]
        n_suspect = (scores > cfg.similarity_low).to(torch.int32).sum()
        found = (max_score >= cfg.similarity_high) & (n_suspect <= cfg.max_above_low)
        det = DetectResult(found=found, loop_kf=best, max_score=max_score)
        return det, _pack(det.found, det.loop_kf, det.max_score)

    # ------------------------------------------------------------------
    def _verify_impl(self, map_state: MapState, loop: LoopState, kf_id: int, loop_kf: int):
        cfg = self.cfg
        N = cfg.features.max_features
        dev = map_state.kf_T_cw.device
        # Loop-KF descriptors (query) against current-KF ones (train),
        # as in loopclosing.cpp:172.
        m = match_descriptors(loop.orb_desc[loop_kf], loop.orb_valid[loop_kf],
                              loop.orb_desc[kf_id], loop.orb_valid[kf_id],
                              loop.orb_class[loop_kf], loop.orb_class[kf_id], max_features=N)
        loop_feat_of_match = loop.orb_class[loop_kf]                    # (M,)
        cur_feat_of_match = loop.orb_class[kf_id][m.best_idx.long()]    # (M,)
        # One pair per current feature slot: the best distance, then the
        # lowest match index (a set keyed by feature ids, loopclosing.cpp:184-193).
        cur_slot = torch.where(m.accepted, cur_feat_of_match, torch.full_like(cur_feat_of_match, N))
        best_per_cur = segment_min(torch.where(m.accepted, m.best_dist, torch.full_like(m.best_dist, BIG)),
                                   cur_slot, N + 1)[:N]
        M_len = m.accepted.shape[0]
        midx = torch.arange(M_len, dtype=torch.int32, device=dev)
        at_best = m.accepted & (m.best_dist <= best_per_cur[torch.clamp(cur_feat_of_match, max=N - 1).long()])
        first_match = segment_min(torch.where(at_best, midx, torch.full_like(midx, M_len)),
                                  cur_slot, N + 1)[:N]
        has_match = first_match < M_len
        match_loop_feat = torch.where(
            has_match, loop_feat_of_match[torch.clamp(first_match, max=M_len - 1).long()],
            torch.full_like(first_match, -1))                           # (N,)

        # The loop feature must carry a landmark (loopclosing.cpp:218-237).
        loop_lm = map_state.kf_feat_lm[loop_kf]
        lm_of_pair = torch.where(match_loop_feat >= 0, loop_lm[match_loop_feat.clamp(min=0).long()],
                                 torch.full_like(match_loop_feat, -1))
        lm_safe = lm_of_pair.clamp(min=0).long()
        pair_ok = (has_match & (lm_of_pair >= 0) & map_state.lm_valid[lm_safe]
                   & ~map_state.lm_outlier[lm_safe])
        n_pairs = pair_ok.to(torch.int32).sum()

        X = map_state.lm_pos[lm_safe]                                   # (N, 3)
        px = map_state.kf_feat_xy[kf_id]                                # (N, 2)
        pnp = pnp_ransac(X, px, pair_ok, self.intr, *self.draw_sets(pair_ok),
                         chi2_threshold=cfg.loop.pnp_ransac_threshold)
        # Pose-only refinement over the RANSAC inliers (OptimizeCurrentPose,
        # loopclosing.cpp:339-433).
        refined = optimize_pose(pnp.T_cw, X, px, pnp.inliers, self.intr,
                                rounds=cfg.tracking.pose_rounds, iters=cfg.tracking.pose_iters,
                                chi2_threshold=cfg.tracking.chi2_threshold)
        enough = (n_pairs >= cfg.loop.min_matches) & pnp.ok & (refined.num_inliers >= cfg.loop.min_inliers)
        # Guard rails: the inlier ratio, and a correction no larger than the
        # drift the odometry since the loop KF can explain.
        ratio_ok = refined.num_inliers.to(torch.float32) >= (
            cfg.loop.min_inlier_ratio * torch.clamp(n_pairs, min=1).to(torch.float32))
        kf_ids = torch.arange(map_state.capacity_kf, device=dev)
        seg = (kf_ids > loop_kf) & (kf_ids <= kf_id) & map_state.kf_valid
        step_len = torch.linalg.norm(map_state.kf_rel_prev[:, :3, 3], dim=-1)
        odo = torch.where(seg, step_len, torch.zeros_like(step_len)).sum()
        T_cur = map_state.kf_T_cw[kf_id]
        pose_err = torch.linalg.norm(se3.log(T_cur @ se3.inv(refined.T_cw)))
        err_ok = pose_err <= (torch.clamp(cfg.loop.max_correction_frac * odo,
                                          max=cfg.loop.max_correction_cap)
                              + cfg.loop.max_correction_abs)
        enough = enough & ratio_ok & err_ok
        need_correct = enough & (pose_err > cfg.loop.correction_threshold)

        # Register the loop edge on verification (loopclosing.cpp:328-330).
        rel = refined.T_cw @ se3.inv(map_state.kf_T_cw[loop_kf])
        map_out = map_state._replace(
            kf_loop=_set_row(map_state.kf_loop, kf_id,
                             torch.where(enough, loop_kf, map_state.kf_loop[kf_id])),
            kf_rel_loop=_set_row(map_state.kf_rel_loop, kf_id,
                                 torch.where(enough, rel, map_state.kf_rel_loop[kf_id])),
        )
        # Only pose-inlier pairs go on to the landmark merge.
        match_final = torch.where(refined.inlier & pair_ok, match_loop_feat,
                                  torch.full_like(match_loop_feat, -1))
        verify = VerifyResult(verified=enough, need_correct=need_correct, T_corrected=refined.T_cw,
                              match_loop_feat=match_final, num_inliers=refined.num_inliers)
        return verify, _pack(enough, need_correct, pose_err, odo, n_pairs, refined.num_inliers), map_out

    # ------------------------------------------------------------------
    def _correct_impl(self, map_state: MapState, loop: LoopState, kf_id: int, loop_kf: int,
                      T_corrected: torch.Tensor, match_loop_feat: torch.Tensor):
        """LoopLocalFusion + PoseGraphOptimization (loopclosing.cpp:466-646)."""
        cfg = self.cfg
        K, L = map_state.capacity_kf, map_state.capacity_lm
        W, N = map_state.active_kf.shape[0], map_state.kf_feat_valid.shape[1]
        dev = map_state.kf_T_cw.device

        # 1. Rigid re-alignment of the active KFs (loopclosing.cpp:471-483).
        active = map_state.active_kf
        act_valid = active >= 0
        act_safe = active.clamp(min=0).long()
        T_act = map_state.kf_T_cw[act_safe]
        T_act_corrected = T_act @ se3.inv(map_state.kf_T_cw[kf_id]) @ T_corrected
        T_act_corrected = torch.where((active == kf_id)[:, None, None], T_corrected, T_act_corrected)

        # 2. Active landmarks move with their first active observer (486-502).
        feat_lm = map_state.kf_feat_lm[act_safe]
        flat_lm = torch.where(map_state.kf_feat_valid[act_safe] & (feat_lm >= 0) & act_valid[:, None],
                              feat_lm, torch.full_like(feat_lm, L))                  # (W, N)
        w_slot = torch.arange(W, dtype=torch.int32, device=dev)[:, None].expand(W, N)
        obs_slot = segment_min(w_slot.reshape(-1), flat_lm.reshape(-1), L + 1)[:L]   # W+ if unseen
        lm_active = obs_slot < W
        slot_safe = obs_slot.clamp(max=W - 1).long()
        p_cam = se3.act(T_act[slot_safe], map_state.lm_pos)
        p_new = se3.act(se3.inv(T_act_corrected[slot_safe]), p_cam)
        lm_pos = torch.where((lm_active & map_state.lm_valid)[:, None], p_new, map_state.lm_pos)

        # 3. Corrected active poses.
        kf_T_cw = drop_set(map_state.kf_T_cw, torch.where(act_valid, active, K), T_act_corrected)

        # 4. Landmark merge: matched current features adopt the loop landmark,
        # the duplicate is removed and every reference to it redirected
        # (loopclosing.cpp:510-532) through a remap table.
        cur_lm_row = map_state.kf_feat_lm[kf_id]
        pair = match_loop_feat
        neg = torch.full_like(pair, -1)
        loop_lm_of_pair = torch.where(pair >= 0, map_state.kf_feat_lm[loop_kf][pair.clamp(min=0).long()], neg)
        tgt = loop_lm_of_pair.clamp(min=0).long()
        merge = (pair >= 0) & (loop_lm_of_pair >= 0) & map_state.lm_valid[tgt]
        dup_lm = torch.where(merge & (cur_lm_row >= 0), cur_lm_row, neg)
        has_dup = dup_lm >= 0
        dup_safe = torch.where(has_dup, dup_lm, torch.full_like(dup_lm, L))
        remap = drop_set(torch.arange(L, dtype=torch.int32, device=dev), dup_safe,
                         torch.where(merge, loop_lm_of_pair, neg))
        adopt = merge & (cur_lm_row < 0)
        kf_feat_lm = _set_row(map_state.kf_feat_lm, kf_id, torch.where(adopt, loop_lm_of_pair, cur_lm_row))
        kf_feat_lm = torch.where(kf_feat_lm >= 0, remap[kf_feat_lm.clamp(min=0).long()], kf_feat_lm)
        lm_valid = drop_set(map_state.lm_valid, dup_safe, False)
        # Observation counts: the duplicate's move to the surviving landmark,
        # each adopting feature adds one (loopclosing.cpp:515-529).
        cnt = map_state.lm_obs_count
        moved = torch.where(has_dup, cnt[dup_lm.clamp(min=0).long()], torch.zeros_like(dup_lm))
        cnt = drop_add(cnt, torch.where(has_dup, tgt, L), moved)
        cnt = drop_set(cnt, dup_safe, 0)
        cnt = drop_add(cnt, torch.where(adopt, tgt, L), 1)
        m1 = map_state._replace(kf_T_cw=kf_T_cw, lm_pos=lm_pos, kf_feat_lm=kf_feat_lm,
                                lm_valid=lm_valid, lm_obs_count=cnt)

        # 5. Global pose-graph optimization (loopclosing.cpp:537-646):
        # sequential and loop edges, a fixed-shape 2K edge list.
        kf_ids = torch.arange(K, dtype=torch.int32, device=dev)
        in_window = (kf_ids[:, None] == active[None, :]).any(1) & map_state.kf_valid
        fixed = in_window | (kf_ids == loop_kf) | (kf_ids == 0)
        seq_valid = m1.kf_valid & (m1.kf_prev >= 0)
        graph = PoseGraph(
            poses=m1.kf_T_cw, vertex_valid=m1.kf_valid, fixed=fixed,
            edge_i=torch.cat([kf_ids, kf_ids]),
            edge_j=torch.cat([m1.kf_prev.clamp(min=0), m1.kf_loop.clamp(min=0)]),
            edge_meas=torch.cat([m1.kf_rel_prev, m1.kf_rel_loop]),
            edge_valid=torch.cat([seq_valid, m1.kf_valid & (m1.kf_loop >= 0)]),
        )
        stats: dict = {}
        if self.mesh is not None:
            poses_opt = optimize_pose_graph_sharded(graph, self.mesh,
                                                    gn_iters=cfg.loop.pgo_gn_iters,
                                                    cg_iters=cfg.loop.pgo_cg_iters, stats=stats)
        else:
            poses_opt = optimize_pose_graph(graph, gn_iters=cfg.loop.pgo_gn_iters,
                                            cg_iters=cfg.loop.pgo_cg_iters, stats=stats)
        self.times["pgo_gn"].append(stats["gn_iters"])
        self.times["pgo_cg"].append(stats["cg_iters"])

        # 6. Non-active landmarks re-anchor to their first observer (617-637).
        first = m1.lm_first_kf
        first_safe = first.clamp(min=0).long()
        p_cam2 = se3.act(m1.kf_T_cw[first_safe], m1.lm_pos)
        p_re = se3.act(se3.inv(poses_opt[first_safe]), p_cam2)
        re_mask = m1.lm_valid & (first >= 0) & ~lm_active
        lm_pos2 = torch.where(re_mask[:, None], p_re, m1.lm_pos)
        m2 = m1._replace(kf_T_cw=poses_opt, lm_pos=lm_pos2)

        # 7. Post-PGO consistency gate, relative to the graph's own residual
        # before the correction; a failure rolls the whole correction back
        # and withdraws the loop edge.
        meas_inv_seq = se3.inv(m1.kf_rel_prev)
        prev_safe = m1.kf_prev.clamp(min=0).long()
        n_seq = torch.clamp(seq_valid.to(torch.int32).sum(), min=1)

        def seq_res(poses):
            r = se3.log(meas_inv_seq @ poses @ se3.inv(poses[prev_safe]))
            r2 = (r * r).sum(-1)
            return torch.where(seq_valid, r2, torch.zeros_like(r2)).sum() / n_seq

        mean_res = seq_res(poses_opt)
        bound = torch.clamp(1.5 * seq_res(map_state.kf_T_cw), min=cfg.loop.max_post_pgo_edge_residual)
        finite = torch.isfinite(poses_opt).all() & torch.isfinite(lm_pos2).all()
        applied = finite & (mean_res <= bound)

        m_roll = map_state._replace(kf_loop=_set_row(map_state.kf_loop, kf_id, -1))
        m_out = _select(applied, m2, m_roll)
        identity = torch.arange(L, dtype=torch.int32, device=dev)
        remap_out = torch.where(applied, remap, identity)
        loop_out = loop._replace(last_closed_kf=torch.full((), kf_id, dtype=torch.int32, device=dev))
        return m_out, loop_out, remap_out, _pack(applied, mean_res, bound)

    # ------------------------------------------------------------------
    def start_detect(self, loop: LoopState, kf_id: int):
        """Enqueue loop detection for keyframe ``kf_id``.  Returns a token for
        :meth:`finish_detect`, or None when the host-mirrored cooldown
        already decides; a database still warming up gives a token that only
        inserts the KF."""
        cfg = self.cfg.loop
        kf_id = int(kf_id)
        if self._host_last_closed is None:
            self.sync_host_counters(loop)
        if kf_id - self._host_last_closed <= cfg.insertion_cooldown:
            return None
        if self._host_db_size <= cfg.database_min_size:
            return ("warmup", kf_id)
        with self._stage("detect"):
            det, packed = self._detect_impl(loop, kf_id)
        return ("detect", kf_id, det, packed)

    def finish_detect(self, map_state: MapState, loop: LoopState,
                      token) -> Tuple[MapState, LoopState, bool, int]:
        """Resolve a :meth:`start_detect` token: database bookkeeping, then
        (on a hit) verification and correction.  Returns (map, loop, closed,
        loop_kf_id)."""
        cfg = self.cfg.loop
        if token is None:
            return map_state, loop, False, -1
        kf_id = token[1]

        def add_to_db(lp: LoopState) -> LoopState:
            self._host_db_size += 1
            return lp._replace(db_valid=_set_row(lp.db_valid, kf_id, True))

        if token[0] == "warmup":
            return map_state, add_to_db(loop), False, -1
        # The cooldown is checked again here: a closure resolved after this
        # detection was enqueued re-arms it only now (loopclosing.cpp:127-131).
        if self._host_last_closed is not None and kf_id - self._host_last_closed <= cfg.insertion_cooldown:
            return map_state, add_to_db(loop), False, -1
        dp = token[3].cpu().numpy()
        if not bool(dp[0]):
            return map_state, add_to_db(loop), False, -1
        loop_kf = int(dp[1])

        with self._stage("verify"):
            verify, packed, map_state = self._verify_impl(map_state, loop, kf_id, loop_kf)
            # [verified, need_correct, pose_err_m, odometry_m, pairs, inliers]
            vp = packed.cpu().numpy()
        if not bool(vp[0]):
            log.info("loop candidate KF %d -> %d not verified: %d pairs, %d pose inliers, "
                     "pose_err %.2f m (odo %.1f m)", kf_id, loop_kf, vp[4], vp[5], vp[2], vp[3])
            return map_state, add_to_db(loop), False, -1
        log.info("loop verified: KF %d -> %d, pose_err %.2f m (odo %.1f m)",
                 kf_id, loop_kf, float(vp[2]), float(vp[3]))
        # Confirmed: the cooldown starts now even if no correction follows
        # (loopclosing.cpp:331).
        self._host_last_closed = kf_id
        loop = loop._replace(last_closed_kf=torch.full_like(loop.last_closed_kf, kf_id))
        self._last_remap = None
        if bool(vp[1]):
            with self._stage("correct"):
                map_state, loop, remap, cpk = self._correct_impl(
                    map_state, loop, kf_id, loop_kf, verify.T_corrected, verify.match_loop_feat)
                cp = cpk.cpu().numpy()  # [applied, mean_residual, bound]
            if not bool(cp[0]):
                log.warning("loop correction ROLLED BACK (KF %d -> %d): post-PGO mean edge "
                            "residual %.4f exceeds bound %.4f", kf_id, loop_kf, cp[1], cp[2])
                return map_state, loop, False, -1
            self._last_remap = remap
        return map_state, loop, True, loop_kf

    def detect_and_correct(self, map_state: MapState, loop: LoopState,
                           kf_id: int) -> Tuple[MapState, LoopState, bool, int]:
        """Synchronous detection -> verification -> correction."""
        return self.finish_detect(map_state, loop, self.start_detect(loop, int(kf_id)))

    def remap_tracks(self, lm_idx: torch.Tensor) -> torch.Tensor:
        """Apply the last correction's landmark merge to frontend tracks."""
        if self._last_remap is None:
            return lm_idx
        return torch.where(lm_idx >= 0, self._last_remap[lm_idx.clamp(min=0).long()], lm_idx)
