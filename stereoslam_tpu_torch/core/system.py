"""System facade: construction, the pipelined frame loop, loop closing and
result export (port of ``stereoslam_tpu/core/system.py``).

The counterpart of the reference ``System`` class (reference
src/system.cpp:18-97), with the JAX facade's pipelined frame loop.  A
tracked frame is ``frontend.track_frame`` replayed as one CUDA graph
(``core/graphs.py``), one asynchronous copy of its packed outcome into
pinned host memory, and, once that copy has landed, the keyframe or
replenish branch where the outcome's flags ask for one.  On a frame with
neither, that copy is the frame's one device-to-host read.

**readback_lag.**  A frame's outcome is *retired* (metrics, status, the
pose log, the capacity guards and compaction, and a keyframe's host-launched
work: loop closing's ``process_keyframe`` and ``start_detect``, and the BA
when ``inline_ba=False``) ``readback_lag`` frames after it was tracked, as
in the JAX facade (``_inflight``, ``_retire_entry``, ``_retire``), from the
entry's own copy of the staged pair.  An older entry retires between the
frame's replay and the wait on its outcome, so its host work overlaps the
card's; it sees the frame's tracked state, and the frame's branch sees what
it changed.  No readiness poll is involved, so a run is a deterministic
function of its frames and the lag.  Unlike JAX's, the branch decision
cannot be deferred: the port launches the keyframe branch from the host,
so the host waits for every frame's flags.  LOST is returned when the LOST
frame retires, within ``readback_lag`` frames; lag 0 (the default, the JAX
package's CPU semantics) reports it on the frame that lost.
:meth:`StereoSlam.process_chunk` takes C staged frames a call, as C
``process_staged`` calls whose entries retire together.

Loop detection of a keyframe is enqueued when the keyframe retires and
resolved (verified, corrected) at the next keyframe's retire, before its
own detection starts, or when a public read drains the queue: the JAX
package's order whenever a verdict has landed by the next keyframe.

**The windowed BA.**  With ``inline_ba`` (the default without a mesh) it
runs in the keyframe branch on the facade's stream, and the frame waits for
it: ``core/graphs.py`` ``SteppedBA`` replays one LM step a graph and reads
each exit test on the host, so it stops at the exit rule.  With
``inline_ba=False`` (the default with a mesh, as in JAX) it is
*asynchronous*, JAX's ``_pending_ba``, and reads nothing back: one CUDA
graph of every LM step, its exit tests frozen on the device
(``BAGraph``).  When a keyframe retires (and at initialization) that
graph is replayed on a side stream that first waits
for the facade's stream, and the host goes on without waiting; the frames
tracked meanwhile read the pre-BA map.  At most one BA is in flight.  Its
result is swapped into the map by a device-side wait of the facade's
stream on the BA's event, never by a host sync, at JAX's
``_flush_pending_ba`` sites (before the next keyframe's retire work, before
compaction, before each loop decision, at every public read through
``_drain`` and so ``save_checkpoint``) and before any host-launched branch
that writes the map (keyframe or replenishment).  The map tensors the side
stream reads are marked for it (``record_stream``) and no map field is
written before the swap; the BA's outputs are marked for the facade's
stream at the swap.  On the CPU the same code runs the BA at its launch
and swaps at the same points.  Two departures from JAX:

- JAX swaps when ``_poll_async`` finds the result ready, so which frames
  see the new map depends on timing.  The port adds no readiness poll: a
  run stays a deterministic function of its frames and ``readback_lag``.
- JAX's swap replaces the whole map by the BA's output, so a keyframe or
  replenishment written by a frame enqueued while the BA was in flight is
  lost at the swap.  The reference writes only the BA's poses and
  landmarks under the map lock; the port swaps before every map write and
  replaces only the BA's fields, so every write is kept.

``load_checkpoint`` drops a BA in flight (JAX's keeps it).

**Undistortion** (``camera.need_undistortion``, reference camera.cpp:36-48):
the two (H, W, 2) source grids are built once at construction (in float32
on the host, so every device remaps through the same grid) and kept on the
device, and every widening of a camera image goes through
``_pre_left`` / ``_pre_right`` (widen to float32, then the bilinear remap),
as in the JAX facade: the left image inside the tracked frame's graph, the
initialization pair, the right image of the keyframe and replenish branches,
and the image handed to the loop closer, so CALC and ORB see the
undistorted image.
"""

from __future__ import annotations

import logging
import time
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core import frontend as frontend_mod
from stereoslam_tpu_torch.core import loopclosing as loop_mod
from stereoslam_tpu_torch.core.backend import BA_OUTPUTS, BAMap
from stereoslam_tpu_torch.core.graphs import BAGraph, SteppedBA, TrackGraph
from stereoslam_tpu_torch.core.maintenance import compact_landmarks
from stereoslam_tpu_torch.core.state import INITING, LOST, TRACKING_GOOD, init_all
from stereoslam_tpu_torch.ops.camera import Intrinsics, undistort_image, undistortion_map
from stereoslam_tpu_torch.ops.image import build_lk_pyramid
from stereoslam_tpu_torch.utils import checkpoint as ckpt
from stereoslam_tpu_torch.utils.prof import Profiler
from stereoslam_tpu_torch.utils import trajectory as traj_io

log = logging.getLogger(__name__)


def _widen(u8: torch.Tensor) -> torch.Tensor:
    return u8.to(torch.float32)


def _widen_remap(src_map: torch.Tensor, u8: torch.Tensor) -> torch.Tensor:
    return undistort_image(u8.to(torch.float32), src_map)


class _Entry(NamedTuple):
    """A tracked frame waiting to retire."""

    frame: int
    counts: Tuple[int, ...]  # num_inliers, num_tracked, status, kf_id or -1, ref_kf, n_lm
    T_rk: np.ndarray         # (4, 4) after the frame's branch
    lr_u8: torch.Tensor      # the frame's (2, H, W) stereo pair, the entry's own
    t_enqueue: Optional[float]  # host clock at the frame's enqueue; None: no latency sample


class StereoSlam:
    """End-to-end stereo SLAM: visual odometry, windowed BA, loop closing.

    Usage::

        slam = StereoSlam(cfg)                  # on the card; device="cpu" for the CPU
        for left, right, ts in frames:
            if not slam.process_frame(left, right, ts):
                break
        slam.save_trajectory("trajectory.txt")
    """

    def __init__(
        self,
        cfg: SlamConfig,
        device="cuda",
        enable_backend: bool = True,
        enable_loop: bool = True,
        readback_lag: Optional[int] = None,
        inline_ba: Optional[bool] = None,
        descriptor_model=None,
        mesh=None,
    ):
        """``device``: where every tensor of the state lives, the card unless
        the caller asks for ``"cpu"`` (which runs the plain versions of the
        kernels and the tracked frame without a graph).
        ``readback_lag``: frames between a frame's tracking and its retire
        (default 0; see the module docstring).
        ``inline_ba``: run windowed BA inside the keyframe branch of the frame
        step; False runs it asynchronously from the keyframe frame's retire
        (see the module docstring; default: True unless a mesh is given, as
        in JAX).
        ``descriptor_model``: the loop closer's whole-image descriptor
        (default: the shipped trained CALC weights, else HOG).
        ``mesh``: a ``DeviceMesh`` (``parallel/mesh.py`` ``make_mesh``) over
        which the loop closer shards its database search and pose graph;
        every rank runs the same facade on the same frames."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoSlam runs on the card by default and no CUDA device is "
                               "available: pass device='cpu' to run on the CPU")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a StereoSlam on {self.device}")
        cfg.validate()
        self.cfg = cfg
        self.enable_backend = enable_backend
        self.enable_loop = enable_loop
        self.readback_lag = int(readback_lag or 0)
        if self.readback_lag < 0:
            raise ValueError(f"readback_lag must be >= 0, got {readback_lag}")
        cam = cfg.camera
        self.intr_left = Intrinsics.create(cam.fx, cam.fy, cam.cx, cam.cy)
        self.intr_right = Intrinsics.create(cam.fx_right, cam.fy_right, cam.cx_right, cam.cy_right)
        self.baseline = cam.baseline
        # uint8 camera image -> the float32 image the system reads.
        self.undistortion_maps = None
        self._pre_left = self._pre_right = _widen
        if cam.need_undistortion:
            h, w = cfg.image_height, cfg.image_width
            # Built once in float32 on the host and kept on the device: every
            # device remaps through the same grid, bit for bit.
            self.undistortion_maps = tuple(
                undistortion_map(h, w, intr, torch.tensor(dist, dtype=torch.float32)
                                 ).to(self.device)
                for intr, dist in ((self.intr_left, (cam.k1, cam.k2, cam.p1, cam.p2)),
                                   (self.intr_right, (cam.k1_right, cam.k2_right, cam.p1_right,
                                                      cam.p2_right))))
            self._pre_left = partial(_widen_remap, self.undistortion_maps[0])
            self._pre_right = partial(_widen_remap, self.undistortion_maps[1])
        self.fs, self.map, self.loop = init_all(cfg, self.device)
        self.inline_ba = bool(inline_ba) if inline_ba is not None else mesh is None
        # The windowed BA (map -> map): stepped to its exit rule where the
        # frame waits for it, one fixed-step graph for the asynchronous BA;
        # the latter's stream, and the BA in flight: (its event on the card
        # or None, its fields).
        self._ba = (SteppedBA if self.inline_ba else BAGraph)(cfg, self.intr_left, self.device)
        self._ba_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._pending_ba = None
        self.track_graph = TrackGraph(cfg, self.intr_left, self.device, pre_left=self._pre_left)
        # The packed outcome's landing place on the host, and its event.
        if self.device.type == "cuda":
            self._host_outcome = torch.empty(frontend_mod.OUTCOME_SIZE, dtype=torch.float32,
                                             pin_memory=True)
            self._outcome_landed = torch.cuda.Event()
        else:
            self._host_outcome = None
        # Outcome reads on the host (one per tracked frame), and the tracked
        # frames whose LK rescue passes ran (their gated launches were on).
        self.outcome_reads = 0
        self.rescues = {"retry": 0, "deep": 0}
        self._pyr_prev = None
        self._frame_count = 0
        self._status = INITING
        # Exact f64 timestamps by frame id (the device keeps f32 copies).
        self._ts_by_frame: Dict[int, float] = {}
        # Per-frame (T_rk, ref_kf), filled as frames retire, resolved against
        # the final KF table by frame_trajectory().
        self._pose_log: Dict[int, Tuple[np.ndarray, int]] = {}
        self.metrics: Dict[str, List[int]] = {"num_inliers": [], "num_tracked": []}
        # One record per frame: status, keyframe and loop events, the
        # "track" stage (the frame's enqueue: copy-in, replay, outcome copy)
        # and the "branch" stage (the wait for the outcome and the branch).
        self.profiler = Profiler()
        # Per-frame latency: host clock from the frame's enqueue to its
        # retire (frames retired by a drain or by process_chunk excluded;
        # an initialization frame retires within its call).
        self.frame_latency_ms: List[float] = []
        self._inflight: List[_Entry] = []
        self._warned_kf_full = False
        self._lm_compact_threshold = int(0.9 * cfg.map.max_landmarks)
        self.compaction_count = 0
        self._loop_edges: List[Tuple[int, int]] = []
        # Loop-detection tokens of earlier keyframes, resolved FIFO.
        self._pending_loops: List = []
        if enable_loop:
            self._loop_closer = loop_mod.LoopCloser(cfg, self.intr_left, self.device,
                                                    descriptor_model=descriptor_model, mesh=mesh)

    # ------------------------------------------------------------------
    def process_frame(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> bool:
        """Track one stereo frame (System::RunStep, system.cpp:92-97).
        Returns False once tracking is LOST (frontend.cpp:64-67)."""
        if self._status == LOST:
            return False
        lr = np.stack([np.asarray(left), np.asarray(right)]).astype(np.uint8)
        return self.process_staged(torch.from_numpy(lr).to(self.device), timestamp)

    def process_staged(self, lr_u8: torch.Tensor, timestamp: float) -> bool:
        """Track one stereo frame whose stacked (2, H, W) uint8 pair already
        lies on the device.  Returns False once a LOST frame has retired."""
        if self._status == LOST:
            return False
        rec = self.profiler.start_frame(self._frame_count, float(timestamp))
        self._ts_by_frame[self._frame_count] = float(timestamp)
        if self._status == INITING:
            t0 = time.perf_counter()
            self._init_step(lr_u8, timestamp)
            # An initialization frame retires within its call.
            self.frame_latency_ms.append((time.perf_counter() - t0) * 1e3)
        else:
            keep = lr_u8.clone() if self.readback_lag > 0 else lr_u8
            self._track(lr_u8, timestamp, keep, retire_to=self.readback_lag - 1)
            self._retire_beyond(self.readback_lag)
        rec.status = self._status
        self.profiler.end_frame()
        return self._status != LOST

    def process_chunk(self, lr_chunk: torch.Tensor, timestamps) -> bool:
        """Track C staged frames, ``lr_chunk`` (C, 2, H, W) uint8 on the
        device and C timestamps: semantically C :meth:`process_staged` calls,
        whose entries retire while more than ``max(readback_lag, C)`` frames
        are in flight, as the JAX facade's chunk does.  The port replays the
        frame's graph and reads its outcome once per frame, so a chunk costs
        C outcome reads; what it saves is the retire work between frames.
        Chunk frames stay out of ``frame_latency_ms``.  Requires initialized
        tracking (feed the first frames through :meth:`process_staged`).
        Returns False once a LOST frame has retired."""
        if self._status == LOST:
            return False
        if self._status == INITING:
            raise RuntimeError("process_chunk requires initialized tracking; feed the first "
                               "frames through process_frame/process_staged")
        keep = lr_chunk.clone()
        for i in range(int(lr_chunk.shape[0])):
            self._ts_by_frame[self._frame_count] = float(timestamps[i])
            self._track(lr_chunk[i], timestamps[i], keep[i], retire_to=None)
        self._retire_beyond(max(self.readback_lag, int(lr_chunk.shape[0])))
        return self._status != LOST

    # ------------------------------------------------------------------
    def _init_step(self, lr_u8: torch.Tensor, timestamp: float) -> None:
        """Stereo initialization, synchronous (the JAX facade's too)."""
        frame_idx = self._frame_count
        ts = torch.full((), float(timestamp), dtype=torch.float32, device=self.device)
        left_f32 = self._pre_left(lr_u8[0])
        lk_levels = self.cfg.tracking.lk_levels
        pyr_left = build_lk_pyramid(left_f32, lk_levels)
        pyr_right = build_lk_pyramid(self._pre_right(lr_u8[1]), lk_levels)
        fs, m, kf_id, n_lm = frontend_mod.stereo_init_step(
            left_f32, pyr_left, pyr_right, self.fs, self.map, self.intr_left,
            self.intr_right, self.baseline, ts, self.cfg,
        )
        n_lm, kf_id = int(n_lm), int(kf_id)
        if n_lm >= self.cfg.features.num_features_init_good:
            self._status = TRACKING_GOOD
            self.fs = fs._replace(status=torch.full((), TRACKING_GOOD, dtype=torch.int32,
                                                    device=self.device))
            self.map = m
            self._pose_log[frame_idx] = (np.eye(4, dtype=np.float32), kf_id)
            # The init keyframe's BA runs here even in inline mode (JAX:
            # force_ba=self.inline_ba): synchronous inline, else launched.
            self._after_keyframe(left_f32, kf_id, run_ba=self.enable_backend)
            log.info("stereo init: %d landmarks, KF %d", n_lm, kf_id)
        else:
            log.info("stereo init failed: only %d landmarks", n_lm)
        self._pyr_prev = pyr_left
        self._frame_count += 1

    def _track(self, lr_u8: torch.Tensor, timestamp: float, keep: torch.Tensor,
               retire_to: Optional[int]) -> None:
        """One tracked frame: replay its graph and start the copy of its
        outcome to the host (the frame's tracked state becomes the facade's
        at once); retire older entries down to ``retire_to`` while the card
        runs (None: retire nothing, a chunk's frames); wait for the outcome,
        run the branch it asks for, and queue the frame's entry, which keeps
        ``keep`` as its stereo pair (a chunk's frames take no latency
        sample)."""
        frame_idx = self._frame_count
        t_enqueue = time.perf_counter()
        with self.profiler.stage("track"):
            left, fs, pyr, packed = self.track_graph.run(lr_u8, self._pyr_prev, self.fs, self.map)
            if self._host_outcome is not None:
                self._host_outcome.copy_(packed, non_blocking=True)
                self._outcome_landed.record()
        self.fs, self._pyr_prev = fs, pyr
        self._frame_count += 1
        if retire_to is not None:
            self._retire_beyond(retire_to)
        with self.profiler.stage("branch"):
            o = self._read_outcome(packed)
            counts = (o.num_inliers, o.num_tracked, o.status, -1, o.ref_kf, o.n_lm)
            T_rk = o.T_rk
            if o.make_kf or o.replenish:
                self._swap_ba()  # the branch writes the map
                ts = torch.full((), float(timestamp), dtype=torch.float32, device=self.device)
                ba_fn = self._ba if (self.enable_backend and self.inline_ba) else None
                self.fs, self.map, kf_id = frontend_mod.run_branch(
                    o, left, lambda: self._pre_right(lr_u8[1]), pyr, self.fs, self.map,
                    self.intr_left, self.intr_right, self.baseline, ts, self.cfg, ba_fn=ba_fn)
                # The branch reads the host anyway: one more read for the
                # frame's final reference and pose.
                kf = kf_id if kf_id is not None else torch.full((), -1, device=self.device)
                post = torch.cat([torch.stack([kf.to(torch.float32),
                                               self.fs.ref_kf.to(torch.float32),
                                               self.map.n_lm.to(torch.float32)]),
                                  self.fs.T_rk.reshape(-1)]).cpu().numpy()
                counts = counts[:3] + tuple(int(v) for v in post[:3])
                T_rk = post[3:].reshape(4, 4).copy()
        self._inflight.append(_Entry(frame_idx, counts, T_rk, keep,
                                     t_enqueue if retire_to is not None else None))

    def _read_outcome(self, packed: torch.Tensor) -> frontend_mod.Outcome:
        """The frame's one device-to-host read: wait for the outcome's copy."""
        if self._host_outcome is not None:
            self._outcome_landed.synchronize()
            packed = self._host_outcome
        packed = packed.numpy()
        self.outcome_reads += 1
        o = frontend_mod.Outcome.unpack(packed)
        self.rescues["retry"] += o.retry
        self.rescues["deep"] += o.deep
        return o

    def _retire_beyond(self, depth: int) -> None:
        """Retire the oldest entries until ``depth`` are left, stopping at a
        LOST one (the frames after it never retire)."""
        while len(self._inflight) > max(depth, 0) and self._status != LOST:
            self._retire_entry(self._inflight.pop(0))

    def _retire_entry(self, entry: _Entry, record_latency: bool = True) -> None:
        """Record a frame's outcome: metrics, status, pose log, capacity
        guards, and the keyframe work (BA when not inline, loop closing)."""
        n_inliers, n_tracked, status, kf_id, ref_kf, n_lm = entry.counts
        frame_idx = entry.frame
        if entry.t_enqueue is not None and record_latency:
            self.frame_latency_ms.append((time.perf_counter() - entry.t_enqueue) * 1e3)
        self.metrics["num_inliers"].append(n_inliers)
        self.metrics["num_tracked"].append(n_tracked)
        self._status = status
        if status == LOST:
            log.warning("tracking LOST at frame %d (%d inliers)", frame_idx, n_inliers)
            return
        self._pose_log[frame_idx] = (entry.T_rk, ref_kf)
        if kf_id == -2 and not self._warned_kf_full:
            self._warned_kf_full = True
            log.error("keyframe table FULL (%d): keyframe creation saturated at frame %d — "
                      "raise map.max_keyframes for longer runs",
                      self.cfg.map.max_keyframes, frame_idx)
        if n_lm >= self._lm_compact_threshold and kf_id >= 0:
            self._swap_ba()
            self.map, tracks, freed = compact_landmarks(self.map, self.fs.tracks)
            self.fs = self.fs._replace(tracks=tracks)
            self.compaction_count += 1
            n_freed = int(freed)
            log.warning("landmark table at %d/%d: compacted, freed %d dead slots",
                        n_lm, self.cfg.map.max_landmarks, n_freed)
            if n_freed < self.cfg.map.max_landmarks // 20:
                log.error("landmark table nearly exhausted even after compaction "
                          "(%d free): raise map.max_landmarks", n_freed)
        if kf_id >= 0:
            if self.profiler._current is not None:
                self.profiler._current.keyframe_id = kf_id
            self._swap_ba()
            self._after_keyframe(self._pre_left(entry.lr_u8[0]), kf_id,
                                 run_ba=self.enable_backend and not self.inline_ba)

    # ------------------------------------------------------------------
    def _after_keyframe(self, left_f32: torch.Tensor, kf_id: int, run_ba: bool) -> None:
        """The work of the reference's backend and loop threads for a new
        keyframe (backend.cpp:74-103, loopclosing.cpp:52-80): descriptors,
        BA (synchronous inline, else launched), then loop closing."""
        if self.enable_loop:
            self.loop = self._loop_closer.process_keyframe(self.map, self.loop, left_f32, kf_id)
        if run_ba and self.inline_ba:
            self.map = self._ba(self.map)
        elif run_ba:
            self._launch_ba()
        if self.enable_loop:
            # The previous keyframes' detections resolve before this one's starts.
            self._flush_loops()
            token = self._loop_closer.start_detect(self.loop, kf_id)
            if token is not None:
                self._pending_loops.append(token)

    def _launch_ba(self) -> None:
        """Start the windowed BA of the current map and do not wait for it
        (JAX ``self._pending_ba = self._jit_ba(self.map)``): on the card
        its graph replays on the side stream after the work the facade's
        stream has enqueued; on the CPU it runs here."""
        self._swap_ba()  # at most one BA in flight
        src = self.map
        if self._ba_stream is None:
            new, done = self._ba(src), None
        else:
            self._ba_stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._ba_stream):
                new = self._ba(src)
                done = torch.cuda.Event()
                done.record()
            # The side stream reads these map tensors, which the facade's
            # stream allocated: none is reused before the BA has read it.
            for t in BAMap.of(src):
                t.record_stream(self._ba_stream)
        self._pending_ba = (done, {f: getattr(new, f) for f in BA_OUTPUTS})

    def _swap_ba(self) -> None:
        """Swap the BA in flight into the map (JAX ``_flush_pending_ba``):
        the facade's stream waits for its event on the device, the host does
        not.  Only the BA's fields change; no map write happens while a BA is
        in flight, so they are the BA of the map as it stands."""
        if self._pending_ba is None:
            return
        done, fields = self._pending_ba
        self._pending_ba = None
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in fields.values():  # made on the side stream
                t.record_stream(stream)
        self.map = self.map._replace(**fields)

    def _drain(self) -> None:
        """Retire every in-flight frame, resolve the pending loop decisions,
        then swap in the BA in flight (before public reads of the map)."""
        while self._inflight and self._status != LOST:
            self._retire_entry(self._inflight.pop(0), record_latency=False)
        self._inflight.clear()
        self._flush_loops()
        self._swap_ba()

    def _flush_loops(self) -> None:
        """Resolve the pending loop decisions, oldest first."""
        while self._pending_loops:
            self._flush_one_loop(self._pending_loops.pop(0))

    def _flush_one_loop(self, token) -> None:
        kf_id = token[1]
        # The correction rewrites the map: it sees the BA's result (the
        # reference pauses the backend here, loopclosing.cpp:445-449).
        self._swap_ba()
        self.map, self.loop, closed, loop_kf = self._loop_closer.finish_detect(
            self.map, self.loop, token)
        if not closed:
            return
        self._loop_edges.append((kf_id, int(loop_kf)))
        if self.profiler._current is not None:
            self.profiler._current.loop_closed_with = int(loop_kf)
        # The frontend pose is KF-relative, so the corrected KF pose carries
        # over; the landmark merge is applied to the live tracks, then links
        # the correction left inconsistent are dropped.
        tracks = self.fs.tracks._replace(lm_idx=self._loop_closer.remap_tracks(self.fs.tracks.lm_idx))
        tracks, _ = loop_mod.post_correction_unlink(tracks, self.fs.T_rk, self.fs.ref_kf,
                                                    self.map, self.intr_left)
        self.fs = self.fs._replace(tracks=tracks)
        log.info("loop closed: KF %d -> KF %d", kf_id, int(loop_kf))

    # ------------------------------------------------------------------
    @property
    def status(self) -> int:
        """Frontend status (INITING/TRACKING_GOOD/TRACKING_BAD/LOST)."""
        return self._status

    def current_pose(self) -> np.ndarray:
        """Absolute T_cw of the latest tracked frame."""
        ref = int(self.fs.ref_kf)
        T_kf = self.map.kf_T_cw[ref].cpu().numpy() if ref >= 0 else np.eye(4, dtype=np.float32)
        return self.fs.T_rk.cpu().numpy() @ T_kf

    def frame_trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        """(frame_ids, T_cw) for every tracked frame, each frame's relative
        pose composed with its reference KF's final (BA-refined, loop-
        corrected) pose."""
        self._drain()
        ids = np.array(sorted(self._pose_log), dtype=np.int64)
        if ids.size == 0:
            return ids, np.zeros((0, 4, 4), np.float64)
        kf_T = self.map.kf_T_cw.cpu().numpy()
        T = np.stack([self._pose_log[f][0] @ kf_T[self._pose_log[f][1]] for f in ids])
        return ids, T

    def keyframe_trajectory(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(kf_ids, timestamps, T_cw) for all valid keyframes."""
        self._drain()
        n = int(self.map.n_kf)
        ts_dev = self.map.kf_timestamp[:n].cpu().numpy()
        fid = self.map.kf_frame_id[:n].cpu().numpy()
        ts = np.array([self._ts_by_frame.get(int(f), float(t)) for f, t in zip(fid, ts_dev)],
                      dtype=np.float64)
        return np.arange(n), ts, self.map.kf_T_cw[:n].cpu().numpy()

    def save_trajectory(self, path: str) -> None:
        ids, ts, T = self.keyframe_trajectory()
        traj_io.save_trajectory(path, ids, ts, T)

    def save_loop_edges(self, path: str) -> None:
        """Two keyframe pose lines per loop edge (system.cpp:203-220)."""
        ids, ts, T = self.keyframe_trajectory()
        traj_io.save_loop_edges(path, self._loop_edges, ids, ts, T)

    @property
    def loop_edges(self) -> List[Tuple[int, int]]:
        """(current KF, loop KF) of every closed loop."""
        self._drain()
        return list(self._loop_edges)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> str:
        """Snapshot the full SLAM state (map, tracks, loop database and the
        previous frame's pyramid) in the JAX package's layout, after
        resolving pending loop decisions and swapping in the BA in flight.
        The keyframes' exact float64 timestamps ride along as
        ``facade.kf_timestamp``."""
        self._drain()
        fs = self.fs._replace(status=torch.tensor(self._status, dtype=torch.int32,
                                                  device=self.device))
        _, ts, _ = self.keyframe_trajectory()
        return ckpt.save_checkpoint(path, fs, self.map, self.loop, pyr=self._pyr_prev,
                                    extra={"facade.kf_timestamp": ts})

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of either package.  The loop closer's
        host-side counters are re-synced from the loaded state and the loop
        edges are read from its keyframe table; the PnP generator's state is
        not part of a checkpoint (nor is the JAX closer's PRNG key), so
        verifications after a resume draw other minimal sets.  A BA in
        flight is dropped."""
        self.fs, self.map, self.loop, self._pyr_prev, extra = ckpt.load_checkpoint(
            path, self.device)
        self._status = int(self.fs.status)
        self._frame_count = int(self.fs.frame_id) + 1
        self._inflight = []
        self._pending_loops = []
        self._pending_ba = None
        n = int(self.map.n_kf)
        kf_loop = self.map.kf_loop[:n].cpu().numpy()
        self._loop_edges = [(int(k), int(lp)) for k, lp in enumerate(kf_loop) if lp >= 0]
        ts = extra.get("facade.kf_timestamp")
        if ts is not None:
            fid = self.map.kf_frame_id[:n].cpu().numpy()
            self._ts_by_frame.update({int(f): float(t) for f, t in zip(fid, ts)})
        if self.enable_loop:
            self._loop_closer.sync_host_counters(self.loop)
